"""Chunk-grounding fact checker.

Two modes, mirroring app/services/fact_checker.py:264:
- "recall" (chunk-only): what fraction of the must-facts is present in
  the RETRIEVED CHUNKS, ignoring the synthesized answer — this is the
  metric behind every strategy-recall number in BASELINE.md (calibration
  scores with chunk-only recall).
- "grounding": each fact asserted by the ANSWER must also be supported
  by some chunk; asserting a fact with no chunk support is a
  hallucination (penalty 1.0 per the reference); honest abstains get
  full grounding credit.

Noise floor: the reference pins σ=0.2 per query (FACT_CHECKER_SIGMA);
we expose the same constant for σ-banded comparisons
(CANONICAL_STRATEGY_BASELINE.md methodology).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from mobius_rag_tpu.clients import LLMClient
from mobius_rag_tpu.eval_harness.judge import _fact_present, _llm_verdicts, _overlap_verdicts
from mobius_rag_tpu.query.text import tokenize

FACT_CHECKER_VERSION = "mrag-v1"
FACT_CHECKER_SIGMA = 0.2


@dataclasses.dataclass
class FactCheckResult:
    recall: float  # fraction of must-facts present in chunks
    grounding: float  # fraction of answer-asserted facts chunk-supported
    hallucinated: list[str]
    per_fact_in_chunks: list[bool]
    mode: str


def check_facts(
    must_facts: Sequence[str],
    chunks_text: Sequence[str],
    answer: str = "",
    mode: str = "recall",
    llm: LLMClient | None = None,
) -> FactCheckResult:
    hay = "\n".join(chunks_text)
    hay_tokens = set(tokenize(hay, drop_stopwords=True))
    in_chunks = [_fact_present(f, hay, hay_tokens) for f in must_facts]
    recall = sum(in_chunks) / len(in_chunks) if in_chunks else 0.0

    hallucinated: list[str] = []
    grounding = 1.0
    if mode == "grounding" and answer.strip():
        if llm is not None:
            v = _llm_verdicts(llm, answer, must_facts, [], [])
            asserted = v.must if v else _overlap_verdicts(answer, must_facts, [], []).must
        else:
            asserted = _overlap_verdicts(answer, must_facts, [], []).must
        n_asserted = sum(asserted)
        if n_asserted:
            supported = sum(1 for a, c in zip(asserted, in_chunks) if a and c)
            grounding = supported / n_asserted
            hallucinated = [f for f, a, c in zip(must_facts, asserted, in_chunks)
                            if a and not c]
    return FactCheckResult(
        recall=round(recall, 4), grounding=round(grounding, 4),
        hallucinated=hallucinated, per_fact_in_chunks=in_chunks, mode=mode,
    )
