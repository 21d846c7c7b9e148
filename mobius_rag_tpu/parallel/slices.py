"""Multi-slice serving: host-side hierarchical merge of per-slice
search results.

The device mesh scales a corpus within one host (parallel/sharded.py:
per-shard scan + allgather candidate merge). Beyond one host's device +
host memory, the corpus splits at the HOST layer — one engine (or one
RemoteIndexClient endpoint) per slice, each serving its own rows — and
queries fan out to every slice, merging the top-k RESULTS per query
(the only traffic between hosts; see parallel/mesh.py and SURVEY
§5.8).

Merge semantics: results merge by the engine's rerank score (the v1.3
weighted blend), deduplicating by chunk_id. Every per-row signal in
that score is slice-independent EXCEPT the lexical normalizer
(lexn = lex / per-slice lex_best), so for embedding-only queries the
hierarchical merge reproduces a whole-corpus engine's ranking exactly
(pinned by __graft_entry__ dryrun stage 9 and tests); for text queries
it matches the reference's own multi-instance semantics — each
instance normalizes lexical scores against the rows it holds.

Reference parity anchor: the reference scales queries by N stateless
API instances over one Postgres; the multi-slice form keeps its
"thin host fan-out, durable host bus" shape (SURVEY §2.10) with the
device mesh inside each slice.
"""
from __future__ import annotations

from typing import Sequence

from mobius_rag_tpu.query.engine import SearchResult


def merge_slice_results(per_slice: "Sequence[list[SearchResult]]",
                        k: int) -> list[SearchResult]:
    """Merge per-query results from S slices: per_slice[s][q] is slice
    s's SearchResult for query q. Returns one merged SearchResult per
    query (top-k by rerank score, chunk_id-deduped, confidence label
    re-derived as the max of the slice labels' scores)."""
    if not per_slice:
        return []
    n_q = len(per_slice[0])
    assert all(len(rs) == n_q for rs in per_slice), "ragged slice results"
    merged: list[SearchResult] = []
    for qi in range(n_q):
        base = per_slice[0][qi]
        seen: set[str] = set()
        hits = []
        for rs in per_slice:
            for h in rs[qi].hits:
                if h.chunk_id not in seen:
                    seen.add(h.chunk_id)
                    hits.append(h)
        hits.sort(key=lambda h: -h.score)
        hits = hits[:k]
        label = max((rs[qi].confidence_label for rs in per_slice),
                    key=_label_rank)
        merged.append(SearchResult(
            query=base.query,
            hits=hits,
            confidence_label=label if hits else "abstain",
            expansion=base.expansion,
            telemetry={
                "multi_slice": {
                    "slices": len(per_slice),
                    "per_slice_hits": [len(rs[qi].hits) for rs in per_slice],
                },
                **{key: v for key, v in base.telemetry.items()
                   if key != "arms"},
            },
        ))
    return merged


_LABELS = ("abstain", "low", "medium", "high")


def _label_rank(label: str) -> int:
    try:
        return _LABELS.index(label)
    except ValueError:
        return 0
