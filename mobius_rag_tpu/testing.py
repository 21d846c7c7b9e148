"""Deterministic test/bench fixtures.

`hash_embed` is a stand-in encoder: a bag-of-words of per-token gaussian
directions (seeded by a stable token hash), L2-normalized. Texts sharing
vocabulary get high cosine similarity, so end-to-end retrieval tests are
meaningful without a trained encoder — the same role the mocked
embedding provider plays in the reference's tests (SURVEY §4 tier 2).
"""
from __future__ import annotations

import zlib

import numpy as np

from mobius_rag_tpu.config import get_config
from mobius_rag_tpu.index.store import ChunkRecord
from mobius_rag_tpu.ingest.featurize import featurize_chunk
from mobius_rag_tpu.query.lexicon import Lexicon
from mobius_rag_tpu.query.text import tokenize


def _token_direction(tok: str, dim: int) -> np.ndarray:
    seed = zlib.crc32(tok.encode())
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def hash_embed(texts: list[str], dim: int | None = None) -> np.ndarray:
    dim = dim or get_config().embed_dim
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        toks = tokenize(t, drop_stopwords=True)
        for tok in toks:
            out[i] += _token_direction(tok, dim)
        n = np.linalg.norm(out[i])
        if n > 0:
            out[i] /= n
    return out


def sample_lexicon() -> Lexicon:
    import os

    path = os.path.join(os.path.dirname(__file__), "data", "lexicon_sample.yaml")
    return Lexicon.from_yaml(path)


# A tiny synthetic healthcare-policy corpus exercising payers, domains,
# authority levels, and distractors.
_TOY_DOCS = [
    ("sunshine_provider_manual", "sunshine_health", "FL", 4, [
        ("Timely filing: participating providers must submit initial claims "
         "within 180 days from the date of service. Non-participating "
         "providers have 365 days. Claim disputes within 90 days of the EOP.",
         "Claims / Timely Filing"),
        ("Prior authorization is required for residential substance use "
         "treatment billed under H0019. Submit the ASAM level of care "
         "determination with the request.", "Behavioral Health / Prior Auth"),
        ("Durable medical equipment over $500 requires prior authorization. "
         "DME rentals are capped at purchase price.", "Benefits / DME"),
    ]),
    ("aetna_provider_manual", "aetna", "FL", 4, [
        ("Aetna Better Health timely filing deadline is 180 days for all "
         "claims. Corrected claims must arrive within 365 days.",
         "Claims / Filing"),
        ("No PCP referral is required for in-network outpatient behavioral "
         "health therapy. Out-of-network requires prior authorization.",
         "Behavioral Health / Referrals"),
        ("Preferred drug list updates are published quarterly. Formulary "
         "exceptions need a coverage determination request.",
         "Pharmacy / Formulary"),
    ]),
    ("ahca_quarterly_report", "", "FL", 1, [
        ("Statewide Medicaid managed care enrollment grew 3% this quarter. "
         "Plans processed claims within contractual windows.",
         "Enrollment Statistics"),
        ("Telehealth utilization remains above pre-pandemic baselines across "
         "behavioral health services.", "Utilization Trends"),
    ]),
    ("molina_quick_reference", "molina", "FL", 3, [
        ("Molina Healthcare eligibility verification is available via the "
         "provider portal or by phone. Verify member eligibility before "
         "each visit.", "Eligibility"),
        ("Electronic claims: use payer ID 51062 through your clearinghouse. "
         "EDI enrollment forms are on the provider portal.", "Billing / EDI"),
    ]),
]


def toy_corpus(lexicon: Lexicon | None = None, *, pad_docs: int = 0,
               rng: np.random.Generator | None = None):
    """Build featurized ChunkRecords for the toy corpus (+ optional random
    distractor docs to scale N). Returns list[ChunkRecord]."""
    cfg = get_config()
    recs: list[ChunkRecord] = []
    for doc, payer, state, auth, chunks in _TOY_DOCS:
        texts = [t for t, _ in chunks]
        embs = hash_embed(texts)
        for i, ((text, section), emb) in enumerate(zip(chunks, embs)):
            prev_text = texts[i - 1] if i > 0 else ""
            next_text = texts[i + 1] if i + 1 < len(texts) else ""
            rec = ChunkRecord(
                chunk_id=f"{doc}-c{i}", doc_id=doc, source_id=f"{doc}-s{i}",
                text=text, embedding=emb, payer=payer, state=state,
                program="medicaid" if payer else "",
                authority_level=auth, filename=f"{doc}.pdf",
                section_path=section, page=i + 1,
                neighbor_text=(prev_text + "\n" + next_text).strip(),
            )
            recs.append(featurize_chunk(rec, lexicon, cfg))
    rng = rng or np.random.default_rng(1234)
    for di in range(pad_docs):
        words = rng.choice(
            ["network", "committee", "annual", "review", "budget", "meeting",
             "training", "audit", "survey", "report", "schedule", "update"],
            size=20,
        )
        text = " ".join(words)
        rec = ChunkRecord(
            chunk_id=f"filler{di}-c0", doc_id=f"filler{di}",
            source_id=f"filler{di}-s0", text=text,
            embedding=hash_embed([text])[0],
            filename=f"filler{di}.pdf", authority_level=0,
        )
        recs.append(featurize_chunk(rec, lexicon, cfg))
    return recs


BENCH_PAYERS = ("sunshine_health", "aetna", "molina", "")


def seeded_corpus(n: int, lexicon: Lexicon, cfg=None, seed: int = 7):
    """The benchmark corpus at the reference's operating point (bench.py,
    SURVEY §6): `n` chunks of random unit vectors over 4 payers (one
    unaffiliated), sampled authority and d-tags, the first 64 chunks
    fully featurized for the lexical arm. Deterministic per seed.
    Returns (records, vectors [n, D] f32, lexical [64, H] f32, rng) —
    the rng continues the same stream for query generation."""
    cfg = cfg or get_config()
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((n, cfg.embed_dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    recs = []
    for i in range(n):
        r = ChunkRecord(
            chunk_id=f"c{i}", doc_id=f"doc{i % 7000}", source_id=f"s{i}",
            text=f"policy paragraph {i} covering claims filing and authorization "
                 f"requirements for plan {i % 97}.",
            embedding=vectors[i],
            payer=BENCH_PAYERS[i % len(BENCH_PAYERS)], state="FL",
            authority_level=int(rng.integers(0, 5)),
            filename=f"doc{i % 7000}.pdf",
        )
        # cheap featurization for scale: no per-chunk regex tagging
        # (d-tags sampled instead)
        r.lexical_weights = {}
        r.d_tags = [int(rng.integers(0, 12))]
        recs.append(r)
    lexical = np.zeros((64, cfg.lexical_buckets), np.float32)
    for i, r in enumerate(recs[:64]):
        featurize_chunk(r, lexicon, cfg)
        for b, w in r.lexical_weights.items():
            lexical[i, b % cfg.lexical_buckets] += w
    return recs, vectors, lexical, rng


def numpy_filter_gate(cols: dict, q: dict, k: int) -> np.ndarray:
    """Plain numpy reference of the filter gate (engine.filter_masks +
    gate_penalty semantics): bool [B, C], True where row c is eligible
    for query b. `cols` holds host copies of the DeviceIndex columns
    (valid, authority, payer, state, program, j_tags, d_tags, p_tags);
    `q` the prepared per-query arrays (payer, state, program, tag_mode,
    inherit_authority, j_bits, d_bits, p_bits). Metadata ids: -1 = any,
    -2 = a value the corpus never saw (matches nothing). tag_mode 0 =
    strict with auto-relax when fewer than k rows pass strict, 1 =
    relaxed, 2 = validity only."""
    valid = np.asarray(cols["valid"]) > 0

    def match(col, want):
        col, want = np.asarray(col)[None, :], np.asarray(want)[:, None]
        return (want == -1) | (col == want)

    def overlap(rows, bits):
        rows, bits = np.asarray(rows, np.uint32), np.asarray(bits, np.uint32)
        return ((rows[None, :, :] & bits[:, None, :]) != 0).any(axis=2)

    regulator = ((np.asarray(cols["authority"]) >= 0.999)
                 & (np.asarray(cols["payer"]) < 0))[None, :]
    inherit = (np.asarray(q["inherit_authority"]) > 0)[:, None]
    meta = ((match(cols["payer"], q["payer"]) | (inherit & regulator))
            & match(cols["state"], q["state"])
            & match(cols["program"], q["program"]))
    has_j = (np.asarray(q["j_bits"]) != 0).any(axis=1)[:, None]
    has_dp = ((np.asarray(q["d_bits"]) != 0).any(axis=1)
              | (np.asarray(q["p_bits"]) != 0).any(axis=1))[:, None]
    j_ok = overlap(cols["j_tags"], q["j_bits"])
    dp_ok = (overlap(cols["d_tags"], q["d_bits"])
             | overlap(cols["p_tags"], q["p_bits"]))
    strict = valid[None, :] & meta & (j_ok | ~has_j)
    relaxed = valid[None, :] & meta & (dp_ok | ~has_dp)
    auto = np.where(strict.sum(axis=1, keepdims=True) >= k,
                    strict, strict | relaxed)
    tm = np.asarray(q["tag_mode"])[:, None]
    return np.where(tm == 0, auto,
                    np.where(tm == 1, relaxed,
                             np.broadcast_to(valid[None, :], auto.shape)))


class ScriptedLLM:
    """Test LLM returning canned responses per stage (falls back to the
    first unconsumed script entry)."""

    def __init__(self, responses: dict[str, str] | None = None,
                 default: str = "UNKNOWN"):
        self.responses = responses or {}
        self.default = default
        self.calls: list[str] = []

    def generate(self, prompt: str, *, system: str = "", max_tokens: int = 1024,
                 temperature: float = 0.0, stage: str = "") -> str:
        self.calls.append(stage)
        return self.responses.get(stage, self.default)


class ScriptedWeb:
    """Test web client serving a url→body map (search returns every url
    whose body shares a query token)."""

    offline = False

    def __init__(self, pages: dict[str, str] | None = None):
        self.pages = pages or {}

    def search(self, query: str, *, max_results: int = 5):
        toks = {t for t in query.lower().split() if len(t) > 3}
        out = [{"url": u, "title": u}
               for u, body in self.pages.items()
               if any(t in body.lower() for t in toks)]
        return out[:max_results]

    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str:
        return self.pages.get(url, "")
