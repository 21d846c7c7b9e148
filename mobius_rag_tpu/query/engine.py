"""The compiled hybrid retrieval pipeline ("strategy a").

This is the on-device rebuild of the reference's ``corpus_search``
(app/services/corpus_search.py:3280): three arms → RRF fusion → weighted
rerank → confidence labels — but where the reference runs two SQL scans
plus Python loops per query, here the entire pipeline is ONE jitted XLA
program over the device-resident index, batched over queries:

  vector arm   pgvector HNSW cosine + strict/relaxed filters (:1427)
               → masked dot-product scores + per-query strict/relaxed
                 mask with auto-relax (strict yields < k → relaxed)
  lexical arm  weighted tsvector FTS over search_vec (:806)
               → hashed-term BM25 weights [C, H] ⊗ IDF query vector
  d-tag arm    tag-membership candidates ordered by authority (:1605)
               → d-tag bitset overlap gated, authority-scored
  RRF          k=60 reciprocal-rank fusion (:1708) → scatter-add
  rerank       v1.3 unified selectivity-weighted coverage + sim +
               authority + length + jpd (:1909) → gathered signal math
               over fused candidates, with binary j-tag doc credit
  confidence   high/medium/low/abstain thresholds (:2307)

Everything string-shaped (tokenizing, lexicon matching, IDF lookup)
happens host-side in ``prepare_query``; everything O(corpus) happens
on device in ``_search_compiled``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import OrderedDict
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from mobius_rag_tpu.config import Config, get_config
from mobius_rag_tpu.index.store import ChunkStore, DeviceIndex, pack_bits
from mobius_rag_tpu.ingest.featurize import query_lexical_weights
from mobius_rag_tpu.ops.topk import NEG_INF
from mobius_rag_tpu.query.gating import query_dtag_ids as _query_dtag_ids
from mobius_rag_tpu.query.lexicon import Lexicon, LexiconExpansion
from mobius_rag_tpu.utils import jit_cache
from mobius_rag_tpu.utils import native

# Rerank weights — reranker v1.3. The reference's 6-weight split
# (corpus_search.py:1917-1921) is sim .25 + authority .10 + length .05 +
# jpd .20 + tag_coverage .40 + meta_boost .15. Here tag_coverage and
# meta_boost FOLD into one coverage signal (W_COV = .40 + .15 = .55):
# the reference computes them as two substring scans over two haystacks
# (body vs metadata), but its v1.3 unified coverage already credits a
# phrase found in EITHER haystack — so this build precomputes phrase
# bits over the ENRICHED haystack (body + neighbors + metadata,
# featurize.enriched_haystack) and scores one selectivity-weighted
# coverage term. Consequences (pinned by tests/test_engine_edges.py::
# test_meta_only_coverage_credit): a phrase present only in a chunk's
# METADATA earns the same coverage credit as one in the body — exactly
# the meta_boost behavior — and a chunk carrying the phrase nowhere
# earns none. Total weight mass and [0,1] normalization match the
# reference's.
W_SIM, W_AUTH, W_LEN, W_JPD, W_COV = 0.25, 0.10, 0.05, 0.20, 0.55

# Max coverage-phrase slots per query (12 lexicon entries × a few phrases
# each; 64 covers the reference's expansion cap comfortably).
MAX_PHRASE_SLOTS = 64


def to_bf16(x: np.ndarray) -> np.ndarray:
    """f32 → bf16 with round-to-nearest-even, via vectorized uint bit math.
    numpy's ``astype(ml_dtypes.bfloat16)`` runs a scalar conversion loop;
    this runs at memory bandwidth."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
    return (rounded >> np.uint32(16)).astype(np.uint16).view(ml_dtypes.bfloat16)

_MODES = ("corpus", "precision", "recall")
# Per-mode arm weights in RRF (vector, lexical, dtag). The reference's
# modes alter SQL behavior (precision tightens the FTS/tag side, recall
# widens the vector side); here ONE compiled program serves all modes
# and the mode picks arm emphasis in the fusion instead. The observable
# contract (pinned by tests/test_engine_edges.py::test_mode_semantics):
#   precision — lexical-dominant: exact-term matches outrank
#               semantically-near-but-wrong-term chunks;
#   recall    — vector-dominant AND no confidence floor (abstain-grade
#               hits are kept, _MODE_MIN semantics below);
#   corpus    — the balanced default.
_MODE_ARM_WEIGHTS = {
    "corpus": (1.0, 1.0, 0.5),
    "precision": (0.5, 1.0, 0.7),
    "recall": (1.0, 0.6, 0.3),
}
# Mode-default minimum confidence floor (corpus_search.py:_MODE_MIN).
MODE_MIN_LABEL = {"corpus": "low", "precision": "low", "recall": "abstain"}


@dataclasses.dataclass
class QueryRequest:
    """One search request (the reference's CorpusSearchRequest shape)."""

    query: str
    embedding: np.ndarray | None = None  # [D]; required until an encoder is attached
    mode: str = "corpus"
    payer: str = ""
    state: str = ""
    program: str = ""
    min_similarity: float = 0.0
    tag_mode: str = "strict"  # strict | relaxed | none
    # inherited authority (corpus_search_agent.py:1970): a payer filter
    # also admits top-authority state/regulator documents (AHCA-class,
    # authority_level 4) in the same state — regulator policy applies to
    # every payer it governs.
    inherit_authority: bool = True


@dataclasses.dataclass
class SearchHit:
    row: int
    chunk_id: str
    doc_id: str
    text: str
    score: float  # rerank score in [0, 1]
    similarity: float  # best-arm cosine
    signals: dict[str, float]
    metadata: dict[str, Any]
    # neighbor expansion (corpus_search.py:3079): adjacent same-document
    # chunks attached for synthesis context, subject to per-doc caps
    neighbors: list[dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SearchResult:
    query: str
    hits: list[SearchHit]
    confidence_label: str
    expansion: LexiconExpansion
    telemetry: dict[str, Any]


def _confidence_label(score: float, cfg: Config) -> str:
    if score >= cfg.confidence_high:
        return "high"
    if score >= cfg.confidence_medium:
        return "medium"
    if score >= cfg.confidence_low:
        return "low"
    return "abstain"


# ---------------------------------------------------------------------------
# The compiled pipeline
# ---------------------------------------------------------------------------

def _bit_test(bits_rows: jnp.ndarray, word: jnp.ndarray, bit: jnp.ndarray) -> jnp.ndarray:
    """bits_rows [..., W] u32; word/bit broadcastable int32 → {0,1} f32."""
    w = jnp.take_along_axis(bits_rows, word[..., None], axis=-1)[..., 0]
    return ((w >> bit.astype(jnp.uint32)) & jnp.uint32(1)).astype(jnp.float32)


def _overlap(bits: jnp.ndarray, qbits: jnp.ndarray) -> jnp.ndarray:
    """Any-bit overlap between chunk bitsets [C, W] and query bitsets
    [B, W] → [B, C] {0,1} f32. Loops over the (static, small) word axis
    so no [B, C, W] temporary materializes — at 1M chunks that 3-D
    intermediate was 1 GB per tag kind and OOMed the hybrid pipeline."""
    acc = jnp.zeros((qbits.shape[0], bits.shape[0]), jnp.bool_)
    for w in range(bits.shape[1]):
        acc = acc | ((bits[:, w][None, :] & qbits[:, w][:, None]) > 0)
    return acc.astype(jnp.float32)


def filter_masks(index: DeviceIndex, q: dict):
    """Eligibility masks [B, C] for the filter gate: (strict, relaxed,
    open, meta_ok). strict = metadata AND j-tags (when present); relaxed
    = metadata AND d/p-tag join (the auto-relax retry target,
    corpus_search.py:1545-1555); open = validity only (strategy b's
    vector_broad tag_mode=none)."""
    valid = index.valid  # [C] f32

    def col_match(col, want):  # [C] i32 vs [B] i32 (-1 = any, -2 = none) → [B, C]
        return jnp.where(
            want[:, None] == -1, 1.0, (col[None, :] == want[:, None]).astype(jnp.float32)
        )

    payer_ok = col_match(index.payer, q["payer"])
    # inherited authority: PAYER-UNAFFILIATED regulator-grade rows
    # (authority_level 4, no payer of their own — AHCA-class) pass a
    # payer filter when the query allows inheritance — the device form
    # of the agent's inherited-authority candidate augmentation
    # (corpus_search_agent.py:1970). Another payer's own documents never
    # inherit, whatever their authority.
    regulator = ((index.authority[None, :] >= 0.999)
                 & (index.payer[None, :] < 0)).astype(jnp.float32)
    payer_ok = jnp.maximum(payer_ok, q["inherit_authority"][:, None] * regulator)
    meta_ok = (
        payer_ok
        * col_match(index.state, q["state"])
        * col_match(index.program, q["program"])
    )  # [B, C]
    has_j = (q["j_bits"].sum(axis=1) > 0)[:, None].astype(jnp.float32)  # [B,1]
    has_dp = (q["d_bits"].sum(axis=1) + q["p_bits"].sum(axis=1) > 0)[:, None].astype(jnp.float32)
    j_ok = _overlap(index.j_tags, q["j_bits"])  # [B, C]
    dp_ok = jnp.maximum(_overlap(index.d_tags, q["d_bits"]), _overlap(index.p_tags, q["p_bits"]))

    strict = valid[None, :] * meta_ok * jnp.where(has_j > 0, j_ok, 1.0)
    relaxed = valid[None, :] * meta_ok * jnp.where(has_dp > 0, dp_ok, 1.0)
    open_mask = valid[None, :] * jnp.ones_like(meta_ok)
    return strict, relaxed, open_mask, meta_ok


def gate_penalty(strict, relaxed, open_mask, q: dict, k: int, strict_total=None):
    """Per-query tag_mode gating with strict→relaxed auto-relax. Under
    sharding, pass the GLOBAL strict count (psum) as strict_total so all
    shards take the same branch."""
    if strict_total is None:
        strict_total = strict.sum(axis=1, keepdims=True)
    auto = jnp.where(strict_total >= k, strict, jnp.maximum(strict, relaxed))
    tm = q["tag_mode"][:, None]
    gate = jnp.where(tm == 0, auto, jnp.where(tm == 1, relaxed, open_mask))
    return (1.0 - gate) * NEG_INF  # [B, C]


def lexical_raw(index: DeviceIndex, q: dict, lex_weights=None) -> jnp.ndarray:
    """Lexical arm raw scores [B, C]. Queries are sparse in the
    hash-bucket space, so instead of a [B, H] x [H, C] matmul (a full
    read of the bucket-major lexical matrix), gather only the batch's
    union of touched buckets and contract against per-query IDF weights
    — HBM traffic drops from H rows to U rows (U is typically a few
    dozen). `lex_weights` overrides q["lex_weights"] (the ANN branch
    threads its sequencing token through it)."""
    lw = q["lex_weights"] if lex_weights is None else lex_weights
    if "lex_cols" in index.fields:
        # sparse postings layout ([H, P] cols + weights): gather the
        # union buckets' postings and scatter-add into per-chunk scores.
        # HBM read is U*P entries; memory scales with nonzeros instead
        # of H*C (the dense layout's 1M-chunk ceiling).
        c = index.valid.shape[0]
        cols = jnp.take(index.lex_cols, q["lex_buckets"], axis=0)  # [U, P]
        wts = jnp.take(index.lex_wts, q["lex_buckets"], axis=0)  # [U, P]
        seg = jnp.where(cols >= 0, cols, c).reshape(-1)  # pads → drop bin c
        vals = lw[:, :, None] * wts[None].astype(jnp.float32)
        return jax.vmap(
            lambda v: jax.ops.segment_sum(v, seg, num_segments=c + 1)
        )(vals.reshape(vals.shape[0], -1))[:, :c]  # [B, C]
    bucket_rows = jnp.take(index.lexical, q["lex_buckets"], axis=0)  # [U, C]
    return jnp.dot(lw, bucket_rows.astype(jnp.float32),
                   preferred_element_type=jnp.float32)  # [B, C]


def dtag_raw(index: DeviceIndex, q: dict, meta_ok, tok=None) -> jnp.ndarray:
    """D-tag arm scores [B, C]: authority-ranked tag membership under
    the metadata filter. `tok` (scalar-ish) threads the ANN branch's
    sequencing token through the live branch."""
    dtag_member = _overlap(index.d_tags, q["d_bits"])  # [B, C]
    live = index.authority[None, :] + 1.0
    if tok is not None:
        live = live + tok
    return (
        jnp.where(dtag_member > 0, live, NEG_INF)
        + (1.0 - index.valid[None, :]) * NEG_INF
        + (1.0 - meta_ok) * NEG_INF
    )


def arm_scores(index: DeviceIndex, q: dict, k: int, *, penalty=None, meta_ok=None,
               strict_count=None):
    """Dense per-chunk scores for the three arms + the filter gate.
    Works on any (sub)index — the sharded path calls this per shard with
    a precomputed (global-count-aware) penalty. Returns (cos, lex_raw,
    dtag_scores, penalty, strict_count)."""
    if penalty is None:
        strict, relaxed, open_mask, meta_ok = filter_masks(index, q)
        strict_count = strict.sum(axis=1)
        penalty = gate_penalty(strict, relaxed, open_mask, q, k)

    cos = jnp.dot(
        q["vec"], index.vectors.astype(jnp.float32).T, preferred_element_type=jnp.float32
    ) * index.vec_scales[None, :]  # [B, C]; scales are 1.0 unless int8 storage
    lex_raw = lexical_raw(index, q)
    dtag_scores = dtag_raw(index, q, meta_ok)
    return cos, lex_raw, dtag_scores, penalty, strict_count


def candidate_signals(index: DeviceIndex, q: dict, cand: jnp.ndarray):
    """Per-candidate rerank signals (auth, len, jpd, cov) for candidate
    rows `cand` [B, M] of (sub)index. Pure gathers + bit math."""

    def gather(col):  # [C] → [B, M]
        return jnp.take(col, cand, axis=0)

    auth = gather(index.authority)
    lsig = gather(index.length_score)

    # jpd ≈ fraction of the query's d-tags the chunk carries (device form
    # of the reference's category-intent haystack check, :1956).
    cand_dbits = jnp.take(index.d_tags, cand, axis=0)  # [B, M, W]
    q_dbits = q["d_bits"][:, None, :]
    inter = (cand_dbits & q_dbits).astype(jnp.uint32)

    def popcount(x):
        x = x - ((x >> 1) & jnp.uint32(0x55555555))
        x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
        x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
        return (x * jnp.uint32(0x01010101)) >> 24

    jpd_hits = popcount(inter).sum(axis=-1).astype(jnp.float32)
    q_dcount = popcount(q["d_bits"]).sum(axis=-1).astype(jnp.float32)[:, None]
    jpd = jnp.where(q_dcount > 0, jnp.minimum(jpd_hits / jnp.maximum(q_dcount, 1.0), 1.0), 0.0)

    # coverage: selectivity-weighted phrase presence with binary j-tag
    # doc credit (v1.3 unified coverage). Slot bit tests run as batched
    # matmuls over the UNPACKED candidate bitsets instead of per-slot
    # take_along_axis word gathers: unpack(shift+mask) and a
    # [M, P]×[P, S] dot replace a [B, M, S] word gather. {0, 1} values
    # are exact in bf16; accumulation is f32.
    cand_pbits = jnp.take(index.phrase_bits, cand, axis=0)  # [B, M, PW]
    cand_jbits = jnp.take(index.j_tags, cand, axis=0)  # [B, M, TW]

    def unpack_bits(bits):  # [B, M, W] u32 → [B, M, W·32] bf16 {0,1}
        r = jnp.arange(32, dtype=jnp.uint32)
        x = (bits[..., None] >> r) & jnp.uint32(1)
        return x.reshape(*bits.shape[:-1], -1).astype(jnp.bfloat16)

    def slot_mask(word, bit, p):  # [B, S] → [B, S, p] bf16 one-hot
        pos = word.astype(jnp.int32) * 32 + bit.astype(jnp.int32)
        return (pos[..., None] == jnp.arange(p, dtype=jnp.int32)
                ).astype(jnp.bfloat16)

    def test_bits(bits, word, bit):  # → [B, M, S] f32 {0,1}
        up = unpack_bits(bits)
        mask = slot_mask(word, bit, up.shape[-1])
        return jnp.einsum("bmp,bsp->bms", up, mask,
                          preferred_element_type=jnp.float32)

    phrase_present = test_bits(cand_pbits, q["slot_word"], q["slot_bit"])
    jtag_present = test_bits(cand_jbits, q["slot_jword"], q["slot_jbit"])
    s_isj = q["slot_isj"][:, None, :]  # {0,1}
    s_w = q["slot_weight"][:, None, :]  # 0 for inactive slots
    present = jnp.where(s_isj > 0, jnp.maximum(jtag_present, phrase_present), phrase_present)
    cov_num = (present * s_w).sum(axis=2)  # [B, M]
    cov_den = q["slot_weight"].sum(axis=1)[:, None]
    cov = jnp.where(cov_den > 0, cov_num / jnp.maximum(cov_den, 1e-6), 0.0)
    return auth, lsig, jpd, cov


def rerank_score(sim, auth, lsig, jpd, cov, has_jpd, has_cov):
    """Reranker v1.3 weighted sum, normalized to [0, 1]."""
    w_jpd = W_JPD * has_jpd
    w_cov = W_COV * has_cov
    max_w = W_SIM + W_AUTH + W_LEN + w_jpd + w_cov
    return (
        W_SIM * sim + W_AUTH * auth + W_LEN * lsig + w_jpd * jpd + w_cov * cov
    ) / jnp.maximum(max_w, 1e-6)


# Per-candidate signal channels carried through fusion:
# cos, lex_raw, auth, len, jpd, cov.
N_SIG = 6


def _sync_ann(ann):
    """Force completion of a freshly built ANN table before returning
    it: table builds queue hundreds of async scatter steps plus multi-GB
    reshape copies, and the next dispatched program (the first search)
    otherwise executes CONCURRENTLY with that backlog, and their
    combined live set can exhaust device memory (the async-dispatch
    gotcha: the error surfaces at the next sync, not at the guilty op)."""
    leaves, _ = ann.tree_flatten()
    for leaf in leaves:
        if isinstance(leaf, jax.Array):
            jax.device_get(leaf.ravel()[:1])
            break
    return ann


def _cand_cos(index: DeviceIndex, qvec: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Per-candidate cosine via row gather [B, m, D] — used when the
    vector arm ran through an ANN backend and no dense [B, C] cosine
    matrix exists."""
    vecs = jnp.take(index.vectors, idx, axis=0).astype(jnp.float32)
    cos = jnp.einsum("bmd,bd->bm", vecs, qvec)
    return cos * jnp.take(index.vec_scales, idx, axis=0)


def arm_candidates(index: DeviceIndex, q: dict, k: int, m: int, *,
                   m_other: int | None = None, axis: str | None = None,
                   ann=None, nprobe: int = 32, approx: float = 0.0,
                   local=None, tag_level: int = 2):
    """Per-(sub)index arm scan: top-m candidates per arm + their rerank
    signals. Shared by the single-chip pipeline and the sharded per-shard
    scan — with `axis` set, the strict count psums over the mesh (so all
    shards take the same auto-relax branch) and indices offset to global.

    ``m_other`` (default m) caps the lexical/d-tag arm widths: only the
    VECTOR arm feeds the host-residency funnel, so when m is
    funnel-wide (1024) the other arms still top_k at the fusion
    over-fetch (80) — lax.top_k cost over a [B, C] score matrix grows
    with k, and at 10M rows two funnel-wide top_ks the fusion never
    reads were pure waste. Their outputs are NEG_INF/0-padded back to m
    so downstream shapes (stacking, fusion, packing) are unchanged;
    padded entries are dead under every live-mask (> NEG_INF/2).

    `ann` selects the vector-arm backend: None = exact masked matmul
    (the [B, C] cosine matrix), an index.ivf.IVFIndex = probed scan over
    the same chunk matrix, a PackedIVF = cluster-contiguous int8 blocks.
    The lexical/d-tag arms and the filter gate stay exact in every
    backend (they are the cheap arms); only the vector scan changes —
    the device analogue of swapping pgvector's seqscan for HNSW
    (vector_store.py:274-287).

    ``local`` switches the config-5 candidate-local path (query/
    gating.py): (gate_tuple, dtag_tuple) of ProjGate/DTagPostings
    arrays. NO [B, C]-sized buffer exists in that mode — the filter
    gate evaluates on the probed cluster blocks inside the probed scan,
    the lexical arm scores only its postings union, and the d-tag arm
    reads per-tag inverted postings. `tag_level` statically bounds the
    gate words read (gating.batch_tag_level). Requires a PackedProj
    ann; unsupported under `axis` (the sharded path stays dense).

    Returns (vals [3,B,m], gidx [3,B,m] i32, sigs [3,B,m,N_SIG],
    strict_total [B,1])."""
    m_oth = min(m_other or m, m)
    if local is not None:
        from mobius_rag_tpu.ops.proj import (PackedProj, encode_qmeta,
                                             proj_search_gated)
        from mobius_rag_tpu.query import gating

        assert axis is None, "candidate-local gating is single-chip"
        assert isinstance(ann, PackedProj)
        gate_t, dtag_t = local
        if "strict_total" in q:
            # host-cached per-filter-signature counts (engine
            # _strict_totals): the auto-relax branch's global count
            # depends only on (payer, state, program, inherit, j_bits,
            # generation), so repeated filters skip the corpus-wide
            # pass entirely
            strict_local = q["strict_total"]
        else:
            strict_local = gating.strict_counts(index, q)
        strict_total = strict_local[:, None]
        offset = 0
        strict_ok = strict_local >= k
        qmeta, qbits = encode_qmeta(q, strict_ok)
        vec_vals, vec_idx = proj_search_gated(
            ann, gate_t, q["vec"], qmeta, qbits, m, nprobe, approx,
            tag_level, tw=index.j_tags.shape[1])
        vec_vals = vec_vals + jnp.where(
            vec_vals < q["min_sim"][:, None], NEG_INF, 0.0)
        cos = None
        vec_vals, vec_idx, tok = jax.lax.optimization_barrier(
            (vec_vals, vec_idx, vec_vals[:1, :1] * 0.0))
        lex_vals, lex_idx, lex_best = gating.lexical_candidates_local(
            index, q, qmeta, qbits, m_oth, tag_level, tok=tok)
        lex_vals, lex_idx, lex_best, tok = jax.lax.optimization_barrier(
            (lex_vals, lex_idx, lex_best, lex_vals[:1, :1] * 0.0))
        dtag_vals, dtag_idx = gating.dtag_candidates_local(
            dtag_t, q, qmeta, m_oth, tok=tok)

        def lex_sig_of(idx_):
            return gating.lex_signal_join(idx_, lex_idx, lex_vals)
    else:
        strict, relaxed, open_mask, meta_ok = filter_masks(index, q)
        strict_local = strict.sum(axis=1)
        if axis is None:
            strict_total = strict_local[:, None]
            offset = 0
        else:
            strict_total = jax.lax.psum(strict_local, axis)[:, None]
            offset = jax.lax.axis_index(axis) * index.valid.shape[0]
        penalty = gate_penalty(strict, relaxed, open_mask, q, k, strict_total)

    if local is not None:
        pass  # arms computed above
    elif ann is None:
        cos, lex_raw, dtag_scores, _, _ = arm_scores(
            index, q, k, penalty=penalty, meta_ok=meta_ok,
            strict_count=strict_total[:, 0],
        )
        vec_scores = cos + penalty + jnp.where(
            cos < q["min_sim"][:, None], NEG_INF, 0.0)
        vec_vals, vec_idx = jax.lax.top_k(vec_scores, m)
        lex_scores = jnp.where(lex_raw > 0, lex_raw, NEG_INF) + penalty
        lex_vals, lex_idx = jax.lax.top_k(lex_scores, m_oth)
        dtag_vals, dtag_idx = jax.lax.top_k(dtag_scores, m_oth)
    else:
        from mobius_rag_tpu.index.ivf import (IVFIndex, ivf_search,
                                              ivf_search_packed)
        from mobius_rag_tpu.ops.pq import PackedPQ, pq_search_packed
        from mobius_rag_tpu.ops.proj import PackedProj, proj_search_packed

        # Vector arm FIRST (probed scan over the ANN tables; penalty is
        # its only [B, C]-sized input), then the lexical and d-tag arms
        # SEQUENCED behind it. Each arm materializes [B, C]-sized
        # transients (the segment-sum matrix + its top_k operand, the
        # d-tag score matrix) — ~1.3 GB each at 10M×32 — and XLA
        # schedules independent arms concurrently, so with multi-GB ANN
        # codes resident their combined peak adds up. A zero-valued
        # token threaded through optimization_barrier makes each arm's
        # inputs depend on the previous arm's outputs, so their
        # transients never coexist; the arms are memory-bound, so
        # serializing them should cost little.
        if isinstance(ann, IVFIndex):
            vec_vals, vec_idx = ivf_search(
                ann, index.vectors, q["vec"], penalty, m, nprobe,
                index.vec_scales)
        elif isinstance(ann, PackedProj):
            # projected-residual candidate generation (config-5 regime,
            # int8 matmuls; see ops/proj.py). Approximate scores stand in
            # for cosine on the vector arm's candidates; the exact host
            # re-rank (SearchEngine._host_rerank) repairs ranking inside
            # the funnel.
            vec_vals, vec_idx = proj_search_packed(
                ann, q["vec"], penalty, m, nprobe, approx)
        elif isinstance(ann, PackedPQ):
            # ADC candidate generation (config-5 regime); the signal
            # gather below re-scores candidates with EXACT cosine, so
            # fusion/rerank see true similarities — two-stage IVFADC in
            # one compiled program
            vec_vals, vec_idx = pq_search_packed(
                ann, q["vec"], penalty, m, nprobe)
        else:
            vec_vals, vec_idx = ivf_search_packed(
                ann, q["vec"], penalty, m, nprobe)
        # min_sim post-filter: for eligible rows the returned value IS
        # the cosine (penalty contributes 0); gated rows are already -inf
        vec_vals = vec_vals + jnp.where(
            vec_vals < q["min_sim"][:, None], NEG_INF, 0.0)
        cos = None  # no dense cosine matrix in ANN mode
        vec_vals, vec_idx, tok = jax.lax.optimization_barrier(
            (vec_vals, vec_idx, vec_vals[:1, :1] * 0.0))

        # lexical arm (arm_scores would recompute the dense cosine
        # matmul this branch exists to avoid), gated on the vector arm's
        # token via its query-weight input
        lex_raw = lexical_raw(index, q, lex_weights=q["lex_weights"] + tok)
        lex_scores = jnp.where(lex_raw > 0, lex_raw, NEG_INF) + penalty
        lex_vals, lex_idx = jax.lax.top_k(lex_scores, m_oth)
        # lex_raw passes the barrier too: the signal gathers below read
        # it, so it stays live (ONE [B, C] buffer) through the d-tag arm
        lex_vals, lex_idx, lex_raw, tok = jax.lax.optimization_barrier(
            (lex_vals, lex_idx, lex_raw, lex_vals[:1, :1] * 0.0))

        # d-tag arm, gated on the lexical arm's token
        dtag_scores = dtag_raw(index, q, meta_ok, tok=tok)
        dtag_vals, dtag_idx = jax.lax.top_k(dtag_scores, m_oth)

    if local is None:
        def lex_sig_of(idx_):
            return jnp.take_along_axis(lex_raw, idx_, axis=1)

    # No dense payload in HBM (host residency): the exact-cosine signal
    # gather is impossible device-side. The vector arm's ADC value (=
    # approx cosine for eligible rows) stands in for its candidates;
    # lex/dtag candidates carry 0 — the POST-FUSION host re-rank
    # (SearchEngine._host_rerank) recomputes exact cosine for every
    # fused candidate from the host int8 matrix before assembly.
    have_dense = index.vectors.shape[0] == index.valid.shape[0]
    out_vals, out_gidx, out_sigs = [], [], []
    for arm_i, (vals, idx) in enumerate(
            ((vec_vals, vec_idx), (lex_vals, lex_idx), (dtag_vals, dtag_idx))):
        auth, lsig, jpd, cov = candidate_signals(index, q, idx)
        if cos is not None:
            cand_cos = jnp.take_along_axis(cos, idx, axis=1)
        elif have_dense:
            cand_cos = _cand_cos(index, q["vec"], idx)
        elif arm_i == 0:
            cand_cos = jnp.clip(vals, 0.0, 1.0)  # ADC ≈ cosine
        else:
            cand_cos = jnp.zeros_like(vals)
        sig = jnp.stack(
            [cand_cos, lex_sig_of(idx), auth, lsig, jpd, cov],
            axis=-1,
        )  # [B, m, N_SIG]
        pad = m - vals.shape[1]
        if pad:  # lex/dtag arms ran at m_other < m: dead-pad back to m
            b = vals.shape[0]
            vals = jnp.concatenate(
                [vals, jnp.full((b, pad), NEG_INF, vals.dtype)], axis=1)
            idx = jnp.concatenate(
                [idx, jnp.zeros((b, pad), idx.dtype)], axis=1)
            sig = jnp.concatenate(
                [sig, jnp.zeros((b, pad, sig.shape[-1]), sig.dtype)], axis=1)
        out_vals.append(vals)
        out_gidx.append(idx + offset)
        out_sigs.append(sig)
    return (
        jnp.stack(out_vals),  # [3, B, m]
        jnp.stack(out_gidx).astype(jnp.int32),
        jnp.stack(out_sigs),
        strict_total,
    )


def fuse_and_rerank(vals, gidx, sigs, q, k: int, rrf_k: int, m_global: int):
    """RRF + rerank over the UNION of per-arm candidate lists — no dense
    [B, C] score buffer (the candidate union is ≤ 3·m_global ids, so
    duplicate-summing is a tiny [B, 3r, 3r] pairwise match; at 1M chunks
    a [B, C] RRF scatter was 128 MB/query-batch of peak HBM for scores
    the fusion never reads). vals/gidx [3, S, B, m], sigs
    [3, S, B, m, N_SIG]; S=1 for the single-chip pipeline, S=shards for
    the all-gathered merge (identical math ⇒ sharded ≡ dense results).

    m_global caps each arm's global candidate list to the single-chip
    over-fetch so RRF contributions are identical in both regimes."""
    n_arms, s, b, m = vals.shape
    r = min(m_global, m * s)

    # per-arm global re-sort
    arm_vals = vals.transpose(0, 2, 1, 3).reshape(n_arms, b, s * m)
    arm_gidx = gidx.transpose(0, 2, 1, 3).reshape(n_arms, b, s * m)
    arm_sigs = sigs.transpose(0, 2, 1, 3, 4).reshape(n_arms, b, s * m, N_SIG)

    cand_parts, contrib_parts, sig_parts = [], [], []
    for a in range(n_arms):
        g_vals, pos = jax.lax.top_k(arm_vals[a], r)  # [B, r]
        g_idx = jnp.take_along_axis(arm_gidx[a], pos, axis=1)
        g_sig = jnp.take_along_axis(
            arm_sigs[a], pos[..., None].repeat(N_SIG, -1), axis=1
        )
        live = (g_vals > NEG_INF / 2).astype(jnp.float32)
        ranks = jnp.arange(r, dtype=jnp.float32)[None, :]
        w = q["arm_weights"][:, a : a + 1]
        contrib = live * w / (rrf_k + ranks + 1.0)
        # dead candidates must never match a real id
        cand_parts.append(jnp.where(live > 0, g_idx, -1 - a * r - ranks.astype(jnp.int32)))
        contrib_parts.append(contrib)
        sig_parts.append(g_sig)

    u_idx = jnp.concatenate(cand_parts, axis=1)  # [B, 3r]
    u_contrib = jnp.concatenate(contrib_parts, axis=1)
    u_sig = jnp.concatenate(sig_parts, axis=1)  # [B, 3r, N_SIG]
    u_live = (u_contrib > 0).astype(jnp.float32)

    # pairwise duplicate handling
    eq = (u_idx[:, :, None] == u_idx[:, None, :]).astype(jnp.float32)  # [B,3r,3r]
    rrf_sum = jnp.einsum("bij,bj->bi", eq, u_contrib)
    first = jnp.argmax(eq, axis=2)  # first occurrence index of each id
    is_first = (first == jnp.arange(u_idx.shape[1])[None, :]).astype(jnp.float32)
    fused = jnp.where((is_first * u_live) > 0, rrf_sum, NEG_INF)

    # Rerank the same fused-candidate count the RRF over-fetch defines.
    n_keep = min(m_global, fused.shape[1])
    cand_rrf, pos = jax.lax.top_k(fused, n_keep)
    cand_idx = jnp.take_along_axis(u_idx, pos, axis=1)
    cand_sig = jnp.take_along_axis(u_sig, pos[..., None].repeat(N_SIG, -1), axis=1)

    cos_c, lex_c = cand_sig[..., 0], cand_sig[..., 1]
    auth_c, len_c = cand_sig[..., 2], cand_sig[..., 3]
    jpd_c, cov_c = cand_sig[..., 4], cand_sig[..., 5]
    # lexical normalizer = best LIVE (gate-passing) lexical score
    lex_best = jnp.max(jnp.where(arm_vals[1] > NEG_INF / 2, arm_vals[1], 0.0), axis=1)
    lexn = jnp.clip(lex_c / jnp.maximum(lex_best[:, None], 1e-6), 0.0, 1.0)
    sim = jnp.clip(jnp.maximum(cos_c, lexn), 0.0, 1.0)

    has_jpd = (q["d_bits"].sum(axis=1) > 0).astype(jnp.float32)[:, None]
    has_cov = (q["slot_weight"].sum(axis=1) > 0).astype(jnp.float32)[:, None]
    rerank = rerank_score(sim, auth_c, len_c, jpd_c, cov_c, has_jpd, has_cov)
    rerank = jnp.where(cand_rrf > NEG_INF / 2, rerank, NEG_INF)

    top_vals, tpos = jax.lax.top_k(rerank, k)
    take = lambda x: jnp.take_along_axis(x, tpos, axis=1)
    return {
        "idx": take(cand_idx),
        "rerank": top_vals,
        "sim": take(sim),
        "cos": take(cos_c),
        "auth": take(auth_c),
        "len": take(len_c),
        "jpd": take(jpd_c),
        "cov": take(cov_c),
        "rrf": take(cand_rrf),
        # normalized lexical sim component, kept separate so a host
        # re-rank can rebuild sim = max(exact_cos, lexn) without the
        # device's (possibly approximate) cosine baked in
        "lexn": take(lexn),
    }


@functools.partial(jax.jit, static_argnames=("k", "over_fetch", "rrf_k",
                                             "nprobe", "funnel", "approx",
                                             "tag_level"))
def _search_compiled(
    index: DeviceIndex,
    q: dict,
    k: int,
    over_fetch: int,
    rrf_k: int,
    ann=None,
    nprobe: int = 32,
    funnel: int = 0,
    approx: float = 0.0,
    local=None,
    tag_level: int = 2,
):
    """One XLA program: all arms, fusion, rerank. q holds per-query arrays
    (see prepare_query for the schema). Fusion runs over the candidate
    UNION (fuse_and_rerank) — peak HBM is the arm scores themselves, not
    a [B, C] RRF buffer, which is what lets the full hybrid pipeline run
    at 1M chunks on one chip. `ann` switches the vector arm to a probed
    IVF/packed scan (MRAG_VECTOR_BACKEND).

    ``funnel`` > 0 (host residency): the vector arm widens to top-funnel
    and its candidate list + rerank signals ride the packed outputs, so
    the exact host re-rank reorders a funnel-wide pool instead of the
    fused top-k — at 10M rows the approximate vector scores' error band
    covers ~10x more competitors than at 1M, and recall is funnel-bound."""
    c = index.valid.shape[0]
    # Under a funnel (host residency) `k` arrives ALREADY over-fetched
    # (k = user_k·over_fetch, _device_k) — the exact host re-rank
    # reorders that fused pool plus the funnel-wide vector list, so the
    # per-arm fusion pool is k itself. Compounding over_fetch again here
    # (k·of = 64× the user k) would put the lex/d-tag arms' lax.top_k
    # at width 640 over [B, C].
    # (2·k, not k: the per-arm telemetry outputs below slice [:, :k·2]
    # and the pack/unpack schema assumes those widths are exact.)
    m_fuse = min(2 * k if funnel else k * over_fetch, c)
    w = min(funnel, c)
    m = max(m_fuse, w)

    # Queries arrive bf16 over the wire (see prepare_batch); widen once
    # on device so every downstream consumer sees f32.
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    vals, gidx, sigs, strict_total = arm_candidates(
        index, q, k, m, m_other=m_fuse, ann=ann, nprobe=nprobe,
        approx=approx, local=local, tag_level=tag_level)
    # Materialize the arm outputs ONCE. They have two consumers (the
    # fusion path and the raw per-arm telemetry outputs below), and
    # without the barrier XLA may rematerialize the full [B, C] arm
    # scan once per consumer.
    vals, gidx, sigs, strict_total = jax.lax.optimization_barrier(
        (vals, gidx, sigs, strict_total))
    out = fuse_and_rerank(vals[:, None], gidx[:, None], sigs[:, None],
                          q, k, rrf_k, m_fuse)
    out.update({
        "vec_idx": gidx[0][:, : k * 2],
        "vec_vals": vals[0][:, : k * 2],
        "lex_idx": gidx[1][:, : k * 2],
        "lex_vals": vals[1][:, : k * 2],
        "dtag_idx": gidx[2][:, : k * 2],
        "dtag_vals": vals[2][:, : k * 2],
        "strict_count": strict_total[:, 0],
    })
    if w:
        out.update(wide_outputs(vals, gidx, sigs, w))
    # Pack the ~16 output arrays into TWO (one f32, one i32): every
    # device→host fetch pays a fixed per-transfer cost, and 16 small
    # arrays × N pipelined batches multiply it. Whether that cost
    # matters on a GPU host is not measured (ROADMAP 3.1).
    return pack_out(out, k, w)


def wide_outputs(vals, gidx, sigs, w: int) -> dict:
    """The funnel block: vector-arm top-w ids + the host re-rank's
    signal inputs (everything _host_rerank needs except the exact
    cosine it recomputes itself). vals/gidx [3, B, m], sigs
    [3, B, m, N_SIG]; the vector arm's lists are already sorted by its
    (approximate) score, so the top-w slice IS the funnel."""
    lex_best = jnp.max(jnp.where(vals[1] > NEG_INF / 2, vals[1], 0.0),
                       axis=1)
    wsig = sigs[0][:, :w]
    return {
        "wide_vals": vals[0][:, :w],
        "wide_lexn": jnp.clip(
            wsig[..., 1] / jnp.maximum(lex_best[:, None], 1e-6), 0.0, 1.0),
        "wide_auth": wsig[..., 2],
        "wide_len": wsig[..., 3],
        "wide_jpd": wsig[..., 4],
        "wide_cov": wsig[..., 5],
        "wide_idx": gidx[0][:, :w],
    }


# Output packing layout: (key, width-multiplier-of-k) per dtype class.
# strict_count rides the int pack as an extra column.
_OUT_F = (("rerank", 1), ("sim", 1), ("cos", 1), ("auth", 1), ("len", 1),
          ("jpd", 1), ("cov", 1), ("rrf", 1), ("lexn", 1),
          ("vec_vals", 2), ("lex_vals", 2), ("dtag_vals", 2))
_OUT_I = (("idx", 1), ("vec_idx", 2), ("lex_idx", 2), ("dtag_idx", 2))

# Funnel block appended when wide outputs ride along (width = funnel,
# not a multiple of k — see pack_out's w argument).
_WIDE_F = ("wide_vals", "wide_lexn", "wide_auth", "wide_len", "wide_jpd",
           "wide_cov")


def _pack_wide(out: dict):
    """Funnel signal block → bf16 pairs bitcast into f32 columns: the
    6·w wide floats dominate the device→host payload (6·1024·B·4 B ≈
    786 KB/batch32 at funnel 1024; bf16 halves it), and bf16 keeps ~3
    significant digits, enough for every consumer: the host re-rank
    recomputes exact cosine itself and uses these only as [0,1] blend
    signals (wide_vals only as a liveness mask; -1e30 stays
    < NEG_INF/2 in bf16)."""
    wf = jnp.concatenate([out[key] for key in _WIDE_F],
                         axis=1).astype(jnp.bfloat16)
    u16 = jax.lax.bitcast_convert_type(wf, jnp.uint16).astype(jnp.uint32)
    u32 = u16[:, 0::2] | (u16[:, 1::2] << 16)
    return jax.lax.bitcast_convert_type(u32, jnp.float32)  # [B, 3·w]


def _unpack_wide(block: np.ndarray, w: int) -> dict[str, np.ndarray]:
    """Host inverse of _pack_wide: [B, 3·w] f32 → the 6 wide_* arrays
    as f32."""
    u32 = np.ascontiguousarray(block).view(np.uint32)
    u16 = np.empty((u32.shape[0], u32.shape[1] * 2), np.uint16)
    u16[0:, 0::2] = (u32 & np.uint32(0xFFFF)).astype(np.uint16)
    u16[0:, 1::2] = (u32 >> np.uint32(16)).astype(np.uint16)
    flat = u16.view(ml_dtypes.bfloat16).astype(np.float32)  # [B, 6·w]
    return {key: flat[:, i * w:(i + 1) * w]
            for i, key in enumerate(_WIDE_F)}


def pack_out(out: dict, k: int, w: int = 0):
    packed_f = jnp.concatenate(
        [out[key] for key, _ in _OUT_F]
        + ([_pack_wide(out)] if w else []), axis=1)
    packed_i = jnp.concatenate(
        [out[key] for key, _ in _OUT_I]
        + [out["strict_count"][:, None].astype(jnp.int32)]
        + ([out["wide_idx"]] if w else []), axis=1)
    return packed_f, packed_i


def unpack_out(fetched, k: int, w: int = 0) -> dict[str, np.ndarray]:
    """Host-side inverse of pack_out: numpy views into the two fetched
    arrays, under the original key schema."""
    packed_f, packed_i = (np.asarray(fetched[0]), np.asarray(fetched[1]))
    out: dict[str, np.ndarray] = {}
    off = 0
    for key, mult in _OUT_F:
        out[key] = packed_f[:, off:off + mult * k]
        off += mult * k
    if w:
        out.update(_unpack_wide(packed_f[:, off:off + 3 * w], w))
    off = 0
    for key, mult in _OUT_I:
        out[key] = packed_i[:, off:off + mult * k]
        off += mult * k
    out["strict_count"] = packed_i[:, off]
    off += 1
    if w:
        out["wide_idx"] = packed_i[:, off:off + w]
    return out


# The sharded merge returns only the fused schema (no per-arm traces):
# the 9 single-width float signals of fuse_and_rerank plus idx.
_FUSED_F = _OUT_F[:9]


def pack_fused(out: dict, k: int, w: int = 0):
    """Pack fuse_and_rerank's dict into TWO arrays (f32 signals, i32
    idx) so a sharded query costs two device→host fetches instead of
    ten (see pack_out).
    With ``w``, the funnel block (wide_* keys) rides the same two
    arrays."""
    del k  # symmetry with pack_out; widths are implied by the schema
    packed_f = jnp.concatenate(
        [out[key] for key, _ in _FUSED_F]
        + ([_pack_wide(out)] if w else []), axis=1)
    idx = (jnp.concatenate([out["idx"], out["wide_idx"]], axis=1)
           if w else out["idx"])
    return packed_f, idx


def unpack_fused(fetched, k: int, w: int = 0) -> dict[str, np.ndarray]:
    """Host-side inverse of pack_fused."""
    packed_f, idx = np.asarray(fetched[0]), np.asarray(fetched[1])
    out = {key: packed_f[:, i * k:(i + 1) * k]
           for i, (key, _) in enumerate(_FUSED_F)}
    if w:
        off = len(_FUSED_F) * k
        out.update(_unpack_wide(packed_f[:, off:off + 3 * w], w))
        out["idx"] = idx[:, :k]
        out["wide_idx"] = idx[:, k:]
    else:
        out["idx"] = idx
    return out


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

class SearchEngine:
    """Host-side handle: prepares query arrays, invokes the compiled
    pipeline, materializes results + telemetry."""

    def __init__(self, store: ChunkStore, lexicon: Lexicon | None = None,
                 cfg: Config | None = None, embed_fn=None, telemetry=None,
                 sharded=None, vector_backend: str | None = None):
        # First-engine-in-process wins the race to point XLA's persistent
        # compilation cache at disk (idempotent; MRAG_JIT_CACHE=0 opts out).
        # On the 1-vCPU serving hosts the wide fused programs take minutes
        # to compile — restarts must be cache hits, not recompiles.
        jit_cache.enable_persistent_cache()
        self.store = store
        self.lexicon = lexicon
        self.cfg = cfg or get_config()
        self.embed_fn = embed_fn  # (list[str]) -> np.ndarray [B, D]
        self.telemetry = telemetry  # observability.TelemetryStore | None
        # Vector-arm backend: exact | ivf | packed (Config.vector_backend).
        # ANN tables build lazily on first search and rebuild when the
        # store's write generation moves (publish/delete invalidates the
        # cluster assignment).
        self.vector_backend = vector_backend or self.cfg.vector_backend
        self._ann = None
        self._ann_generation = -1
        # Incremental ANN maintenance (proj backend): store mutations
        # queue here and _try_ann_incremental applies them as device
        # scatters into reserved slabs instead of re-running the k-means
        # build (host k-means over every row, with buffers that compete
        # with serving). bulk rewrites force the full rebuild.
        self._ann_events: list[tuple[str, list[int]]] = []
        self._ann_stale_hard = False
        self._ann_slot_of_row: np.ndarray | None = None  # row → flat slot
        self._ann_cursor = 0  # next free flat slot in the reserved region
        # Candidate-local gating structures (query/gating.py): the
        # cluster-layout eligibility pack + per-tag inverted postings.
        # Built alongside the proj ANN when the local regime is active;
        # the d-tag postings rebuild lazily when TAGGED rows mutate
        # (untagged streaming inserts — the common republish shape —
        # cost nothing).
        self._ann_gate = None
        self._dtag_postings = None
        self._dtag_stale = False
        # host strict-count cache (filter signature → global count)
        self._strict_cache: "OrderedDict[tuple, float]" = OrderedDict()
        self._strict_jit = None
        store.listeners.append(self._on_store_mutation)
        # parallel.ShardedEngine over the SAME store: when attached, the
        # compiled stage runs sharded over the mesh and the whole host
        # stack (agent, strategies, API) serves multi-chip transparently.
        # The vector backend propagates INTO the sharded engine (it
        # builds per-shard ANN tables) — round 2 silently served exact
        # when a mesh was attached with MRAG_VECTOR_BACKEND=ivf.
        self.sharded = sharded
        if sharded is not None:
            if vector_backend is not None:
                sharded.set_vector_backend(vector_backend)
            else:  # inherit the sharded engine's configured backend
                self.vector_backend = sharded.vector_backend
        # optional models.cross_encoder.CrossEncoderModel: jointly rescores
        # the hybrid top-k as a final stage (beyond the reference's linear
        # signal blend)
        self.cross_encoder = None
        # query-embedding LRU (corpus_search.py:434-443: the reference's
        # dominant cold-latency source was re-embedding repeated queries;
        # with an on-chip encoder it's cheaper but still worth skipping)
        self._embed_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._embed_cache_max = 256
        # prepared-query LRU: prepare_query is a pure function of the
        # request's string fields given a fixed (store stats, lexicon)
        # state, so repeated queries skip expansion/tokenization/IDF
        # entirely (the serving analogue of the reference's lexicon TTL
        # cache + embed LRU). Invalidated by store writes (generation)
        # and lexicon growth (phrase count) via the cache token.
        self._prep_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._prep_cache_max = 1024

    # -- vector-arm backend -------------------------------------------------

    def set_vector_backend(self, backend: str) -> None:
        if backend not in ("exact", "ivf", "packed", "pq", "proj"):
            raise ValueError(
                f"backend {backend!r} must be exact|ivf|packed|pq|proj")
        if backend != self.vector_backend:
            self.vector_backend = backend
            self._ann = None
            self._ann_generation = -1
            self._reset_ann_incremental()
        if self.sharded is not None:
            self.sharded.set_vector_backend(backend)

    def _on_store_mutation(self, event: str, rows: list[int]) -> None:
        """ChunkStore listener: queue row-level mutations for the
        incremental ANN path. With no ANN built there is nothing to
        patch (the first ensure_ann indexes the current state).
        D-tag postings staleness is decided HERE (records for deleted
        rows are gone by the time the queue drains): any mutated row
        that carries d-tags — or whose record can't be checked —
        forces a lazy postings rebuild."""
        if self._dtag_postings is not None and not self._dtag_stale \
                and event in ("add", "delete", "bulk"):
            for r in rows or [None]:
                rec = self.store.record(r) if r is not None else None
                if rec is None or rec.d_tags:
                    self._dtag_stale = True
                    break
        if self._ann is None:
            return
        if event in ("add", "delete") and rows:
            self._ann_events.append((event, rows))
        elif event == "grow":
            pass  # capacity move: row ids unchanged, ANN is a separate pytree
        else:  # "bulk" and anything unknown: whole-corpus rewrite
            self._ann_stale_hard = True

    def _reset_ann_incremental(self) -> None:
        self._ann_events.clear()
        self._ann_stale_hard = False
        self._ann_slot_of_row = None
        self._ann_cursor = 0
        self._ann_gate = None
        self._dtag_postings = None
        self._dtag_stale = False

    # -- candidate-local gating ([B, C]-free config-5 path) -----------------

    def _local_gating_active(self) -> bool:
        """MRAG_GATING: "local" forces, "dense" disables, "auto" =
        proj backend + host vector residency (the 10M regime whose
        [B, C] buffers the local path exists to eliminate)."""
        mode = self.cfg.gating
        if mode == "dense" or self.sharded is not None:
            return False
        if self.vector_backend != "proj":
            return False
        if mode == "local":
            return True
        return self.store.host_vectors is not None

    def _ensure_local_structs(self, ann):
        """Build/refresh the ProjGate + DTagPostings for the current
        ann tables. Returns the `local` tuple for arm_candidates, or
        None when local gating is off."""
        from mobius_rag_tpu.ops.proj import PackedProj, ProjGate
        from mobius_rag_tpu.query.gating import DTagPostings

        if not self._local_gating_active() or not isinstance(ann, PackedProj):
            return None
        if self._ann_gate is None:
            self._ann_gate = ProjGate.build(ann, self.store.index)
        if self._dtag_postings is None or self._dtag_stale:
            self._dtag_postings = DTagPostings.build(
                self.store.index, self.cfg.dtag_postings)
            self._dtag_stale = False
        return (self._ann_gate.words, self._dtag_postings.as_tuple())

    @staticmethod
    def _batch_tag_level(exps) -> int:
        """Static gate width for a prepared batch (see
        gating.batch_tag_level): over-approximates from the lexicon
        expansions, which is safe (extra words DMA'd, same gate)."""
        if any(exp.tag_ids["d"] or exp.tag_ids["p"] for exp in exps):
            return 2
        return 1 if any(exp.tag_ids["j"] for exp in exps) else 0

    def _try_ann_incremental(self) -> bool:
        """Apply queued adds/deletes to the live PackedProj tables as
        in-place device scatters (donated buffers). Adds encode into the
        reserved always-probed slabs (zero centroid — the code is the
        projected row itself; the exact host/signal re-rank repairs
        ranking as for every other candidate). Returns False when the
        tables can't absorb the mutations (no reserved headroom left,
        bulk rewrite, non-proj backend) — the caller falls back to the
        full rebuild."""
        from mobius_rag_tpu.ops.proj import (PackedProj, encode_reserved,
                                             invalidate_slots, scatter_slots)

        ann = self._ann
        if (self._ann_stale_hard or not isinstance(ann, PackedProj)
                or getattr(ann, "build_rowids", None) is None
                or getattr(ann, "reserve_start", ann.nlist) >= ann.nlist):
            return False
        events, self._ann_events = self._ann_events, []
        if not events:
            # generation moved without row mutations (e.g. pure grow)
            return True
        pad = ann.pad
        res_base = ann.reserve_start * pad
        res_cap = (ann.nlist - ann.reserve_start) * pad
        if self._ann_slot_of_row is None:
            flat_rows = ann.build_rowids.reshape(-1)
            flat_ok = ann.build_valid.reshape(-1) > 0
            slot_of = np.full(self.store.capacity, -1, np.int64)
            slot_of[flat_rows[flat_ok]] = np.flatnonzero(flat_ok)
            self._ann_slot_of_row = slot_of
            self._ann_cursor = int(
                flat_ok[res_base:res_base + res_cap].sum())
        slot_of = self._ann_slot_of_row
        if len(slot_of) < self.store.capacity:  # store grew since the map
            grown = np.full(self.store.capacity, -1, np.int64)
            grown[: len(slot_of)] = slot_of
            slot_of = self._ann_slot_of_row = grown

        # Host pass first: replay events in order against the row→slot
        # map, then reconcile to FINAL slot states (a row added and then
        # deleted inside one batch must not resurrect). A capacity
        # bail-out drops the (mid-mutation) map and leaves the device
        # tables untouched for the rebuild path.
        freed: list[int] = []
        placed: list[tuple[int, int]] = []  # (row, fresh reserved slot)
        cursor = self._ann_cursor
        for event, rows in events:
            for r in rows:
                old = int(slot_of[r]) if r < len(slot_of) else -1
                if old >= 0:
                    freed.append(old)
                    slot_of[r] = -1
                if event == "add":
                    if cursor >= res_cap:
                        self._ann_slot_of_row = None
                        return False
                    s = res_base + cursor
                    cursor += 1
                    placed.append((r, s))
                    slot_of[r] = s
        self._ann_cursor = cursor
        add_final = [(r, s) for r, s in placed if slot_of[r] == s]
        live_slots = {s for _, s in add_final}
        del_slots = sorted({s for s in freed if s not in live_slots})
        add_rows = [r for r, _ in add_final]
        add_slots = [s for _, s in add_final]
        fv = ann.build_valid.reshape(-1)
        fr = ann.build_rowids.reshape(-1)
        if del_slots:
            fv[np.asarray(del_slots, np.int64)] = 0.0
        if add_rows:
            ar = np.asarray(add_rows, np.int64)
            asl = np.asarray(add_slots, np.int64)
            fr[asl] = ar
            fv[asl] = 1.0

        # Device pass: fixed-size blocks (pads repeat the last entry →
        # ONE compiled scatter program per block size).
        BLK = 256
        index = self.store.index

        def blocks(arr: np.ndarray):
            n = len(arr)
            for off in range(0, n, BLK):
                blk = arr[off:off + BLK]
                if len(blk) < BLK:
                    blk = np.concatenate(
                        [blk, np.repeat(blk[-1:], BLK - len(blk), axis=0)])
                yield blk

        for blk in blocks(np.asarray(del_slots, np.int64)) if del_slots else ():
            cells = jnp.asarray(blk // pad, jnp.int32)
            slots = jnp.asarray(blk % pad, jnp.int32)
            ann.valid = invalidate_slots(ann.valid, cells, slots)
            if self._ann_gate is not None:
                self._ann_gate.invalidate(cells, slots)
        if add_rows:
            from mobius_rag_tpu.ops.proj import ProjGate

            for rblk, sblk in zip(blocks(np.asarray(add_rows, np.int64)),
                                  blocks(np.asarray(add_slots, np.int64))):
                if self.store.host_vectors is not None:
                    x = (self.store.host_vectors[rblk].astype(np.float32)
                         * self.store.host_scales[rblk][:, None])
                    xdev = jnp.asarray(x)
                else:
                    ridx = jnp.asarray(rblk)
                    xdev = jnp.take(index.vectors, ridx, axis=0).astype(
                        jnp.float32)
                    if self.cfg.vector_dtype == "int8":
                        xdev = xdev * jnp.take(index.vec_scales, ridx)[:, None]
                codes, scales = encode_reserved(ann.proj, xdev)
                cells = jnp.asarray(sblk // pad, jnp.int32)
                slots = jnp.asarray(sblk % pad, jnp.int32)
                (ann.codes, ann.scales, ann.valid, ann.rowids) = scatter_slots(
                    ann.codes, ann.scales, ann.valid, ann.rowids,
                    cells, slots, codes, scales,
                    jnp.ones((BLK,), jnp.float32),
                    jnp.asarray(rblk, jnp.int32))
                if self._ann_gate is not None:
                    packed = ProjGate.pack_rows(index, jnp.asarray(rblk))
                    self._ann_gate.scatter(
                        cells, slots, packed, scales,
                        jnp.asarray(rblk, jnp.int32))
        return True

    def ensure_ann(self):
        """Build (or rebuild after store mutations) the ANN tables for
        the configured backend. Returns None for exact. When tables
        exist and the store moved, the incremental path
        (_try_ann_incremental) absorbs row-level mutations in place;
        only bulk rewrites / exhausted insert headroom re-run the
        k-means build."""
        if self.vector_backend == "exact":
            return None
        if self._ann is not None and self._ann_generation == self.store.generation:
            return self._ann
        if self._ann is not None and self._try_ann_incremental():
            self._ann_generation = self.store.generation
            return _sync_ann(self._ann)
        self._reset_ann_incremental()
        from mobius_rag_tpu.index.ivf import IVFIndex, PackedIVF

        cfg = self.cfg
        index = self.store.index
        if self.store.host_vectors is not None:
            # codes-only regime: cluster + encode from the HOST matrix.
            # "proj" builds projected-residual codes (int8 matmul scan);
            # any other backend builds residual PQ.
            valid_np = np.asarray(jax.device_get(index.valid))
            ivf = IVFIndex.build_host(
                self.store.host_vectors, self.store.host_scales, valid_np,
                nlist=cfg.ivf_nlist or None)
            if self.vector_backend == "proj":
                from mobius_rag_tpu.ops.proj import PackedProj

                self._ann = PackedProj.from_ivf(
                    ivf, self.store.host_vectors, p=cfg.proj_p,
                    row_scales=self.store.host_scales,
                    reserve_slabs=cfg.ann_reserve_slabs)
            else:
                from mobius_rag_tpu.ops.pq import PackedPQ, effective_m

                self._ann = PackedPQ.from_ivf(
                    ivf, self.store.host_vectors,
                    m=effective_m(cfg.embed_dim, cfg.pq_m),
                    row_scales=self.store.host_scales)
            self._ann_generation = self.store.generation
            self._ann_nprobe = None
            return _sync_ann(self._ann)
        ivf = IVFIndex.build(
            index.vectors, np.asarray(index.valid),
            nlist=cfg.ivf_nlist or None)
        scales = (index.vec_scales if cfg.vector_dtype == "int8" else None)
        if self.vector_backend == "packed":
            self._ann = PackedIVF.from_ivf(ivf, index.vectors,
                                           row_scales=scales)
        elif self.vector_backend == "pq":
            from mobius_rag_tpu.ops.pq import PackedPQ, effective_m

            self._ann = PackedPQ.from_ivf(
                ivf, index.vectors, m=effective_m(cfg.embed_dim, cfg.pq_m),
                row_scales=scales)
        elif self.vector_backend == "proj":
            from mobius_rag_tpu.ops.proj import PackedProj

            self._ann = PackedProj.from_ivf(
                ivf, index.vectors, p=cfg.proj_p, row_scales=scales,
                reserve_slabs=cfg.ann_reserve_slabs)
        else:
            self._ann = ivf
        self._ann_generation = self.store.generation
        self._ann_nprobe = None
        if cfg.ivf_target_recall > 0 and self.vector_backend not in (
                "pq", "proj"):
            self._calibrate_nprobe(cfg.ivf_target_recall)
        return _sync_ann(self._ann)

    def save_ann(self, path: str) -> dict:
        """Persist the built ANN tables next to a store snapshot (the
        reference's HNSW lives durably in Postgres — restarts never
        re-run the index build; see index/ann_io.py). Returns the meta
        header written."""
        from mobius_rag_tpu.index.ann_io import save_ann as _save

        ann = self.ensure_ann()
        if ann is None:
            raise ValueError("exact backend has no ANN tables to save")
        meta = {"backend": self.vector_backend,
                "rows": len(self.store.records),
                "dim": self.cfg.embed_dim,
                "nprobe": self._ann_nprobe}
        _save(ann, path, meta=meta)
        return meta

    def load_ann(self, path: str) -> dict:
        """Adopt persisted ANN tables for the CURRENT store (written by
        save_ann against the matching snapshot). Refuses on backend or
        row-count mismatch — a stale ann file must never serve rows that
        no longer exist."""
        from mobius_rag_tpu.index.ann_io import load_ann as _load

        ann, meta = _load(path)
        if meta.get("backend") != self.vector_backend:
            raise ValueError(
                f"ann file is for backend {meta.get('backend')!r}, "
                f"engine serves {self.vector_backend!r}")
        if meta.get("rows") != len(self.store.records):
            raise ValueError(
                f"ann file indexed {meta.get('rows')} rows, store has "
                f"{len(self.store.records)} — snapshot/ann pairing broken")
        self._ann = ann
        self._ann_generation = self.store.generation
        self._ann_nprobe = meta.get("nprobe")
        self._reset_ann_incremental()
        return meta

    def _logged_query_vectors(self, want: int) -> np.ndarray | None:
        """Embed up to `want` recent distinct PRODUCTION queries from the
        telemetry log (search_events) for the calibration sample, so
        auto-nprobe tunes on the distribution actually being served, not
        only on perturbed corpus rows. Returns None when no telemetry /
        embedder is attached or the log is empty (fresh deployments)."""
        if self.telemetry is None or self.embed_fn is None or want <= 0:
            return None
        try:
            events = self.telemetry.recent_search_events(limit=max(200, want * 4))
        except Exception:
            return None
        seen: set[str] = set()
        texts: list[str] = []
        for ev in events:
            qt = (ev.get("query") or "").strip()
            if qt and qt.lower() not in seen:
                seen.add(qt.lower())
                texts.append(qt)
            if len(texts) >= want:
                break
        if not texts:
            return None
        return self._embeddings([QueryRequest(query=t) for t in texts])

    def _calibrate_nprobe(self, target: float, sample: int = 32) -> dict:
        """Per-corpus auto-nprobe. The calibration sample mixes recent
        logged production queries (when a telemetry store is attached —
        the distribution that actually hits the index) with self-queries
        (live rows + small perturbation — the corpus's own embedding
        geometry), so fresh deployments still calibrate sensibly."""
        import jax as _jax
        import jax.numpy as _jnp

        from mobius_rag_tpu.index.ivf import calibrate_nprobe

        index = self.store.index
        valid = np.asarray(jax.device_get(index.valid)) > 0
        live = np.flatnonzero(valid)
        if len(live) == 0:
            return {}
        logged = self._logged_query_vectors(sample // 2)
        n_logged = 0 if logged is None else len(logged)
        n_self = max(sample - n_logged, 1)
        rng = np.random.default_rng(0)
        rows = rng.choice(live, size=min(n_self, len(live)), replace=False)
        qv = _jnp.take(index.vectors, _jnp.asarray(rows), axis=0).astype(
            _jnp.float32)
        if self.cfg.vector_dtype == "int8":
            qv = qv * _jnp.take(index.vec_scales, _jnp.asarray(rows))[:, None]
        key = _jax.random.PRNGKey(0)
        qv = qv + 0.02 * _jax.random.normal(key, qv.shape)
        qv = qv / _jnp.linalg.norm(qv, axis=1, keepdims=True)
        if n_logged:
            qv = _jnp.concatenate(
                [_jnp.asarray(logged, _jnp.float32), qv], axis=0)
        scales = (index.vec_scales if self.cfg.vector_dtype == "int8"
                  else None)
        cal = calibrate_nprobe(self._ann, index.vectors, qv,
                               k=self.cfg.default_k, target_recall=target,
                               row_scales=scales)
        cal["logged_queries"] = n_logged
        self._ann_nprobe = cal["nprobe"]
        self._ann_calibration = cal
        return cal

    @property
    def effective_nprobe(self) -> int:
        return getattr(self, "_ann_nprobe", None) or self.cfg.ivf_nprobe

    # -- post-fusion host re-rank (the codes-only 10M regime) ---------------

    def _device_k(self, k: int) -> int:
        """Result width requested from the compiled program: k normally;
        k·over_fetch under host residency so the exact host re-rank has
        candidates to reorder (ADC ranking errors inside the widened set
        are repaired; errors beyond it bound recall)."""
        if self.store.host_vectors is None:
            return k
        return min(k * self.cfg.over_fetch, self.store.capacity)

    def _device_funnel(self, k: int) -> int:
        """Vector-arm funnel width under host residency (0 elsewhere):
        how many approximately-ranked vector candidates the exact host
        re-rank reorders. MRAG_HOST_FUNNEL, auto = max(512, k·of)."""
        if self.store.host_vectors is None:
            return 0
        w = self.cfg.host_funnel or max(512, k * self.cfg.over_fetch)
        return int(min(w, self.store.capacity))

    def _host_rerank(self, reqs, exps, out: dict, k: int) -> dict:
        """Exact re-rank of the fused candidates from the host int8
        matrix: recompute sim = max(exact cosine, normalized lexical)
        and the v1.3 weighted score, re-sort, keep top-k. This is the
        second stage of the two-stage IVFADC shape — candidate
        generation ran on PQ codes in HBM; the truth lives in host RAM.
        Host cost per batch: one fused int8 gather+dot (cpp/rerank.cc;
        numpy [B, W, D] gather + einsum fallback when the native
        library is unavailable)."""
        hv, hs = self.store.host_vectors, self.store.host_scales
        idx = np.asarray(out["idx"])
        alive = np.asarray(out["rerank"]) > NEG_INF / 2
        lexn = np.asarray(out["lexn"])
        auth, lng = np.asarray(out["auth"]), np.asarray(out["len"])
        jpd, cov = np.asarray(out["jpd"]), np.asarray(out["cov"])
        rrf = np.asarray(out["rrf"])
        if "wide_idx" in out:
            # funnel union: fused top-kd + the vector arm's top-W, each
            # with its device-side signals; duplicates are resolved
            # after scoring (identical rows score identically — the
            # sort-order dedup keeps whichever copy carries rrf)
            idx = np.concatenate([idx, out["wide_idx"]], axis=1)
            alive = np.concatenate(
                [alive, np.asarray(out["wide_vals"]) > NEG_INF / 2], axis=1)
            lexn = np.concatenate([lexn, out["wide_lexn"]], axis=1)
            auth = np.concatenate([auth, out["wide_auth"]], axis=1)
            lng = np.concatenate([lng, out["wide_len"]], axis=1)
            jpd = np.concatenate([jpd, out["wide_jpd"]], axis=1)
            cov = np.concatenate([cov, out["wide_cov"]], axis=1)
            rrf = np.concatenate(
                [rrf, np.zeros_like(np.asarray(out["wide_vals"]))], axis=1)
        qv = self._embeddings(reqs)  # [B, D], normalized (LRU-cached)
        cos = native.gather_cos(hv, hs, idx, qv)
        if cos is None:
            safe = np.clip(idx, 0, hv.shape[0] - 1)
            rows = hv[safe].astype(np.float32) * hs[safe][..., None]
            cos = np.einsum("bwd,bd->bw", rows, qv.astype(np.float32))
        sim = np.clip(np.maximum(cos, lexn), 0.0, 1.0)
        has_jpd = np.array([1.0 if exp.tag_ids["d"] else 0.0
                            for exp in exps])[:, None]
        has_cov = np.array([1.0 if exp.phrase_slots else 0.0
                            for exp in exps])[:, None]
        w_jpd, w_cov = W_JPD * has_jpd, W_COV * has_cov
        max_w = W_SIM + W_AUTH + W_LEN + w_jpd + w_cov
        score = (W_SIM * sim + W_AUTH * auth + W_LEN * lng
                 + w_jpd * jpd + w_cov * cov) / np.maximum(max_w, 1e-6)
        score = np.where(alive, score, NEG_INF)
        if "wide_idx" in out:
            # duplicate rows between the fused and funnel sets: keep the
            # first in score order (ties broken toward the rrf-carrying
            # fused copy by the epsilon term), then the top-k uniques
            full = np.argsort(-(score + rrf * 1e-6), axis=1, kind="stable")
            sid = np.take_along_axis(idx, full, axis=1)
            order = np.empty((idx.shape[0], k), np.int64)
            for i in range(idx.shape[0]):
                _, first = np.unique(sid[i], return_index=True)
                first.sort()
                sel = first[:k]
                if len(sel) < k:
                    sel = np.concatenate(
                        [sel, np.full(k - len(sel), sel[-1])])
                order[i] = full[i, sel]
        else:
            order = np.argsort(-score, axis=1)[:, :k]
        take = lambda a: np.take_along_axis(np.asarray(a), order, axis=1)
        new = {key: v for key, v in out.items()
               if not key.startswith("wide_")}
        new.update({
            "rerank": take(score), "sim": take(sim), "cos": take(cos),
            "idx": take(idx),
            "auth": take(auth), "len": take(lng),
            "jpd": take(jpd), "cov": take(cov),
            "rrf": take(rrf), "lexn": take(lexn),
        })
        return new

    # -- host-side query prep ---------------------------------------------

    def prepare_query(self, req: QueryRequest
                      ) -> tuple[dict[str, np.ndarray], LexiconExpansion,
                                 dict[int, float]]:
        cfg = self.cfg
        if req.mode not in _MODES:
            raise ValueError(f"mode {req.mode!r} must be one of {_MODES}")
        if req.tag_mode not in ("strict", "relaxed", "none"):
            raise ValueError(f"tag_mode {req.tag_mode!r} must be strict|relaxed|none")
        # LRU on the string-derived prep: key is every request field that
        # feeds the arrays below (embedding excluded — handled separately
        # in _embeddings), token is the mutable state it reads.
        cache_key = (req.query, req.mode, req.payer, req.state, req.program,
                     float(req.min_similarity), req.tag_mode, req.inherit_authority)
        token = (self.store.generation,
                 self.lexicon.num_phrases if self.lexicon else 0)
        hit = self._prep_cache.get(cache_key)
        if hit is not None and hit[0] == token:
            self._prep_cache.move_to_end(cache_key)
            return hit[1], hit[2], hit[3]
        exp = self.lexicon.expand(req.query) if self.lexicon else LexiconExpansion()

        df, n_live = self.store.lexical_stats()
        lex_w = query_lexical_weights(req.query, exp.expansion_phrases, df, n_live,
                                      cfg.lexical_buckets)

        slots = exp.phrase_slots[:MAX_PHRASE_SLOTS]
        s_word = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_bit = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_jword = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_jbit = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_isj = np.zeros(MAX_PHRASE_SLOTS, np.float32)
        s_weight = np.zeros(MAX_PHRASE_SLOTS, np.float32)
        for i, (pid, weight, jtag) in enumerate(slots):
            if pid >= cfg.phrase_words * 32:
                continue  # phrase id beyond bitset capacity — skip slot
            s_word[i] = pid // 32
            s_bit[i] = pid % 32
            s_weight[i] = weight
            if jtag >= 0 and jtag < cfg.tag_words * 32:
                s_isj[i] = 1.0
                s_jword[i] = jtag // 32
                s_jbit[i] = jtag % 32

        tag_mode_code = {"strict": 0, "relaxed": 1, "none": 2}[req.tag_mode]

        def meta_id(interner, value):
            # "" → -1 = no filter; an unknown non-empty value → -2, which
            # matches no row (a filter on a payer the corpus has never
            # seen must return nothing, like the SQL WHERE it replaces).
            if not value:
                return -1
            return interner.to_id.get(value, -2)

        q = {
            "payer": np.int32(meta_id(self.store.payers, req.payer)),
            "state": np.int32(meta_id(self.store.states, req.state)),
            "program": np.int32(meta_id(self.store.programs, req.program)),
            "j_bits": pack_bits(exp.tag_ids["j"], cfg.tag_words),
            "d_bits": pack_bits(exp.tag_ids["d"], cfg.tag_words),
            "p_bits": pack_bits(exp.tag_ids["p"], cfg.tag_words),
            "min_sim": np.float32(req.min_similarity),
            "inherit_authority": np.float32(1.0 if req.inherit_authority else 0.0),
            "tag_mode": np.int32(tag_mode_code),
            "arm_weights": np.asarray(_MODE_ARM_WEIGHTS[req.mode], np.float32),
            "slot_word": s_word,
            "slot_bit": s_bit,
            "slot_jword": s_jword,
            "slot_jbit": s_jbit,
            "slot_isj": s_isj,
            "slot_weight": s_weight,
            # explicit d-tag id list for the candidate-local d-tag arm
            # (the dense arm reads the packed bits; this rides along —
            # 64 B/query — so one prepared dict serves both modes)
            "d_tag_ids": _query_dtag_ids(exp.tag_ids["d"], cfg.tag_words),
        }
        if len(self._prep_cache) >= self._prep_cache_max:
            self._prep_cache.popitem(last=False)
        self._prep_cache[cache_key] = (token, q, exp, lex_w)
        return q, exp, lex_w

    # Static pads for the batch bucket union — each distinct pad is one
    # XLA compilation, so round up to a few sizes instead of exact counts.
    _BUCKET_PADS = (128, 512, 2048)

    def prepare_batch(self, reqs: Sequence[QueryRequest]):
        """Assemble the batched device-query dict: per-query arrays
        stacked + the sparse lexical contraction (union bucket list
        [U] + per-query weights [B, U]).

        The entire batch ships in ONE ``jax.device_put`` of the finished
        numpy pytree — 19 separate ``jnp.asarray`` enqueues were 43% of
        host prep time (per-transfer dispatch overhead, not bytes)."""
        vecs = self._embeddings(reqs)
        prepared = [self.prepare_query(r) for r in reqs]
        # Ship query vectors as bf16: half the upload bytes. The dot
        # accumulates in f32 (preferred_element_type), and query-side
        # bf16 rounding stays inside the recall floor: vector-arm
        # recall@10 vs an exact fp64 oracle is checked by chip_smoke.py
        # (phase d, with the cost of f32 queries beside it) and
        # bench.py. Whether the halved upload pays on a GPU host is
        # not measured (ROADMAP 3.1).
        q: dict = {"vec": to_bf16(vecs)}
        for key in prepared[0][0]:
            q[key] = np.stack([p[0][key] for p in prepared])

        union: list[int] = []
        seen: dict[int, int] = {}
        for _, _, lex_w in prepared:
            for b in lex_w:
                if b not in seen:
                    seen[b] = len(union)
                    union.append(b)
        u_pad = next((p for p in self._BUCKET_PADS if len(union) <= p),
                     self.cfg.lexical_buckets)
        if len(union) > u_pad:  # beyond the largest pad — keep the heaviest
            union = union[:u_pad]
            seen = {b: i for i, b in enumerate(union)}
        buckets = np.zeros(u_pad, np.int32)
        buckets[: len(union)] = union
        weights = np.zeros((len(reqs), u_pad), np.float32)
        for bi, (_, _, lex_w) in enumerate(prepared):
            for b, w in lex_w.items():
                if b in seen:
                    weights[bi, seen[b]] = w
        q["lex_buckets"] = buckets
        q["lex_weights"] = weights
        if (self.sharded is None and self._local_gating_active()
                and self._ann is not None):
            q["strict_total"] = self._strict_totals(prepared)
        return jax.device_put(q), [p[1] for p in prepared]

    # Pad width for the strict-count miss batch: one compiled count
    # program regardless of how many signatures missed.
    _STRICT_MISS_PAD = 32

    def _strict_totals(self, prepared) -> np.ndarray:
        """Host-cached global strict-eligible counts per request (the
        auto-relax branch's input). Key = the full filter signature +
        store generation; misses batch through ONE jitted
        gating.strict_counts call. Repeated filters — the dominant
        serving pattern — cost nothing corpus-sized."""
        from mobius_rag_tpu.query import gating

        gen = self.store.generation
        counts = np.zeros(len(prepared), np.float32)
        missing: list[tuple[int, tuple]] = []
        for i, (qq, _, _) in enumerate(prepared):
            sig = (gen, int(qq["payer"]), int(qq["state"]),
                   int(qq["program"]), float(qq["inherit_authority"]),
                   qq["j_bits"].tobytes())
            hit = self._strict_cache.get(sig)
            if hit is None:
                missing.append((i, sig))
            else:
                self._strict_cache.move_to_end(sig)
                counts[i] = hit
        if missing:
            pad = self._STRICT_MISS_PAD
            groups = [missing[o:o + pad] for o in range(0, len(missing), pad)]
            tw = self.cfg.tag_words
            for grp in groups:
                mq = {
                    "payer": np.full(pad, -2, np.int32),
                    "state": np.full(pad, -2, np.int32),
                    "program": np.full(pad, -2, np.int32),
                    "inherit_authority": np.zeros(pad, np.float32),
                    "j_bits": np.zeros((pad, tw), np.uint32),
                }
                for slot, (i, _) in enumerate(grp):
                    qq = prepared[i][0]
                    for key in ("payer", "state", "program",
                                "inherit_authority"):
                        mq[key][slot] = qq[key]
                    mq["j_bits"][slot] = qq["j_bits"]
                if self._strict_jit is None:
                    self._strict_jit = jax.jit(gating.strict_counts)
                vals = np.asarray(jax.device_get(
                    self._strict_jit(self.store.index, mq)))
                for slot, (i, sig) in enumerate(grp):
                    v = float(vals[slot])
                    counts[i] = v
                    if len(self._strict_cache) >= 4096:
                        self._strict_cache.popitem(last=False)
                    self._strict_cache[sig] = v
        return counts

    def _embeddings(self, reqs: Sequence[QueryRequest]) -> np.ndarray:
        def cache_key(q: str) -> str:
            return q.strip().lower()

        need = [r.query for r in reqs
                if r.embedding is None and cache_key(r.query) not in self._embed_cache]
        if need and self.embed_fn is None:
            raise ValueError("QueryRequest.embedding missing and no embed_fn attached")
        if need:
            for q, v in zip(need, self.embed_fn(need)):
                if len(self._embed_cache) >= self._embed_cache_max:
                    self._embed_cache.popitem(last=False)
                self._embed_cache[cache_key(q)] = np.asarray(v, np.float32)
        out = []
        for r in reqs:
            if r.embedding is not None:
                v = np.asarray(r.embedding, np.float32)
            else:
                key = cache_key(r.query)
                self._embed_cache.move_to_end(key)  # refresh LRU position
                v = self._embed_cache[key]
            n = np.linalg.norm(v)
            out.append(v / n if n > 0 else v)
        return np.stack(out)

    # -- public API ---------------------------------------------------------

    def search_pipelined(self, batches: Sequence[Sequence[QueryRequest]],
                         k: int | None = None) -> list[list[SearchResult]]:
        """Bulk search: dispatch every batch's compiled program before
        fetching any results, so host↔device round-trips overlap device
        execution (the serving-throughput shape; jax dispatch is async).
        Results are fully materialized before returning.

        With ``pipeline_merge`` > 1, runs same-size batches fused into
        wider program invocations (every score is per-query, so the
        split results are identical) — fewer host↔device round-trips and
        wider matmuls per dispatch."""
        merge = self.cfg.pipeline_merge
        if merge > 1 and len(batches) > 1 and len({len(b) for b in batches}) == 1:
            bsz = len(batches[0])
            fused = [[r for b in batches[i:i + merge] for r in b]
                     for i in range(0, len(batches), merge)]
            out: list[list[SearchResult]] = []
            for mb, res in zip(fused, self._pipelined_impl(fused, k)):
                out.extend(res[off:off + bsz]
                           for off in range(0, len(mb), bsz))
            return out
        return self._pipelined_impl(batches, k)

    def _pipelined_impl(self, batches: Sequence[Sequence[QueryRequest]],
                        k: int | None = None) -> list[list[SearchResult]]:
        k = k or self.cfg.default_k
        if self.sharded is not None:
            self.sharded.refresh()
            kd = self._device_k(k)  # widened under host residency
            fw = self._device_funnel(k)
            prepared = [self.prepare_batch(b) for b in batches]
            outs = [self.sharded._run(q, kd, fw) for q, _ in prepared]
            fetch_iter = self._iter_fetched(
                outs, kd, functools.partial(unpack_fused, w=fw))
        else:
            ann = self.ensure_ann()
            kd = self._device_k(k)
            fw = self._device_funnel(k)
            # interleave host prep with device execution: each batch
            # dispatches the moment it's prepared (dispatch is async), so
            # batch i+1's string work overlaps batch i's device scan
            local = self._ensure_local_structs(ann)
            prepared, outs = [], []
            for b in batches:
                q, exps = self.prepare_batch(b)
                prepared.append((q, exps))
                outs.append(_search_compiled(
                    self.store.index, q, kd, self.cfg.over_fetch,
                    self.cfg.rrf_k, ann, self.effective_nprobe, fw,
                    self.cfg.ann_approx_topk, local,
                    self._batch_tag_level(exps) if local else 2))
            fetch_iter = self._iter_fetched(
                outs, kd, functools.partial(unpack_out, w=fw))
        results = []
        for batch, (qq, exps), out in zip(batches, prepared, fetch_iter):
            if kd != k or fw:
                out = self._host_rerank(list(batch), exps, out, k)
            results.append(self._assemble(list(batch), exps, out, k))
        return results

    def _iter_fetched(self, outs, kd: int, unpack):
        """Yield per-batch unpacked output dicts for a list of dispatched
        (f, i) packed program outputs. Same-shape batches stack on device
        in `pipeline_fetch_groups` contiguous groups, each fetched as TWO
        arrays; groups after the first download in a worker thread while
        the caller assembles the previous group (device→host transfer is
        IO — the GIL is released — so assembly overlaps it even on a
        single-vCPU host). One group reproduces the round-3 single
        stacked fetch exactly."""
        n = len(outs)
        if n > 1 and len({f.shape for f, _ in outs}) == 1:
            g = max(1, min(self.cfg.pipeline_fetch_groups, n))
            bounds = [round(j * n / g) for j in range(g + 1)]
            stacked = [
                (jnp.stack([f for f, _ in outs[lo:hi]]),
                 jnp.stack([i for _, i in outs[lo:hi]]))
                for lo, hi in zip(bounds, bounds[1:]) if hi > lo
            ]
            if len(stacked) == 1:
                fs, is_ = jax.device_get(stacked[0])
                for j in range(n):
                    yield unpack((fs[j], is_[j]), kd)
                return
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=1) as ex:
                futs = [ex.submit(jax.device_get, s) for s in stacked]
                for fut in futs:
                    fs, is_ = fut.result()
                    for j in range(fs.shape[0]):
                        yield unpack((fs[j], is_[j]), kd)
            return
        for f in jax.device_get(outs):
            yield unpack(f, kd)

    def search(self, reqs: Sequence[QueryRequest] | QueryRequest, k: int | None = None
               ) -> list[SearchResult]:
        if isinstance(reqs, QueryRequest):
            reqs = [reqs]
        cfg = self.cfg
        k = k or cfg.default_k
        t0 = time.perf_counter()

        if self.sharded is None:
            # ann must exist BEFORE prepare: the local-gating path bakes
            # host-cached strict counts into the prepared batch, and a
            # first batch prepared without them would compile a second
            # (count-in-graph) variant of the big program
            self.ensure_ann()
        q, exps = self.prepare_batch(reqs)

        t_prep = time.perf_counter()
        if self.sharded is not None:
            self.sharded.refresh()
            kd = self._device_k(k)
            fw = self._device_funnel(k)
            out = unpack_fused(jax.device_get(self.sharded._run(q, kd, fw)),
                               kd, w=fw)
            if kd != k or fw:
                out = self._host_rerank(reqs, exps, out, k)
        else:
            ann = self.ensure_ann()
            local = self._ensure_local_structs(ann)
            kd = self._device_k(k)
            fw = self._device_funnel(k)
            out = unpack_out(jax.device_get(
                _search_compiled(self.store.index, q, kd, cfg.over_fetch,
                                 cfg.rrf_k, ann, self.effective_nprobe, fw,
                                 self.cfg.ann_approx_topk, local,
                                 self._batch_tag_level(exps) if local else 2)),
                kd, w=fw)
            if kd != k or fw:
                out = self._host_rerank(reqs, exps, out, k)
        t_dev = time.perf_counter()
        timings = {
            "prepare": (t_prep - t0) * 1e3 / len(reqs),
            "device": (t_dev - t_prep) * 1e3 / len(reqs),
        }
        return self._assemble(list(reqs), exps, out, k, timings)

    # Neighbor-expansion caps (corpus_search.py:2690 per-doc caps: don't
    # let one document's siblings crowd the context window).
    MAX_NEIGHBORS_PER_HIT = 2
    MAX_NEIGHBOR_CHUNKS_PER_DOC = 4

    def _expand_with_neighbors(self, hits: list[SearchHit]) -> None:
        """Attach adjacent same-document chunks to each hit (the
        reference's sibling fetch, corpus_search.py:2560): ±1 rows in
        publish order within the same doc, deduped against hits already
        present, capped per doc."""
        hit_rows = {h.row for h in hits}
        per_doc: dict[str, int] = {}
        for h in hits:
            rec = self.store.record(h.row)
            if rec is None:
                continue
            doc_rows = self.store._doc_rows.get(h.doc_id, [])
            try:
                pos = doc_rows.index(h.row)
            except ValueError:
                continue
            for npos in (pos - 1, pos + 1):
                if not (0 <= npos < len(doc_rows)):
                    continue
                nrow = doc_rows[npos]
                if nrow in hit_rows:
                    continue
                if per_doc.get(h.doc_id, 0) >= self.MAX_NEIGHBOR_CHUNKS_PER_DOC:
                    break
                nrec = self.store.record(nrow)
                if nrec is None:
                    continue
                if len(h.neighbors) >= self.MAX_NEIGHBORS_PER_HIT:
                    break
                h.neighbors.append({
                    "chunk_id": nrec.chunk_id, "text": nrec.text,
                    "section_path": nrec.section_path, "page": nrec.page,
                    "position": "before" if npos < pos else "after",
                })
                per_doc[h.doc_id] = per_doc.get(h.doc_id, 0) + 1

    # Signal channels materialized per hit, in out-dict key order.
    _SIGNAL_KEYS = (("sim", "sim"), ("cos", "cosine"), ("auth", "authority"),
                    ("len", "length"), ("jpd", "jpd"), ("cov", "coverage"),
                    ("rrf", "rrf"))

    def _assemble(self, reqs: list[QueryRequest], exps, out, k: int,
                  timings: dict | None = None) -> list[SearchResult]:
        cfg = self.cfg
        # Bulk-convert every device output to nested Python lists ONCE:
        # numpy's tolist() is a single C pass, vs the previous per-element
        # float()/int() calls (7 signals × k × B plus arm traces ≈ 4,000
        # scalar conversions per batch32, corpus-size-independent).
        cols = {key: np.asarray(v).tolist() for key, v in out.items()}
        results = []
        for bi, req in enumerate(reqs):
            # mode-default minimum confidence floor (corpus_search.py
            # _MODE_MIN): corpus/precision drop abstain-grade hits;
            # recall keeps everything.
            floor = 0.0 if MODE_MIN_LABEL.get(req.mode) == "abstain" \
                else cfg.confidence_low
            rerank_b = cols["rerank"][bi]
            idx_b = cols["idx"][bi]
            sig_b = [cols[src][bi] for src, _ in self._SIGNAL_KEYS]
            hits = []
            for j in range(k):
                score = rerank_b[j]
                if score <= NEG_INF / 2 or score < floor:
                    continue
                row = idx_b[j]
                rec = self.store.record(row)
                if rec is None:
                    continue
                hits.append(SearchHit(
                    row=row,
                    chunk_id=rec.chunk_id,
                    doc_id=rec.doc_id,
                    text=rec.text,
                    score=score,
                    similarity=sig_b[0][j],
                    signals={name: col[j] for (_, name), col
                             in zip(self._SIGNAL_KEYS, sig_b)},
                    metadata={
                        "payer": rec.payer, "state": rec.state,
                        "program": rec.program, "filename": rec.filename,
                        "section_path": rec.section_path, "page": rec.page,
                        "authority_level": rec.authority_level,
                    },
                ))
            if self.cross_encoder is not None and hits:
                ce = self.cross_encoder(req.query, [h.text for h in hits])
                for h, s in zip(hits, ce):
                    h.signals["cross_encoder"] = float(s)
                # stable re-sort by cross-encoder logit; keep the linear
                # rerank score for confidence labels
                hits.sort(key=lambda h: -h.signals["cross_encoder"])
            self._expand_with_neighbors(hits)
            label = _confidence_label(max(h.score for h in hits), cfg) \
                if hits else "abstain"
            exp = exps[bi]

            def _arm_trace(name):
                # the sharded merge path reports no per-arm traces
                if f"{name}_idx" not in cols:
                    return []
                idxs = cols[f"{name}_idx"][bi]
                vals = cols[f"{name}_vals"][bi]
                return [
                    {"row": i, "score": v}
                    for i, v in zip(idxs, vals) if v > NEG_INF / 2
                ][: k]

            result = SearchResult(
                query=req.query,
                hits=hits,
                confidence_label=label,
                expansion=exp,
                telemetry={
                    "timings_ms": timings or {},
                    "arms": {
                        "vector": _arm_trace("vec"),
                        "lexical": _arm_trace("lex"),
                        "dtag": _arm_trace("dtag"),
                    },
                    "strict_count": int(cols["strict_count"][bi])
                    if "strict_count" in cols else -1,
                    "expansion_log": exp.log,
                    "mode": req.mode,
                },
            )
            results.append(result)
            if self.telemetry is not None:
                # fire-and-forget search_events row (corpus_search.py:3187)
                self.telemetry.record_search_event(
                    query=req.query, mode=req.mode,
                    timings=result.telemetry["timings_ms"],
                    arms={a: len(v) for a, v in result.telemetry["arms"].items()},
                    expansion=exp.matched_codes,
                    results=[{"chunk_id": h.chunk_id, "score": h.score,
                              "signals": h.signals} for h in hits],
                    extra={"strict_count": result.telemetry["strict_count"],
                           "confidence": label},
                )
        return results
