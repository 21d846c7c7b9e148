"""Candidate-local filter gating and arm scans — the [B, C]-free form
of the hybrid query program for corpora where C is tens of millions.

The dense pipeline (query/engine.py filter_masks / gate_penalty /
lexical_raw / dtag_raw) materializes several [B, C]-sized buffers per
batch: eligibility masks, the additive gate penalty, the lexical
segment-sum matrix and the d-tag score matrix, each feeding a
lax.top_k over all C rows — corpus-sized work whose LIVE content is a
few thousand candidates. This module evaluates the same semantics
candidate-locally:

- strict_counts: the ONE corpus-wide pass that must remain (the
  auto-relax branch needs the global strict-eligible count,
  corpus_search.py:1545-1555) — a fused reduction with no
  materialized [B, C] output.
- lexical_candidates_local: scores ONLY the rows in the query
  buckets' postings (the sparse layout already bounds them), gates
  them through the exact packed-word gate (ops/proj.py
  _gate_blocks_xla), and top-ks in postings space.
- DTagPostings + dtag_candidates_local: a per-tag, authority-ranked
  inverted index (the device form of a GIN index on the tag column)
  with the metadata gate words packed NEXT to the postings, so the
  arm never touches a [C]-indexed array at query time.
- lex_signal_join: per-candidate lexical signal for the other arms'
  candidates by id-join against the lexical arm's scored top list
  (the dense path reads lex_raw[idx]; candidates outside the lexical
  top-R carry 0 — exact whenever the bucket postings hold ≤ R live
  rows, pinned by the parity tests).

Reference parity anchor: the strict/relaxed tag filters + auto-relax
retry of corpus_search.py:1427-1555 and the d-tag membership arm at
:1605, evaluated as one compiled program.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.ops.proj import (ProjGate, _gate_blocks_xla,
                                     meta_ok_from_words)
from mobius_rag_tpu.ops.topk import NEG_INF


def batch_tag_level(q_np: dict) -> int:
    """Static gate width for a prepared batch (host-side, pre-
    device_put): 0 = no query carries tag bits (metadata-only gate),
    1 = j bits only, 2 = d/p bits present (the relax branch may need
    them whatever strict_ok turns out to be)."""
    has_dp = (np.asarray(q_np["d_bits"]).any()
              or np.asarray(q_np["p_bits"]).any())
    if has_dp:
        return 2
    return 1 if np.asarray(q_np["j_bits"]).any() else 0


def _strict_block(valid, payer, state, program, authority, j_tags, q):
    """Strict mask over one row block: [B, S] bool (the exact
    filter_masks strict semantics)."""

    def col_match(col, want):  # [S] vs [B] → [B, S] bool
        return jnp.where(want[:, None] == -1, True,
                         col[None, :] == want[:, None])

    regulator = (authority[None, :] >= 0.999) & (payer[None, :] < 0)
    payer_ok = col_match(payer, q["payer"]) | (
        (q["inherit_authority"][:, None] > 0) & regulator)
    meta_ok = (payer_ok
               & col_match(state, q["state"])
               & col_match(program, q["program"]))
    j_ov = jnp.zeros_like(meta_ok)
    for w in range(j_tags.shape[1]):
        j_ov = j_ov | ((j_tags[None, :, w] & q["j_bits"][:, w:w + 1]) > 0)
    has_j = (q["j_bits"].sum(axis=1) > 0)[:, None]
    return (valid[None, :] > 0) & meta_ok & (j_ov | ~has_j)


# Row-block width for the scanned count: [B, 2^18] bool transients stay
# ~8 MB while the column reads remain streaming-contiguous.
_COUNT_BLOCK = 262_144


def strict_counts(index, q) -> jnp.ndarray:
    """Global strict-eligible row count per query [B] f32 — the
    no-materialization form of filter_masks' strict.sum(axis=1).
    Numerically identical to the dense path (a count of exact boolean
    conditions has no summation-order sensitivity).

    Beyond _COUNT_BLOCK rows the reduction runs as a lax.scan over row
    blocks, so every transient stays block-sized instead of [B, C]."""
    c = index.valid.shape[0]
    if c <= _COUNT_BLOCK:
        blk = _strict_block(index.valid, index.payer, index.state,
                            index.program, index.authority, index.j_tags, q)
        return blk.sum(axis=1).astype(jnp.float32)

    nb = -(-c // _COUNT_BLOCK)
    pad_to = nb * _COUNT_BLOCK

    def padded(col, fill):
        return jnp.pad(col, [(0, pad_to - c)] + [(0, 0)] * (col.ndim - 1),
                       constant_values=fill)

    valid = padded(index.valid, 0.0).reshape(nb, _COUNT_BLOCK)
    payer = padded(index.payer, -1).reshape(nb, _COUNT_BLOCK)
    state = padded(index.state, -1).reshape(nb, _COUNT_BLOCK)
    program = padded(index.program, -1).reshape(nb, _COUNT_BLOCK)
    authority = padded(index.authority, 0.0).reshape(nb, _COUNT_BLOCK)
    j_tags = padded(index.j_tags, 0).reshape(nb, _COUNT_BLOCK, -1)

    def step(acc, xs):
        v, p, s, g, a, j = xs
        blk = _strict_block(v, p, s, g, a, j, q)
        return acc + blk.sum(axis=1).astype(jnp.float32), None

    b = q["payer"].shape[0]
    init = jnp.zeros((b,), jnp.float32)
    out, _ = jax.lax.scan(step, init,
                          (valid, payer, state, program, authority, j_tags))
    return out


def rows_gate(index, qmeta, qbits, rows, tag_level: int) -> jnp.ndarray:
    """Full gate (strict/relaxed/auto + tag_mode) for arbitrary row ids.
    rows [S] (shared across the batch) or [B, S] → bool [B, S]. Rows
    < 0 or >= C gate False (pack_rows marks them invalid)."""
    flat = rows.reshape(-1)
    packed = ProjGate.pack_rows(index, flat)  # [n, 2+3TW]
    tw = index.j_tags.shape[1]
    shape = rows.shape + (-1,)
    meta_blk = packed[:, :2].reshape(shape)
    jw_blk = packed[:, 2:2 + tw].reshape(shape)
    dpw_blk = packed[:, 2 + tw:].reshape(shape)
    if rows.ndim == 1:  # shared rows: broadcast over the batch
        meta_blk, jw_blk, dpw_blk = (meta_blk[None], jw_blk[None],
                                     dpw_blk[None])
    return _gate_blocks_xla(meta_blk, jw_blk, dpw_blk, qmeta, qbits,
                            tw, tag_level)


def lexical_candidates_local(index, q, qmeta, qbits, m: int,
                             tag_level: int, tok=None):
    """Lexical arm over the postings union only. Returns (vals [B, m],
    idx [B, m] i32, lex_best [B]) matching the dense arm's semantics:
    score = Σ_buckets weight·posting, rows with score ≤ 0 or failing
    the gate are NEG_INF; lex_best = best LIVE score (the rerank
    normalizer, engine.fuse_and_rerank)."""
    lw = q["lex_weights"] if tok is None else q["lex_weights"] + tok
    c_rows = index.valid.shape[0]
    if "lex_cols" not in index.fields:
        # dense [H, C] lexical layout (the ≤~500k-row regime): no
        # postings bound the candidates, so score densely and gate all
        # rows through the same packed-word gate. Only reachable when
        # local gating is FORCED on a dense-lexical corpus (auto
        # activates with sparse postings only) — small by construction.
        from mobius_rag_tpu.query.engine import lexical_raw

        lraw = lexical_raw(index, q, lex_weights=lw)
        gate = rows_gate(index, qmeta, qbits,
                         jnp.arange(c_rows, dtype=jnp.int32), tag_level)
        scores = jnp.where((lraw > 0) & gate, lraw, NEG_INF)
        vals, idx = jax.lax.top_k(scores, min(m, c_rows))
        if m > c_rows:
            b = vals.shape[0]
            vals = jnp.concatenate(
                [vals, jnp.full((b, m - c_rows), NEG_INF, vals.dtype)],
                axis=1)
            idx = jnp.concatenate(
                [idx, jnp.zeros((b, m - c_rows), idx.dtype)], axis=1)
        lex_best = jnp.max(jnp.where(vals > NEG_INF / 2, vals, 0.0), axis=1)
        return vals, idx.astype(jnp.int32), lex_best
    cols = jnp.take(index.lex_cols, q["lex_buckets"], axis=0)  # [U, P]
    wts = jnp.take(index.lex_wts, q["lex_buckets"], axis=0)  # [U, P]
    c = index.valid.shape[0]
    u, p = cols.shape
    s = u * p
    ids = jnp.where(cols.reshape(-1) < 0, c, cols.reshape(-1))  # pads → c
    order = jnp.argsort(ids)
    ids_s = jnp.take(ids, order)  # grouped by row id, pads last
    contrib = (lw[:, :, None] * wts[None].astype(jnp.float32)).reshape(
        lw.shape[0], s)
    contrib_s = jnp.take(contrib, order, axis=1)  # [B, S]
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), ids_s[1:] != ids_s[:-1]])
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1  # [S] group index
    scores = jax.vmap(
        lambda v: jax.ops.segment_sum(v, seg, num_segments=s))(contrib_s)
    # representative row id per group (all members equal; min = value)
    grows = jnp.full((s,), c, jnp.int32).at[seg].min(ids_s.astype(jnp.int32))
    live = grows < c
    gate = rows_gate(index, qmeta, qbits, jnp.minimum(grows, c - 1),
                     tag_level)
    lex_scores = jnp.where(
        live[None, :] & (scores > 0) & gate, scores, NEG_INF)
    vals, pos = jax.lax.top_k(lex_scores, min(m, s))
    idx = jnp.take(grows, pos)
    if m > s:  # postings space narrower than the arm width: dead-pad
        b = vals.shape[0]
        vals = jnp.concatenate(
            [vals, jnp.full((b, m - s), NEG_INF, vals.dtype)], axis=1)
        idx = jnp.concatenate([idx, jnp.zeros((b, m - s), idx.dtype)], axis=1)
    lex_best = jnp.max(jnp.where(vals > NEG_INF / 2, vals, 0.0), axis=1)
    return vals, idx.astype(jnp.int32), lex_best


# ---------------------------------------------------------------------------
# D-tag inverted postings
# ---------------------------------------------------------------------------

class DTagPostings:
    """Authority-ranked per-tag row lists with the metadata gate words
    packed alongside: rows [T, Pd] i32 (-1 pad), auth [T, Pd] f32,
    meta [T, Pd, 2] i32 (ProjGate word layout). T = tag_words·32.

    Truncation contract: a tag with more than Pd live members keeps its
    top-Pd by (authority desc, row asc) — the same ordering the dense
    arm's lax.top_k applies, so results are identical whenever a tag's
    membership fits Pd (pinned by tests); beyond Pd the arm sees the
    highest-authority members only (the arm IS an authority ranking,
    so the dropped tail is exactly what it would rank last).
    """

    def __init__(self, rows, auth, meta, pd: int):
        self.rows, self.auth, self.meta, self.pd = rows, auth, meta, int(pd)

    @classmethod
    def build(cls, index, pd: int = 4096) -> "DTagPostings":
        tw = index.d_tags.shape[1]
        t = tw * 32
        c = index.valid.shape[0]
        pd = int(min(pd, c))

        @jax.jit
        def tag_top(ix, word, bit):  # dynamic tag id → ONE compile
            col = jnp.take(ix.d_tags, word, axis=1)  # [C] u32
            member = ((col >> bit.astype(jnp.uint32)) & jnp.uint32(1)) > 0
            score = jnp.where(member & (ix.valid > 0), ix.authority, NEG_INF)
            vals, rows = jax.lax.top_k(score, pd)
            rows = jnp.where(vals > NEG_INF / 2, rows, -1)
            return vals, rows.astype(jnp.int32)

        all_rows = np.full((t, pd), -1, np.int32)
        all_auth = np.zeros((t, pd), np.float32)
        for tag in range(t):
            vals, rows = jax.device_get(tag_top(
                index, jnp.int32(tag // 32), jnp.uint32(tag % 32)))
            all_rows[tag] = rows
            all_auth[tag] = np.where(rows >= 0, vals, 0.0)
        rows_dev = jnp.asarray(all_rows)
        packed = ProjGate.pack_rows(index, jnp.maximum(rows_dev.reshape(-1), 0))
        meta = packed[:, :2].reshape(t, pd, 2)
        w1 = jnp.where(rows_dev >= 0, meta[..., 1],
                       meta[..., 1] & ~jnp.int32(1 << 16))
        meta = meta.at[..., 1].set(w1)
        # word-major [T, 2, Pd]: a trailing size-2 word axis would tile
        # as the 128-lane dimension and pad the array 64x (the 10M HBM
        # OOM lesson — see ProjGate)
        return cls(rows_dev, jnp.asarray(all_auth),
                   meta.transpose(0, 2, 1), pd)

    def as_tuple(self):
        return (self.rows, self.auth, self.meta)


MAX_QUERY_DTAGS = 16


def query_dtag_ids(tag_ids: list[int], tag_words: int) -> np.ndarray:
    """Host-side: the first MAX_QUERY_DTAGS in-range d-tag ids of a
    query, -1 padded (prepare_query attaches this as q["d_tag_ids"]
    for the candidate-local arm)."""
    out = np.full(MAX_QUERY_DTAGS, -1, np.int32)
    keep = [t for t in tag_ids if 0 <= t < tag_words * 32]
    out[: min(len(keep), MAX_QUERY_DTAGS)] = keep[:MAX_QUERY_DTAGS]
    return out


def dtag_candidates_local(dtp: tuple, q, qmeta, m: int, tok=None):
    """D-tag arm over the per-tag postings: candidates = the union of
    the query's tags' lists, scored authority+1 under valid & meta_ok
    (the dense dtag_raw semantics). Duplicates across a query's tags
    are masked to NEG_INF after the first occurrence (the dense arm
    scores each row once). Returns (vals [B, m], idx [B, m] i32)."""
    t_rows, t_auth, t_meta = dtp
    tag_ids = q["d_tag_ids"]  # [B, T_q] i32, -1 pads
    if tok is not None:
        tag_ids = tag_ids + tok.astype(tag_ids.dtype)
    t = t_rows.shape[0]
    safe = jnp.clip(tag_ids, 0, t - 1)
    live_tag = (tag_ids >= 0)[..., None]  # [B, T_q, 1]
    rows = jnp.where(live_tag, jnp.take(t_rows, safe, axis=0), -1)
    auth = jnp.take(t_auth, safe, axis=0)  # [B, T_q, Pd]
    meta = jnp.take(t_meta, safe, axis=0)  # [B, T_q, 2, Pd] word-major
    b, tq, pd = rows.shape
    s = tq * pd
    rows_f = rows.reshape(b, s)
    meta_f = jnp.moveaxis(meta, 2, -1).reshape(b, s, 2)
    meta_ok, valid = meta_ok_from_words(meta_f, qmeta)
    score = jnp.where(
        (rows_f >= 0) & valid & meta_ok,
        auth.reshape(b, s) + 1.0, NEG_INF)
    # dedup across tags: sort ids, mark repeats, scatter the mask back
    order = jnp.argsort(jnp.where(rows_f < 0, jnp.int32(2**31 - 1), rows_f),
                        axis=1)
    ids_s = jnp.take_along_axis(rows_f, order, axis=1)
    rep = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.bool_),
         (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)], axis=1)
    dup = jnp.zeros((b, s), jnp.bool_).at[
        jnp.arange(b)[:, None], order].set(rep)
    score = jnp.where(dup, NEG_INF, score)
    vals, pos = jax.lax.top_k(score, min(m, s))
    idx = jnp.take_along_axis(rows_f, pos, axis=1)
    if m > s:
        vals = jnp.concatenate(
            [vals, jnp.full((b, m - s), NEG_INF, vals.dtype)], axis=1)
        idx = jnp.concatenate([idx, jnp.zeros((b, m - s), idx.dtype)], axis=1)
    return vals, jnp.maximum(idx, 0).astype(jnp.int32)


def lex_signal_join(cand_idx, lex_idx, lex_vals) -> jnp.ndarray:
    """Per-candidate lexical raw score by id-join against the lexical
    arm's top list: cand_idx [B, M], lex_idx/lex_vals [B, R] →
    [B, M] f32 (0 where the candidate is outside the top-R)."""
    live = (lex_vals > NEG_INF / 2)
    eq = (cand_idx[:, :, None] == lex_idx[:, None, :]) & live[:, None, :]
    return jnp.einsum("bmr,br->bm", eq.astype(jnp.float32),
                      jnp.where(live, lex_vals, 0.0))
