"""Masked cosine top-k over the device-resident chunk matrix.

This is the device replacement for pgvector's ``embedding_vec <=> query
ORDER BY ... LIMIT k`` scan (reference: app/services/vector_store.py:274-287,
app/services/corpus_search.py:1530-1541). Two XLA forms:

- :func:`cosine_topk_xla` — one matmul + additive mask + ``lax.top_k``
  over the full [B, N] score row. Memory-bound for large N (the [N, D]
  matrix read dominates). The numerical reference the tests and the
  recall checks compare against.
- :func:`cosine_topk_blocked` — the same result from per-block top-k
  under ``lax.map`` and one final merge, never materializing [B, N].

Both run the dot at ``Precision.HIGHEST``: on GPUs a float32 dot at
default precision may run in TF32, and a reference must not.

Filters (tag gating, validity) arrive as an additive penalty vector
(0 for eligible rows, -inf for gated rows) — the fused form of the
reference's strict/relaxed SQL WHERE clauses (corpus_search.py:1498-1516).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mobius_rag_tpu.utils import round_up

NEG_INF = -1e30
_HIGHEST = jax.lax.Precision.HIGHEST


def merged_topk(vals: jnp.ndarray, ids: jnp.ndarray, k: int,
                approx_recall: float = 0.0):
    """Final top-k over a flat candidate pool. vals/ids [B, S] → [B, k].

    The probed scans (ivf/pq/proj *_search_packed) accumulate every
    probe step's scores and select ONCE here, instead of carrying a
    running top-k through the scan — lax.top_k at funnel width (k=1024)
    is sort-bound, and nprobe per-step sorts dominated the config-5
    vector arm.

    ``approx_recall`` > 0 selects ``jax.lax.approx_max_k`` with that
    recall target. XLA's CPU and GPU backends lower it to an exact
    top-k (its ``is_fallback`` form), so results there equal
    ``lax.top_k``'s. Candidate selection feeding a downstream exact
    re-rank (the host funnel) tolerates an approximate top-k by
    construction."""
    s = vals.shape[1]
    if s < k:
        b = vals.shape[0]
        vals = jnp.concatenate(
            [vals, jnp.full((b, k - s), NEG_INF, vals.dtype)], axis=1)
        ids = jnp.concatenate(
            [ids, jnp.zeros((b, k - s), ids.dtype)], axis=1)
    if approx_recall:
        v, pos = jax.lax.approx_max_k(
            vals, k, recall_target=float(approx_recall))
    else:
        v, pos = jax.lax.top_k(vals, k)
    return v, jnp.take_along_axis(ids, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def cosine_topk_xla(vectors: jax.Array, queries: jax.Array, penalty: jax.Array, k: int):
    """Exact masked top-k via one XLA matmul.

    Args:
      vectors: [N, D] chunk matrix (rows assumed L2-normalized; any dtype).
      queries: [B, D] query vectors (L2-normalized).
      penalty: [N] additive mask — 0.0 eligible, -inf (NEG_INF) gated.
      k: number of results per query.

    Returns:
      (scores [B, k] f32 desc, indices [B, k] i32). Gated rows surface as
      scores <= NEG_INF/2 and should be treated as absent by the caller.
    """
    scores = jnp.dot(
        queries.astype(jnp.float32),
        vectors.astype(jnp.float32).T,
        precision=_HIGHEST,
        preferred_element_type=jnp.float32,
    )
    scores = scores + penalty[None, :]
    vals, idx = jax.lax.top_k(scores, k)
    return vals, idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "block"))
def cosine_topk_blocked(vectors: jax.Array, queries: jax.Array,
                        penalty: jax.Array, k: int, block: int = 131072):
    """Hierarchical two-phase masked top-k: per-block matmul + per-block
    top-k under lax.map, then one final merge over [B, nb·k].

    Blocking keeps the memory traffic of cosine_topk_xla — one pass
    over the chunk matrix — while each sort only spans `block` columns,
    and it never materializes the full [B, N] score matrix. Returns the
    same results. Which form is faster on a GPU is not measured yet.
    """
    n, d = vectors.shape
    b = queries.shape[0]
    n_pad = round_up(n, block)
    nb = n_pad // block
    v = jnp.pad(vectors, ((0, n_pad - n), (0, 0)))
    pen = jnp.pad(penalty, (0, n_pad - n), constant_values=NEG_INF)
    q32 = queries.astype(jnp.float32)
    vb = v.reshape(nb, block, d)
    pb = pen.reshape(nb, block)
    kk = min(k, block)

    def per_block(args):
        vblk, pblk = args
        scores = jnp.dot(q32, vblk.astype(jnp.float32).T, precision=_HIGHEST,
                         preferred_element_type=jnp.float32) + pblk[None, :]
        vals, idx = jax.lax.top_k(scores, kk)  # [B, kk] block-local
        return vals, idx

    vals, idx = jax.lax.map(per_block, (vb, pb))  # [nb, B, kk]
    offsets = (jnp.arange(nb, dtype=jnp.int32) * block)[:, None, None]
    gidx = idx.astype(jnp.int32) + offsets
    all_vals = vals.transpose(1, 0, 2).reshape(b, nb * kk)
    all_idx = gidx.transpose(1, 0, 2).reshape(b, nb * kk)
    out_vals, pos = jax.lax.top_k(all_vals, k)
    out_idx = jnp.take_along_axis(all_idx, pos, axis=1)
    return out_vals, out_idx
