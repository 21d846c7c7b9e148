"""Quantized vector scan: int8 symmetric per-row quantization.

The 10M-chunk config's memory lever (BASELINE.json config 5): fp32
embeddings are 4 bytes/dim; int8 cuts HBM residency and scan bandwidth
4× while recall@10 stays ≥0.99 on L2-normalized embeddings (validated
in tests/test_quant.py and the scale bench). The matmul multiplies int8
operands accumulating in int32; the per-row scale re-enters as a cheap
f32 epilogue multiply.

The reference has no quantization anywhere (vectors live as Postgres
JSONB + pgvector fp32); this is net-new capability this build adds.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np




def fill_cluster_packed(nlist: int, pad: int, enc, out_dtypes, out_widths,
                        *, block: int = 65536):
    """Encode all ``nlist*pad`` cluster slots blockwise and scatter each
    block straight into FINAL-SHAPE donated device buffers.

    The previous pattern in every packed builder — scatter into a flat
    ``[n_flat_padded, w]`` buffer, then ``buf[:n_flat].reshape(nlist,
    pad, w)`` — materializes the multi-GB codes payload up to THREE
    times at the end (original + slice copy + reshape copy): three
    times the codes payload at peak. Scattering cluster-aligned blocks into
    ``[nlist, pad, w]`` directly keeps peak HBM at ONE buffer + one
    block's transients.

    ``enc(lo, hi)`` returns one device array per output for flat slots
    ``[lo, hi)`` (shape ``[hi-lo, w]``, or ``[hi-lo]`` when the spec
    width is 0 → a per-slot ``[nlist, pad]`` output). Block bounds are
    always pad-aligned and exactly ``cpb*pad`` wide; when ``cpb`` does
    not divide ``nlist`` the final block SHIFTS BACK to overlap the
    previous one — enc must therefore be deterministic (every packed
    encoder here is: pure jit of gathered rows)."""
    cpb = max(1, min(nlist, block // max(pad, 1)))

    def buf_shape(w):
        return (nlist, pad) if w == 0 else (nlist, pad, w)

    if nlist <= cpb:  # small corpus: single encode, reshape is cheap
        outs = enc(0, nlist * pad)
        return tuple(o.reshape(buf_shape(w)).astype(dt)
                     for o, w, dt in zip(outs, out_widths, out_dtypes))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scatter(bufs, blks, c_off):
        return tuple(
            jax.lax.dynamic_update_slice_in_dim(
                b, blk.reshape((cpb,) + b.shape[1:]).astype(b.dtype),
                c_off, axis=0)
            for b, blk in zip(bufs, blks))

    bufs = tuple(jnp.zeros(buf_shape(w), dt)
                 for w, dt in zip(out_widths, out_dtypes))
    for c in range(0, nlist, cpb):
        c = min(c, nlist - cpb)  # final partial block: shift back
        blks = enc(c * pad, (c + cpb) * pad)
        bufs = scatter(bufs, tuple(blks), jnp.int32(c))
    return bufs


@jax.jit
def _quantize_block(v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    v32 = v.astype(jnp.float32)
    max_abs = jnp.max(jnp.abs(v32), axis=1)
    scale = jnp.where(max_abs > 0, max_abs / 127.0, 1.0)
    q = jnp.clip(jnp.round(v32 / scale[:, None]), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def quantize_rows(vectors: np.ndarray | jnp.ndarray, *, block: int = 131072
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[N, D] float → (int8 values [N, D], per-row scales [N] f32) with
    symmetric per-row max-abs scaling. Processed in row blocks so the
    transient f32 copy never exceeds ~block×D×4 bytes (a full-corpus f32
    materialization OOMs at the 1M×1536 scale)."""
    v = jnp.asarray(vectors)
    n = v.shape[0]
    if n <= block:
        return _quantize_block(v)
    qs, ss = [], []
    for off in range(0, n, block):
        q, s = _quantize_block(v[off:off + block])
        qs.append(q)
        ss.append(s)
    return jnp.concatenate(qs, axis=0), jnp.concatenate(ss, axis=0)


@functools.partial(jax.jit, static_argnames=("k",))
def cosine_topk_int8(values: jnp.ndarray, scales: jnp.ndarray, queries: jnp.ndarray,
                     penalty: jnp.ndarray, k: int):
    """Masked top-k over an int8-quantized chunk matrix.

    scores[b, n] = (q[b] · values[n]) * scales[n]  — int8×int8→int32
    via an int8-quantized query (per-query scale), then two f32
    scale multiplies in the epilogue.
    """
    qv = queries.astype(jnp.float32)
    q_max = jnp.max(jnp.abs(qv), axis=1)
    q_scale = jnp.where(q_max > 0, q_max / 127.0, 1.0)
    q_int = jnp.clip(jnp.round(qv / q_scale[:, None]), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        q_int, values,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [B, N] int32
    scores = acc.astype(jnp.float32) * q_scale[:, None] * scales[None, :]
    scores = scores + penalty[None, :]
    vals, idx = jax.lax.top_k(scores, k)
    return vals, idx.astype(jnp.int32)
