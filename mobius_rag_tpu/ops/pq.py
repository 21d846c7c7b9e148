"""Product quantization (PQ) for the ≥4M-rows/chip regime.

BASELINE.md build-target config 5 ("10M chunks int8 PQ + fused scan"):
int8 symmetric quantization carries to ~8M rows/chip (1536 B/row);
past that the vector payload itself must shrink. PQ splits each D-dim
row into M subvectors and stores one codebook index per subvector —
M bytes/row (16× smaller than int8 at M = D/16), with scoring done
against per-query lookup tables (ADC, asymmetric distance computation).

Design:
- codebook training is M independent k-means problems — vmapped Lloyd
  iterations over the subvector axis, all on device.
- encoding is blockwise: per block, one [block, M, K] distance einsum +
  argmin. No host loops over rows.
- search reuses the IVF cluster layout (PackedPQ mirrors PackedIVF's
  cluster-contiguous blocks): per query build the [M, K] dot-product
  LUT (one einsum), then each probed cluster block scores as a flat
  gather-sum over its codes — work linear in (probed rows × M)
  instead of matmul/memory work linear in (probed rows × D).

Scoring uses inner-product ADC: score(x, q) ≈ Σ_m LUT[m, code_m(x)]
where LUT[m, j] = q_m · C[m, j]. Codebooks are trained with L2 Lloyd
(the IP-optimal quantizer for unit-norm full vectors decomposed into
subvectors).

RESIDUAL encoding (IVFADC): codes quantize x − centroid(x) instead of x,
and search adds the q·centroid term per probed cluster. The cluster-
center component is the bulk of each row's energy but carries ZERO
within-cluster ranking information — encoding the residual spends the
code bits on what actually ranks neighbors. Measured on the adversarial
isotropic-noise substrate: plain ADC recall@10 0.35 → residual 0.60 →
residual + exact re-rank of the ADC top-100 = 1.00 (the two-stage
production shape: PQ codes in HBM for candidate generation, int8 rows in
host RAM for re-rank — host→device traffic is k·over_fetch rows/query,
a few hundred KB).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.ops.topk import NEG_INF
from mobius_rag_tpu.utils import round_up

K_CODES = 256  # one byte per subvector


def effective_m(d: int, m_requested: int) -> int:
    """Largest usable subvector count ≤ the requested M that divides D
    (config knob MRAG_PQ_M assumes D=1536; other dims — e.g. the test
    env's 256 — fall back to 16-dim subvectors)."""
    if d % m_requested == 0:
        return m_requested
    for ds in (16, 8, 4, 32, 2):
        if d % ds == 0:
            return d // ds
    return 1


@functools.partial(jax.jit, static_argnames=("iters",))
def _pq_kmeans(sub: jnp.ndarray, init: jnp.ndarray, iters: int):
    """Vmapped Lloyd over the subvector axis.
    sub [M, S, ds] training subvectors; init [M, K, ds] → [M, K, ds]."""

    def one_space(x, c0):
        def step(c, _):
            # [S, K] L2 distances via the dot trick
            dots = x @ c.T  # [S, K]
            c2 = (c * c).sum(axis=1)[None, :]
            assign = jnp.argmin(c2 - 2.0 * dots, axis=1)  # [S]
            sums = jax.ops.segment_sum(x, assign, num_segments=c.shape[0])
            counts = jax.ops.segment_sum(
                jnp.ones(assign.shape, jnp.float32), assign,
                num_segments=c.shape[0])
            new = jnp.where(counts[:, None] > 0,
                            sums / jnp.maximum(counts[:, None], 1.0), c)
            return new, None

        c, _ = jax.lax.scan(step, c0, None, length=iters)
        return c

    return jax.vmap(one_space)(sub, init)


def train_pq(vectors, m: int, *, iters: int = 12, sample: int = 100_000,
             seed: int = 0) -> jnp.ndarray:
    """Train PQ codebooks [M, K, ds] on a row sample of `vectors` [N, D].
    D must divide evenly into m subvectors."""
    n, d = vectors.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    ds = d // m
    rng = np.random.default_rng(seed)
    rows = rng.choice(n, size=min(sample, n), replace=False)
    x = jnp.asarray(vectors)[jnp.asarray(np.sort(rows))].astype(jnp.float32)
    sub = x.reshape(-1, m, ds).transpose(1, 0, 2)  # [M, S, ds]
    init_rows = rng.choice(sub.shape[1], size=K_CODES,
                           replace=sub.shape[1] < K_CODES)
    init = sub[:, jnp.asarray(init_rows)]  # [M, K, ds]
    return _pq_kmeans(sub, init, iters)


@jax.jit
def _encode_block(block: jnp.ndarray, codebooks: jnp.ndarray) -> jnp.ndarray:
    """block [B, D] f32 → codes [B, M] uint8 (argmin L2 per subvector)."""
    b, d = block.shape
    m, k, ds = codebooks.shape
    sub = block.reshape(b, m, ds)
    dots = jnp.einsum("bmd,mkd->bmk", sub, codebooks)
    c2 = (codebooks * codebooks).sum(axis=2)[None]  # [1, M, K]
    return jnp.argmin(c2 - 2.0 * dots, axis=2).astype(jnp.uint8)


def encode_pq(vectors, codebooks, *, block: int = 65536) -> np.ndarray:
    """Encode [N, D] → [N, M] uint8, blockwise on device, assembled on
    host (one transfer per block; no N-sized f32 transient)."""
    n = vectors.shape[0]
    m = codebooks.shape[0]
    out = np.empty((n, m), np.uint8)
    v = jnp.asarray(vectors)
    for off in range(0, n, block):
        blk = v[off:off + block].astype(jnp.float32)
        out[off:off + blk.shape[0]] = np.asarray(
            jax.device_get(_encode_block(blk, codebooks)))
    return out


@jax.tree_util.register_pytree_node_class
class PackedPQ:
    """Cluster-contiguous PQ codes over an IVF layout (PackedIVF's
    block shape, with M-byte codes instead of D-byte int8 rows)."""

    FIELDS = ("centroids", "codes", "codebooks", "valid", "rowids")

    def __init__(self, centroids, codes, codebooks, valid, rowids,
                 nlist: int, pad: int, base_nlist: int | None = None,
                 residual: bool = True):
        self.centroids = centroids  # [nlist, D] f32
        self.codes = codes  # [nlist, pad, M] uint8
        self.codebooks = codebooks  # [M, K, ds] f32
        self.valid = valid  # [nlist, pad] f32
        self.rowids = rowids  # [nlist, pad] i32
        self.nlist = nlist
        self.pad = pad
        self.base_nlist = base_nlist if base_nlist is not None else nlist
        self.residual = residual  # codes quantize x − centroid(x)

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self.FIELDS),
                (self.nlist, self.pad, self.base_nlist, self.residual))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, nlist=aux[0], pad=aux[1], base_nlist=aux[2],
                   residual=aux[3])

    @property
    def bytes_per_row(self) -> int:
        return int(self.codes.shape[-1])

    @classmethod
    def from_ivf(cls, ivf, vectors, *, m: int = 96, iters: int = 12,
                 row_scales=None, seed: int = 0, residual: bool = True,
                 block: int = 65536) -> "PackedPQ":
        """Train codebooks + pack codes cluster-contiguously. Mirrors
        PackedIVF.from_ivf (spill rows fold into synthetic clusters).
        When `vectors` is an int8 store, pass `row_scales` so training/
        encoding sees the dequantized values. residual=True (IVFADC)
        quantizes x − centroid(x). `vectors` may be a HOST numpy matrix
        (the codes-only 10M regime): row gathers then happen host-side
        and only the gathered block crosses to the device."""
        host_side = isinstance(vectors, np.ndarray)
        if host_side:
            scales_np = (np.asarray(row_scales) if row_scales is not None
                         else None)

            def rows_f32(idx) -> jnp.ndarray:
                # gather host-side, ship the RAW dtype (a quarter of
                # the f32 bytes), dequantize on device
                rows_np = np.asarray(idx)
                blk = jnp.asarray(vectors[rows_np]).astype(jnp.float32)
                if scales_np is not None:
                    blk = blk * jnp.asarray(scales_np[rows_np])[:, None]
                return blk
        else:
            v = jnp.asarray(vectors)
            if row_scales is not None:
                scales = jnp.asarray(row_scales)

            def rows_f32(idx) -> jnp.ndarray:
                out = jnp.take(v, jnp.asarray(idx), axis=0).astype(jnp.float32)
                if row_scales is not None:
                    out = out * jnp.take(scales, jnp.asarray(idx))[:, None]
                return out

        members = np.asarray(ivf.members)
        mvalid = np.asarray(ivf.member_valid)
        spill = np.asarray(ivf.spill)[np.asarray(ivf.spill_valid) > 0]
        pad = ivf.pad
        extra = int(np.ceil(len(spill) / pad)) if len(spill) else 0
        nlist = ivf.nlist + extra
        rowids = np.zeros((nlist, pad), np.int32)
        valid = np.zeros((nlist, pad), np.float32)
        rowids[: ivf.nlist] = members
        valid[: ivf.nlist] = mvalid
        for e in range(extra):
            seg = spill[e * pad:(e + 1) * pad]
            rowids[ivf.nlist + e, : len(seg)] = seg
            valid[ivf.nlist + e, : len(seg)] = 1.0

        # full centroid table (incl. synthetic spill slabs) BEFORE
        # encoding — residual codes need every row's owning centroid
        cents = np.asarray(ivf.centroids, np.float32)
        if extra:
            extra_cents = []
            for e in range(extra):
                seg = spill[e * pad:(e + 1) * pad]
                mvec = np.asarray(jax.device_get(
                    rows_f32(jnp.asarray(seg)))).mean(axis=0)
                extra_cents.append(mvec / max(np.linalg.norm(mvec), 1e-6))
            cents = np.concatenate([cents, np.stack(extra_cents)], axis=0)

        flat = rowids.reshape(-1)
        flat_cell = np.repeat(np.arange(nlist), pad)
        flat_valid = valid.reshape(-1) > 0
        if not flat_valid.any():
            # empty (sub)corpus — e.g. one shard of a tiny sharded store
            ds = vectors.shape[1] // m
            return cls(jnp.asarray(cents),
                       jnp.zeros((nlist, pad, m), jnp.uint8),
                       jnp.zeros((m, K_CODES, ds), jnp.float32),
                       jnp.asarray(valid), jnp.asarray(rowids),
                       nlist, pad, base_nlist=ivf.nlist, residual=residual)

        # encode source stays ON DEVICE end-to-end: the only transfers
        # are the raw int8 row gather up and the m-byte codes down — no
        # host f32 round trip per block.
        cents_dev = jnp.asarray(cents)

        def encode_src(slots: np.ndarray) -> jnp.ndarray:
            rows = rows_f32(flat[slots])  # device f32 [S, D]
            if residual:
                rows = rows - cents_dev[jnp.asarray(flat_cell[slots])]
            return rows

        rng = np.random.default_rng(seed)
        live_slots = np.flatnonzero(flat_valid)
        pick = np.sort(rng.choice(live_slots,
                                  size=min(100_000, len(live_slots)),
                                  replace=False))
        sample = encode_src(pick)
        codebooks = train_pq(sample, m, iters=iters, sample=len(pick),
                             seed=seed)
        del sample

        # codes scatter cluster-aligned into a FINAL-SHAPE donated
        # DEVICE buffer — they never touch the host (no device→host
        # bounce of the codes), and peak HBM is one
        # codes buffer (see ops.quant.fill_cluster_packed for why the
        # flat-buffer + slice/reshape tail tripled it). Host→device
        # traffic stays one pass of raw int8 rows via encode_src.
        from mobius_rag_tpu.ops.quant import fill_cluster_packed

        (codes,) = fill_cluster_packed(
            nlist, pad,
            lambda lo, hi: (_encode_block(
                encode_src(np.arange(lo, hi)), codebooks),),
            (jnp.uint8,), (m,), block=block)
        return cls(jnp.asarray(cents), codes, codebooks, jnp.asarray(valid),
                   jnp.asarray(rowids), nlist, pad, base_nlist=ivf.nlist,
                   residual=residual)


def stack_shard_pq(shards: "list[PackedPQ]") -> PackedPQ:
    """Leading-shard-axis stack of per-shard PackedPQ tables (the pq
    analogue of index.ivf.stack_shard_packed — see its invariants).
    Every shard trains its OWN codebooks; they stack along the shard
    axis like every other leaf. base_nlist unifies to the max; cells a
    shard doesn't really have are fully invalid."""
    base = max(s.base_nlist for s in shards)
    extra = max(s.nlist - s.base_nlist for s in shards)
    nlist, pad = base + extra, max(s.pad for s in shards)
    m = shards[0].codes.shape[-1]
    d = shards[0].centroids.shape[-1]
    residual = shards[0].residual
    cols = {f: [] for f in PackedPQ.FIELDS}
    for sh in shards:
        assert sh.residual == residual and sh.codes.shape[-1] == m
        c = np.zeros((nlist, d), np.float32)
        codes = np.zeros((nlist, pad, m), np.uint8)
        ok = np.zeros((nlist, pad), np.float32)
        rid = np.zeros((nlist, pad), np.int32)
        nb, ne = sh.base_nlist, sh.nlist - sh.base_nlist
        src = {f: np.asarray(getattr(sh, f)) for f in PackedPQ.FIELDS}
        for dst_lo, src_lo, n in ((0, 0, nb), (base, nb, ne)):
            c[dst_lo:dst_lo + n] = src["centroids"][src_lo:src_lo + n]
            codes[dst_lo:dst_lo + n, : sh.pad] = src["codes"][src_lo:src_lo + n]
            ok[dst_lo:dst_lo + n, : sh.pad] = src["valid"][src_lo:src_lo + n]
            rid[dst_lo:dst_lo + n, : sh.pad] = src["rowids"][src_lo:src_lo + n]
        for f, a in zip(PackedPQ.FIELDS,
                        (c, codes, src["codebooks"], ok, rid)):
            cols[f].append(a)
    return PackedPQ(**{f: np.stack(v) for f, v in cols.items()},
                    nlist=nlist, pad=pad, base_nlist=base, residual=residual)


@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def pq_search_packed(ppq: PackedPQ, queries: jnp.ndarray,
                     penalty: jnp.ndarray, k: int, nprobe: int):
    """Probed masked top-k over PQ codes (ADC). penalty indexes global
    row ids; [C] shared or [B, C] per-query.

    Scans over probe RANK with the whole query batch per step: step p
    gathers every query's p-th cluster's codes [B, pad, M] and scores
    them via per-query LUT gathers — nprobe VPU-wide steps instead of
    B·nprobe scalar-latency-bound micro-ops."""
    b = queries.shape[0]
    q32 = queries.astype(jnp.float32)
    if penalty.ndim == 1:
        penalty = jnp.broadcast_to(penalty[None, :], (b, penalty.shape[0]))
    m, kk, ds = ppq.codebooks.shape

    # full centroid scores [B, nlist]: routing over base cells AND the
    # residual add-back term (spill slabs included)
    cscores = jnp.dot(q32, ppq.centroids.T, preferred_element_type=jnp.float32)
    p_eff = min(nprobe, ppq.base_nlist)
    _, probe = jax.lax.top_k(cscores[:, : ppq.base_nlist], p_eff)
    n_spill = ppq.nlist - ppq.base_nlist
    if n_spill:  # spill slabs (capacity-assign leftovers) always probed
        spill_cells = jnp.broadcast_to(
            jnp.arange(ppq.base_nlist, ppq.nlist, dtype=probe.dtype)[None, :],
            (b, n_spill))
        probe = jnp.concatenate([probe, spill_cells], axis=1)

    # per-query ADC lookup table [M, K], flattened for one-gather scoring
    luts = jnp.einsum("bmd,mkd->bmk", q32.reshape(b, m, ds), ppq.codebooks)
    lut_flat = luts.reshape(b, m * kk)
    code_base = jnp.arange(m, dtype=jnp.int32) * kk  # [M]

    def scan_probe(carry, pc):
        best_v, best_i = carry  # [B, k]
        codes = jnp.take(ppq.codes, pc, axis=0)  # [B, pad, M]
        ok = jnp.take(ppq.valid, pc, axis=0)  # [B, pad]
        rid = jnp.take(ppq.rowids, pc, axis=0)
        idx = codes.astype(jnp.int32) + code_base[None, None, :]
        s = jax.vmap(jnp.take)(lut_flat, idx.reshape(b, -1)) \
            .reshape(idx.shape).sum(axis=2)  # [B, pad]
        if ppq.residual:  # IVFADC: q·x ≈ q·centroid + q·residual
            s = s + jnp.take_along_axis(cscores, pc[:, None], axis=1)
        s = s + jnp.take_along_axis(penalty, rid, axis=1) \
            + (1.0 - ok) * NEG_INF
        vals = jnp.concatenate([best_v, s], axis=1)
        ids = jnp.concatenate([best_i, rid], axis=1)
        nv, pos = jax.lax.top_k(vals, k)
        return (nv, jnp.take_along_axis(ids, pos, axis=1)), None

    # carry seeded from the shard-varying penalty — see
    # index.ivf.ivf_search_packed for why a constant init fails
    # under shard_map
    veps = penalty[:, :1] * 0.0  # [B, 1]
    init = (jnp.full((b, k), NEG_INF, jnp.float32) + veps,
            jnp.zeros((b, k), jnp.int32) + veps.astype(jnp.int32))
    (vals, idx), _ = jax.lax.scan(scan_probe, init, probe.T)
    return vals, idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def _rerank_scores(cand_vecs: jnp.ndarray, cand_scales: jnp.ndarray,
                   queries: jnp.ndarray) -> jnp.ndarray:
    """[B, R, D] candidate rows (any dtype) × [B, D] queries → [B, R]."""
    s = jnp.einsum("brd,bd->br", cand_vecs.astype(jnp.float32),
                   queries.astype(jnp.float32))
    return s * cand_scales


def pq_search_reranked(ppq: PackedPQ, queries, penalty, k: int, nprobe: int,
                       host_vectors: np.ndarray,
                       host_scales: np.ndarray | None = None,
                       over_fetch: int = 10):
    """Two-stage PQ search: ADC candidate generation on device (top
    k·over_fetch), then EXACT re-rank of the candidates against rows
    gathered from HOST memory (the int8 matrix lives in host RAM at the
    ≥4M regime — HBM holds only the codes). Host→device traffic is
    B·k·over_fetch rows/query batch (~a few MB)."""
    r = k * over_fetch
    cand_vals, cand_idx = pq_search_packed(ppq, queries, penalty, r, nprobe)
    idx_np = np.asarray(jax.device_get(cand_idx))  # [B, R]
    vals_np = np.asarray(jax.device_get(cand_vals))
    gathered = host_vectors[idx_np]  # [B, R, D] host fancy-index
    scales = (host_scales[idx_np] if host_scales is not None
              else np.ones(idx_np.shape, np.float32))
    scores = _rerank_scores(jnp.asarray(gathered), jnp.asarray(scales),
                            jnp.asarray(queries))
    # dead ADC candidates stay dead through the re-rank
    scores = jnp.where(jnp.asarray(vals_np) > NEG_INF / 2, scores, NEG_INF)
    vals, pos = jax.lax.top_k(scores, k)
    idx = jnp.take_along_axis(jnp.asarray(idx_np), pos, axis=1)
    return vals, idx.astype(jnp.int32)
