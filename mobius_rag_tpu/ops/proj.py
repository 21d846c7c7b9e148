"""Projected-residual ANN codes: the int8-matmul compression for the
≥4M-rows-per-card regime (BASELINE.md build-target config 5).

Why this exists next to ops/pq.py: classic LUT-PQ (ADC) scoring is a
per-element table gather per code byte. This module spends the code
bytes on a dense low-rank view instead of subvector codebooks, so
scoring is a matmul rather than a gather:

    code(x)  = int8( P (x − centroid(x)) )          # P: [p, D] PCA rows
    score(q) ≈ q·centroid + (Pq) · dequant(code)    # one int8 matmul

- candidate scoring per probed cluster is a [pad, p] × [p] int8
  dot_general with int32 accumulation, the same shape
  ivf_search_packed runs, with 6-16× less memory traffic than full-D
  int8;
- the projection is the top-p principal subspace of the coarse
  residuals, so the discarded dimensions are the lowest-variance ones
  the corpus has (covariance accumulated blockwise on device, eigh on
  device);
- ranking error inside the funnel is repaired by the exact host re-rank
  (SearchEngine._host_rerank) over the top-W candidates, same two-stage
  shape as IVFADC — see MRAG_HOST_FUNNEL.

Whether proj still beats LUT-PQ on a GPU, whose gathers are not
serialized, is not measured yet (ROADMAP 3.2).

Reference parity anchor: this plays pgvector's HNSW role
(vector_store.py:274-287) at corpus scales where neither a dense scan
nor a graph index fits the card.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.ops.topk import NEG_INF, merged_topk

# The query-side dots (probe choice, int8 query code) are [B, D] small;
# full float32 keeps them off TF32, so a GPU probes the same clusters
# and quantizes the same query code as the CPU reference.
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
class PackedProj:
    """Cluster-contiguous int8 projected-residual codes over an IVF
    layout (PackedIVF's block shape with p-byte rows + the projection
    matrix)."""

    FIELDS = ("centroids", "proj", "codes", "scales", "valid", "rowids")

    def __init__(self, centroids, proj, codes, scales, valid, rowids,
                 nlist: int, pad: int, base_nlist: int | None = None,
                 reserve_start: int | None = None):
        self.centroids = centroids  # [nlist, D] f32
        self.proj = proj  # [p, D] f32 orthonormal rows
        self.codes = codes  # [nlist, pad, p] int8
        self.scales = scales  # [nlist, pad] f32 dequant scales
        self.valid = valid  # [nlist, pad] f32
        self.rowids = rowids  # [nlist, pad] i32 global row ids
        self.nlist = nlist
        self.pad = pad
        self.base_nlist = base_nlist if base_nlist is not None else nlist
        # First reserved (streaming-insert) slab; == nlist when none.
        # Static aux so it survives save/load and pytree round trips.
        self.reserve_start = (reserve_start if reserve_start is not None
                              else nlist)

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self.FIELDS),
                (self.nlist, self.pad, self.base_nlist, self.reserve_start))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, nlist=aux[0], pad=aux[1], base_nlist=aux[2],
                   reserve_start=aux[3] if len(aux) > 3 else None)

    @property
    def bytes_per_row(self) -> int:
        return int(self.codes.shape[-1])

    @classmethod
    def from_ivf(cls, ivf, vectors, *, p: int = 256, row_scales=None,
                 sample: int = 200_000, seed: int = 0,
                 block: int = 65536, reserve_slabs: int = 0) -> "PackedProj":
        """Fit the residual PCA + encode all rows cluster-contiguously.

        `vectors` may be a HOST numpy int8 matrix (the codes-only 10M
        regime — gathers happen host-side, raw int8 crosses to the
        device) or a device array. `row_scales` dequantizes int8
        storage. Mirrors PackedPQ.from_ivf's spill handling: overflow
        rows fold into synthetic always-probed slabs.

        ``reserve_slabs`` appends that many EMPTY always-probed slabs
        (zero centroid, valid 0) as streaming-insert headroom: the
        engine's incremental path (SearchEngine._try_ann_incremental)
        encodes published rows into these slots instead of re-running
        the k-means build — a full rebuild re-runs host k-means over
        every row, with buffers that compete with serving (the
        reference's pgvector HNSW likewise inserts incrementally;
        republish is its steady state, publish.py:27-481). Host mirrors of the slot
        layout (``build_rowids``/``build_valid``, numpy) ride on the
        instance for the engine's row→slot map; they are NOT pytree
        children and vanish across tree ops — only the build-time
        object carries them."""
        host_side = isinstance(vectors, np.ndarray)
        d = vectors.shape[1]
        p = int(min(p, d))
        if host_side:
            scales_np = (np.asarray(row_scales) if row_scales is not None
                         else None)

            def rows_f32(idx) -> jnp.ndarray:
                rows_np = np.asarray(idx)
                blk = jnp.asarray(vectors[rows_np]).astype(jnp.float32)
                if scales_np is not None:
                    blk = blk * jnp.asarray(scales_np[rows_np])[:, None]
                return blk
        else:
            v = jnp.asarray(vectors)
            scl = (jnp.asarray(row_scales) if row_scales is not None
                   else None)

            def rows_f32(idx) -> jnp.ndarray:
                out = jnp.take(v, jnp.asarray(idx), axis=0).astype(jnp.float32)
                if scl is not None:
                    out = out * jnp.take(scl, jnp.asarray(idx))[:, None]
                return out

        members = np.asarray(ivf.members)
        mvalid = np.asarray(ivf.member_valid)
        spill = np.asarray(ivf.spill)[np.asarray(ivf.spill_valid) > 0]
        pad = ivf.pad
        extra = int(np.ceil(len(spill) / pad)) if len(spill) else 0
        nlist = ivf.nlist + extra + reserve_slabs
        rowids = np.zeros((nlist, pad), np.int32)
        valid = np.zeros((nlist, pad), np.float32)
        rowids[: ivf.nlist] = members
        valid[: ivf.nlist] = mvalid
        for e in range(extra):
            seg = spill[e * pad:(e + 1) * pad]
            rowids[ivf.nlist + e, : len(seg)] = seg
            valid[ivf.nlist + e, : len(seg)] = 1.0

        cents = np.asarray(ivf.centroids, np.float32)
        if extra:
            for e in range(extra):
                seg = spill[e * pad:(e + 1) * pad]
                mvec = np.asarray(jax.device_get(
                    rows_f32(seg))).mean(axis=0)
                cents = np.concatenate(
                    [cents, (mvec / max(np.linalg.norm(mvec), 1e-6))[None]],
                    axis=0)
        if reserve_slabs:
            # zero centroids: reserved-slab scores are purely the
            # projected code (residual vs 0 = the row itself)
            cents = np.concatenate(
                [cents, np.zeros((reserve_slabs, d), np.float32)], axis=0)
        cents_dev = jnp.asarray(cents)

        flat = rowids.reshape(-1)
        flat_cell = np.repeat(np.arange(nlist), pad)
        flat_valid = valid.reshape(-1) > 0
        if not flat_valid.any():
            # empty (sub)corpus — e.g. one shard of a tiny sharded store
            eye = jnp.eye(p, d, dtype=jnp.float32)
            obj = cls(cents_dev, eye,
                      jnp.zeros((nlist, pad, p), jnp.int8),
                      jnp.zeros((nlist, pad), jnp.float32),
                      jnp.asarray(valid), jnp.asarray(rowids),
                      nlist, pad, base_nlist=ivf.nlist,
                      reserve_start=nlist - reserve_slabs)
            obj.build_rowids, obj.build_valid = rowids, valid
            return obj

        # ---- residual PCA: blockwise covariance + device eigh ----
        @jax.jit
        def cov_block(rows, cell_c):
            r = rows - cell_c
            return r.T @ r

        rng = np.random.default_rng(seed)
        live_slots = np.flatnonzero(flat_valid)
        pick = np.sort(rng.choice(live_slots,
                                  size=min(sample, len(live_slots)),
                                  replace=False))
        # fixed cov blocking (NOT the scatter `block`): f32 summation
        # order pins the eigh result, so the fitted projection — and
        # therefore the codes — are deterministic w.r.t. `block`
        cov_blk = 65536
        cov = jnp.zeros((d, d), jnp.float32)
        for off in range(0, len(pick), cov_blk):
            sl = pick[off:off + cov_blk]
            cov = cov + cov_block(rows_f32(flat[sl]),
                                  cents_dev[jnp.asarray(flat_cell[sl])])
        _, evecs = jnp.linalg.eigh(cov)  # ascending eigenvalues
        proj = evecs[:, -p:].T  # [p, D] top principal rows

        # ---- encode every slot, scattering cluster-aligned blocks into
        # FINAL-SHAPE donated buffers (nothing round-trips to the host;
        # peak HBM = one codes buffer — see ops.quant.fill_cluster_packed
        # for why the old flat-buffer + slice/reshape tail OOMed) ----
        from mobius_rag_tpu.ops.quant import fill_cluster_packed

        @jax.jit
        def enc_block(rows, cell_c, pm):
            pr = (rows - cell_c) @ pm.T  # [S, p]
            mx = jnp.maximum(jnp.max(jnp.abs(pr), axis=1), 1e-9)
            scale = mx / 127.0
            q8 = jnp.round(pr / scale[:, None]).astype(jnp.int8)
            return q8, scale

        def enc(lo, hi):
            sl = np.arange(lo, hi)
            return enc_block(rows_f32(flat[sl]),
                             cents_dev[jnp.asarray(flat_cell[sl])], proj)

        codes, scales = fill_cluster_packed(
            nlist, pad, enc, (jnp.int8, jnp.float32), (p, 0), block=block)
        obj = cls(cents_dev, proj, codes, scales, jnp.asarray(valid),
                  jnp.asarray(rowids), nlist, pad, base_nlist=ivf.nlist,
                  reserve_start=nlist - reserve_slabs)
        obj.build_rowids, obj.build_valid = rowids, valid
        return obj


# ---------------------------------------------------------------------------
# Incremental mutation (streaming publish/delete without a k-means rebuild)
# ---------------------------------------------------------------------------
# The engine (SearchEngine._try_ann_incremental) owns the bookkeeping
# (row→slot map, reserved-slot cursor); these are the device halves. All
# index arrays are padded to fixed blocks by the caller so XLA compiles
# ONE scatter program per block size, not one per batch length — pads
# repeat the last (cell, slot, value) triple, and duplicate scatter
# writes of identical values are harmless.

@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def scatter_slots(codes, scales, valid, rowids, cells, slots,
                  new_codes, new_scales, new_valid, new_rowids):
    """Write encoded rows into (cell, slot) positions in place (donated
    buffers — no second copy of the multi-GB codes array)."""
    return (codes.at[cells, slots].set(new_codes),
            scales.at[cells, slots].set(new_scales),
            valid.at[cells, slots].set(new_valid),
            rowids.at[cells, slots].set(new_rowids))


@functools.partial(jax.jit, donate_argnums=(0,))
def invalidate_slots(valid, cells, slots):
    """Mask deleted rows' slots (codes stay — NEG_INF gating is enough)."""
    return valid.at[cells, slots].set(0.0)


@jax.jit
def encode_reserved(proj, rows_f32):
    """Encode rows for a RESERVED slab (zero centroid → the code is the
    projection of the row itself, same int8 shape as enc_block)."""
    pr = rows_f32 @ proj.T  # [n, p]
    mx = jnp.maximum(jnp.max(jnp.abs(pr), axis=1), 1e-9)
    scale = mx / 127.0
    return jnp.round(pr / scale[:, None]).astype(jnp.int8), scale


def stack_shard_proj(shards: "list[PackedProj]") -> PackedProj:
    """Leading-shard-axis stack (see index.ivf.stack_shard_ivf for the
    invariants). Each shard keeps its OWN projection + centroids; cells
    a shard doesn't have are fully invalid, zero centroids score 0."""
    base = max(s.base_nlist for s in shards)
    extra = max(s.nlist - s.base_nlist for s in shards)
    nlist, pad = base + extra, max(s.pad for s in shards)
    p = shards[0].codes.shape[-1]
    d = shards[0].centroids.shape[-1]
    cols = {f: [] for f in PackedProj.FIELDS}
    for sh in shards:
        assert sh.codes.shape[-1] == p
        c = np.zeros((nlist, d), np.float32)
        codes = np.zeros((nlist, pad, p), np.int8)
        sc = np.zeros((nlist, pad), np.float32)
        ok = np.zeros((nlist, pad), np.float32)
        rid = np.zeros((nlist, pad), np.int32)
        nb, ne = sh.base_nlist, sh.nlist - sh.base_nlist
        src = {f: np.asarray(getattr(sh, f)) for f in PackedProj.FIELDS}
        for dst_lo, src_lo, n in ((0, 0, nb), (base, nb, ne)):
            c[dst_lo:dst_lo + n] = src["centroids"][src_lo:src_lo + n]
            codes[dst_lo:dst_lo + n, : sh.pad] = src["codes"][src_lo:src_lo + n]
            sc[dst_lo:dst_lo + n, : sh.pad] = src["scales"][src_lo:src_lo + n]
            ok[dst_lo:dst_lo + n, : sh.pad] = src["valid"][src_lo:src_lo + n]
            rid[dst_lo:dst_lo + n, : sh.pad] = src["rowids"][src_lo:src_lo + n]
        for f, a in zip(PackedProj.FIELDS,
                        (c, src["proj"], codes, sc, ok, rid)):
            cols[f].append(a)
    return PackedProj(**{f: np.stack(v) for f, v in cols.items()},
                      nlist=nlist, pad=pad, base_nlist=base)


def query_side(pp: PackedProj, q32: jnp.ndarray, nprobe: int):
    """Per-query work shared by both probed scans: centroid scores
    [B, nlist], probed cells [B, P] (the top-``nprobe`` base cells, then
    every synthetic spill/reserve slab), and the int8 query code with
    its dequant scale (symmetric quantization of the projected query,
    the same shape as ivf_search_packed: int8×int8 → int32, rescale
    after)."""
    b = q32.shape[0]
    cscores = jnp.dot(q32, pp.centroids.T, precision=_HIGHEST,
                      preferred_element_type=jnp.float32)  # [B, nlist]
    p_eff = min(nprobe, pp.base_nlist)
    _, probe = jax.lax.top_k(cscores[:, : pp.base_nlist], p_eff)
    n_spill = pp.nlist - pp.base_nlist
    if n_spill:
        spill_cells = jnp.broadcast_to(
            jnp.arange(pp.base_nlist, pp.nlist, dtype=probe.dtype)[None, :],
            (b, n_spill))
        probe = jnp.concatenate([probe, spill_cells], axis=1)
    qp = jnp.dot(q32, pp.proj.T, precision=_HIGHEST)  # [B, p]
    qmax = jnp.maximum(jnp.max(jnp.abs(qp), axis=1), 1e-9)
    q_scale = qmax / 127.0
    q8 = jnp.round(qp / q_scale[:, None]).astype(jnp.int8)
    return cscores, probe, q8, q_scale


def block_dots(blk: jnp.ndarray, q8: jnp.ndarray) -> jnp.ndarray:
    """Raw scores of one probed block per query: blk [B, pad, p] int8 ·
    q8 [B, p] int8 → [B, pad] int32. Integer-exact: |dot| ≤ p·128² stays
    far inside int32."""
    return jax.lax.dot_general(
        blk, q8, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "approx"))
def proj_search_packed(pp: PackedProj, queries: jnp.ndarray,
                       penalty: jnp.ndarray, k: int, nprobe: int,
                       approx: float = 0.0):
    """Probed masked top-k over projected-residual codes. penalty
    indexes GLOBAL row ids, [C] shared or [B, C] per-query (same
    contract as every other scan op). Returns (scores [B, k], global
    row ids [B, k]); scores approximate cosine for eligible rows.

    Scans over probe RANK with the whole query batch per step: step j
    gathers every query's j-th cluster block [B, pad, p] and scores it
    as one batched int8 dot_general — nprobe batched matmul steps, not
    B·nprobe scalar micro-ops. The raw int8 dots accumulate in int32 and
    are exact. Synthetic spill slabs (cells ≥ base_nlist) are always
    probed. Probe scores accumulate as scan outputs and the
    top-k runs ONCE at the end (ops.topk.merged_topk — optionally
    approx_max_k via ``approx``); a per-step running top-k was
    sort-bound at funnel widths."""
    b = queries.shape[0]
    q32 = queries.astype(jnp.float32)
    if penalty.ndim == 1:
        penalty = jnp.broadcast_to(penalty[None, :], (b, penalty.shape[0]))

    cscores, probe, q8, q_scale = query_side(pp, q32, nprobe)

    def scan_probe(tok, pc):
        blk = jnp.take(pp.codes, pc, axis=0)  # [B, pad, p] int8
        sc = jnp.take(pp.scales, pc, axis=0)  # [B, pad]
        ok = jnp.take(pp.valid, pc, axis=0)
        rid = jnp.take(pp.rowids, pc, axis=0)
        acc = block_dots(blk, q8).astype(jnp.float32)  # [B, pad]
        s = acc * sc * q_scale[:, None] \
            + jnp.take_along_axis(cscores, pc[:, None], axis=1) \
            + jnp.take_along_axis(penalty, rid, axis=1) \
            + (1.0 - ok) * NEG_INF
        return tok, (s + tok, rid)

    # carry seeded from the shard-varying penalty (see
    # index.ivf.ivf_search_packed for why a constant init fails under
    # shard_map); it also rides the ys so they stay axis-varying
    veps = penalty[:, :1] * 0.0  # [B, 1]
    _, (ss, rids) = jax.lax.scan(scan_probe, veps, probe.T)
    vals = jnp.moveaxis(ss, 0, 1).reshape(b, -1)  # [B, P*pad]
    ids = jnp.moveaxis(rids, 0, 1).reshape(b, -1)
    nv, ni = merged_topk(vals, ids, k, approx)
    return nv, ni.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Candidate-local gating: the [B, C]-free config-5 query program
# ---------------------------------------------------------------------------
# At 10M rows the dense filter gate (strict/relaxed/open masks +
# penalty, each [B, C]) and its scattered per-candidate gather inside
# the scan are corpus-sized work per batch. ProjGate packs every
# per-row input of the filter gate (query/engine.py filter_masks
# semantics; reference SQL WHERE at
# corpus_search.py:1427-1555) into the SAME cluster-contiguous layout
# as the codes, so the probed scan evaluates eligibility on the blocks
# it already streams — no corpus-sized per-query buffer exists at all.

def gate_width(tw: int) -> int:
    """Word count W of the slot-word array, rounded up to a multiple of
    8 with zero words. Word-row layout (see ProjGate):
      0 payer|state · 1 program|flags · 2 scale(f32 bits) · 3 rowid ·
      4..4+tw j · 4+tw..4+2tw d · 4+2tw..4+3tw p · zero-padding."""
    return -(-(4 + 3 * tw) // 8) * 8


class ProjGate:
    """Cluster-layout eligibility pack for a PackedProj table:
    ONE word-major array ``words [nlist, W, pad]`` i32 (layout in
    :func:`gate_width`). Word-major keeps the long pad axis minor, so
    one probed block is W contiguous rows of pad words, and the dequant
    scale + rowid ride the same gather as the gate words (no separate
    per-slot streams)."""

    def __init__(self, words, tw: int):
        self.words, self.tw = words, int(tw)

    @staticmethod
    def pack_rows(index, rows) -> jnp.ndarray:
        """Per-row packed gate words [n, 2 + 3TW] i32 for `rows` of the
        DeviceIndex (elementwise encode + row gather — used by the full
        build and by the engine's incremental insert path)."""
        rid = jnp.asarray(rows, jnp.int32)
        c = index.valid.shape[0]
        safe = jnp.clip(rid, 0, c - 1)

        def enc16(col):
            v = jnp.take(col, safe)
            return jnp.where(v < 0, jnp.int32(0xFFFF), v) & jnp.int32(0xFFFF)

        payer_raw = jnp.take(index.payer, safe)
        w0 = enc16(index.payer) | (enc16(index.state) << 16)
        valid = (jnp.take(index.valid, safe) > 0) & (rid >= 0) & (rid < c)
        reg = (jnp.take(index.authority, safe) >= 0.999) & (payer_raw < 0)
        w1 = (enc16(index.program)
              | (valid.astype(jnp.int32) << 16)
              | (reg.astype(jnp.int32) << 17))
        jw = _as_i32(jnp.take(index.j_tags, safe, axis=0))
        dw = _as_i32(jnp.take(index.d_tags, safe, axis=0))
        pw = _as_i32(jnp.take(index.p_tags, safe, axis=0))
        return jnp.concatenate(
            [w0[:, None], w1[:, None], jw, dw, pw], axis=1)

    @staticmethod
    def slot_words(packed, scales, rowids, tw: int) -> jnp.ndarray:
        """[n, W] slot words from pack_rows output + per-slot dequant
        scales (f32, bitcast into word 2) + row ids (word 3)."""
        w = gate_width(tw)
        n = packed.shape[0]
        cols = [packed[:, :2],
                jax.lax.bitcast_convert_type(
                    scales.astype(jnp.float32), jnp.int32)[:, None],
                jnp.asarray(rowids, jnp.int32)[:, None],
                packed[:, 2:]]
        out = jnp.concatenate(cols, axis=1)
        if out.shape[1] < w:
            out = jnp.concatenate(
                [out, jnp.zeros((n, w - out.shape[1]), jnp.int32)], axis=1)
        return out

    @classmethod
    def build(cls, pp: PackedProj, index) -> "ProjGate":
        tw = index.j_tags.shape[1]
        nlist, pad = pp.rowids.shape
        words = _gate_build_jit(index, pp.rowids, pp.valid, pp.scales, tw)
        return cls(words, tw)

    def scatter(self, cells, slots, packed, scales, rowids) -> None:
        """Write freshly packed rows into (cell, slot) positions (the
        engine's incremental insert path; donated in-place update)."""
        vals = ProjGate.slot_words(packed, scales, rowids, self.tw)
        self.words = _gate_scatter(self.words, cells, slots, vals)

    def invalidate(self, cells, slots) -> None:
        self.words = _gate_invalidate(self.words, cells, slots)


def _as_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32) \
        if x.dtype != jnp.int32 else x


@functools.partial(jax.jit, static_argnames=("tw",))
def _gate_build_jit(index, rowids, valid, scales, tw: int):
    nlist, pad = rowids.shape
    packed = ProjGate.pack_rows(index, rowids.reshape(-1))
    # slots without a live row must carry valid=0 whatever row id the
    # pad slot holds
    slot_ok = (valid.reshape(-1) > 0)
    w1 = jnp.where(slot_ok, packed[:, 1],
                   packed[:, 1] & ~jnp.int32(1 << 16))
    packed = packed.at[:, 1].set(w1)
    flat = ProjGate.slot_words(packed, scales.reshape(-1),
                               rowids.reshape(-1), tw)  # [S, W]
    w = flat.shape[1]
    return flat.reshape(nlist, pad, w).transpose(0, 2, 1)  # [nlist, W, pad]


@functools.partial(jax.jit, donate_argnums=(0,))
def _gate_scatter(words, cells, slots, vals):
    return words.at[cells, :, slots].set(vals)


@functools.partial(jax.jit, donate_argnums=(0,))
def _gate_invalidate(words, cells, slots):
    w1 = words[cells, 1, slots] & ~jnp.int32(1 << 16)
    return words.at[cells, 1, slots].set(w1)


def encode_qmeta(q: dict, strict_ok) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-query gate params for the gated scan: qmeta [B, 8] i32 and
    qbits [B, 3TW] i32. Metadata ids re-encode into the pack's u16
    space (-1 "any" → 0xFFFE, -2 "unknown value, match nothing" →
    0xFFFD — both distinct from the slot-side 0xFFFF "no value")."""

    def enc(col):
        v = q[col].astype(jnp.int32)
        return jnp.where(v == -1, jnp.int32(0xFFFE),
                         jnp.where(v < 0, jnp.int32(0xFFFD), v))

    has_j = (q["j_bits"].sum(axis=1) > 0)
    has_dp = (q["d_bits"].sum(axis=1) + q["p_bits"].sum(axis=1) > 0)
    qmeta = jnp.stack([
        enc("payer"), enc("state"), enc("program"),
        q["tag_mode"].astype(jnp.int32),
        strict_ok.astype(jnp.int32),
        (q["inherit_authority"] > 0).astype(jnp.int32),
        has_j.astype(jnp.int32),
        has_dp.astype(jnp.int32),
    ], axis=1)
    qbits = jnp.concatenate(
        [_as_i32(q["j_bits"]), _as_i32(q["d_bits"]), _as_i32(q["p_bits"])],
        axis=1)
    return qmeta, qbits


def meta_ok_from_words(meta_blk, qmeta):
    """Metadata eligibility from packed gate words: meta_blk [..., 2]
    i32 vs qmeta [B, 8] → (meta_ok, valid) bools broadcast over the
    candidate axes. The d-tag arm gates on exactly this (dense form:
    engine.dtag_raw's valid + meta_ok penalties)."""
    e0, e1 = meta_blk[..., 0], meta_blk[..., 1]
    m16 = jnp.int32(0xFFFF)
    payer, state = e0 & m16, (e0 >> 16) & m16
    program = e1 & m16
    valid = ((e1 >> 16) & 1) > 0
    reg = ((e1 >> 17) & 1) > 0
    qp, qs, qg = (qmeta[:, 0:1], qmeta[:, 1:2], qmeta[:, 2:3])
    inherit = qmeta[:, 5:6] > 0
    any16 = jnp.int32(0xFFFE)
    ok = (((qp == any16) | (payer == qp) | (inherit & reg))
          & ((qs == any16) | (state == qs))
          & ((qg == any16) | (program == qg)))
    return ok, valid


def _gate_blocks_xla(meta_blk, jw_blk, dpw_blk, qmeta, qbits, tw: int,
                     tag_level: int):
    """The filter gate over gathered blocks
    meta_blk [B, S, 2] (+ jw [B, S, TW], dpw [B, S, 2TW]) → bool [B, S].
    Shared by the CPU/parity path and by the candidate-local lexical/
    d-tag arms (query/gating.py) so every consumer computes the exact
    same gate."""
    ok, valid = meta_ok_from_words(meta_blk, qmeta)
    tm = qmeta[:, 3:4]
    strict_ok = qmeta[:, 4:5] > 0
    has_j, has_dp = qmeta[:, 6:7] > 0, qmeta[:, 7:8] > 0
    if tag_level >= 1:
        j_ov = jnp.zeros_like(valid)
        for w in range(tw):
            j_ov = j_ov | ((jw_blk[..., w] & qbits[:, w:w + 1]) != 0)
        strict = valid & ok & (j_ov | ~has_j)
    else:
        strict = valid & ok
    if tag_level >= 2:
        dp_ov = jnp.zeros_like(valid)
        for w in range(tw):
            dp_ov = dp_ov | ((dpw_blk[..., w] & qbits[:, tw + w:tw + w + 1]) != 0)
            dp_ov = dp_ov | (
                (dpw_blk[..., tw + w] & qbits[:, 2 * tw + w:2 * tw + w + 1]) != 0)
        relaxed = valid & ok & (dp_ov | ~has_dp)
    else:
        relaxed = valid & ok
    auto = jnp.where(strict_ok, strict, strict | relaxed)
    return jnp.where(tm == 0, auto, jnp.where(tm == 1, relaxed, valid))


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "approx",
                                             "tag_level", "tw"))
def proj_search_gated(pp: PackedProj, gate, queries: jnp.ndarray,
                      qmeta: jnp.ndarray, qbits: jnp.ndarray, k: int,
                      nprobe: int, approx: float = 0.0,
                      tag_level: int = 2, tw: int = 8):
    """Probed top-k over projected-residual codes with the filter gate
    evaluated CANDIDATE-LOCALLY on the streamed cluster blocks — the
    [B, C]-free form of proj_search_packed. ``gate`` is ProjGate.words
    [nlist, W, pad] (word-major; carries metadata, dequant scale and
    rowid per slot — see gate_width). `qmeta`/`qbits` from
    encode_qmeta (strict_ok already folded in). `tag_level` statically
    selects which tag words the gate reads: 0 = metadata only, 1 = +j,
    2 = +d/p."""
    g_words = gate
    b = queries.shape[0]
    q32 = queries.astype(jnp.float32)
    cscores, probe, q8, q_scale = query_side(pp, q32, nprobe)

    def scan_probe(tok, pc):
        blk = jnp.take(pp.codes, pc, axis=0)  # [B, pad, p] int8
        wblk = jnp.take(g_words, pc, axis=0)  # [B, W, pad]
        sc = jax.lax.bitcast_convert_type(wblk[:, 2], jnp.float32)
        rid = wblk[:, 3]
        meta_blk = jnp.moveaxis(wblk[:, 0:2], 1, -1)  # [B, pad, 2]
        jw_blk = (jnp.moveaxis(wblk[:, 4:4 + tw], 1, -1)
                  if tag_level >= 1 else None)
        dpw_blk = (jnp.moveaxis(wblk[:, 4 + tw:4 + 3 * tw], 1, -1)
                   if tag_level >= 2 else None)
        acc = block_dots(blk, q8).astype(jnp.float32)  # [B, pad]
        ok = _gate_blocks_xla(meta_blk, jw_blk, dpw_blk, qmeta, qbits,
                              tw, tag_level)
        gated = jnp.where(ok, acc * sc, NEG_INF)
        s = jnp.where(
            gated > NEG_INF / 2,
            gated * q_scale[:, None]
            + jnp.take_along_axis(cscores, pc[:, None], axis=1),
            NEG_INF) + tok
        return tok, (s, rid)

    veps = q_scale[:, None] * 0.0  # [B, 1] axis-varying token
    _, (ss, rids) = jax.lax.scan(scan_probe, veps, probe.T)
    vals = jnp.moveaxis(ss, 0, 1).reshape(b, -1)
    ids = jnp.moveaxis(rids, 0, 1).reshape(b, -1)
    nv, ni = merged_topk(vals, ids, k, approx)
    return nv, ni.astype(jnp.int32)
