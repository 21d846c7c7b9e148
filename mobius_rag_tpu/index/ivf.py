"""IVF (inverted-file) index: coarse k-means clustering + probed scan.

The 1M-chunk config (BASELINE.json config 4): instead of scanning the
whole chunk matrix per query, score the query against ``nlist``
centroids, pick the ``nprobe`` nearest clusters, and scan only their
members — cutting per-query HBM traffic ~(nlist / nprobe)×. pgvector's
HNSW plays this role in the reference; IVF maps far better onto an
accelerator's matmul units (probed scan = a few dense matmuls) than a
pointer-chasing graph would.

Design decisions:
- k-means runs ON DEVICE as jitted Lloyd iterations (assignment = one
  [N, nlist] matmul + argmax; update = segment-sum).
- clusters are stored PADDED to a uniform width in a reordered member
  table, so probing is static-shape gathers (no ragged anything under
  jit). Overflow rows beyond the pad width go to a spill list that every
  query scans (bounded: pad = 2× mean occupancy) — recall never silently
  drops for rows the pad cut off.
- member vectors can be fp32/bf16 (from the main index) — probing
  gathers rows from the SAME chunk matrix, so IVF adds only
  centroids + member-id tables (~1% memory), not a second copy.
"""
from __future__ import annotations


import functools

import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.ops.topk import NEG_INF
from mobius_rag_tpu.utils import round_up


# Row-block width for the assignment matmul: keeps the [block, nlist]
# score matrix + block f32 copy bounded (~1 GB at nlist=1024, D=1536)
# instead of materializing [N, nlist] (4 GB at 1M rows) each iteration.
_KM_BLOCK = 131072


def _aligned_pad(raw: int) -> int:
    """Cluster pad width: a multiple of 8, at least 8 (the incremental
    scatter pads index blocks to multiples of 8)."""
    return max(8, round_up(raw, 8))


@functools.partial(jax.jit, static_argnames=("nlist", "iters", "n_pad"))
def _kmeans(vectors: jnp.ndarray, init_idx: jnp.ndarray, nlist: int, iters: int,
            n_pad: int):
    """Blockwise Lloyd iterations on device. vectors [N, D] assumed
    L2-normalized (cosine k-means: assignment by max dot; centroids
    re-normalized). Rows are processed in fixed blocks via lax.map so
    peak memory is independent of N. Returns centroids only — final
    row placement happens via the capacity-constrained multi-choice
    pass (:func:`_capacity_assign`), not raw argmax."""
    n, d = vectors.shape
    pad_rows = n_pad - n
    v = jnp.pad(vectors, ((0, pad_rows), (0, 0)))
    vb = v.reshape(n_pad // _KM_BLOCK if n_pad >= _KM_BLOCK else 1,
                   min(_KM_BLOCK, n_pad), d)
    centroids0 = vectors[init_idx].astype(jnp.float32)  # [nlist, D]

    def assign_block(centroids, block):
        scores = jnp.dot(block.astype(jnp.float32), centroids.T,
                         preferred_element_type=jnp.float32)
        return jnp.argmax(scores, axis=1)

    def step(centroids, _):
        def per_block(block):
            a = assign_block(centroids, block)
            b32 = block.astype(jnp.float32)
            sums = jax.ops.segment_sum(b32, a, num_segments=nlist)
            counts = jax.ops.segment_sum(jnp.ones(a.shape, jnp.float32), a,
                                         num_segments=nlist)
            return sums, counts

        sums, counts = jax.lax.map(per_block, vb)
        sums = sums.sum(axis=0)
        counts = counts.sum(axis=0)
        # padded zero-rows all land in one cell; subtract their pull by
        # removing pad contributions (zero vectors add nothing to sums,
        # only to counts of the argmax cell — correct for it)
        if pad_rows:
            pad_assign = assign_block(centroids, jnp.zeros((1, d), vectors.dtype))[0]
            counts = counts.at[pad_assign].add(-float(pad_rows))
        new = jnp.where(counts[:, None] > 0,
                        sums / jnp.maximum(counts[:, None], 1.0), centroids)
        norm = jnp.linalg.norm(new, axis=1, keepdims=True)
        return new / jnp.maximum(norm, 1e-6), None

    centroids, _ = jax.lax.scan(step, centroids0, None, length=iters)
    return centroids


@functools.partial(jax.jit, static_argnames=("j",))
def _topj_block(centroids: jnp.ndarray, block: jnp.ndarray, j: int):
    """Top-j nearest centroids per row of one block: [B, j] scores+ids."""
    scores = jnp.dot(block.astype(jnp.float32), centroids.T,
                     preferred_element_type=jnp.float32)
    return jax.lax.top_k(scores, j)


def _capacity_assign(choice_idx: np.ndarray, choice_val: np.ndarray,
                     nlist: int, cap: int) -> np.ndarray:
    """Greedy capacity-constrained multi-choice placement.

    choice_idx/choice_val [N, J]: each row's J nearest centroids in
    descending affinity. Round j places still-pending rows into their
    j-th choice while that cluster has < cap members; within a round,
    rows with HIGHER affinity win the remaining slots (the bumped rows
    sit near the cluster boundary, where the next choice is nearly as
    good). Returns the final cell per row, -1 for rows unplaced after
    J rounds (the spill backstop).

    This replaces raw-argmax + overflow-to-spill-slabs: on skewed
    corpora (near-duplicate revision ladders, templated text) raw
    argmax overflowed ~20% of 10M rows into synthetic slabs whose
    centroids were meaningless member means — residual-PQ codes for
    those rows were garbage (recall collapse) and every slab had to be
    probed by every query (24% of the corpus scanned per query)."""
    n, j_max = choice_idx.shape
    cells = np.full(n, -1, np.int64)
    occ = np.zeros(nlist, np.int64)
    pending = np.arange(n)
    for j in range(j_max):
        if not len(pending):
            break
        c = choice_idx[pending, j].astype(np.int64)
        v = choice_val[pending, j]
        order = np.lexsort((-v, c))  # by cluster, best-affinity first
        cs = c[order]
        slot = np.arange(len(cs)) - np.searchsorted(cs, cs, side="left")
        fits = (slot + occ[cs]) < cap
        cells[pending[order[fits]]] = cs[fits]
        occ += np.bincount(cs[fits], minlength=nlist)
        pending = pending[order[~fits]]
    return cells


def _fill_members(live_rows: np.ndarray, cells_live: np.ndarray, nlist: int,
                  pad: int):
    """Vectorized member-table fill from capacity-assigned cells
    (occupancy ≤ pad for cells ≥ 0 by construction); rows with cell -1
    go to the spill backstop every query scans."""
    placed = cells_live >= 0
    rows_p = live_rows[placed].astype(np.int64)
    cells_p = cells_live[placed]
    order = np.argsort(cells_p, kind="stable")
    rows_sorted = rows_p[order]
    cells = cells_p[order]
    slot = np.arange(len(cells)) - np.searchsorted(cells, cells, side="left")
    members = np.zeros((nlist, pad), np.int32)
    member_valid = np.zeros((nlist, pad), np.float32)
    members[cells, slot] = rows_sorted
    member_valid[cells, slot] = 1.0
    spill = live_rows[~placed].astype(np.int64)
    n_spill = round_up(max(len(spill), 1), 8)
    spill_arr = np.zeros(n_spill, np.int32)
    spill_val = np.zeros(n_spill, np.float32)
    spill_arr[: len(spill)] = spill
    spill_val[: len(spill)] = 1.0
    return members, member_valid, spill_arr, spill_val


@jax.tree_util.register_pytree_node_class
class IVFIndex:
    """Device-side IVF tables over an existing chunk matrix."""

    FIELDS = ("centroids", "members", "member_valid", "spill", "spill_valid")

    def __init__(self, centroids, members, member_valid, spill, spill_valid,
                 nlist: int, pad: int):
        self.centroids = centroids  # [nlist, D] f32
        self.members = members  # [nlist, pad] i32 row ids (0 where invalid)
        self.member_valid = member_valid  # [nlist, pad] f32
        self.spill = spill  # [n_spill] i32 rows every query scans
        self.spill_valid = spill_valid  # [n_spill] f32
        self.nlist = nlist
        self.pad = pad

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self.FIELDS),
                (self.nlist, self.pad))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, nlist=aux[0], pad=aux[1])

    # -- build ------------------------------------------------------------

    @classmethod
    def build(cls, vectors, valid: np.ndarray | None = None, *,
              nlist: int | None = None, iters: int = 10, pad_factor: float = 2.0,
              seed: int = 0, choices: int = 16) -> "IVFIndex":
        v = jnp.asarray(vectors)
        n, d = v.shape
        valid_np = (np.asarray(valid) > 0) if valid is not None else np.ones(n, bool)
        n_live = int(valid_np.sum())
        nlist = nlist or max(16, int(np.sqrt(max(n_live, 1)) ))
        if n_live == 0:
            # empty (sub)corpus — e.g. one shard of a tiny sharded store.
            # Zero centroids score 0 against every query; no members, no
            # spill: the probed scan returns all-NEG_INF, like an empty
            # exact scan.
            nlist = max(int(nlist), 1)
            return cls(
                centroids=jnp.zeros((nlist, d), jnp.float32),
                members=jnp.zeros((nlist, 8), jnp.int32),
                member_valid=jnp.zeros((nlist, 8), jnp.float32),
                spill=jnp.zeros(8, jnp.int32),
                spill_valid=jnp.zeros(8, jnp.float32),
                nlist=nlist, pad=8,
            )
        nlist = min(nlist, max(n_live, 1))

        rng = np.random.default_rng(seed)
        live_rows = np.flatnonzero(valid_np)
        init = rng.choice(live_rows, size=nlist, replace=n_live < nlist)
        n_pad = n if n <= _KM_BLOCK else round_up(n, _KM_BLOCK)
        centroids = _kmeans(v, jnp.asarray(init, jnp.int32), nlist, iters,
                            n_pad)

        pad = _aligned_pad(int(pad_factor * max(n_live, 1) / nlist))
        j = int(min(choices, nlist))
        ch_v = np.empty((n, j), np.float32)
        ch_i = np.empty((n, j), np.int32)
        for off in range(0, n, _KM_BLOCK):
            vv, ii = jax.device_get(
                _topj_block(centroids, v[off:off + _KM_BLOCK], j))
            ch_v[off:off + vv.shape[0]] = vv
            ch_i[off:off + ii.shape[0]] = ii
        cells_live = _capacity_assign(ch_i[live_rows], ch_v[live_rows],
                                      nlist, pad)
        members, member_valid, spill_arr, spill_val = _fill_members(
            live_rows, cells_live, nlist, pad)
        return cls(
            centroids=centroids,
            members=jnp.asarray(members), member_valid=jnp.asarray(member_valid),
            spill=jnp.asarray(spill_arr), spill_valid=jnp.asarray(spill_val),
            nlist=nlist, pad=pad,
        )

    @property
    def spill_count(self) -> int:
        return int(np.asarray(self.spill_valid).sum())

    @classmethod
    def build_host(cls, host_vectors: np.ndarray, host_scales: np.ndarray,
                   valid: np.ndarray | None = None, *, nlist: int | None = None,
                   iters: int = 10, pad_factor: float = 2.0, seed: int = 0,
                   sample: int = 500_000, block: int = 250_000,
                   choices: int = 16) -> "IVFIndex":
        """Build from a HOST-resident int8 matrix (the 10M codes-only
        regime: the full matrix never fits HBM next to its own index).
        k-means runs on an uploaded row sample; assignment streams the
        matrix through the device block-by-block — peak HBM is one
        block, host→device traffic is one pass over the int8 bytes."""
        n, d = host_vectors.shape
        valid_np = (np.asarray(valid) > 0) if valid is not None \
            else np.ones(n, bool)
        n_live = int(valid_np.sum())
        nlist = nlist or max(16, int(np.sqrt(max(n_live, 1))))
        if n_live == 0:
            return cls.build(jnp.zeros((8, d), jnp.float32),
                             np.zeros(8), nlist=nlist)
        nlist = min(nlist, n_live)
        rng = np.random.default_rng(seed)
        live_rows = np.flatnonzero(valid_np)
        pick = np.sort(rng.choice(live_rows, size=min(sample, n_live),
                                  replace=False))

        def up_f32(rows_np: np.ndarray) -> jnp.ndarray:
            v = jnp.asarray(host_vectors[rows_np]).astype(jnp.float32)
            return v * jnp.asarray(host_scales[rows_np])[:, None]

        sv = up_f32(pick)
        init = rng.choice(len(pick), size=nlist, replace=len(pick) < nlist)
        n_pad = len(pick) if len(pick) <= _KM_BLOCK else round_up(
            len(pick), _KM_BLOCK)
        centroids = _kmeans(sv, jnp.asarray(init, jnp.int32), nlist,
                            iters, n_pad)
        del sv

        pad = _aligned_pad(int(pad_factor * max(n_live, 1) / nlist))
        j = int(min(choices, nlist))
        ch_v = np.empty((n, j), np.float32)
        ch_i = np.empty((n, j), np.int32)
        for off in range(0, n, block):
            rows_np = np.arange(off, min(off + block, n))
            vv, ii = jax.device_get(
                _topj_block(centroids, up_f32(rows_np), j))
            ch_v[off:off + len(rows_np)] = vv
            ch_i[off:off + len(rows_np)] = ii
        cells_live = _capacity_assign(ch_i[live_rows], ch_v[live_rows],
                                      nlist, pad)
        members, member_valid, spill_arr, spill_val = _fill_members(
            live_rows, cells_live, nlist, pad)
        return cls(
            centroids=centroids,
            members=jnp.asarray(members),
            member_valid=jnp.asarray(member_valid),
            spill=jnp.asarray(spill_arr), spill_valid=jnp.asarray(spill_val),
            nlist=nlist, pad=pad,
        )


@jax.tree_util.register_pytree_node_class
class PackedIVF:
    """Cluster-contiguous int8 storage for corpora past the exact-scan
    budget (BASELINE.json config 5, the 10M-chunk regime).

    The row-gather probing of :func:`ivf_search` is gather-bound (it lost
    to an exact scan at 1M); here each cluster's members are REORDERED
    into a contiguous [pad, D] int8 block, so probing is whole-block
    reads the DMA engine streams. Memory: ~pad_factor × N × D bytes
    (int8) + per-row scales + the row-id map back to global ids."""

    FIELDS = ("centroids", "values", "scales", "valid", "rowids")

    def __init__(self, centroids, values, scales, valid, rowids,
                 nlist: int, pad: int, base_nlist: int | None = None):
        self.centroids = centroids  # [nlist, D] f32
        self.values = values  # [nlist, pad, D] int8
        self.scales = scales  # [nlist, pad] f32
        self.valid = valid  # [nlist, pad] f32
        self.rowids = rowids  # [nlist, pad] i32 (global row ids)
        self.nlist = nlist
        self.pad = pad
        # real (k-means) clusters; cells beyond this are synthetic spill
        # slabs that every query must probe
        self.base_nlist = base_nlist if base_nlist is not None else nlist

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self.FIELDS),
                (self.nlist, self.pad, self.base_nlist))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, nlist=aux[0], pad=aux[1], base_nlist=aux[2])

    @classmethod
    def from_ivf(cls, ivf: IVFIndex, vectors, *, row_scales=None,
                 block: int = 65536) -> "PackedIVF":
        """Quantize + pack the member rows of an existing IVFIndex.
        Spill rows are folded into extra synthetic clusters (pad-sized
        slabs) whose centroids are their member means, so every row stays
        probeable and the search loop has ONE layout.

        When `vectors` is ALREADY int8-quantized, pass its per-row scales
        as `row_scales` — requantizing int8 patterns yields scale≈1 and
        silently drops the true row magnitudes, which reweights ranking
        by 1/maxabs (a ~50-point recall bug found at 2M scale)."""
        from mobius_rag_tpu.ops.quant import _quantize_block

        d = vectors.shape[1]
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

        # gather + quantize member rows block-by-block ENTIRELY ON
        # DEVICE, scattering each block into a donated flat buffer —
        # peak memory is the packed buffer + one block (no doubling),
        # and nothing round-trips to the host (a host assembly would
        # pull the full int8 payload down and push it back up).
        flat_ids = rowids.reshape(-1)
        vectors = jnp.asarray(vectors)  # one upload if given as numpy
        scl = (jnp.asarray(row_scales, jnp.float32)
               if row_scales is not None
               else jnp.ones((vectors.shape[0],), jnp.float32))

        @jax.jit
        def quant_rows(vecs, rscl, rows):
            q, s = _quantize_block(jnp.take(vecs, rows, axis=0))
            return q.astype(jnp.int8), s * jnp.take(rscl, rows)

        # cluster-aligned scatter into FINAL-SHAPE donated buffers: peak
        # HBM = the packed buffer + one block (the old flat buffer's
        # closing slice+reshape tripled it — see
        # ops.quant.fill_cluster_packed)
        from mobius_rag_tpu.ops.quant import fill_cluster_packed

        values, scales = fill_cluster_packed(
            nlist, pad,
            lambda lo, hi: quant_rows(
                vectors, scl, jnp.asarray(flat_ids[lo:hi])),
            (jnp.int8, jnp.float32), (d, 0), block=block)

        # centroids for the synthetic spill clusters = member means
        cents = np.asarray(ivf.centroids, np.float32)
        if extra:
            extra_cents = []
            v_host_get = lambda rows: np.asarray(
                jax.device_get(jnp.take(vectors, jnp.asarray(rows), axis=0)),
                np.float32)
            for e in range(extra):
                seg = spill[e * pad:(e + 1) * pad]
                m = v_host_get(seg).mean(axis=0)
                extra_cents.append(m / max(np.linalg.norm(m), 1e-6))
            cents = np.concatenate([cents, np.stack(extra_cents)], axis=0)
        return cls(jnp.asarray(cents), values, scales, jnp.asarray(valid),
                   jnp.asarray(rowids), nlist, pad, base_nlist=ivf.nlist)


_NPROBE_LADDER = (4, 8, 16, 32, 64, 128, 256, 512, 1024)


def calibrate_nprobe(ann, vectors, queries, *, k: int = 10,
                     target_recall: float = 0.95,
                     row_scales=None, search_fn=None) -> dict:
    """Probe-until-recall calibration: smallest ladder nprobe whose
    recall@k (vs the exact scan over the same matrix, on the given query
    sample) clears the target. Returns the full frontier so callers can
    record the recall/nprobe curve, not just the pick.

    This is the round-3 answer to 'ANN recall is unproven': nprobe stops
    being a static guess and becomes a per-corpus calibrated value — the
    IVF analogue of pgvector's ef_search tuning, measured on the actual
    embedding geometry the corpus serves."""
    import jax

    q = jnp.asarray(queries, jnp.float32)
    b = q.shape[0]
    # exact oracle over the same matrix, BLOCKWISE: materializing an f32
    # copy of the whole corpus OOM'd at 1M×1536 bf16 with the IVF +
    # packed tables already resident (the copy is +6 GB); per-block
    # conversion peaks at one block.
    vdev = jnp.asarray(vectors)
    n = vdev.shape[0]
    ob = min(131_072, n)
    scl = (jnp.asarray(row_scales, jnp.float32) if row_scales is not None
           else jnp.ones((n,), jnp.float32))

    @jax.jit
    def _oracle_block(vecs, scales, qs, lo):
        blk = jax.lax.dynamic_slice_in_dim(vecs, lo, ob, axis=0)
        s = jnp.dot(qs, blk.astype(jnp.float32).T,
                    preferred_element_type=jnp.float32)
        s = s * jax.lax.dynamic_slice_in_dim(scales, lo, ob)[None, :]
        vals, idx = jax.lax.top_k(s, k)
        return vals, idx + lo

    best_v = np.full((b, k), -np.inf, np.float32)
    best_i = np.zeros((b, k), np.int64)
    for lo in range(0, n, ob):
        lo_c = min(lo, n - ob)  # clamp: tail block re-reads overlap
        v, i = jax.device_get(_oracle_block(vdev, scl, q, jnp.int32(lo_c)))
        allv = np.concatenate([best_v, v], axis=1)
        alli = np.concatenate([best_i, i.astype(np.int64)], axis=1)
        order = np.argsort(-allv, axis=1)
        for qi in range(b):
            seen, vv, ii = set(), [], []
            for oi in order[qi]:
                row = alli[qi, oi]
                if row in seen:
                    continue
                seen.add(row)
                vv.append(allv[qi, oi])
                ii.append(row)
                if len(vv) == k:
                    break
            best_v[qi], best_i[qi] = vv, ii
    exact_sets = [set(map(int, row)) for row in best_i]
    penalty = jnp.zeros((n,), jnp.float32)

    if search_fn is None:
        if isinstance(ann, IVFIndex):
            search_fn = lambda npx: ivf_search(ann, vectors, q, penalty, k,
                                               npx, row_scales)
        else:
            search_fn = lambda npx: ivf_search_packed(ann, q, penalty, k, npx)
    nlist = ann.nlist if not hasattr(ann, "base_nlist") else ann.base_nlist
    curve = []
    chosen = None
    for npx in _NPROBE_LADDER:
        npx = min(npx, nlist)
        _, idx = search_fn(npx)
        recall = float(np.mean([
            len(exact_sets[i] & set(map(int, row))) / k
            for i, row in enumerate(np.asarray(idx))]))
        curve.append({"nprobe": npx, "recall": round(recall, 4)})
        if recall >= target_recall and chosen is None:
            chosen = npx
        if npx >= nlist:
            break
    if chosen is None:  # target unreachable — full probe is the honest max
        chosen = min(_NPROBE_LADDER[-1], nlist)
    return {"nprobe": chosen, "target_recall": target_recall, "k": k,
            "sample_queries": b, "curve": curve}


def stack_shard_ivf(shards: "list[IVFIndex]") -> IVFIndex:
    """Stack per-shard IVF tables into arrays with a leading shard axis
    (the sharded engine device_puts the result with the shard axis
    partitioned over the mesh; inside shard_map each device unwraps its
    own [1, ...] slice). Shards are first padded to the max (nlist, pad,
    spill-length) so shapes are uniform — padded centroids are zero
    (score 0 against any unit query) and padded member cells invalid, so
    probing them returns NEG_INF, never a wrong row."""
    nlist = max(s.nlist for s in shards)
    pad = max(s.pad for s in shards)
    n_spill = max(s.spill.shape[0] for s in shards)
    d = shards[0].centroids.shape[1]
    cols = {f: [] for f in IVFIndex.FIELDS}
    for sh in shards:
        c = np.zeros((nlist, d), np.float32)
        c[: sh.nlist] = np.asarray(sh.centroids)
        m = np.zeros((nlist, pad), np.int32)
        m[: sh.nlist, : sh.pad] = np.asarray(sh.members)
        mv = np.zeros((nlist, pad), np.float32)
        mv[: sh.nlist, : sh.pad] = np.asarray(sh.member_valid)
        sp = np.zeros(n_spill, np.int32)
        sp[: sh.spill.shape[0]] = np.asarray(sh.spill)
        sv = np.zeros(n_spill, np.float32)
        sv[: sh.spill_valid.shape[0]] = np.asarray(sh.spill_valid)
        for f, a in zip(IVFIndex.FIELDS, (c, m, mv, sp, sv)):
            cols[f].append(a)
    return IVFIndex(**{f: np.stack(v) for f, v in cols.items()},
                    nlist=nlist, pad=pad)


def stack_shard_packed(shards: "list[PackedIVF]") -> PackedIVF:
    """Leading-shard-axis stack of per-shard packed tables (see
    stack_shard_ivf). base_nlist unifies to the max — a shard whose real
    base is smaller exposes zero-score centroids there, whose cells are
    entirely invalid."""
    base = max(s.base_nlist for s in shards)
    extra = max(s.nlist - s.base_nlist for s in shards)
    nlist, pad = base + extra, max(s.pad for s in shards)
    d = shards[0].values.shape[-1]
    cols = {f: [] for f in PackedIVF.FIELDS}
    for sh in shards:
        c = np.zeros((nlist, d), np.float32)
        vals = np.zeros((nlist, pad, d), np.int8)
        sc = np.zeros((nlist, pad), np.float32)
        ok = np.zeros((nlist, pad), np.float32)
        rid = np.zeros((nlist, pad), np.int32)
        nb, ne = sh.base_nlist, sh.nlist - sh.base_nlist
        src = {f: np.asarray(getattr(sh, f)) for f in PackedIVF.FIELDS}
        # base cells at [0, nb), spill slabs re-homed at [base, base+ne)
        for dst_lo, src_lo, n in ((0, 0, nb), (base, nb, ne)):
            c[dst_lo:dst_lo + n] = src["centroids"][src_lo:src_lo + n]
            vals[dst_lo:dst_lo + n, : sh.pad] = src["values"][src_lo:src_lo + n]
            sc[dst_lo:dst_lo + n, : sh.pad] = src["scales"][src_lo:src_lo + n]
            ok[dst_lo:dst_lo + n, : sh.pad] = src["valid"][src_lo:src_lo + n]
            rid[dst_lo:dst_lo + n, : sh.pad] = src["rowids"][src_lo:src_lo + n]
        for f, a in zip(PackedIVF.FIELDS, (c, vals, sc, ok, rid)):
            cols[f].append(a)
    return PackedIVF(**{f: np.stack(v) for f, v in cols.items()},
                     nlist=nlist, pad=pad, base_nlist=base)


@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def ivf_search_packed(pivf: PackedIVF, queries: jnp.ndarray,
                      penalty: jnp.ndarray, k: int, nprobe: int):
    """Probed masked top-k over the packed int8 layout. penalty indexes
    GLOBAL row ids (same contract as every other scan op); it may be
    [C] (shared) or [B, C] (per-query — the hybrid engine's tag gate).

    Probing scans over probe RANK with the whole query batch per step:
    step p gathers every query's p-th cluster block [B, pad, D] and
    scores it as ONE batched int8 matmul — nprobe matmul steps
    instead of B·nprobe scalar-latency-bound micro-ops (the per-query
    lax.map formulation was device-latency-bound at high occupancy)."""
    b = queries.shape[0]
    q32 = queries.astype(jnp.float32)
    if penalty.ndim == 1:
        penalty = jnp.broadcast_to(penalty[None, :], (b, penalty.shape[0]))
    q_max = jnp.max(jnp.abs(q32), axis=1)
    q_scale = jnp.where(q_max > 0, q_max / 127.0, 1.0)
    q_int = jnp.clip(jnp.round(q32 / q_scale[:, None]), -127, 127).astype(jnp.int8)

    cscores = jnp.dot(q32, pivf.centroids.T, preferred_element_type=jnp.float32)
    p_eff = min(nprobe, pivf.base_nlist)
    _, probe = jax.lax.top_k(cscores[:, : pivf.base_nlist], p_eff)  # [B, P]
    # synthetic spill cells (beyond base_nlist) are ALWAYS probed — their
    # members are overflow the capacity-constrained assignment could not
    # place, so centroid routing can't find them (normally zero cells).
    n_spill_cells = pivf.nlist - pivf.base_nlist
    if n_spill_cells:
        spill_cells = jnp.broadcast_to(
            jnp.arange(pivf.base_nlist, pivf.nlist, dtype=probe.dtype)[None, :],
            (b, n_spill_cells))
        probe = jnp.concatenate([probe, spill_cells], axis=1)

    def scan_probe(carry, pc):
        best_v, best_i = carry  # [B, k]
        block = jnp.take(pivf.values, pc, axis=0)  # [B, pad, D] int8
        sc = jnp.take(pivf.scales, pc, axis=0)  # [B, pad]
        ok = jnp.take(pivf.valid, pc, axis=0)
        rid = jnp.take(pivf.rowids, pc, axis=0)
        acc = jax.lax.dot_general(
            block, q_int, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32).astype(jnp.float32)  # [B, pad]
        s = acc * sc * q_scale[:, None] \
            + jnp.take_along_axis(penalty, rid, axis=1) + (1.0 - ok) * NEG_INF
        vals = jnp.concatenate([best_v, s], axis=1)
        ids = jnp.concatenate([best_i, rid], axis=1)
        nv, pos = jax.lax.top_k(vals, k)
        return (nv, jnp.take_along_axis(ids, pos, axis=1)), None

    # Carry seeded from a varying operand (penalty comes from the
    # shard-local filter masks): under shard_map the loop body's
    # outputs are axis-varying, and a constant init would make the
    # scan carry types mismatch ("varying manual axes do not match").
    veps = penalty[:, :1] * 0.0  # [B, 1]
    init = (jnp.full((b, k), NEG_INF, jnp.float32) + veps,
            jnp.zeros((b, k), jnp.int32) + veps.astype(jnp.int32))
    (vals, idx), _ = jax.lax.scan(scan_probe, init, probe.T)
    return vals, idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def ivf_search(ivf: IVFIndex, vectors: jnp.ndarray, queries: jnp.ndarray,
               penalty: jnp.ndarray, k: int, nprobe: int,
               row_scales: jnp.ndarray | None = None):
    """Probed masked top-k.

    Args mirror cosine_topk: vectors is the FULL chunk matrix (any
    dtype), penalty is the additive filter/validity mask — [C] (shared)
    or [B, C] (per-query tag gate). Returns (scores [B, k], global row
    indices [B, k]).
    """
    b = queries.shape[0]
    q32 = queries.astype(jnp.float32)
    if penalty.ndim == 1:
        penalty = jnp.broadcast_to(penalty[None, :], (b, penalty.shape[0]))

    cscores = jnp.dot(q32, ivf.centroids.T, preferred_element_type=jnp.float32)
    _, probe = jax.lax.top_k(cscores, min(nprobe, ivf.nlist))  # [B, P]

    # candidate rows: probed clusters' members + the spill list
    cand = ivf.members[probe].reshape(b, -1)  # [B, P*pad]
    cand_ok = ivf.member_valid[probe].reshape(b, -1)
    cand = jnp.concatenate([cand, jnp.broadcast_to(ivf.spill[None, :], (b, ivf.spill.shape[0]))], axis=1)
    cand_ok = jnp.concatenate(
        [cand_ok, jnp.broadcast_to(ivf.spill_valid[None, :], (b, ivf.spill_valid.shape[0]))],
        axis=1)

    def per_query(args):
        qv, rows, ok, pen = args
        vecs = jnp.take(vectors, rows, axis=0).astype(jnp.float32)  # [S, D]
        s = jnp.dot(vecs, qv, preferred_element_type=jnp.float32)  # [S]
        if row_scales is not None:  # int8 storage: per-row dequant scales
            s = s * jnp.take(row_scales, rows)
        s = s + jnp.take(pen, rows) + (1.0 - ok) * NEG_INF
        vals, pos = jax.lax.top_k(s, k)
        return vals, jnp.take(rows, pos)

    vals, idx = jax.lax.map(per_query, (q32, cand, cand_ok, penalty))
    return vals, idx.astype(jnp.int32)
