"""Corpus sharding across a device mesh with an all-gather top-k merge.

The device replacement for the reference's missing scale-out story
(SURVEY §2.9 row 'multi-node scale-out', §5.8): the chunk matrix and all
its companion columns shard along rows over the ``shard`` mesh axis;
each device scans only its shard (arm scores + local top-M + local
rerank signals) under ``shard_map``; the tiny per-shard candidate
payloads (M rows × ~6 floats, not [B, C] scores) are then all-gathered
and fused/reranked identically on every device.

Communication per query ≈ 3 arms × M candidates × (val + idx + 6
signals) × S shards — a few KB — versus the chunk matrix never leaving
its shard. This is the 'shard-local top-k, allgather merge' recipe
(SURVEY §5.8, scaling-book style).

RRF caveat handled here: reciprocal-rank fusion needs each arm's GLOBAL
ranks. Because the global top-M of an arm is a subset of the union of
shard-local top-Ms, gathering local top-Ms and re-sorting reproduces the
exact single-chip ranks (tested against the dense engine in
tests/test_sharded.py). The strict-count for filter auto-relax is a
psum so every shard takes the same strict/relaxed branch.

LIVE SERVING: the sharded copy tracks the source ChunkStore through its
mutation listeners (store.listeners). Publishes/deletes after
construction accumulate as pending row updates; ``refresh()`` applies
them as replicated scatter writes into the sharded arrays (or falls
back to a full re-shard when the store grew, bulk-loaded, or uses the
sparse postings layout, whose per-shard tables are re-keyed globally).
The query entry points auto-refresh, so a freshly published document
surfaces in sharded results without reconstructing the engine — the
multi-chip counterpart of the reference's republish contract
(app/services/publish.py:27-481).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mobius_rag_tpu.config import Config, get_config
from mobius_rag_tpu.index.store import ChunkStore, DeviceIndex
from mobius_rag_tpu.ops.topk import NEG_INF
from mobius_rag_tpu.query import engine as eng
from mobius_rag_tpu.utils import round_up

_N_SIG = eng.N_SIG  # cos, lex_raw, auth, len, jpd, cov

# Static pads for incremental row-refresh batches (each distinct pad is
# one XLA compile of the scatter program); beyond the largest pad a full
# re-shard is cheaper anyway.
_ROW_PADS = (256, 1024, 4096)


def _local_candidates(index: DeviceIndex, q: dict, ann, k: int, m: int,
                      m_other: int, axis: str, nprobe: int):
    """Per-shard arm scan: delegates to the engine's shared
    arm_candidates with the mesh axis (strict counts psum so every shard
    takes the same auto-relax branch; indices offset to global).
    `ann` is the per-shard ANN table slice ([1, ...] leaves under
    shard_map — each device's own IVF/packed tables over its LOCAL rows,
    built by ShardedEngine.ensure_ann) or None for the exact scan.
    Returns (vals [3,B,m], gidx [3,B,m], sigs [3,B,m,_N_SIG])."""
    # queries arrive bf16 over the wire (engine.prepare_batch); widen once
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    if ann is not None:
        ann = jax.tree.map(lambda x: x[0], ann)  # drop the shard axis
    vals, gidx, sigs, _ = eng.arm_candidates(index, q, k, m,
                                             m_other=m_other, axis=axis,
                                             ann=ann, nprobe=nprobe)
    return vals, gidx, sigs


# The replicated merge is the engine's fuse_and_rerank (shared with the
# single-chip pipeline — one fusion code path ⇒ sharded ≡ dense results).
_fuse_and_rerank = eng.fuse_and_rerank


@functools.lru_cache(maxsize=None)
def _sharded_run(mesh: Mesh, axis: str, over_fetch: int, rrf_k: int):
    """Build the jitted sharded query program for a (mesh, axis, knobs)
    tuple. Module-level + lru_cached so every ShardedEngine instance over
    the same mesh shares ONE compiled program per index signature —
    refresh/republish never recompiles (round-1 keyed the jit on `self`,
    so each rebuild paid a full compile).

    2D meshes (make_serve_mesh): every mesh axis besides ``axis`` is a
    DATA axis — the index (and ANN tables) replicate over it and the
    query batch splits over it, so query throughput scales with dp at
    unchanged per-query latency (the corpus-fits-a-subset-of-the-slice
    regime). The shard-local scan and the allgather merge are identical
    to the 1D program; only the specs change."""
    s = mesh.shape[axis]
    data_axes = tuple(a for a in mesh.axis_names if a != axis)
    dp = 1
    for a in data_axes:
        dp *= mesh.shape[a]

    def index_specs(index: DeviceIndex) -> DeviceIndex:
        specs = {}
        for f in index.fields:
            ndim = getattr(index, f).ndim
            spec = [None] * ndim
            spec[1 if f == "lexical" else 0] = axis
            specs[f] = P(*spec)
        return DeviceIndex(**specs)

    @functools.partial(jax.jit, static_argnames=("k", "nprobe", "funnel"))
    def run(index: DeviceIndex, q: dict, k: int, ann=None, nprobe: int = 32,
            funnel: int = 0):
        c_total = index.valid.shape[0]
        c_local = c_total // s
        w = min(funnel, c_total)
        # Per-shard over-fetch: the global top-pool of an arm (and the
        # global funnel top-w) can in the worst case live entirely on
        # one shard. Under a funnel (host residency) `k` arrives ALREADY
        # over-fetched (_device_k) and the exact host re-rank reorders
        # fused-k + funnel-w — compounding over_fetch again here put the
        # lex/d-tag arms' top_k at 64× the user k (see _search_compiled).
        pool = k if funnel else k * over_fetch
        m = min(max(pool, w), c_local)
        m_other = min(pool, c_local)
        m_global = min(pool, c_total)
        b = q["vec"].shape[0]
        b_pad = -(-b // dp) * dp
        if b_pad != b:
            # pad by repeating the last query (static shapes; the pad
            # rows are dropped below, so duplicate work is the only cost)
            q = {key: (v if key == "lex_buckets" else jnp.concatenate(
                [v, jnp.broadcast_to(v[-1:], (b_pad - b, *v.shape[1:]))], 0))
                 for key, v in q.items()}
        if data_axes:
            # batch-major leaves split over the data axes; the union
            # bucket list (lex_buckets, [U]) is batch-global → replicated
            q_specs = {key: (P() if key == "lex_buckets"
                             else P(data_axes,
                                    *([None] * (q[key].ndim - 1))))
                       for key in q}
            # out dim 1 is shard-major then batch-contiguous: global
            # [3, S*dp*B_loc, m] reshapes to [3, S, B, m] with the batch
            # in original order (P(data) splits the batch contiguously)
            out_spec = P(None, (axis, *data_axes))
        else:
            q_specs = P()
            out_spec = P(None, axis)
        # ANN tables enter with a leading shard axis (stack_shard_ivf);
        # every leaf shards on that axis so each device scans its own
        # local tables.
        ann_specs = jax.tree.map(
            lambda x: P(axis, *([None] * (x.ndim - 1))), ann)
        vals, gidx, sigs = shard_map(
            functools.partial(_local_candidates, k=k, m=m, m_other=m_other,
                              axis=axis, nprobe=nprobe),
            mesh=mesh,
            in_specs=(index_specs(index), q_specs, ann_specs),
            out_specs=(out_spec, out_spec, out_spec),
        )(index, q, ann)
        # locally [3, B_loc, m] → gathered along axis 1 → [3, S*B, m]
        vals = vals.reshape(3, s, b_pad, m)
        gidx = gidx.reshape(3, s, b_pad, m)
        sigs = sigs.reshape(3, s, b_pad, m, _N_SIG)
        out = _fuse_and_rerank(vals, gidx, sigs, q, k, rrf_k, m_global)
        if w:
            # funnel block (host-residency exact re-rank): global top-w
            # of the vector arm across shards + the same signal slices
            # the single-chip wide_outputs ships (engine.wide_outputs
            # operates on [3, B, m]; here the shard axis flattens into
            # the candidate axis first — same math, merged lists)
            g_vals = vals.transpose(0, 2, 1, 3).reshape(3, b_pad, s * m)
            g_gidx = gidx.transpose(0, 2, 1, 3).reshape(3, b_pad, s * m)
            g_sigs = sigs.transpose(0, 2, 1, 3, 4).reshape(
                3, b_pad, s * m, _N_SIG)
            wv, pos = jax.lax.top_k(g_vals[0], w)
            out.update({
                "wide_vals": wv,
                "wide_idx": jnp.take_along_axis(g_gidx[0], pos, axis=1),
            })
            lex_best = jnp.max(
                jnp.where(g_vals[1] > NEG_INF / 2, g_vals[1], 0.0),
                axis=1)
            wsig = jnp.take_along_axis(
                g_sigs[0], pos[..., None].repeat(_N_SIG, -1), axis=1)
            out.update({
                "wide_lexn": jnp.clip(
                    wsig[..., 1] / jnp.maximum(lex_best[:, None], 1e-6),
                    0.0, 1.0),
                "wide_auth": wsig[..., 2],
                "wide_len": wsig[..., 3],
                "wide_jpd": wsig[..., 4],
                "wide_cov": wsig[..., 5],
            })
        # pack to two output arrays: two fetches per query batch instead
        # of ten (each device→host transfer pays a fixed cost; same
        # reasoning as engine._search_compiled)
        packed = eng.pack_fused(out, k, w)
        return tuple(a[:b] for a in packed) if b_pad != b else packed

    return run


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("fields",))
def _scatter_rows(index: DeviceIndex, rows: jnp.ndarray, updates: tuple,
                  fields: tuple):
    """Replicated row-scatter into the (sharded) index arrays. `rows` is
    padded by REPEATING the last real row (duplicate writes carry
    identical values, so scatter order can't corrupt anything). GSPMD
    routes each row's write to the shard that owns it."""
    upd = dict(zip(fields, updates))
    new = {}
    for f in index.fields:
        arr = getattr(index, f)
        if f not in upd:
            new[f] = arr
            continue
        val = upd[f].astype(arr.dtype)
        if f == "lexical":  # bucket-major [H, C]: column updates
            new[f] = arr.at[:, rows].set(val)
        else:
            new[f] = arr.at[rows].set(val)
    return DeviceIndex(**new)


class ShardedEngine:
    """Search over a corpus sharded across a mesh.

    Build from a ChunkStore: rows are block-partitioned over shards
    (shard s owns global rows [s*Cs, (s+1)*Cs)), so ChunkStore row ids
    remain valid global ids for record lookup."""

    def __init__(self, store: ChunkStore, mesh: Mesh | None = None,
                 cfg: Config | None = None, axis: str | None = None,
                 vector_backend: str | None = None):
        from mobius_rag_tpu.parallel.mesh import make_mesh, make_serve_mesh

        self.cfg = cfg or get_config()
        self.store = store
        if (store.host_vectors is not None
                and (vector_backend or self.cfg.vector_backend)
                not in ("pq", "proj")):
            raise ValueError(
                "host vector residency (MRAG_VECTOR_RESIDENCY=host) shards "
                "as a codes-only index: HBM holds per-shard residual-PQ or "
                "projected-residual tables and the exact re-rank runs from "
                "host RAM after the merge — the vector backend must be "
                "'pq' or 'proj' (exact/ivf/packed need the device-resident "
                "payload)")
        if mesh is None:
            mesh = (make_serve_mesh(self.cfg.serve_dp, self.cfg.num_shards,
                                    shard_axis=self.cfg.shard_axis)
                    if self.cfg.serve_dp > 1
                    else make_mesh(self.cfg.num_shards, self.cfg.shard_axis))
        self.mesh = mesh
        self.axis = axis or self.cfg.shard_axis
        self._run_fn = _sharded_run(self.mesh, self.axis,
                                    self.cfg.over_fetch, self.cfg.rrf_k)
        self._pending: set[int] = set()
        self._needs_rebuild = False
        self._sparse = "lex_cols" in store.index.fields
        store.listeners.append(self._on_store_event)
        self.index = self._shard_index(store.index)
        self._synced_generation = store.generation
        # Vector-arm backend under sharding: per-shard ANN tables (each
        # shard k-means-clusters its OWN rows; probe happens inside
        # shard_map). Rebuilt whenever the store's write generation moves
        # — cluster membership can't be incrementally patched safely.
        self.vector_backend = vector_backend or self.cfg.vector_backend
        self._ann = None
        self._ann_generation = -1
        self._ann_backend = None

    # -- liveness ----------------------------------------------------------

    def _on_store_event(self, event: str, rows: list[int]) -> None:
        if event in ("grow", "bulk") or self._sparse:
            # capacity/bulk changes reshape the shards; the sparse
            # postings tables are re-keyed globally — full re-shard
            self._needs_rebuild = True
        else:
            self._pending.update(rows)

    @property
    def stale(self) -> bool:
        return self._synced_generation != self.store.generation

    def refresh(self) -> dict:
        """Bring the sharded copy current with the store. Incremental
        row scatter for dense layouts; full re-shard when the store
        grew/bulk-loaded, uses sparse postings, or the dirty set exceeds
        the largest scatter pad."""
        if not self.stale:
            return {"refreshed": False}
        if self._needs_rebuild or len(self._pending) > _ROW_PADS[-1]:
            self.index = self._shard_index(self.store.index)
            mode = "rebuild"
        else:
            self._apply_rows(sorted(self._pending))
            mode = f"scatter:{len(self._pending)}"
        self._pending.clear()
        self._needs_rebuild = False
        self._synced_generation = self.store.generation
        return {"refreshed": True, "mode": mode}

    def _apply_rows(self, rows: list[int]) -> None:
        src = self.store.index
        n = len(rows)
        n_pad = next(p for p in _ROW_PADS if n <= p)
        padded = np.full(n_pad, rows[-1], np.int64)
        padded[:n] = rows
        gather = jnp.asarray(padded)
        fields, updates = [], []
        for f in src.fields:
            if f in ("lex_cols", "lex_wts"):
                continue
            arr = getattr(src, f)
            if arr.shape[1 if f == "lexical" else 0] == 0:
                continue  # 0-row payload under host residency
            if f == "lexical":
                updates.append(np.asarray(arr[:, gather]))  # [H, R]
            else:
                updates.append(np.asarray(arr[gather]))
            fields.append(f)
        self.index = _scatter_rows(self.index, jnp.asarray(padded),
                                   tuple(jnp.asarray(u) for u in updates),
                                   tuple(fields))

    def rebuilt(self, store: ChunkStore) -> "ShardedEngine":
        """A fresh sharded engine over a NEW store (post-restore swap),
        reusing this engine's mesh/axis (and hence its compiled program)."""
        return ShardedEngine(store, mesh=self.mesh, cfg=self.cfg, axis=self.axis)

    # -- build ---------------------------------------------------------------

    def _shard_index(self, index: DeviceIndex) -> DeviceIndex:
        s = self.mesh.shape[self.axis]
        host = jax.device_get(index)
        arrays = {}
        c_pad = round_up(index.capacity, s)
        for f in index.fields:
            if f in ("lex_cols", "lex_wts"):
                continue  # rebuilt per shard below (row ids must go local)
            a = np.asarray(getattr(host, f))
            # every field is chunk-major except lexical ([H, C]) — the
            # chunk axis is what shards
            chunk_axis = 1 if f == "lexical" else 0
            c = a.shape[chunk_axis]
            if c == 0:
                # host residency: the vectors payload is deliberately
                # [0, D] (codes-only HBM) — keep it empty, don't pad a
                # full-size zeros matrix into every shard
                spec = [None] * a.ndim
                spec[chunk_axis] = self.axis
                arrays[f] = jax.device_put(
                    a, NamedSharding(self.mesh, P(*spec)))
                continue
            if c_pad != c:
                shape = list(a.shape)
                shape[chunk_axis] = c_pad - c
                a = np.concatenate([a, np.zeros(shape, a.dtype)], axis=chunk_axis)
            spec = [None] * a.ndim
            spec[chunk_axis] = self.axis
            arrays[f] = jax.device_put(a, NamedSharding(self.mesh, P(*spec)))
        if "lex_cols" in index.fields:
            sc, sw = self._shard_sparse_tables(s, c_pad)
            spec = NamedSharding(self.mesh, P(self.axis, None))
            arrays["lex_cols"] = jax.device_put(sc, spec)
            arrays["lex_wts"] = jax.device_put(sw.astype(jnp.bfloat16), spec)
        return DeviceIndex(**arrays)

    def _shard_sparse_tables(self, s: int, c_pad: int):
        """Re-key the store's sparse postings per shard: shard s owns
        global rows [s*Cs, (s+1)*Cs); its table holds LOCAL row ids so
        the per-shard arm scan scatter-adds into [B, c_local] directly.
        Tables stack to [S*H, P_local] and shard on axis 0 — inside
        shard_map each device sees its own [H, P_local]."""
        cols_np = self.store._lex_cols_np  # [H, P] global row ids
        wts_np = self.store._lex_wts_np
        h = cols_np.shape[0]
        cs = c_pad // s
        hh, pp = np.nonzero(cols_np >= 0)
        rows = cols_np[hh, pp]
        shard = rows // cs
        key = shard * h + hh  # [NNZ] → row of the stacked [S*H, ...] table
        counts = np.bincount(key, minlength=s * h)
        p_loc = int(round_up(max(8, int(counts.max(initial=0))), 8))
        out_cols = np.full((s * h, p_loc), -1, np.int32)
        out_wts = np.zeros((s * h, p_loc), np.float32)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        # slot within each key run (ks is sorted, so searchsorted-left
        # gives each run's first position)
        slot = np.arange(len(ks)) - np.searchsorted(ks, ks, side="left")
        out_cols[ks, slot] = (rows - shard * cs)[order]
        out_wts[ks, slot] = wts_np[hh, pp][order]
        return out_cols, out_wts

    # -- vector-arm ANN backend ---------------------------------------------

    def set_vector_backend(self, backend: str) -> None:
        if backend not in ("exact", "ivf", "packed", "pq", "proj"):
            raise ValueError(
                f"backend {backend!r} must be exact|ivf|packed|pq|proj")
        if self.store.host_vectors is not None and backend not in ("pq",
                                                                   "proj"):
            raise ValueError("host vector residency serves codes-only "
                             "shards — the backend must stay 'pq'/'proj'")
        self.vector_backend = backend

    def ensure_ann(self):
        """Per-shard ANN tables for the configured backend, stacked along
        a leading shard axis and laid out so shard s's tables live on
        shard s's device. Local row ids: shard s clusters rows
        [s*Cs, (s+1)*Cs) of the store, ids are shard-local (the per-shard
        scan offsets them to global, like the exact path)."""
        if self.vector_backend == "exact":
            return None
        if (self._ann is not None
                and self._ann_generation == self.store.generation
                and self._ann_backend == self.vector_backend):
            return self._ann
        from mobius_rag_tpu.index.ivf import (IVFIndex, PackedIVF,
                                              stack_shard_ivf,
                                              stack_shard_packed)
        from mobius_rag_tpu.ops.pq import (PackedPQ, effective_m,
                                            stack_shard_pq)
        from mobius_rag_tpu.ops.proj import PackedProj, stack_shard_proj

        src = self.store.index
        s = self.mesh.shape[self.axis]
        c_pad = round_up(src.capacity, s)
        cs = c_pad // s
        valid = np.asarray(jax.device_get(src.valid))
        n_live = int((valid > 0).sum())
        # uniform nlist across shards (shapes must match when stacked)
        nlist = self.cfg.ivf_nlist or max(16, int(np.sqrt(max(n_live // s, 1))))
        shards: list = []
        pq_m = effective_m(self.cfg.embed_dim, self.cfg.pq_m)
        for si in range(s):
            lo, hi = si * cs, min((si + 1) * cs, src.capacity)
            if self.store.host_vectors is not None:
                # codes-only regime: shard si clusters + encodes its
                # OWN host int8 rows (the sharded form of the engine's
                # single-chip host build); the exact re-rank after the
                # merge reads the same host matrix, mesh-agnostic
                hv = self.store.host_vectors[lo:hi]
                hs = self.store.host_scales[lo:hi]
                ivf = IVFIndex.build_host(hv, hs, valid[lo:hi], nlist=nlist)
                if self.vector_backend == "proj":
                    shards.append(PackedProj.from_ivf(
                        ivf, hv, p=self.cfg.proj_p, row_scales=hs))
                else:
                    shards.append(PackedPQ.from_ivf(ivf, hv, m=pq_m,
                                                    row_scales=hs))
                continue
            vec_local = src.vectors[lo:hi]  # device slice; k-means on device
            ivf = IVFIndex.build(vec_local, valid[lo:hi], nlist=nlist)
            scales = (src.vec_scales[lo:hi]
                      if self.cfg.vector_dtype == "int8" else None)
            if self.vector_backend == "packed":
                shards.append(PackedIVF.from_ivf(ivf, vec_local,
                                                 row_scales=scales))
            elif self.vector_backend == "pq":
                shards.append(PackedPQ.from_ivf(ivf, vec_local, m=pq_m,
                                                row_scales=scales))
            elif self.vector_backend == "proj":
                shards.append(PackedProj.from_ivf(
                    ivf, vec_local, p=self.cfg.proj_p, row_scales=scales))
            else:
                shards.append(ivf)
        stacked = {"packed": stack_shard_packed, "pq": stack_shard_pq,
                   "proj": stack_shard_proj,
                   "ivf": stack_shard_ivf}[self.vector_backend](shards)
        # lay the stacked tables out over the mesh: shard axis partitioned
        put = lambda x: jax.device_put(
            x, NamedSharding(self.mesh, P(self.axis, *([None] * (x.ndim - 1)))))
        self._ann = jax.tree.map(put, stacked)
        self._ann_generation = self.store.generation
        self._ann_backend = self.vector_backend
        return self._ann

    # -- query ---------------------------------------------------------------

    def _run(self, q: dict, k: int, funnel: int = 0):
        return self._run_fn(self.index, q, k, self.ensure_ann(),
                            self.cfg.ivf_nprobe, funnel)

    def search_arrays(self, q_host: dict[str, np.ndarray], k: int):
        """Run the sharded pipeline on prepared query arrays (schema =
        SearchEngine.prepare_batch). Returns host dict."""
        self.refresh()
        q = {key: jnp.asarray(v) for key, v in q_host.items()}
        return eng.unpack_fused(jax.device_get(self._run(q, k)), k)

    def search(self, engine, reqs, k: int | None = None):
        """Full search over the sharded index: borrow the (single-chip)
        SearchEngine for host-side prep and result assembly; run the
        compiled portion sharded. `engine` must wrap the SAME ChunkStore
        this ShardedEngine was built from (row ids are shared)."""
        from mobius_rag_tpu.query.engine import QueryRequest

        if isinstance(reqs, QueryRequest):
            reqs = [reqs]
        k = k or self.cfg.default_k
        self.refresh()
        q, exps = engine.prepare_batch(reqs)
        # host residency: the compiled merge returns k·over_fetch fused
        # candidates + the funnel-wide vector list; the exact re-rank
        # from host RAM restores top-k
        kd = engine._device_k(k)
        fw = engine._device_funnel(k)
        out = eng.unpack_fused(jax.device_get(self._run(q, kd, fw)), kd,
                               w=fw)
        if kd != k or fw:
            out = engine._host_rerank(list(reqs), exps, out, k)
        return engine._assemble(list(reqs), exps, out, k)
