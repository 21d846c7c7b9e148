"""Projected-residual ANN experiment (candidate replacement for LUT-PQ
ADC at the 10M config-5 scale).

The PQ ADC scan is a per-element LUT gather, and its error floods
narrow funnels. The matmul alternative: store per-row int8 PCA projections of
the residual (x − centroid), score probed blocks as dense int8 matmuls
(the ivf_search_packed shape that already runs at wire speed), with the
q·centroid add-back. Code bytes are spent on the residual's top
principal subspace instead of subvector codebooks — same memory at
P = pq_m bytes/row, but scoring is dot_general, not gathers.

Measures funnel recall@10-in-top-W and scan ms/batch for P in
{96, 192, 256}, vs the same exact oracle.

Usage: python scripts/diag_proj_funnel.py [--n 1000000]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ps", type=int, nargs="+", default=[96, 192, 256])
    ap.add_argument("--cache", default="/tmp/bench10m_vec_10000000.npy")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.index.ivf import IVFIndex
    from mobius_rag_tpu.ops.topk import NEG_INF

    full = np.load(args.cache, mmap_mode="r")
    fsca = np.load(args.cache.replace("_vec_", "_sca_"), mmap_mode="r")
    NB_FULL = full.shape[0] // 10
    nb = args.n // 10
    vec = np.empty((args.n, full.shape[1]), np.int8)
    sca = np.empty((args.n,), np.float32)
    for t in range(10):
        vec[t * nb:(t + 1) * nb] = full[t * NB_FULL:t * NB_FULL + nb]
        sca[t * nb:(t + 1) * nb] = fsca[t * NB_FULL:t * NB_FULL + nb]
    del full, fsca
    N, D = vec.shape
    log(f"slice: {N}x{D} backend={jax.default_backend()}")

    rng = np.random.default_rng(0)
    q_rows = rng.choice(N, args.queries, replace=False)
    qv = vec[q_rows].astype(np.float32) * sca[q_rows][:, None]
    qv += 0.02 * rng.standard_normal(qv.shape).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    qdev = jnp.asarray(qv)

    # ---- oracle ----
    @jax.jit
    def scan_block(qs, blk8, bsc, base):
        s = jnp.dot(qs, blk8.astype(jnp.float32).T,
                    preferred_element_type=jnp.float32) * bsc[None, :]
        vals, idx = jax.lax.top_k(s, args.k)
        return vals, idx + base

    t0 = time.perf_counter()
    best_v = np.full((args.queries, args.k), -1e30, np.float32)
    best_i = np.zeros((args.queries, args.k), np.int64)
    OB = 250_000
    for off in range(0, N, OB):
        hi = min(off + OB, N)
        v, i = jax.device_get(scan_block(
            qdev, jnp.asarray(vec[off:hi]), jnp.asarray(sca[off:hi]),
            jnp.int32(off)))
        allv = np.concatenate([best_v, v], axis=1)
        alli = np.concatenate([best_i, i], axis=1)
        top = np.argsort(-allv, axis=1)[:, :args.k]
        best_v = np.take_along_axis(allv, top, axis=1)
        best_i = np.take_along_axis(alli, top, axis=1)
    log(f"oracle: {time.perf_counter() - t0:.0f}s")
    oracle_sets = [set(map(int, r)) for r in best_i]

    # ---- IVF (same as engine) ----
    t0 = time.perf_counter()
    ivf = IVFIndex.build_host(vec, sca, nlist=args.nlist)
    log(f"ivf: {time.perf_counter() - t0:.0f}s (nlist {ivf.nlist}, "
        f"pad {ivf.pad}, spill {ivf.spill_count})")
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
    cents = np.asarray(ivf.centroids, np.float32)
    if extra:
        for e in range(extra):
            seg = spill[e * pad:(e + 1) * pad]
            m = (vec[seg].astype(np.float32) * sca[seg][:, None]).mean(0)
            cents = np.concatenate(
                [cents, (m / max(np.linalg.norm(m), 1e-6))[None]], axis=0)
    cents_dev = jnp.asarray(cents)
    flat = rowids.reshape(-1)
    flat_cell = np.repeat(np.arange(nlist), pad)

    # ---- PCA of residuals (device: covariance accumulation + eigh) ----
    @jax.jit
    def cov_block(rows8, rsca, cell_c):
        r = rows8.astype(jnp.float32) * rsca[:, None] - cell_c
        return r.T @ r

    t0 = time.perf_counter()
    samp = np.sort(rng.choice(np.flatnonzero(valid.reshape(-1) > 0),
                              size=200_000, replace=False))
    cov = jnp.zeros((D, D), jnp.float32)
    SB = 50_000
    for off in range(0, len(samp), SB):
        sl = samp[off:off + SB]
        rows = flat[sl]
        cov = cov + cov_block(jnp.asarray(vec[rows]),
                              jnp.asarray(sca[rows]),
                              cents_dev[jnp.asarray(flat_cell[sl])])
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    evecs = np.asarray(jax.device_get(evecs))
    evals = np.asarray(jax.device_get(evals))
    tot = evals.sum()
    log(f"pca: {time.perf_counter() - t0:.0f}s; var captured: "
        + ", ".join(f"P{p}={evals[-p:].sum() / tot:.3f}"
                    for p in args.ps))

    report = {"n": N, "nlist": nlist, "pad": pad, "proj": {}}
    n_flat = len(flat)

    for P in args.ps:
        pm = jnp.asarray(evecs[:, -P:].T.copy())  # [P, D]

        @jax.jit
        def enc_block(rows8, rsca, cell_c, pm=pm):
            r = rows8.astype(jnp.float32) * rsca[:, None] - cell_c
            pr = r @ pm.T  # [S, P]
            m = jnp.maximum(jnp.max(jnp.abs(pr), axis=1), 1e-9)
            scale = m / 127.0
            q8 = jnp.round(pr / scale[:, None]).astype(jnp.int8)
            return q8, scale

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def scatter(vals_buf, sc_buf, q8, s, off):
            vals_buf = jax.lax.dynamic_update_slice_in_dim(
                vals_buf, q8, off, axis=0)
            sc_buf = jax.lax.dynamic_update_slice_in_dim(sc_buf, s, off,
                                                         axis=0)
            return vals_buf, sc_buf

        t0 = time.perf_counter()
        EB = 65536
        n_pad_flat = ((n_flat + EB - 1) // EB) * EB
        vals_buf = jnp.zeros((n_pad_flat, P), jnp.int8)
        sc_buf = jnp.zeros((n_pad_flat,), jnp.float32)
        for off in range(0, n_flat, EB):
            sl = np.arange(off, min(off + EB, n_flat))
            rows = flat[sl]
            q8, s = enc_block(jnp.asarray(vec[rows]), jnp.asarray(sca[rows]),
                              cents_dev[jnp.asarray(flat_cell[sl])])
            if q8.shape[0] < EB:
                q8 = jnp.pad(q8, ((0, EB - q8.shape[0]), (0, 0)))
                s = jnp.pad(s, (0, EB - s.shape[0]))
            vals_buf, sc_buf = scatter(vals_buf, sc_buf, q8, s,
                                       jnp.int32(off))
        codes = vals_buf[:n_flat].reshape(nlist, pad, P)
        scales = sc_buf[:n_flat].reshape(nlist, pad)
        valid_dev = jnp.asarray(valid)
        rowid_dev = jnp.asarray(rowids)
        log(f"P={P} encode: {time.perf_counter() - t0:.0f}s "
            f"({n_flat * P / 1e6:.0f} MB codes)")

        @functools.partial(jax.jit, static_argnames=("w", "nprobe"))
        def proj_search(q, w, nprobe, pm=pm, codes=codes, scales=scales):
            b = q.shape[0]
            q32 = q.astype(jnp.float32)
            cscores = jnp.dot(q32, cents_dev.T,
                              preferred_element_type=jnp.float32)
            p_eff = min(nprobe, ivf.nlist)
            _, probe = jax.lax.top_k(cscores[:, : ivf.nlist], p_eff)
            if extra:
                sp_cells = jnp.broadcast_to(
                    jnp.arange(ivf.nlist, nlist,
                               dtype=probe.dtype)[None, :], (b, extra))
                probe = jnp.concatenate([probe, sp_cells], axis=1)
            qp = q32 @ pm.T  # [B, P]
            qmax = jnp.maximum(jnp.max(jnp.abs(qp), axis=1), 1e-9)
            qscale = qmax / 127.0
            q8 = jnp.round(qp / qscale[:, None]).astype(jnp.int8)

            def step(carry, pc):
                bv, bi = carry
                blk = jnp.take(codes, pc, axis=0)  # [B, pad, P] int8
                sc = jnp.take(scales, pc, axis=0)
                ok = jnp.take(valid_dev, pc, axis=0)
                rid = jnp.take(rowid_dev, pc, axis=0)
                acc = jax.lax.dot_general(
                    blk, q8,
                    dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.int32).astype(jnp.float32)
                s = acc * sc * qscale[:, None] \
                    + jnp.take_along_axis(cscores, pc[:, None], axis=1) \
                    + (1.0 - ok) * NEG_INF
                vals = jnp.concatenate([bv, s], axis=1)
                ids = jnp.concatenate([bi, rid], axis=1)
                nv, pos = jax.lax.top_k(vals, w)
                return (nv, jnp.take_along_axis(ids, pos, axis=1)), None

            init = (jnp.full((b, w), NEG_INF, jnp.float32),
                    jnp.zeros((b, w), jnp.int32))
            (vals, idx), _ = jax.lax.scan(step, init, probe.T)
            return vals, idx

        entry = {}
        for W in (80, 256, 1024):
            _, idx = proj_search(qdev, W, args.nprobe)
            idx = np.asarray(jax.device_get(idx))
            rec = np.mean([
                len(oracle_sets[i] & set(map(int, idx[i]))) / args.k
                for i in range(args.queries)])
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                jax.device_get(proj_search(qdev, W, args.nprobe)[0])
                ts.append(time.perf_counter() - t0)
            entry[W] = {"recall_at_10_in_topW": round(float(rec), 4),
                        "ms_per_batch": round(sorted(ts)[1] * 1e3, 1)}
            log(f"P={P} W={W}: funnel recall {rec:.4f} "
                f"scan {sorted(ts)[1] * 1e3:.0f} ms/batch{args.queries}")
        report["proj"][f"P{P}"] = entry
        del codes, scales, vals_buf, sc_buf

    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
