"""Scale benchmark: 1M-chunk corpus on one GPU — exact bf16 scan vs
int8 quantized scan vs IVF probed scan (BASELINE.json configs 4-5).

Corpus is generated ON DEVICE (no host transfer): 4096 cluster centers,
per-chunk noise — realistic locality for IVF. Ground truth = f32-accum
exact scan over the same bf16 matrix.

Usage: python bench_scale.py [--n 1000000] [--nprobe 32]   (fails without a GPU)
Prints one JSON line per method on stdout; progress on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def packed_mode(args):
    """--packed: the beyond-exact-scan regime (config 5). int8-only
    residency: generate → quantize block-wise (the fp source never fully
    materializes), k-means over the int8 matrix, pack cluster-contiguous,
    compare packed-IVF probing vs the int8 exact scan at small batch."""
    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.index.ivf import IVFIndex, PackedIVF, ivf_search_packed
    from mobius_rag_tpu.ops.quant import _quantize_block, cosine_topk_int8

    n, d, k, b = args.n, args.d, args.k, args.batch
    log(f"[packed] generating {n}x{d} int8 corpus (block-quantized)")
    key = jax.random.PRNGKey(0)
    kc, ka, kn, kq = jax.random.split(key, 4)
    n_centers = 4096
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)
    assign = jax.random.randint(ka, (n,), 0, n_centers)

    @jax.jit
    def gen_block(key, rows):
        v = centers[rows] + 0.05 * jax.random.normal(key, (rows.shape[0], d))
        return v / jnp.linalg.norm(v, axis=1, keepdims=True)

    vals, scales = [], []
    block = 100_000
    for off in range(0, n, block):
        vb = gen_block(jax.random.fold_in(kn, off), assign[off:off + block])
        qb, sb = _quantize_block(vb)
        vals.append(qb)
        scales.append(sb)
    v_int8 = jnp.concatenate(vals)
    s_rows = jnp.concatenate(scales)
    del vals, scales
    jax.block_until_ready(v_int8)
    log(f"[packed] int8 corpus ready ({v_int8.size / 1e9:.1f} GB)")

    q_rows = jax.random.randint(kq, (b,), 0, n)
    qv = v_int8[q_rows].astype(jnp.float32) * s_rows[q_rows][:, None]
    qv = qv + 0.02 * jax.random.normal(jax.random.fold_in(kq, 1), (b, d))
    qv = qv / jnp.linalg.norm(qv, axis=1, keepdims=True)
    penalty = jnp.zeros((n,), jnp.float32)

    def timed(fn, iters=10):
        out = fn()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
            jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / iters

    (e_vals, e_idx), t_exact = timed(
        lambda: cosine_topk_int8(v_int8, s_rows, qv, penalty, k))
    exact_set = [set(map(int, row)) for row in np.asarray(e_idx)]
    log(f"[packed] int8 exact scan: {t_exact * 1e3:.1f} ms/batch → {b / t_exact:.0f} qps")

    t0 = time.perf_counter()
    ivf = IVFIndex.build(v_int8, nlist=args.nlist, iters=6, pad_factor=2.0)
    pivf = PackedIVF.from_ivf(ivf, v_int8, row_scales=s_rows)
    del ivf
    jax.block_until_ready(pivf.values)
    log(f"[packed] packed IVF built in {time.perf_counter() - t0:.1f}s "
        f"(nlist {pivf.nlist}, pad {pivf.pad})")

    (p_vals, p_idx), t_p = timed(
        lambda: ivf_search_packed(pivf, qv, penalty, k, nprobe=args.nprobe))
    recall = float(np.mean([
        len(exact_set[i] & set(map(int, row))) / k
        for i, row in enumerate(np.asarray(p_idx))]))
    log(f"[packed] packed IVF nprobe={args.nprobe}: {t_p * 1e3:.1f} ms/batch "
        f"→ {b / t_p:.0f} qps, recall {recall:.4f} vs int8 exact")

    print(json.dumps({
        "metric": f"packed_ivf_{n // 1000}k_int8_1chip",
        "value": round(b / t_p, 1),
        "unit": "queries/sec",
        "vs_baseline": round((b / t_p) / (1.0 / 1.1), 1),
        "detail": {
            "int8_exact_qps": round(b / t_exact, 1),
            "packed_ivf_qps": round(b / t_p, 1),
            "recall_vs_int8_exact": round(recall, 4),
            "nprobe": args.nprobe, "batch": b,
        },
    }))


def hybrid_mode(args):
    """--hybrid: the FULL hybrid pipeline (filters, three arms, RRF,
    rerank, assembly) at --n chunks with the configured vector dtype —
    the engine-level companion to bench.py's 70k headline."""
    import time as _t

    import numpy as np

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu.ingest.featurize import featurize_chunk
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import sample_lexicon

    cfg = get_config()
    n, b, k = args.n, args.batch, args.k
    rng = np.random.default_rng(11)
    log(f"[hybrid] building {n}-chunk corpus (vector_dtype={cfg.vector_dtype}, "
        f"backend={cfg.vector_backend})")
    # CLUSTERED corpus (centers + noise): text-embedding spaces are
    # strongly clustered; a uniform-random corpus is the pathological
    # worst case for probed ANN and measures nothing real.
    n_centers = 4096
    centers = rng.standard_normal((n_centers, cfg.embed_dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_centers, n)
    vectors = centers[assign] + 0.05 * rng.standard_normal(
        (n, cfg.embed_dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    payers = ["sunshine_health", "aetna", "molina", ""]
    recs = [
        ChunkRecord(
            chunk_id=f"c{i}", doc_id=f"doc{i % (n // 10 or 1)}", source_id=f"s{i}",
            text=f"policy paragraph {i} on claims and authorization.",
            embedding=vectors[i], payer=payers[i % 4], state="FL",
            authority_level=int(rng.integers(0, 5)),
            d_tags=[int(rng.integers(0, 12))],
        )
        for i in range(n)
    ]
    lexicon = sample_lexicon()
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    t0 = _t.perf_counter()
    store = ChunkStore(cfg, capacity=n)
    store.bulk_load(recs, vectors=vectors)
    log(f"[hybrid] bulk_load {_t.perf_counter() - t0:.1f}s")
    engine = SearchEngine(store, lexicon)

    q_rows = rng.choice(n, b, replace=False)
    q_vecs = vectors[q_rows] + 0.02 * rng.standard_normal(
        (b, cfg.embed_dim)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)
    reqs = [
        QueryRequest(query=f"timely filing for {payers[i % 3]} claims",
                     embedding=q_vecs[i])
        for i in range(b)
    ]
    def measure(eng, rqs, reps=4):
        eng.search(rqs, k=k)  # warm (compile + ANN build)
        rounds = []
        for _ in range(3):
            t0 = _t.perf_counter()
            for _ in range(reps):
                eng.search(rqs, k=k)
            rounds.append(len(rqs) * reps / (_t.perf_counter() - t0))
        return sorted(rounds)[1], rounds

    if args.matrix:
        # one corpus, every (backend × batch) cell — the backend-selection
        # guidance table (exact amortizes the corpus read over the batch
        # matmul; probed backends win at small batch / huge N)
        exact_eng = SearchEngine(store, lexicon, vector_backend="exact")
        sanity_reqs = [QueryRequest(query=r.query, embedding=r.embedding,
                                    tag_mode="none") for r in reqs]
        ex_res = exact_eng.search(sanity_reqs, k=k)
        cells = {}
        for backend in ("exact", "ivf", "packed"):
            eng = SearchEngine(store, lexicon, vector_backend=backend)
            if backend != "exact":
                t0 = _t.perf_counter()
                eng.ensure_ann()
                log(f"[matrix] {backend} ANN build {_t.perf_counter() - t0:.1f}s")
            recall = 1.0
            if backend != "exact":
                res_ = eng.search(sanity_reqs, k=k)
                recalls = []
                for ra, re_ in zip(res_, ex_res):
                    a = {h["row"] for h in ra.telemetry["arms"]["vector"]}
                    e = {h["row"] for h in re_.telemetry["arms"]["vector"]}
                    if e:
                        recalls.append(len(a & e) / len(e))
                recall = round(float(np.mean(recalls)), 4)
            for bb in (1, 4, 32):
                qps_bb, rounds = measure(eng, reqs[:bb], reps=4 if bb > 1 else 8)
                cells[f"{backend}_b{bb}"] = {
                    "qps": round(qps_bb, 1), "recall_vs_exact": recall,
                    "rounds": [round(x, 1) for x in rounds]}
                log(f"[matrix] {backend} batch={bb}: {qps_bb:.1f} qps "
                    f"(recall {recall})")
        print(json.dumps({
            "metric": f"hybrid_backend_matrix_{n // 1000}k_1chip",
            "value": cells["exact_b32"]["qps"],
            "unit": "queries/sec",
            "vs_baseline": round(cells["exact_b32"]["qps"] / (1.0 / 1.1), 1),
            "detail": {"cells": cells, "nprobe": cfg.ivf_nprobe,
                       "vector_dtype": cfg.vector_dtype},
        }))
        return

    qps, rounds = measure(engine, reqs)
    # sanity on the VECTOR ARM with tag gating off (the gate correctly
    # filters this synthetic corpus's random tags; the reranker correctly
    # reorders by authority — neither invalidates the cosine math): each
    # query is an exact stored row, so it must top the ungated arm.
    sanity_reqs = [
        QueryRequest(query=r.query, embedding=r.embedding, tag_mode="none")
        for r in reqs
    ]
    res = engine.search(sanity_reqs, k=k)
    arm_top1 = float(np.mean([
        bool(r.telemetry["arms"]["vector"])
        and r.telemetry["arms"]["vector"][0]["row"] == q_rows[i]
        for i, r in enumerate(res)]))
    detail = {"vector_arm_self_top1": arm_top1,
              "vector_dtype": cfg.vector_dtype,
              "vector_backend": engine.vector_backend, "batch": b}
    if engine.vector_backend != "exact":
        # vector-arm recall vs the exact backend over the same store
        # (VERDICT r1 #2 done-criterion: ANN arm recall ≥0.97 vs exact)
        exact_eng = SearchEngine(store, lexicon, vector_backend="exact")
        ex = exact_eng.search(sanity_reqs, k=k)
        recalls = []
        for ra, re_ in zip(res, ex):
            a = {h["row"] for h in ra.telemetry["arms"]["vector"]}
            e = {h["row"] for h in re_.telemetry["arms"]["vector"]}
            if e:
                recalls.append(len(a & e) / len(e))
        detail["vector_arm_recall_vs_exact"] = round(float(np.mean(recalls)), 4)
        detail["nprobe"] = cfg.ivf_nprobe
        log(f"[hybrid] ANN vector-arm recall vs exact: "
            f"{detail['vector_arm_recall_vs_exact']}")
    log(f"[hybrid] {n // 1000}k chunks: {qps:.1f} qps median of "
        f"{[round(x) for x in rounds]}, vector-arm self top-1 {arm_top1:.2f}")
    print(json.dumps({
        "metric": f"hybrid_full_pipeline_{n // 1000}k_1chip",
        "value": round(qps, 1),
        "unit": "queries/sec",
        "vs_baseline": round(qps / (1.0 / 1.1), 1),
        "detail": detail,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=1536)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--packed", action="store_true",
                    help="int8-only packed-IVF regime (config 5)")
    ap.add_argument("--hybrid", action="store_true",
                    help="full hybrid pipeline at --n chunks")
    ap.add_argument("--matrix", action="store_true",
                    help="with --hybrid: every (backend x batch) cell on "
                         "one corpus build")
    args = ap.parse_args()
    from mobius_rag_tpu.utils.device import measurement_device

    log(f"device={measurement_device()}")
    if args.packed:
        packed_mode(args)
        return
    if args.hybrid:
        hybrid_mode(args)
        return

    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.index.ivf import IVFIndex, ivf_search
    from mobius_rag_tpu.ops.quant import cosine_topk_int8, quantize_rows
    from mobius_rag_tpu.ops.topk import cosine_topk_xla

    n, d, k, b = args.n, args.d, args.k, args.batch
    log(f"generating {n}x{d} clustered corpus on device")

    key = jax.random.PRNGKey(0)
    kc, ka, kn, kq = jax.random.split(key, 4)
    n_centers = 4096
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    @jax.jit
    def gen_block(key, center_rows):
        noise = jax.random.normal(key, (center_rows.shape[0], d), jnp.float32)
        v = centers[center_rows] + 0.05 * noise
        v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
        return v.astype(jnp.bfloat16)

    block = 100_000
    blocks = []
    assign = jax.random.randint(ka, (n,), 0, n_centers)
    for off in range(0, n, block):
        kb = jax.random.fold_in(kn, off)
        blocks.append(gen_block(kb, assign[off:off + block]))
    v_bf16 = jnp.concatenate(blocks, axis=0)
    jax.block_until_ready(v_bf16)
    del blocks  # free the 3 GB of generation blocks before quantizing
    log(f"corpus ready: {v_bf16.shape} bf16 ({v_bf16.size * 2 / 1e9:.1f} GB)")

    # queries: noisy copies of random rows
    q_rows = jax.random.randint(kq, (b,), 0, n)
    qv = v_bf16[q_rows].astype(jnp.float32) + 0.02 * jax.random.normal(
        jax.random.fold_in(kq, 1), (b, d), jnp.float32)
    qv = qv / jnp.linalg.norm(qv, axis=1, keepdims=True)
    penalty = jnp.zeros((n,), jnp.float32)

    def timed(fn, iters=10):
        out = fn()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
            jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / iters

    results = {}

    # exact bf16 (ground truth + baseline timing)
    (ex_vals, ex_idx), t_exact = timed(lambda: cosine_topk_xla(v_bf16, qv, penalty, k))
    exact_set = [set(map(int, row)) for row in np.asarray(ex_idx)]
    log(f"exact bf16 scan: {t_exact * 1e3:.1f} ms/batch → {b / t_exact:.0f} qps")
    results["exact_bf16"] = {"qps": b / t_exact, "recall": 1.0}

    # int8 quantized scan
    log("quantizing to int8...")
    v_int8, scales = quantize_rows(v_bf16)
    jax.block_until_ready(v_int8)
    (i_vals, i_idx), t_int8 = timed(lambda: cosine_topk_int8(v_int8, scales, qv, penalty, k))
    recall8 = float(np.mean([
        len(exact_set[i] & set(map(int, row))) / k
        for i, row in enumerate(np.asarray(i_idx))]))
    log(f"int8 scan: {t_int8 * 1e3:.1f} ms/batch → {b / t_int8:.0f} qps, recall {recall8:.4f}")
    results["int8"] = {"qps": b / t_int8, "recall": recall8}

    # IVF
    log(f"building IVF nlist={args.nlist}...")
    t0 = time.perf_counter()
    ivf = IVFIndex.build(v_bf16, nlist=args.nlist, iters=8, pad_factor=2.0)
    jax.block_until_ready(ivf.centroids)
    log(f"IVF built in {time.perf_counter() - t0:.1f}s (pad {ivf.pad}, spill {ivf.spill_count})")
    (v_vals, v_idx), t_ivf = timed(
        lambda: ivf_search(ivf, v_bf16, qv, penalty, k, nprobe=args.nprobe))
    recall_ivf = float(np.mean([
        len(exact_set[i] & set(map(int, row))) / k
        for i, row in enumerate(np.asarray(v_idx))]))
    log(f"IVF nprobe={args.nprobe}: {t_ivf * 1e3:.1f} ms/batch → {b / t_ivf:.0f} qps, "
        f"recall {recall_ivf:.4f}")
    results["ivf"] = {"qps": b / t_ivf, "recall": recall_ivf, "nprobe": args.nprobe}

    print(json.dumps({
        "metric": f"scale_scan_{n // 1000}k_1chip",
        "value": round(results["int8"]["qps"], 1),
        "unit": "queries/sec",
        "vs_baseline": round(results["int8"]["qps"] / (1.0 / 1.1), 1),
        "detail": {m: {kk: round(vv, 4) if isinstance(vv, float) else vv
                       for kk, vv in r.items()} for m, r in results.items()},
    }))


if __name__ == "__main__":
    main()
