"""1M-chunk END-TO-END serving benchmark on one GPU (BASELINE.md
build-target config 4).

Device-generated 1M x 1536 bf16 corpus with cluster locality, full hybrid engine (vector + lexical +
phrase arms, RRF + rerank in ONE compiled program), sparse lexical
layout, pipeline_merge-fused serving.

Measures (median of 3 rounds):
1. sync qps (one fetch per batch of 32);
2. pipelined qps (dispatch-all-then-fetch, merge-fused programs);
3. host prepare/assemble ms per batch (wrapped timers around the
   engine's own stages);
4. vector-arm self-hit sanity (exact corpus rows must retrieve
   themselves ungated).

Usage: python bench_1m_e2e.py [--n 1000000]   (fails without a GPU)
Writes eval_artifacts/BENCH_1m_e2e.json; prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Serving configuration (same operating point as bench.py's headline):
# fuse 4 same-size batches per pipelined program invocation.
os.environ.setdefault("MRAG_PIPELINE_MERGE", "4")
os.environ.setdefault("MRAG_LEXICAL_FORMAT", "sparse")

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu.ingest.featurize import featurize_chunk
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import sample_lexicon
    from mobius_rag_tpu.utils.device import measurement_device

    device = measurement_device()
    cfg = get_config()
    N, B, K, D = args.n, args.batch, args.k, cfg.embed_dim
    log(f"device={device} N={N} D={D}")

    # ---- corpus: device-generated, cluster locality ------------------------
    # 4096 unit centers + per-row noise, normalized, bf16 — generated in
    # 125k-row blocks entirely on device (no host RNG pass, no f32
    # upload of the corpus).
    t0 = time.perf_counter()
    n_centers = 4096
    key = jax.random.PRNGKey(11)
    kc, kb = jax.random.split(key)
    centers = jax.random.normal(kc, (n_centers, D), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    BLK = 125_000

    @jax.jit
    def gen_block(bkey, cents):
        ka_, kn_ = jax.random.split(bkey)
        rows = jax.random.randint(ka_, (BLK,), 0, n_centers)
        v = cents[rows] + 0.05 * jax.random.normal(kn_, (BLK, D), jnp.float32)
        v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
        return v.astype(jnp.bfloat16)

    blocks = [gen_block(jax.random.fold_in(kb, t), centers)
              for t in range((N + BLK - 1) // BLK)]
    vectors = jnp.concatenate(blocks, axis=0)[:N]
    vectors.block_until_ready()
    del blocks
    t_gen = time.perf_counter() - t0
    log(f"corpus generated on device: {t_gen:.1f}s ({N}x{D} bf16)")

    # ---- records + bulk_load ----------------------------------------------
    t0 = time.perf_counter()
    lexicon = sample_lexicon()
    payers = ["sunshine_health", "aetna", "molina", ""]
    _Z = np.zeros(0, np.float32)  # embedding supplied via the device array
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"doc{i % 70_000}",
                        source_id=f"s{i}",
                        text="policy paragraph on claims filing and "
                             "authorization requirements.",
                        embedding=_Z, payer=payers[i & 3], state="FL",
                        authority_level=i % 5, d_tags=[i % 12])
            for i in range(N)]
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    store = ChunkStore(cfg, capacity=N)
    store.bulk_load(recs, vectors=vectors)
    jax.block_until_ready(store.index.vectors)
    log(f"bulk_load: {time.perf_counter() - t0:.1f}s for {store.size} chunks")
    t_load = time.perf_counter() - t0

    engine = SearchEngine(store, lexicon)

    # ---- instrument host stages (prep + assemble wall time) ---------------
    stage_acc = {"prepare": [0.0, 0], "assemble": [0.0, 0]}

    def timed(name, fn):
        def wrap(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            stage_acc[name][0] += time.perf_counter() - t
            stage_acc[name][1] += 1
            return r
        return wrap

    engine.prepare_batch = timed("prepare", engine.prepare_batch)
    engine._assemble = timed("assemble", engine._assemble)

    # ---- self-hit sanity: exact corpus rows retrieve themselves -----------
    q_rows = np.arange(0, N, max(N // B, 1))[:B]
    q_vecs = np.asarray(jax.device_get(
        vectors[jnp.asarray(q_rows)].astype(jnp.float32)))
    sanity = [QueryRequest(query="claims filing authorization",
                           embedding=q_vecs[i], tag_mode="none",
                           mode="recall")
              for i in range(B)]
    res = engine.search(sanity, k=K)
    hits = sum(1 for i, r in enumerate(res)
               if int(q_rows[i]) in {h["row"]
                                     for h in r.telemetry["arms"]["vector"][:K]})
    log(f"vector-arm self-hit (ungated): {hits}/{B}")

    # ---- throughput ---------------------------------------------------------
    bench_reqs = [QueryRequest(
        query=f"timely filing deadline for {payers[i % 3]} claims",
        embedding=q_vecs[i % B]) for i in range(B)]

    engine.search(bench_reqs, k=K)  # warm sync program
    sync_rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.batches):
            engine.search(bench_reqs, k=K)
        sync_rounds.append(B * args.batches / (time.perf_counter() - t0))
    qps_sync = sorted(sync_rounds)[1]
    log(f"sync: {qps_sync:.1f} qps median of {[round(x) for x in sync_rounds]}")

    all_batches = [bench_reqs for _ in range(args.batches)]
    engine.search_pipelined(all_batches, k=K)  # warm the merge-fused program
    for v in stage_acc.values():
        v[0], v[1] = 0.0, 0
    pipe_rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        results = engine.search_pipelined(all_batches, k=K)
        pipe_rounds.append(B * args.batches / (time.perf_counter() - t0))
        assert all(r.hits for batch in results for r in batch)
    qps_pipe = sorted(pipe_rounds)[1]
    log(f"pipelined: {qps_pipe:.1f} qps median of {[round(x) for x in pipe_rounds]}")

    # per-BATCH host stage cost: prepare runs per merge-fused call
    # (merge x B queries), assemble per original batch
    prep_ms = (stage_acc["prepare"][0] / max(stage_acc["prepare"][1], 1)
               * 1e3 / max(cfg.pipeline_merge, 1))
    asm_ms = stage_acc["assemble"][0] / max(stage_acc["assemble"][1], 1) * 1e3

    out = {
        "metric": "hybrid_full_pipeline_1000k_1card",
        "device": device,
        "value": round(qps_pipe, 1),
        "unit": "queries/sec",
        "pipelined_qps": round(qps_pipe, 1),
        "sync_qps": round(qps_sync, 1),
        "batch": B,
        "pipeline_merge": cfg.pipeline_merge,
        "host_prepare_ms_per_batch": round(prep_ms, 2),
        "host_assemble_ms_per_batch": round(asm_ms, 2),
        "vector_arm_self_hit_ungated": f"{hits}/{B}",
        "note": "Full hybrid (vector+lexical+phrase arms, RRF+rerank, one "
                "compiled program) at 1M x 1536 bf16, sparse lexical, "
                "merge-fused pipelined serving; "
                "corpus device-generated with cluster locality; median "
                "of 3. tag_mode=none for sanity (synthetic tags "
                "uncorrelated with text).",
        "corpus_build": {"gen_on_device_s": round(t_gen, 1),
                         "bulk_load_s": round(t_load, 1)},
    }
    os.makedirs("eval_artifacts", exist_ok=True)
    with open("eval_artifacts/BENCH_1m_e2e.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("metric", "value", "unit", "pipelined_qps", "sync_qps",
                       "host_prepare_ms_per_batch",
                       "host_assemble_ms_per_batch")}))


if __name__ == "__main__":
    main()
