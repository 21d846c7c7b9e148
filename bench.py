"""Headline benchmark — run on one NVIDIA GPU.

Scenario mirrors the reference's operating point (SURVEY §6): a ~70k-chunk
published corpus, strategy-a hybrid queries, k=10. Two measurements:

1. recall@10 of the engine's vector arm vs an exact float64 numpy
   brute-force oracle over the same corpus (the pgvector-parity check —
   BASELINE.json target ≥ 0.99);
2. end-to-end queries/sec through the FULL compiled hybrid pipeline
   (host query prep + all three arms + RRF + rerank + host
   materialization), batched at 32, synced per batch.

Baseline: the reference's strategy-a median latency of 1.1 s/query on the
same corpus size (BASELINE.md: CALIBRATION_BASELINE.md:59), i.e. ~0.909
qps — it runs strictly one query at a time (SURVEY §7 phase 4).

Fails without a GPU. Prints the device and the card's nvidia-smi name
and power limit, then ONE JSON line on stdout; progress goes to stderr.
"""
from __future__ import annotations

import json
import os
import sys
import time

# Serving configuration: fuse 4 same-size batches per pipelined program
# invocation (merge is lossless — every score is per-query): fewer
# host↔device round trips and wider matmuls per dispatch. Whether it
# pays on a GPU host is not measured yet (ROADMAP 3.1).
os.environ.setdefault("MRAG_PIPELINE_MERGE", "4")

import numpy as np

N_CHUNKS = 70_000
K = 10
BATCH = 32
N_BATCHES = 8
BASELINE_QPS = 1.0 / 1.1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkStore
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import BENCH_PAYERS, sample_lexicon, seeded_corpus
    from mobius_rag_tpu.utils.device import measurement_device

    device = measurement_device()
    print(f"device: {device}", flush=True)
    cfg = get_config()

    # ---- corpus ----------------------------------------------------------
    log(f"building {N_CHUNKS}-chunk corpus (D={cfg.embed_dim}, H={cfg.lexical_buckets})")
    lexicon = sample_lexicon()
    recs, vectors, lexical, rng = seeded_corpus(N_CHUNKS, lexicon, cfg)
    t0 = time.perf_counter()
    store = ChunkStore(cfg, capacity=N_CHUNKS)
    store.bulk_load(recs, vectors=vectors, lexical=lexical)
    jax.block_until_ready(store.index.vectors)
    log(f"bulk_load: {time.perf_counter() - t0:.2f}s for {store.size} chunks")

    engine = SearchEngine(store, lexicon)

    # ---- recall@10 vs exact float64 brute force ---------------------------
    nq = 64
    q_rows = rng.choice(N_CHUNKS, nq, replace=False)
    q_vecs = vectors[q_rows] + 0.15 * rng.standard_normal((nq, cfg.embed_dim)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)

    exact = np.argsort(-(q_vecs.astype(np.float64) @ vectors.astype(np.float64).T), axis=1)[:, :K]

    reqs = [
        QueryRequest(query="claims filing authorization requirements",
                     embedding=q_vecs[i], tag_mode="none", mode="recall")
        for i in range(nq)
    ]
    # parity is defined on the VECTOR ARM (the component that replaces
    # pgvector's cosine top-k); the hybrid reranker deliberately reorders
    # by authority/coverage downstream, exactly like the reference's own
    # reranker does on top of pgvector.
    recalls = []
    for off in range(0, nq, BATCH):
        results = engine.search(reqs[off:off + BATCH], k=K)
        for bi, res in enumerate(results):
            got = {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
            want = set(map(int, exact[off + bi]))
            recalls.append(len(got & want) / K)
    recall = float(np.mean(recalls))
    log(f"vector-arm recall@{K} vs exact fp64 oracle: {recall:.4f}")

    # ---- throughput: full pipeline, synced per batch ----------------------
    bench_reqs = [
        QueryRequest(
            query=f"timely filing deadline for {BENCH_PAYERS[i % 3]} claims",
            embedding=q_vecs[i % nq],
        )
        for i in range(BATCH)
    ]
    # Median of 3 measurement rounds; report the spread beside it.
    engine.search(bench_reqs, k=K)  # warm / compile
    sync_rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_BATCHES):
            engine.search(bench_reqs, k=K)
        sync_rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
    qps = sorted(sync_rounds)[1]
    log(f"throughput: {qps:.1f} qps median of {[round(x) for x in sync_rounds]} "
        f"(batch={BATCH})")

    # pipelined throughput: dispatch all batches before the single sync —
    # the serving-throughput shape (amortizes per-dispatch overhead)
    all_batches = [bench_reqs for _ in range(N_BATCHES)]
    # warm with the FULL batch list: with pipeline_merge > 1 the fused
    # wider program (batch × merge queries) compiles on first use, and a
    # one-batch warmup would never trigger it
    engine.search_pipelined(all_batches, k=K)
    pipe_rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        results = engine.search_pipelined(all_batches, k=K)
        pipe_rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        assert all(r.hits for batch in results for r in batch)
    qps_pipe = sorted(pipe_rounds)[1]
    log(f"pipelined throughput: {qps_pipe:.1f} qps median of "
        f"{[round(x) for x in pipe_rounds]}")

    # single-query latency (sync each)
    one = [bench_reqs[0]]
    engine.search(one, k=K)
    t0 = time.perf_counter()
    for _ in range(10):
        engine.search(one, k=K)
    p50_ms = (time.perf_counter() - t0) / 10 * 1e3
    log(f"single-query end-to-end: {p50_ms:.1f} ms")

    print(json.dumps({
        "metric": "strategy_a_hybrid_qps_70k_1card",
        "value": round(qps_pipe, 2),
        "unit": "queries/sec",
        "vs_baseline": round(qps_pipe / BASELINE_QPS, 1),
        "recall_at_10_vs_exact": round(recall, 4),
        "qps_sync_per_batch": round(qps, 2),
        "single_query_ms": round(p50_ms, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
