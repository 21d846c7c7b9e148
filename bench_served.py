"""Served-path latency under concurrent load, on one GPU.

The reference's latency table is SERVED-path (BASELINE.md: strategy-a
median 1.1 s, p95 24 s through FastAPI+Postgres). This bench drives
the aiohttp server with concurrent batch-of-1 POST /api/query arrivals
at a fixed offered load and reports p50/p95/p99 — exercising the
round-4 adaptive micro-batcher (query/microbatch.py), which folds
arrivals into batched compiled-program invocations while the event
loop stays live.

Corpus: the 70k-chunk headline shape (bench.py's operating point).
Fails without a GPU. Writes eval_artifacts/BENCH_served_latency_<n>k.json;
prints one JSON line. Usage:
  python bench_served.py [--qps 100] [--seconds 20] [--n 70000]
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("MRAG_DATA_DIR", os.path.join(
    tempfile.gettempdir(), "mrag-bench-served"))

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def build_ctx(n: int):
    from mobius_rag_tpu.api.server import AppContext
    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu.ingest.featurize import featurize_chunk
    from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus

    cfg = get_config()
    lexicon = sample_lexicon()
    store = ChunkStore(cfg, capacity=n + 1024)
    base = toy_corpus(lexicon)
    log(f"building {n}-chunk corpus…")
    rng = np.random.default_rng(0)
    payers = ["sunshine_health", "aetna", "molina", ""]
    texts = [r.text for r in base]
    empty = np.zeros(0, np.float32)
    recs = []
    for i in range(n):
        t = texts[i % len(texts)]
        recs.append(ChunkRecord(
            chunk_id=f"c{i}", doc_id=f"doc{i // 50}", source_id=f"s{i}",
            text=t, embedding=empty,
            payer=payers[i % 4], state="FL", d_tags=[i % 12]))
    for r in recs[:256]:
        featurize_chunk(r, lexicon, cfg)
    # bulk vector generation: one RNG block tiled with row rolls, not a
    # per-record standard_normal loop — this is a LATENCY bench (vector
    # content is irrelevant; shapes and dtypes are what's exercised)
    blk = min(n, 65536)
    base_vecs = rng.standard_normal((blk, cfg.embed_dim)).astype(np.float32)
    reps = -(-n // blk)
    vectors = np.vstack([np.roll(base_vecs, r, axis=1)
                         for r in range(reps)])[:n]
    store.bulk_load(recs, vectors=vectors)
    ctx = AppContext.build(store=store, lexicon=lexicon,
                           embed_fn=hash_embed)
    return ctx


QUERIES = [
    "timely filing deadline for sunshine health claims",
    "prior authorization for residential treatment",
    "corrected claim submission window",
    "telehealth modifier for behavioral health",
    "provider dispute deadline aetna",
    "molina eligibility verification",
]


async def drive(ctx, qps: float, seconds: float, warmup: int = 12):
    from aiohttp.test_utils import TestClient, TestServer

    from mobius_rag_tpu.api.server import build_app

    # build the app INSIDE the driving loop: aiohttp binds an
    # Application to the loop that first serves it
    import aiohttp

    # warmup compiles the microbatch bucket shapes — a long first
    # request at 1M, past aiohttp's default 5-min total timeout
    client = TestClient(TestServer(build_app(ctx)),
                        timeout=aiohttp.ClientTimeout(total=3600))
    await client.start_server()
    try:
        async def one(i: int):
            t0 = time.perf_counter()
            r = await client.post("/api/query", json={
                "query": QUERIES[i % len(QUERIES)], "k": 10,
                "tag_mode": "none"})
            body = await r.json()
            assert r.status == 200, body
            return (time.perf_counter() - t0) * 1e3

        # warm every microbatch bucket shape (compiles are not latency)
        log("warmup (compiling batch shapes)…")
        for group in (1, 2, 4, 8, 16, 32):
            await asyncio.gather(*[one(i) for i in range(group)])

        log(f"driving {qps} qps offered for {seconds}s…")
        lat: list[float] = []
        tasks = []
        interval = 1.0 / qps
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < seconds:
            tasks.append(asyncio.ensure_future(one(i)))
            i += 1
            # uniform arrivals at the offered rate
            next_t = t_start + i * interval
            delay = next_t - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
        lat = list(await asyncio.gather(*tasks))
        elapsed = time.perf_counter() - t_start
        mb = await (await client.get("/admin/microbatch")).json()
        return lat, i / elapsed, mb
    finally:
        await client.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=70_000)
    ap.add_argument("--qps", type=float, default=100.0)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()

    from mobius_rag_tpu.utils.device import measurement_device

    device = measurement_device()
    log(f"device={device}")
    ctx = build_ctx(args.n)

    results = {}
    for qps in (args.qps, args.qps / 4):
        lat, achieved, mb = asyncio.new_event_loop().run_until_complete(
            drive(ctx, qps, args.seconds))
        arr = np.asarray(sorted(lat))
        results[f"offered_{int(qps)}qps"] = {
            "achieved_qps": round(achieved, 1),
            "n_requests": len(lat),
            "p50_ms": round(float(np.percentile(arr, 50)), 1),
            "p95_ms": round(float(np.percentile(arr, 95)), 1),
            "p99_ms": round(float(np.percentile(arr, 99)), 1),
            "max_ms": round(float(arr[-1]), 1),
            "microbatch": mb,
        }
        log(f"{qps} qps: {results[f'offered_{int(qps)}qps']}")

    head = results[f"offered_{int(args.qps)}qps"]
    art = {
        "metric": f"served_p50_ms_at_offered_load_{args.n // 1000}k",
        "value": head["p50_ms"],
        "unit": "ms",
        "device": device,
        "vs_baseline": round(1100.0 / max(head["p50_ms"], 1e-9), 1),
        "offered_qps": args.qps,
        "results": results,
        "note": ("POST /api/query through aiohttp with concurrent "
                 "batch-of-1 arrivals; adaptive micro-batching folds "
                 "in-flight arrivals into one compiled batch. Reference "
                 "served-path baseline: strategy-a median 1.1 s / p95 "
                 "24 s one-query-at-a-time (BASELINE.md)."),
    }
    print(json.dumps({"metric": art["metric"], "value": art["value"],
                      "unit": art["unit"], "p95_ms": head["p95_ms"],
                      "vs_baseline": art["vs_baseline"]}))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "eval_artifacts")
    os.makedirs(out_dir, exist_ok=True)
    name = f"BENCH_served_latency_{args.n // 1000}k.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(art, f, indent=1)


if __name__ == "__main__":
    main()
