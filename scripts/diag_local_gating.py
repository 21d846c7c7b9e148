"""Measure the candidate-local gating path against the dense [B, C]
pipeline on the chip at the 2M (default) or 10M corpus shape — the
round-5 follow-through on DIAG_sig_stages_10000000.json: the diagnosed
remainder (filter masks + penalty + lexical/d-tag [B, C] arms + the
scan's penalty gather) should collapse to the gated probed scan plus
candidate-space work.

Usage: PYTHONPATH=/root/repo python scripts/diag_local_gating.py [--n 2000000]
Writes eval_artifacts/DIAG_local_gating_{N}.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("MRAG_VECTOR_RESIDENCY", "host")
os.environ.setdefault("MRAG_VECTOR_DTYPE", "int8")
os.environ.setdefault("MRAG_VECTOR_BACKEND", "proj")
os.environ.setdefault("MRAG_PROJ_P", "192")
os.environ.setdefault("MRAG_LEXICAL_FORMAT", "sparse")
os.environ.setdefault("MRAG_PHRASE_WORDS", "8")
os.environ.setdefault("MRAG_TAG_WORDS", "4")
os.environ.setdefault("MRAG_IVF_NLIST", "4096")
os.environ.setdefault("MRAG_IVF_NPROBE", "64")
os.environ.setdefault("MRAG_OVER_FETCH", "8")
os.environ.setdefault("MRAG_HOST_FUNNEL", "1024")
os.environ.setdefault("MRAG_DATA_DIR", "/tmp/mrag-diag")

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu.ingest.featurize import featurize_chunk
    from mobius_rag_tpu.ops.proj import encode_qmeta, proj_search_gated
    from mobius_rag_tpu.query import engine as eng
    from mobius_rag_tpu.query import gating
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import sample_lexicon

    cfg = get_config()
    N, B, K = args.n, args.batch, args.k
    log(f"backend={jax.default_backend()} N={N}")

    cvec = "/tmp/bench10m_vec_10000000.npy"
    csca = "/tmp/bench10m_sca_10000000.npy"
    host_vec = np.array(np.load(cvec, mmap_mode="r")[:N])
    host_sca = np.array(np.load(csca, mmap_mode="r")[:N])
    qv = np.load("/tmp/ann_curve_queries.npy")[:B].astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)

    payers = ["sunshine_health", "aetna", "molina", ""]
    Z = np.zeros(0, np.float32)
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"doc{i % 100_000}",
                        source_id=f"s{i}",
                        text="policy paragraph on claims and authorization.",
                        embedding=Z, payer=payers[i & 3], state="FL",
                        authority_level=0, d_tags=[i % 12])
            for i in range(N)]
    lexicon = sample_lexicon()
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    store = ChunkStore(cfg, capacity=N)
    store.bulk_load(recs, vectors=host_vec)
    store.host_scales[:N] = host_sca
    jax.device_get(store.index.valid[:1])
    log("bulk_load done")

    dense_cfg = dataclasses.replace(cfg, gating="dense")
    local_cfg = dataclasses.replace(cfg, gating="local")
    engine = SearchEngine(store, lexicon, cfg=dense_cfg)
    ann = engine.ensure_ann()
    log("ann ready")
    local_engine = SearchEngine(store, lexicon, cfg=local_cfg)
    local_engine._ann = ann
    local_engine._ann_generation = store.generation
    t0 = time.perf_counter()
    local = local_engine._ensure_local_structs(ann)
    jax.device_get(local[0][0].ravel()[:1])
    t_gate_build = time.perf_counter() - t0
    log(f"gate structures built in {t_gate_build:.1f}s")

    reqs = [QueryRequest(query=f"timely filing for {payers[i % 3]} claims",
                         embedding=qv[i % len(qv)], tag_mode="strict",
                         payer=payers[i % 3])
            for i in range(B)]
    q, exps = engine.prepare_batch(reqs)
    qdev = {key: jnp.asarray(v) for key, v in q.items()}
    qdev["vec"] = qdev["vec"].astype(jnp.float32)
    tag_level = local_engine._batch_tag_level(exps)
    log(f"tag_level={tag_level}")
    nprobe = engine.effective_nprobe
    kd = engine._device_k(K)
    fw = engine._device_funnel(K)
    m_fuse = min(2 * kd, N)

    def timed(f, iters=5):
        jax.device_get(jax.tree.leaves(f())[0].ravel()[:1])
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.device_get(jax.tree.leaves(f())[0].ravel()[:1])
            ts.append(time.perf_counter() - t0)
        return round(sorted(ts)[len(ts) // 2] * 1e3, 1)

    res = {"tag_level": tag_level, "gate_build_s": round(t_gate_build, 1)}

    # -- stages of the local path --
    @jax.jit
    def strict_only(ix, qq):
        return gating.strict_counts(ix, qq).sum()

    res["strict_counts"] = timed(lambda: strict_only(store.index, qdev))

    @jax.jit
    def qmeta_of(ix, qq):
        sc = gating.strict_counts(ix, qq)
        return encode_qmeta(qq, sc >= K)

    qmeta, qbits = qmeta_of(store.index, qdev)
    jax.device_get(qmeta[:1])

    import functools

    @functools.partial(jax.jit, static_argnames=("lvl",))
    def vec_gated(ann_, g, qq, qm, qb, lvl):
        v, i = proj_search_gated(ann_, g, qq["vec"], qm, qb, fw, nprobe,
                                 0.0, lvl)
        return v.sum() + i.sum()

    res["vec_gated_w1024"] = timed(
        lambda: vec_gated(ann, local[0], qdev, qmeta, qbits, tag_level))

    @functools.partial(jax.jit, static_argnames=("lvl",))
    def lex_local(ix, qq, qm, qb, lvl):
        v, i, lb = gating.lexical_candidates_local(ix, qq, qm, qb,
                                                   m_fuse, lvl)
        return v.sum() + i.sum() + lb.sum()

    res["lex_local"] = timed(
        lambda: lex_local(store.index, qdev, qmeta, qbits, tag_level))

    @jax.jit
    def dtag_local(dt, qq, qm):
        v, i = gating.dtag_candidates_local(dt, qq, qm, m_fuse)
        return v.sum() + i.sum()

    res["dtag_local"] = timed(
        lambda: dtag_local(local[1], qdev, qmeta))

    # -- full programs --
    res["full_dense"] = timed(lambda: eng._search_compiled(
        store.index, qdev, kd, cfg.over_fetch, cfg.rrf_k, ann, nprobe, fw))
    res["full_local"] = timed(lambda: eng._search_compiled(
        store.index, qdev, kd, cfg.over_fetch, cfg.rrf_k, ann, nprobe, fw,
        0.0, local, tag_level))

    # -- end-to-end engine qps, both modes --
    for name, e in (("dense", engine), ("local", local_engine)):
        e.search(reqs, k=K)
        NB = 8
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            e.search_pipelined([reqs] * NB, k=K)
            ts.append(time.perf_counter() - t0)
        res[f"pipelined_qps_{name}"] = round(B * NB / sorted(ts)[1], 1)

    # -- result parity dense vs local at this scale --
    ra = engine.search(reqs, k=K)
    rb = local_engine.search(reqs, k=K)
    agree = np.mean([
        len({h.row for h in a.hits} & {h.row for h in b.hits})
        / max(len(a.hits), 1)
        for a, b in zip(ra, rb)])
    res["dense_local_topk_agreement"] = round(float(agree), 4)

    log(json.dumps(res))
    print(json.dumps({"metric": f"diag_local_gating_{N}", **res}))
    with open(f"/root/repo/eval_artifacts/DIAG_local_gating_{N}.json",
              "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
