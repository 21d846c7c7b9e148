#!/usr/bin/env python3
"""Smoke run of the system's main path on one NVIDIA GPU.

    python chip_smoke.py           # phases a-e, one card
    python chip_smoke.py --four    # the sharded path on four cards, only

Phases (any failure fails the run):
  a. device   — platform, kind, count, nvidia-smi name and power limit,
                JAX version, XLA_FLAGS, compile-cache directory, whether
                the native helper library built;
  b. encoder  — the configured encoder widths (config.py encoder_*)
                encode a few hundred chunks of the packaged corpus;
                a sample is checked against the same parameters run in
                float32 at highest precision on the CPU;
  c. served   — AppContext with the on-card encoder and the offline LLM
                stub: the packaged corpus uploads through the instant
                pipeline, then /api/query (plain and payer-filtered) and
                /api/skills/v1/corpus_search_agent answer in-process;
  d. exact    — bench.py's seeded 70k corpus (D=1536 float32 + the dense
                [16384, C] bf16 lexical matrix): vector-arm recall@10 vs
                a float64 numpy oracle, search and search_pipelined,
                gated rows never surface, the exact-arm dot's precision
                choices timed;
  e. proj     — 1M rows generated on the card, vector_backend=proj with
                host residency and int8 rows: raw block dots bitwise vs
                int32 numpy, full-probe and default-nprobe recall@10 vs
                the exact int8 oracle, the gated scan at tag levels 0-2
                timed with its bytes as a share of 3.35 TB/s.
  --four      — ShardedEngine on make_mesh(4) and make_serve_mesh(2, 2),
                and MeshEncoderModel on 4 cards, each against the
                one-card SearchEngine / EncoderModel.

Every number is printed beside the card's name and power limit. The
last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the run exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

K = 10
BATCH = 32
# recall floors (see each phase for what bounds them)
EXACT_RECALL_FLOOR = 0.99
PROJ_FULL_PROBE_FLOOR = 0.95
# per-row cosine between the card's bfloat16 encoder and the CPU float32
# reference: bf16 keeps 8 mantissa bits, so each activation carries
# ~0.4% relative error; through 12 residual layers and a mean pool the
# output direction stays within 1% of the exact one
ENCODER_COS_FLOOR = 0.99
# peak HBM bandwidth of one H100 SXM (NVIDIA data sheet)
H100_HBM_BYTES_PER_S = 3.35e12

_LABEL = ""


def say(msg: str) -> None:
    """One stdout line before the final JSON, with the card's label."""
    print(f"{msg} | card: {_LABEL}", flush=True)


def check(ok, what="check failed") -> None:
    """Fail the run (asserts vanish under python -O)."""
    if not ok:
        raise RuntimeError(str(what))


def _median_ms(fn, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# a. device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import jax

    from mobius_rag_tpu.utils.device import device_summary

    from mobius_rag_tpu.utils.native import get_lib

    dev = device_summary()
    say(f"[a] platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    # built from cpp/*.cc on first use; without it the host re-rank and
    # Aho-Corasick tagging fall back to numpy/Python
    say(f"[a] native helper library loaded: {get_lib() is not None}")
    say(f"[a] jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={jax.config.jax_compilation_cache_dir}")
    return dev


# ---------------------------------------------------------------------------
# b. encoder
# ---------------------------------------------------------------------------

def corpus_texts() -> list[str]:
    """Paragraphs of the packaged corpus, then each paragraph's
    sentences: a few hundred chunk-sized texts."""
    import yaml

    from mobius_rag_tpu.eval_harness.fixture_corpus import DEFAULT_CORPUS_DIR
    from mobius_rag_tpu.ingest.chunking import split_paragraphs_from_markdown

    with open(os.path.join(DEFAULT_CORPUS_DIR, "manifest.yaml")) as f:
        manifest = yaml.safe_load(f)
    paras = []
    for doc in manifest["documents"]:
        with open(os.path.join(DEFAULT_CORPUS_DIR, doc["file"])) as f:
            paras += [p.text for p in split_paragraphs_from_markdown(f.read())]
    sentences = [s.strip() + "." for p in paras
                 for s in p.replace("\n", " ").split(". ") if len(s) > 20]
    return paras + sentences


def phase_encoder(enc_cfg, texts: list[str], n_ref: int = 8,
                  floor: float = ENCODER_COS_FLOOR):
    """Encode `texts` on the default device; compare the first `n_ref`
    with a float32, highest-precision run of the same parameters on the
    CPU. Returns the model (reused by phase c)."""
    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.models.encoder import EncoderModel, encode_jit

    model = EncoderModel(enc_cfg, seed=0)
    t0 = time.perf_counter()
    emb = model(texts)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model(texts)
    warm_s = time.perf_counter() - t0
    check(emb.shape == (len(texts), enc_cfg.out_dim), emb.shape)
    check(np.isfinite(emb).all(), "non-finite embeddings")
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3)

    sample = texts[:n_ref]
    tokens = model._seq_bucket(model.tokenizer.encode_batch(sample))
    cpu = jax.devices("cpu")[0]
    ref_cfg = dataclasses.replace(enc_cfg, dtype="float32")
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = np.asarray(encode_jit(jax.device_put(model.params, cpu),
                                    jnp.asarray(tokens), ref_cfg))
    cos = np.sum(emb[:n_ref] * ref, axis=1) / np.maximum(
        np.linalg.norm(emb[:n_ref], axis=1) * np.linalg.norm(ref, axis=1), 1e-9)
    say(f"[b] encoder L={enc_cfg.num_layers} d={enc_cfg.model_dim} "
        f"mlp={enc_cfg.mlp_dim} seq={enc_cfg.max_seq} "
        f"vocab={enc_cfg.vocab_size} out={enc_cfg.out_dim}: "
        f"{len(texts)} chunks, first pass {first_s:.3f} s (incl. compile), "
        f"warm pass {warm_s:.3f} s = {len(texts) / warm_s:.1f} chunks/s")
    say(f"[b] bf16 card vs f32-highest CPU on {n_ref} chunks: per-row "
        f"cosine min={cos.min():.6f} mean={cos.mean():.6f} (floor {floor})")
    check(cos.min() >= floor, f"encoder off the CPU reference: {cos}")
    return model


# ---------------------------------------------------------------------------
# c. served path
# ---------------------------------------------------------------------------

SERVED_QUERIES = [
    "timely filing deadline for sunshine health claims",
    "prior authorization for residential treatment",
    "corrected claim submission window",
    "telehealth modifier for behavioral health",
    "provider dispute deadline aetna",
    "molina eligibility verification",
    "EPSDT child health check-up billing",
    "non-emergency transportation coverage",
]
FILTER_PAYER = "sunshine_health"


def phase_served(embed_fn) -> None:
    import yaml

    from mobius_rag_tpu.api.server import AppContext, build_app
    from mobius_rag_tpu.clients import OfflineLLMStub
    from mobius_rag_tpu.eval_harness.fixture_corpus import DEFAULT_CORPUS_DIR

    ctx = AppContext.build(embed_fn=embed_fn, llm=OfflineLLMStub())
    with open(os.path.join(DEFAULT_CORPUS_DIR, "manifest.yaml")) as f:
        manifest = yaml.safe_load(f)
    t0 = time.perf_counter()
    for doc in manifest["documents"]:
        with open(os.path.join(DEFAULT_CORPUS_DIR, doc["file"]), "rb") as f:
            data = f.read()
        ctx.pipeline.upload(
            data, doc["file"], payer=doc.get("payer", ""),
            state=doc.get("state", ""), program=doc.get("program", ""),
            authority_level=int(doc.get("authority_level", 0)),
            summary=doc.get("summary", ""), instant=True)
    upload_s = time.perf_counter() - t0
    n_docs = len(manifest["documents"])
    check(ctx.store.size > n_docs, f"only {ctx.store.size} chunks published")
    say(f"[c] uploaded {n_docs} documents -> {ctx.store.size} chunks "
        f"(extract, chunk, tag, encode, publish) in {upload_s:.3f} s")

    async def drive():
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(build_app(ctx)))
        await client.start_server()
        try:
            lat = []
            for q in SERVED_QUERIES:
                t0 = time.perf_counter()
                r = await client.post("/api/query", json={"query": q, "k": K})
                body = await r.json()
                lat.append((time.perf_counter() - t0) * 1e3)
                check(r.status == 200, body)
                check(body["results"], f"no results for {q!r}")
            r = await client.post("/api/query", json={
                "query": "timely filing deadline for claims", "k": K,
                "payer": FILTER_PAYER})
            body = await r.json()
            check(r.status == 200, body)
            hits = body["results"]
            check(hits, "payer-filtered query returned nothing")
            # a payer filter admits that payer's rows and, by design,
            # payer-unaffiliated regulator rows (inherited authority)
            for h in hits:
                m = h["metadata"]
                check(m["payer"] == FILTER_PAYER or (
                    m["payer"] == "" and m["authority_level"] >= 4), m)
            own = sum(h["metadata"]["payer"] == FILTER_PAYER for h in hits)
            t0 = time.perf_counter()
            r = await client.post("/api/skills/v1/corpus_search_agent", json={
                "query": "What is the timely filing deadline for Sunshine "
                         "Health Medicaid claims?", "payer": FILTER_PAYER})
            agent = await r.json()
            agent_ms = (time.perf_counter() - t0) * 1e3
            check(r.status == 200, agent)
            check(agent["answer"] or agent["refused"], agent)
            return lat, len(hits), own, agent, agent_ms
        finally:
            await client.close()

    lat, n_hits, own, agent, agent_ms = asyncio.run(drive())
    say(f"[c] /api/query x{len(lat)}: first {lat[0]:.3f} ms (incl. compile), "
        f"rest median {np.median(lat[1:]):.3f} ms")
    say(f"[c] payer={FILTER_PAYER}: {n_hits} hits, {own} of that payer, "
        f"the rest payer-less regulator rows; no other payer surfaced")
    say(f"[c] agent: {len(agent['chunks'])} chunks, refused={agent['refused']}, "
        f"strategies={agent['strategy_chain']}, {agent_ms:.3f} ms")


# ---------------------------------------------------------------------------
# d. 70k exact regime
# ---------------------------------------------------------------------------

def exact_fixture(n: int, nq: int, seed: int = 7):
    """bench.py's seeded corpus in a ChunkStore + its queries and the
    float64 oracle's top-k."""
    import jax

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkStore
    from mobius_rag_tpu.testing import sample_lexicon, seeded_corpus

    cfg = get_config()
    lexicon = sample_lexicon()
    recs, vectors, lexical, rng = seeded_corpus(n, lexicon, cfg, seed)
    t0 = time.perf_counter()
    store = ChunkStore(cfg, capacity=n)
    store.bulk_load(recs, vectors=vectors, lexical=lexical)
    jax.block_until_ready(store.index)
    load_s = time.perf_counter() - t0
    q_rows = rng.choice(n, nq, replace=False)
    qv = vectors[q_rows] + 0.15 * rng.standard_normal(
        (nq, cfg.embed_dim)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    exact = np.argsort(-(qv.astype(np.float64) @ vectors.astype(np.float64).T),
                       axis=1)[:, :K]
    return lexicon, store, vectors, qv, exact, load_s


def phase_exact(n: int = 70_000, nq: int = 64,
                floor: float = EXACT_RECALL_FLOOR) -> None:
    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine, to_bf16

    lexicon, store, vectors, qv, exact, load_s = exact_fixture(n, nq)
    cfg = store.cfg
    engine = SearchEngine(store, lexicon)
    say(f"[d] corpus {n} x {cfg.embed_dim} {cfg.vector_dtype} + lexical "
        f"[{cfg.lexical_buckets}, {store.capacity}] bf16: bulk_load "
        f"{load_s:.3f} s (set-up)")

    reqs = [QueryRequest(query="claims filing authorization requirements",
                         embedding=qv[i], tag_mode="none", mode="recall")
            for i in range(nq)]
    t0 = time.perf_counter()
    first = engine.search(reqs[:BATCH], k=K)
    compile_s = time.perf_counter() - t0
    results = first + engine.search(reqs[BATCH:], k=K)
    recalls = [len({h["row"] for h in r.telemetry["arms"]["vector"][:K]}
                   & set(map(int, exact[i]))) / K
               for i, r in enumerate(results)]
    recall = float(np.mean(recalls))
    say(f"[d] vector-arm recall@{K} vs float64 oracle on {nq} queries: "
        f"{recall:.4f} (floor {floor}); first batch {compile_s:.3f} s "
        f"(incl. compile)")
    check(recall >= floor, recall)

    batches = [reqs[i:i + BATCH] for i in range(0, nq, BATCH)]
    t0 = time.perf_counter()
    piped = engine.search_pipelined(batches, k=K)
    pipe_s = time.perf_counter() - t0
    check(all(r.hits for b in piped for r in b), "pipelined search empty")
    say(f"[d] search_pipelined {len(batches)} x {BATCH}: answered in "
        f"{pipe_s:.3f} s (incl. compile)")

    # gated rows: a deleted document and every other payer stay out
    gone_doc = results[0].hits[0].doc_id
    gone_rows = set(store._doc_rows.get(gone_doc, []))
    store.delete_by_document(gone_doc)
    gated = [QueryRequest(query="claims filing authorization requirements",
                          embedding=qv[i], tag_mode="relaxed",
                          payer="aetna", inherit_authority=False)
             for i in range(BATCH)]
    for r in engine.search(gated, k=K) + engine.search(reqs[:BATCH], k=K):
        for h in r.hits:
            check(h.row not in gone_rows, f"deleted row {h.row} surfaced")
    for r in engine.search(gated, k=K):
        check(r.hits, "payer-filtered query returned nothing")
        check(all(h.metadata["payer"] == "aetna" for h in r.hits))
    say(f"[d] deleted doc {gone_doc} ({len(gone_rows)} rows) and non-aetna "
        f"rows never surfaced under payer=aetna; peak device bytes "
        f"{_peak_bytes()}")

    # the exact arm's dot at batch 32: as shipped (bf16 query, default
    # precision — TF32 on the GPU), HIGHEST, and float32 queries at HIGHEST
    mat = store.index.vectors
    qb = jnp.asarray(to_bf16(qv[:BATCH]))
    qf = jnp.asarray(qv[:BATCH])
    oracle = np.argsort(-(qv[:BATCH].astype(np.float64)
                          @ vectors.astype(np.float64).T), axis=1)[:, :K]

    def arm(precision):
        @jax.jit
        def f(q, m):
            s = jnp.dot(q.astype(jnp.float32), m.T, precision=precision,
                        preferred_element_type=jnp.float32)
            return jax.lax.top_k(s[:, :n], K)[1]
        return f

    for name, f, q in (("bf16-query default", arm(None), qb),
                       ("bf16-query HIGHEST", arm(jax.lax.Precision.HIGHEST), qb),
                       ("f32-query HIGHEST", arm(jax.lax.Precision.HIGHEST), qf)):
        ms = _median_ms(lambda: f(q, mat), reps=20)
        idx = np.asarray(f(q, mat))
        rec = np.mean([len(set(map(int, a)) & set(map(int, b))) / K
                       for a, b in zip(idx, oracle)])
        say(f"[d] exact-arm dot+top_k, batch {BATCH} x {n}: {name} "
            f"{ms:.4f} ms, recall@{K} {rec:.4f}")


# ---------------------------------------------------------------------------
# e. proj + host residency
# ---------------------------------------------------------------------------

def proj_config():
    from mobius_rag_tpu.config import get_config

    return dataclasses.replace(
        get_config(), vector_backend="proj", vector_residency="host",
        vector_dtype="int8", lexical_format="sparse")


COPIES = 10


def graded_corpus(n: int, d: int, seed: int):
    """Device-generated graded near-duplicate corpus: n/10 base unit
    vectors, each with 10 copies whose noise norm grows 0, 0.03, ...,
    0.27 (the republished-revision geometry: a query near a base row
    has its family as a top-10 at distinct distances; an iid corpus
    instead puts hundreds of rows at near-identical distance from every
    query, ties no approximate index resolves). Returns (vectors [n, d]
    f32 on device, base [n/10, d])."""
    import jax
    import jax.numpy as jnp

    nb = n // COPIES
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def unit(x):
        return x / jnp.linalg.norm(x, axis=1, keepdims=True)

    base = unit(jax.random.normal(key, (nb, d), jnp.float32))
    copies = [unit(base + 0.03 * t * unit(jax.random.normal(
        jax.random.fold_in(key, t + 1), (nb, d), jnp.float32)))
        for t in range(COPIES)]
    return jnp.concatenate(copies, axis=0), base


def int8_oracle(store, qv: np.ndarray, block: int = 131072):
    """Exact top-k over the store's own int8 rows × scales, blockwise on
    the device in float32 at HIGHEST precision. Returns (scores, ids)."""
    import jax
    import jax.numpy as jnp

    n = store.size
    q = jnp.asarray(qv)

    @jax.jit
    def blk_topk(q, v8, sc):
        s = jnp.dot(q, (v8.astype(jnp.float32) * sc[:, None]).T,
                    precision=jax.lax.Precision.HIGHEST)
        return jax.lax.top_k(s, K)

    vals, ids = [], []
    for off in range(0, n, block):
        hi = min(off + block, n)
        v, i = blk_topk(q, jnp.asarray(store.host_vectors[off:hi]),
                        jnp.asarray(store.host_scales[off:hi]))
        vals.append(np.asarray(v))
        ids.append(np.asarray(i) + off)
    vals, ids = np.concatenate(vals, 1), np.concatenate(ids, 1)
    order = np.argsort(-vals, axis=1)[:, :K]
    return np.take_along_axis(vals, order, 1), np.take_along_axis(ids, order, 1)


def tie_aware_recall(store, qv, hits_rows, oracle_vals, tol: float = 1e-5):
    """A returned row counts when its exact int8 score reaches the
    oracle's k-th score within `tol` (float32 sums of 1536 products in
    another order differ by ~1e-6; graded copies can tie exactly)."""
    out = []
    for i, rows in enumerate(hits_rows):
        rows = np.asarray(rows, np.int64)
        s = (store.host_vectors[rows].astype(np.float64)
             * store.host_scales[rows, None]) @ qv[i].astype(np.float64)
        out.append(float(np.sum(s >= oracle_vals[i, K - 1] - tol)) / K)
    return float(np.mean(out))


def phase_proj(n: int = 1_000_000, nq: int = BATCH, seed: int = 11,
               floor: float = PROJ_FULL_PROBE_FLOOR) -> dict:
    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore, pack_bits
    from mobius_rag_tpu.ops.proj import (block_dots, encode_qmeta, gate_width,
                                         proj_search_gated, query_side)
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import numpy_filter_gate, sample_lexicon

    cfg = proj_config()
    d = cfg.embed_dim
    t0 = time.perf_counter()
    vectors, base = graded_corpus(n, d, seed)
    nb = n // COPIES
    payers = ("sunshine_health", "aetna", "molina")
    empty = np.zeros(0, np.float32)
    recs = [ChunkRecord(
        chunk_id=f"p{i}", doc_id=f"pd{i % nb}", text="", embedding=empty,
        payer=payers[(i % nb) % 3], state="FL", authority_level=0,
        j_tags=[i % 7], d_tags=[(i // 7) % 11], p_tags=[i % 5])
        for i in range(n)]
    store = ChunkStore(cfg, capacity=n)
    store.bulk_load(recs, vectors=vectors)
    del vectors, recs
    load_s = time.perf_counter() - t0
    engine = SearchEngine(store, sample_lexicon(), cfg=cfg)
    t0 = time.perf_counter()
    ann = engine.ensure_ann()
    local = engine._ensure_local_structs(ann)
    jax.block_until_ready((ann, local))
    build_s = time.perf_counter() - t0
    say(f"[e] {n} x {d} int8 host rows, proj p={ann.codes.shape[-1]} "
        f"nlist={ann.nlist} pad={ann.pad}: generate+bulk_load {load_s:.3f} s, "
        f"ann build {build_s:.3f} s (set-up)")

    rng = np.random.default_rng(seed)
    q_rows = rng.choice(nb, nq, replace=False)
    noise = rng.standard_normal((nq, d)).astype(np.float32)
    qv = np.asarray(base[jnp.asarray(q_rows)]) + 0.02 * noise / np.linalg.norm(
        noise, axis=1, keepdims=True)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    o_vals, _ = int8_oracle(store, qv)

    # raw int8 block dots on the card == int32 numpy
    q32 = jnp.asarray(qv)
    _, probe, q8, q_scale = jax.jit(query_side, static_argnums=2)(
        ann, q32, cfg.ivf_nprobe)
    codes_dev = ann.codes
    probe_np, q8_np = np.asarray(probe), np.asarray(q8)
    checked = 0
    for j in (0, 1, probe_np.shape[1] - 1):
        cells = probe_np[:, j]
        blk = np.asarray(codes_dev[jnp.asarray(cells)])
        got = np.asarray(block_dots(jnp.asarray(blk), q8))
        want = np.einsum("bsp,bp->bs", blk.astype(np.int32),
                         q8_np.astype(np.int32))
        np.testing.assert_array_equal(got, want)
        checked += got.size
    say(f"[e] raw int8 block dots bitwise equal to int32 numpy on "
        f"{checked} sampled dots")

    reqs = [QueryRequest(query="", embedding=qv[i], tag_mode="none",
                         mode="recall") for i in range(nq)]
    t0 = time.perf_counter()
    res = engine.search(reqs, k=K)
    first_s = time.perf_counter() - t0
    rec_default = tie_aware_recall(store, qv, [[h.row for h in r.hits]
                                               for r in res], o_vals)
    engine.cfg = dataclasses.replace(cfg, ivf_nprobe=ann.nlist)  # full probe
    res_full = engine.search(reqs, k=K)
    engine.cfg = cfg
    rec_full = tie_aware_recall(store, qv, [[h.row for h in r.hits]
                                            for r in res_full], o_vals)
    say(f"[e] recall@{K} vs exact int8 oracle (tie-aware): nprobe="
        f"{cfg.ivf_nprobe} {rec_default:.4f}, full probe (nprobe={ann.nlist}) "
        f"{rec_full:.4f} (floor {floor}); first batch {first_s:.3f} s "
        f"(incl. compile)")
    check(rec_full >= floor, rec_full)

    # the XLA gated scan at tag levels 0, 1, 2
    ix = store.index
    cols = {f: np.asarray(getattr(ix, f)) for f in (
        "valid", "authority", "payer", "state", "program",
        "j_tags", "d_tags", "p_tags")}
    tw = cfg.tag_words
    words = local[0]
    w_words = gate_width(tw)
    n_probe = int(probe_np.shape[1])
    bytes_moved = nq * n_probe * ann.pad * (ann.codes.shape[-1] + 4 * w_words)
    gated = {}
    for level in (0, 1, 2):
        zero = np.zeros((nq, tw), np.uint32)
        tagged = np.stack([pack_bits([i % 7], tw) for i in range(nq)])
        q = {"payer": np.array([i % 4 - 1 for i in range(nq)], np.int32),
             "state": np.full(nq, -1, np.int32),
             "program": np.full(nq, -1, np.int32),
             "tag_mode": np.array([i % 3 for i in range(nq)], np.int32),
             "inherit_authority": np.zeros(nq, np.float32),
             "j_bits": tagged if level >= 1 else zero,
             "d_bits": tagged if level >= 2 else zero,
             "p_bits": zero}
        strict = numpy_filter_gate(cols, dict(q, tag_mode=np.zeros(nq, np.int32)), 0)
        qmeta, qbits = encode_qmeta({key: jnp.asarray(v) for key, v in q.items()},
                                    jnp.asarray(strict.sum(axis=1) >= K))

        def scan(level=level, qmeta=qmeta, qbits=qbits):
            return proj_search_gated(ann, words, q32, qmeta, qbits, K,
                                     cfg.ivf_nprobe, tag_level=level, tw=tw)

        ms = _median_ms(scan)
        vals, ids = map(np.asarray, scan())
        check(np.isfinite(vals).all())
        ok = numpy_filter_gate(cols, q, K)
        live = vals > -1e30 / 2
        for b in range(nq):
            check(ok[b, ids[b][live[b]]].all(), f"level {level} query {b}")
        share = bytes_moved / (ms * 1e-3) / H100_HBM_BYTES_PER_S
        gated[level] = (ms, share)
        say(f"[e] XLA gated scan, tag level {level}, batch {nq}, nprobe "
            f"{cfg.ivf_nprobe} (+{n_probe - cfg.ivf_nprobe} always-probed "
            f"slabs): {ms:.4f} ms, {bytes_moved} bytes of codes+gate words "
            f"= {bytes_moved / (ms * 1e-3) / 1e9:.1f} GB/s, "
            f"{share:.4f} of 3.35 TB/s; live results all pass the numpy gate")
    say(f"[e] peak device bytes {_peak_bytes()}")
    return {"recall_default": rec_default, "recall_full": rec_full,
            "gated": gated}


# ---------------------------------------------------------------------------
# --four: sharded serving and the mesh encoder
# ---------------------------------------------------------------------------

def _fused_topk_agree(a: dict, b: dict, tol: float = 1e-4) -> int:
    """Queries whose fused top-k row sets differ beyond ties: rows only
    one side returned must score within `tol` of that side's k-th."""
    bad = 0
    for i in range(a["idx"].shape[0]):
        la, lb = a["rerank"][i] > -1e30 / 2, b["rerank"][i] > -1e30 / 2
        sa, sb = set(map(int, a["idx"][i][la])), set(map(int, b["idx"][i][lb]))
        if sa == sb:
            continue
        kth = min(a["rerank"][i][la].min(), b["rerank"][i][lb].min())
        only = [(a, r) for r in sa - sb] + [(b, r) for r in sb - sa]
        for side, r in only:
            pos = list(map(int, side["idx"][i])).index(r)
            if side["rerank"][i][pos] > kth + tol:
                bad += 1
                break
    return bad


def phase_four(enc_cfg, texts: list[str], n: int = 70_000,
               floor: float = ENCODER_COS_FLOOR) -> None:
    import jax

    from mobius_rag_tpu.models.encoder import EncoderModel, MeshEncoderModel
    from mobius_rag_tpu.parallel.mesh import make_mesh, make_serve_mesh
    from mobius_rag_tpu.parallel.sharded import ShardedEngine
    from mobius_rag_tpu.query.engine import (QueryRequest, SearchEngine,
                                             _search_compiled, unpack_out)

    check(len(jax.devices()) >= 4, f"--four needs 4 devices: {jax.devices()}")
    lexicon, store, _, qv, _, _ = exact_fixture(n, BATCH)
    single = SearchEngine(store, lexicon)
    reqs = [QueryRequest(query="claims filing authorization requirements",
                         embedding=qv[i], tag_mode="none", mode="recall")
            for i in range(BATCH)]
    q, _ = single.prepare_batch(reqs)
    cfg = store.cfg
    dense = unpack_out(jax.device_get(_search_compiled(
        store.index, q, K, cfg.over_fetch, cfg.rrf_k)), K)
    for name, mesh in (("make_mesh(4)", make_mesh(4)),
                       ("make_serve_mesh(2, 2)", make_serve_mesh(2, 2))):
        sharded = ShardedEngine(store, mesh=mesh)
        t0 = time.perf_counter()
        out = sharded.search_arrays(q, K)
        first_s = time.perf_counter() - t0
        bad = _fused_topk_agree(dense, out)
        say(f"[4] ShardedEngine {name} vs one-card SearchEngine, {n} rows, "
            f"batch {BATCH}: top-{K} differs beyond ties on {bad} queries; "
            f"first call {first_s:.3f} s (incl. compile)")
        check(bad == 0, f"{name}: {bad} queries differ")
        res = sharded.search(single, reqs[:4], k=K)
        check(all(r.hits for r in res))

    one = EncoderModel(enc_cfg, seed=0)
    mesh_enc = MeshEncoderModel(make_mesh(4, axis="dp"), enc_cfg, seed=0)
    a, b = one(texts), mesh_enc(texts)
    cos = np.sum(a * b, axis=1)
    say(f"[4] MeshEncoderModel on 4 cards vs EncoderModel on one, "
        f"{len(texts)} chunks: per-row cosine min={cos.min():.6f} "
        f"(floor {floor})")
    check(cos.min() >= floor, cos.min())


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    global _LABEL
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    # the encoder reference runs on the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    # the served path's sqlite stores and blobs go to a scratch data
    # dir unless the caller chose one
    data_dir = None
    if "MRAG_DATA_DIR" not in os.environ:
        data_dir = tempfile.mkdtemp(prefix="mrag-smoke-")
        os.environ["MRAG_DATA_DIR"] = data_dir
    try:
        from mobius_rag_tpu.utils import jit_cache
        from mobius_rag_tpu.utils.device import card_label, require_gpu

        try:
            require_gpu()
        except RuntimeError as e:
            print(f"chip_smoke: {e}", file=sys.stderr)
            return 2
        jit_cache.enable_persistent_cache()
        _LABEL = card_label().replace("\n", "; ")
        print(_LABEL, flush=True)
        dev = phase_device()

        from mobius_rag_tpu.models.encoder import EncoderConfig

        enc_cfg = EncoderConfig.from_env()
        texts = corpus_texts()
        if args.four:
            phase_four(enc_cfg, texts[:128])
            check(dev["count"] == 4, dev)
        else:
            model = phase_encoder(enc_cfg, texts)
            phase_served(model)
            del model
            phase_exact()
            import gc

            gc.collect()
            phase_proj()
        print(json.dumps({"ok": True, "device": dev}), flush=True)
        return 0
    finally:
        if data_dir:
            shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
