"""Config-5 demonstration: 10M × 1536 chunks served END-TO-END on one
GPU through the full SearchEngine API (BASELINE.md build target 5).

Architecture (MRAG_VECTOR_RESIDENCY=host):
- HBM holds the residual-PQ codes (pq_m bytes/row, cluster-contiguous)
  + tag bitsets + sparse lexical postings — NO dense vector payload.
- Host RAM holds the int8 rows (15.4 GB at 10M×1536) serving the
  post-fusion exact re-rank (engine._host_rerank).
- The corpus is generated ON HOST directly in int8 (quantized base
  embeddings + graded bounded int8 noise) from the embedding cache of
  scripts/ann_recall_curve.py; host→device int8 streams the matrix up
  once for the IVF assignment pass and once for the exact oracle.

Measures:
1. recall@10 of the full hybrid engine vs an exact-scan oracle
   (blockwise device scan over streamed-up int8 blocks — the 10M
   matrix never needs to be HBM-resident even for the oracle);
2. end-to-end qps (sync + pipelined, batch 32);
3. streaming embed-and-insert ingest: chunks/sec through
   store.add_chunks WHILE the engine keeps serving between batches
   (republish-grade liveness at 10M);
4. the memory budget (HBM arrays + host matrix), printed.

Usage:  python bench_10m.py [--n 10000000]   (fails without a GPU)
Caches (embeddings, corpus, oracle) live in MRAG_BENCH_CACHE (default:
the system temp directory). Writes eval_artifacts/BENCH_10m_e2e*.json;
prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("MRAG_VECTOR_RESIDENCY", "host")
os.environ.setdefault("MRAG_VECTOR_DTYPE", "int8")
# proj (PCA-projected residual int8, scored by int8 matmuls) rather
# than LUT-PQ, whose ADC scoring is a per-code-byte gather (ops/proj.py)
os.environ.setdefault("MRAG_VECTOR_BACKEND", "proj")
os.environ.setdefault("MRAG_PROJ_P", "192")
os.environ.setdefault("MRAG_LEXICAL_FORMAT", "sparse")
# 8 phrase words (256 tracked phrases) at 10M: the 64-word default costs
# 2.56 GB of HBM for the coverage bitset alone
os.environ.setdefault("MRAG_PHRASE_WORDS", "8")
os.environ.setdefault("MRAG_TAG_WORDS", "4")
os.environ.setdefault("MRAG_IVF_NLIST", "4096")
os.environ.setdefault("MRAG_IVF_NPROBE", "64")
os.environ.setdefault("MRAG_OVER_FETCH", "8")
# funnel: the vector arm hands its top-1024 (approximately ranked) to
# the exact host re-rank — at 10M the approximation error band covers
# ~10x more competitors than at 1M, and recall is funnel-width-bound
# (funnel diag: W=80 0.64 / W=1024 0.99 at 1M-slice geometry)
os.environ.setdefault("MRAG_HOST_FUNNEL", "1024")
CACHE = os.environ.get("MRAG_BENCH_CACHE", tempfile.gettempdir())
os.environ.setdefault("MRAG_DATA_DIR", os.path.join(CACHE, "mrag-bench10m"))

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--oracle-queries", type=int, default=32)
    ap.add_argument("--ingest-docs", type=int, default=20)
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the host corpus cache is written "
                         "(pre-build on CPU while the chip is busy)")
    # r4: the headline run is TAG-GATED — strict payer filtering through
    # the compiled filter gate, with payer correlated at the near-dup
    # FAMILY level (copies of a base row share a payer, the republished-
    # revision structure of real corpora; reference filter semantics:
    # corpus_search.py:1427-1555). --tag-mode none keeps the old
    # unfiltered ANN-only comparison available.
    ap.add_argument("--tag-mode", choices=["strict", "none"],
                    default="strict")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu.ingest.featurize import featurize_chunk
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import hash_embed, sample_lexicon
    from mobius_rag_tpu.utils.device import measurement_device

    device = measurement_device()
    cfg = get_config()
    N, B, K, D = args.n, args.batch, args.k, cfg.embed_dim
    log(f"device={device} N={N} D={D}")

    # ---- 1. corpus: tiled REAL-encoder embeddings, graded near-dups -------
    # Built on host. Substrate = the 1M trained-encoder embeddings cached
    # by scripts/ann_recall_curve.py (policy-shaped texts through the
    # trained checkpoint — the serving geometry), quantized to int8 and
    # tiled with per-copy GRADED int8 noise: copy t of base row b sits
    # at a distinct distance band (amplitude grows with t), the
    # republished-revision structure of real corpora. An iid-noise
    # synthetic corpus puts ~300 rows at near-identical distance from
    # every query — rank-k near-ties that NO approximate method can
    # resolve and that say nothing about serving recall.
    t0 = time.perf_counter()
    cache = os.environ.get("MRAG_BENCH_EMB_CACHE",
                           os.path.join(CACHE, "ann_curve_vec_u16.npy"))
    if not os.path.exists(cache):
        log(f"FATAL: embedding cache {cache} missing — run "
            "scripts/ann_recall_curve.py first (encodes + caches 1M rows)")
        sys.exit(2)
    import functools

    base_u16 = np.load(cache, mmap_mode="r")
    nb = min(base_u16.shape[0], max(N // 10, 1))
    T = (N + nb - 1) // nb  # ~10 graded copies per base row

    # Host-side array passes run as XLA-CPU jits (multithreaded, and
    # no ml_dtypes scalar conversion loop for bf16).
    @functools.partial(jax.jit, backend="cpu")
    def quant_block(u16):
        # bf16 → f32 via integer shift (ml_dtypes .astype is a scalar
        # loop), then per-row maxabs int8 with |v| ≤ 115 so +12 noise
        # can't wrap
        f = jax.lax.bitcast_convert_type(
            u16.astype(jnp.uint32) << 16, jnp.float32)
        m = jnp.maximum(jnp.max(jnp.abs(f), axis=1, keepdims=True), 1e-9)
        return jnp.round(f / m * 115.0).astype(jnp.int8)

    @functools.partial(jax.jit, backend="cpu", static_argnames=("amp",))
    def tile_block(b8, key, salt, amp):
        # fold_in INSIDE the cpu jit: an eager fold_in on the default
        # device would cost a device→host key fetch per call. Noise
        # from uint8 random bits +
        # modulo (4x fewer threefry words than 32-bit randint; the tiny
        # modulo bias is irrelevant for corpus noise).
        if amp:
            k = jax.random.fold_in(key, salt)
            bits = jax.random.bits(k, b8.shape, jnp.uint8)
            noise = (bits % np.uint8(2 * amp + 1)).astype(jnp.int32) - amp
            x = b8.astype(jnp.int32) + noise
        else:
            x = b8.astype(jnp.int32)
        norms = jnp.sqrt(jnp.sum((x * x).astype(jnp.float32), axis=1))
        return x.astype(jnp.int8), 1.0 / jnp.maximum(norms, 1.0)

    # disk cache: the built corpus survives crashes of the later
    # (device) phases, so a rerun skips the host build
    cvec = os.path.join(CACHE, f"bench10m_vec_{N}.npy")
    csca = os.path.join(CACHE, f"bench10m_sca_{N}.npy")
    if os.path.exists(cvec) and os.path.exists(csca):
        log(f"loading cached corpus from {cvec} (mmap copy)")
        host_vec = np.array(np.load(cvec, mmap_mode="r"))
        host_sca = np.array(np.load(csca, mmap_mode="r"))
    else:
        base8 = np.empty((nb, D), np.int8)
        QB = 125_000
        for off in range(0, nb, QB):
            hi = min(off + QB, nb)
            base8[off:hi] = np.asarray(
                quant_block(np.ascontiguousarray(base_u16[off:hi])))
        log(f"base quantized: {time.perf_counter() - t0:.0f}s")
        amps = [0, 1, 2, 3, 4, 5, 6, 8, 10, 12]
        with jax.default_device(jax.devices("cpu")[0]):
            ckey = jax.random.PRNGKey(5)  # on CPU; no device round trips
        host_vec = np.empty((N, D), np.int8)
        host_sca = np.empty((N,), np.float32)
        for t in range(T):
            lo, hi = t * nb, min((t + 1) * nb, N)
            amp = amps[t % len(amps)]
            for boff in range(0, hi - lo, QB):
                bhi = min(boff + QB, hi - lo)
                blk, sca = tile_block(base8[boff:bhi], ckey,
                                      np.uint32(t * 1000 + boff // QB), amp)
                host_vec[lo + boff:lo + bhi] = np.asarray(blk)
                host_sca[lo + boff:lo + bhi] = np.asarray(sca)
            log(f"  corpus copy {t + 1}/{T} amp={amp} "
                f"({time.perf_counter() - t0:.0f}s)")
        np.save(cvec, host_vec)
        np.save(csca, host_sca)
        log(f"corpus cached to {cvec}")
    del base_u16
    t_gen = time.perf_counter() - t0
    log(f"corpus ready: {t_gen:.0f}s "
        f"({host_vec.nbytes / 1e9:.1f} GB host, {nb} base rows × {T})")
    if args.build_only:
        log("--build-only: corpus cache written, exiting")
        return

    # ---- 2. oracle: blockwise exact scan (host blocks streamed up) --------
    # Runs FIRST, while HBM is empty: with the 3.9 GB of proj codes +
    # tag/lexical structures resident, the scan's cast transient OOMed a
    # 16 GB chip (session-8 crash). Queries = REAL production-shaped
    # query texts through the trained encoder (cached by
    # scripts/ann_recall_curve.py) — the serving geometry. The previous
    # recipe (row + 0.02/dim iid noise) put the query at cos ≈ 0.787
    # from its own source row with a 0.006-wide oracle band over 10M
    # rows — a near-degenerate margin no approximate method (including
    # the reference's HNSW) resolves, and not what any served query
    # looks like.
    qcache = os.environ.get("MRAG_BENCH_QUERY_CACHE",
                            os.path.join(CACHE, "ann_curve_queries.npy"))
    if not os.path.exists(qcache):
        log(f"FATAL: query cache {qcache} missing — run "
            "scripts/ann_recall_curve.py first (encodes the query bank)")
        sys.exit(2)
    qv = np.load(qcache)[: args.oracle_queries].astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    # tag-gated mode: query i targets payer (i % 3); eligible rows are
    # those whose near-dup FAMILY carries that payer (payer index =
    # family % 3, family = row % nb — matching the record construction
    # below). The oracle applies the SAME eligibility mask, so recall
    # measures the filtered task the engine actually serves.
    strict = args.tag_mode == "strict"
    q_tgt = np.arange(len(qv), dtype=np.int32) % 3

    @jax.jit
    def scan_block(qs, tgt, blk8, bsc, base):
        # f32-exact multiply (int8 values are exact in f32): the oracle's
        # boundary score is the tie-aware recall floor below, so its
        # arithmetic must match the host re-rank's exact f32 scoring —
        # bf16 query rounding (~1e-3 relative) would blur the boundary
        # by more than the near-dup copy gaps. Runs FIRST (empty HBM),
        # so the per-block f32 cast transient (1.5 GB at 250k rows) fits.
        s = jnp.dot(qs, blk8.astype(jnp.float32).T,
                    preferred_element_type=jnp.float32) * bsc[None, :]
        if strict:
            rows = base + jnp.arange(blk8.shape[0], dtype=jnp.int32)
            fam_payer = (rows % np.int32(nb)) % 3
            s = jnp.where(fam_payer[None, :] == tgt[:, None], s, -1e30)
        vals, idx = jax.lax.top_k(s, K)
        return vals, idx + base

    ocache = os.path.join(CACHE, f"bench10m_oracle_v2_{N}_{args.oracle_queries}"
                                 f"{'_strict' if strict else ''}.npz")
    t0 = time.perf_counter()
    if os.path.exists(ocache):
        z = np.load(ocache)
        best_i, best_v = z["idx"], z["vals"]
        log(f"oracle loaded from {ocache}")
    else:
        best_v = np.full((args.oracle_queries, K), -1e30, np.float32)
        best_i = np.zeros((args.oracle_queries, K), np.int64)
        qdev = jnp.asarray(qv)
        OB = 250_000
        for off in range(0, N, OB):
            hi = min(off + OB, N)
            v, i = jax.device_get(scan_block(
                qdev, jnp.asarray(q_tgt), jnp.asarray(host_vec[off:hi]),
                jnp.asarray(host_sca[off:hi]), jnp.int32(off)))
            allv = np.concatenate([best_v, v], axis=1)
            alli = np.concatenate([best_i, i], axis=1)
            top = np.argsort(-allv, axis=1)[:, :K]
            best_v = np.take_along_axis(allv, top, axis=1)
            best_i = np.take_along_axis(alli, top, axis=1)
            if off % 2_000_000 < OB:
                log(f"  oracle {off // 1_000_000}M/{N // 1_000_000}M "
                    f"({time.perf_counter() - t0:.0f}s)")
        np.savez(ocache, idx=best_i, vals=best_v)
        log(f"exact oracle scan: {time.perf_counter() - t0:.0f}s "
            f"(cached to {ocache})")
    oracle_sets = [set(map(int, row)) for row in best_i]

    # ---- 3. records + bulk_load (host residency) --------------------------
    t0 = time.perf_counter()
    payers = ["sunshine_health", "aetna", "molina"]
    # authority_level constant: the v1.3 rerank blend weighs authority
    # by DESIGN (policy semantics); random per-row authority uncorrelated
    # with relevance would make recall-vs-cosine-oracle measure the
    # blend, not the ANN path (see .claude/skills/verify: compare the
    # vector path against the cosine oracle, not the blended output).
    # payer/d_tags correlate at the near-dup FAMILY grain (family =
    # i % nb): all graded copies of a base row share a payer, so a
    # strict payer filter competes whole republished-revision families
    # — the realistic filtered-retrieval structure (the oracle above
    # masks with the same rule).
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"doc{i % 1_000_000}",
                        source_id=f"s{i}",
                        text="policy paragraph on claims and authorization.",
                        embedding=_Z, payer=payers[(i % nb) % 3], state="FL",
                        authority_level=0, d_tags=[(i % nb) % 12])
            for i in range(N)]
    lexicon = sample_lexicon()
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    log(f"records: {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    # capacity covers the streaming-ingest inserts: growth at 10M would
    # doubly allocate the host int8 matrix (a +15 GB spike) and copy the
    # full device index.
    store = ChunkStore(cfg, capacity=N + args.ingest_docs * 50 + 64)
    store.bulk_load(recs, vectors=host_vec)
    store.host_scales[:N] = host_sca  # direct int8 path keeps given scales
    jax.device_get(store.index.valid[:1])
    t_load = time.perf_counter() - t0
    log(f"bulk_load: {t_load:.0f}s")

    engine = SearchEngine(store, lexicon)
    t0 = time.perf_counter()
    engine.ensure_ann()  # IVF (host build) + projected-residual encode
    t_ann = time.perf_counter() - t0
    ann = engine._ann
    hbm = {
        "codes_gb": round(int(np.prod(ann.codes.shape)) / 1e9, 2),
        "rowids_valid_gb": round(
            (ann.rowids.size * 4 + ann.valid.size * 4) / 1e9, 2),
        "tags_gb": round(3 * N * cfg.tag_words * 4 / 1e9, 2),
        "phrase_bits_gb": round(N * cfg.phrase_words * 4 / 1e9, 2),
        "scalar_cols_gb": round(7 * N * 4 / 1e9, 2),
    }
    log(f"ANN ready in {t_ann:.0f}s; HBM budget: {hbm}")

    # ---- 4. engine recall + throughput ------------------------------------
    tm = args.tag_mode
    reqs = [QueryRequest(query=f"timely filing for {payers[i % 3]} claims",
                         embedding=qv[i % len(qv)], tag_mode=tm,
                         payer=payers[i % 3] if strict else "")
            for i in range(B)]
    engine.search(reqs, k=K)  # warm/compile
    # recall queries: EMPTY query text + given embedding, so the
    # lexical/d-tag arms are dead (zero lexical weights → lex_raw 0 →
    # NEG_INF rows) and ranking is sim-driven end-to-end — the
    # apples-to-apples comparison against the pure-cosine oracle (which
    # applies the SAME strict payer mask in tag-gated mode). Any
    # real token would hash into occupied lexical buckets and feed
    # collision junk into RRF; since sim = max(cos, lexn), junk lexn
    # saturates sim and the measurement becomes arm-dilution, not ANN
    # quality.
    res = engine.search(
        [QueryRequest(query="", embedding=qv[i], tag_mode=tm,
                      payer=payers[q_tgt[i]] if strict else "")
         for i in range(len(qv))], k=K)
    recalls, recalls_tie, recalls_fam = [], [], []
    for i, r in enumerate(res):
        got = [h.row for h in r.hits]
        recalls.append(len(set(got) & oracle_sets[i]) / K)
        # Tie-aware recall: this corpus carries EXACT duplicate rows
        # (templated near-dup families — ~2.6 rows per distinct text at
        # 1M bases), so the oracle's 10th/11th scores tie EXACTLY
        # (margin 0.0) and id-membership recall is capped by
        # arbitrary tie ordering, not retrieval quality. A hit whose
        # EXACT f32 score >= the oracle's k-th score (within f32
        # rounding) is correct by value — the metric the reference's
        # over-fetch tie-crowding trick exists for
        # (corpus_search.py:1453-1457).
        rows = np.asarray(got, np.int64)
        hv = host_vec[rows].astype(np.float32)
        sc = (hv @ qv[i]) * host_sca[rows]
        floor = best_v[i, K - 1] - 1e-6 * abs(best_v[i, K - 1])
        ok = (np.isin(rows, best_i[i]) | (sc >= floor))
        recalls_tie.append(float(ok.sum()) / K)
        # Family-grain recall: copies of one base row are revisions of
        # the SAME source text (near-tied scores ~1e-4 apart at the
        # k-boundary); retrieving a different revision of the text the
        # oracle picked is production success, so score at the family
        # grain: |engine families ∩ oracle families| / |oracle families|
        fam_e = {int(r) % nb for r in rows}
        fam_o = {int(r) % nb for r in best_i[i]}
        recalls_fam.append(len(fam_e & fam_o) / max(len(fam_o), 1))
    recall = float(np.mean(recalls))
    recall_tie = float(np.mean(recalls_tie))
    recall_fam = float(np.mean(recalls_fam))
    log(f"engine hybrid recall@{K} vs exact oracle: {recall:.4f} "
        f"(tie-aware {recall_tie:.4f}, family {recall_fam:.4f})")

    def median3(f):
        vals = []
        for _ in range(3):
            t0 = time.perf_counter()
            f()
            vals.append(time.perf_counter() - t0)
        return sorted(vals)[1]

    NB = 8
    t_sync = median3(lambda: [engine.search(reqs, k=K) for _ in range(NB)])
    sync_qps = B * NB / t_sync
    t_pipe = median3(lambda: engine.search_pipelined([reqs] * NB, k=K))
    pipe_qps = B * NB / t_pipe
    log(f"sync {sync_qps:.1f} qps, pipelined {pipe_qps:.1f} qps")

    # ---- 5. streaming embed-and-insert while serving -----------------------
    texts = [f"new policy bulletin {i} on prior authorization limits."
             for i in range(50)]
    t0 = time.perf_counter()
    inserted = 0
    for d in range(args.ingest_docs):
        embs = hash_embed(texts)  # stand-in encoder (encode benched elsewhere)
        new = [ChunkRecord(chunk_id=f"live{d}-c{i}", doc_id=f"live_doc_{d}",
                           source_id=f"live{d}-s{i}", text=texts[i],
                           embedding=embs[i] / np.linalg.norm(embs[i]),
                           payer="sunshine_health", state="FL")
               for i in range(len(texts))]
        store.add_chunks(new)
        inserted += len(new)
        # serving interleaved with ingest — full warm batch shape (a
        # narrower batch would compile a second 10M program)
        engine.search(reqs, k=K)
    t_ing = time.perf_counter() - t0
    ing_rate = inserted / t_ing
    log(f"streaming ingest: {inserted} chunks in {t_ing:.1f}s "
        f"= {ing_rate:.0f} chunks/s (interleaved with serving)")
    live_req = QueryRequest(
        query="new policy bulletin prior authorization",
        embedding=hash_embed([texts[0]])[0], tag_mode=tm,
        payer="sunshine_health" if strict else "")
    # ride the warm B=32 program (a B=1 call would compile a third one)
    live = engine.search([live_req] * B, k=K)[0]
    live_ok = any(h.doc_id.startswith("live_doc") for h in live.hits)
    log(f"freshly inserted chunks served: {live_ok}")

    art = {
        "metric": f"hybrid_pq_host_{N // 1_000_000}m_e2e_1card"
                  + ("_tag_gated" if strict else ""),
        "device": device,
        "value": round(pipe_qps, 1),
        "unit": "queries/sec",
        "pipelined_qps": round(pipe_qps, 1),
        "sync_qps": round(sync_qps, 1),
        "recall_at_10_vs_exact": round(recall_tie, 4),
        "recall_at_10_id_membership": round(recall, 4),
        "recall_at_10_family": round(recall_fam, 4),
        "recall_note": ("tie-aware: hits scoring >= the oracle's k-th "
                        "score count (exact-duplicate rows make the "
                        "oracle's k-boundary an exact tie; id-membership "
                        "recall caps at arbitrary tie ordering)"),
        "tag_mode": tm,
        "batch": B,
        "backend": engine.vector_backend,
        "nprobe": cfg.ivf_nprobe,
        "proj_p": cfg.proj_p,
        "host_funnel": cfg.host_funnel,
        "gating": "local" if engine._local_gating_active() else "dense",
        "proj_scan": "xla-gated" if engine._local_gating_active() else "xla",
        "streaming_ingest_chunks_per_s": round(ing_rate, 1),
        "fresh_inserts_served": live_ok,
        "memory_budget": {
            "hbm": hbm,
            "host_int8_matrix_gb": round(host_vec.nbytes / 1e9, 2),
        },
        "build_s": {"corpus_gen_stream": round(t_gen, 1),
                    "bulk_load": round(t_load, 1),
                    "ann_build": round(t_ann, 1)},
        "note": ("Config 5 (BASELINE build target): host vector residency "
                 "— HBM holds int8 PCA-projected-residual codes (int8 "
                 "matmul scan, ops/proj.py) + tag/lexical structures; int8 rows "
                 "in host RAM serve the funnel-wide post-fusion exact "
                 "re-rank (MRAG_HOST_FUNNEL). Full SearchEngine API "
                 "(prepare → compiled hybrid program with proj vector "
                 "arm → host re-rank → assemble). Oracle = blockwise "
                 "exact device scan of the same int8 matrix; queries = "
                 "trained-encoder embeddings of production-shaped query "
                 "texts. In tag_mode=strict the oracle applies the same "
                 "family-correlated payer mask the engine's compiled "
                 "filter gate enforces."),
    }
    print(json.dumps(art))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "eval_artifacts")
    os.makedirs(out_dir, exist_ok=True)
    tag = "_tag_gated" if strict else ""
    name = (f"BENCH_10m_e2e{tag}.json" if N >= 10_000_000
            else f"BENCH_{N // 1_000_000}m_e2e_validation{tag}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(art, f, indent=1)


_Z = np.zeros(0, np.float32)  # placeholder embedding (vectors given directly)

if __name__ == "__main__":
    main()
