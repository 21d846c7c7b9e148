"""The round-2 quality loop (VERDICT r1 #1): measure retrieval quality on
REAL TEXT against the reference's own eval banks and record artifacts.

Pipeline:
  1. Ingest the authored fixture corpus (data/corpus_cmhc) through the
     full pipeline (upload → Path-B tagging → embed → publish).
  2. Eval queries_cmhc.yaml (natural routing) at CORE scale.
  3. Scale with policy-shaped distractor docs; eval again at SCALE.
  4. Gate-contour bank (queries_gate_contours.yaml) match rate.
  5. Forced-arm calibration matrix (a/b/c/d/s + natural) → derive_priors
     → regenerate data/router_priors.json from the framework's OWN
     calibration (replacing the round-1 reference-shaped priors).
  6. Train the on-device encoder on corpus ICT pairs, checkpoint it,
     re-embed the corpus + queries with it, and eval again — the
     trained-encoder pass the round-1 verdict flagged as missing.
  7. Write eval_artifacts/EVAL_r2_*.json with a number-for-number
     comparison against BASELINE.md's per-strategy table.

Honest-comparison caveats are recorded IN the artifact: the corpus is
authored from the bank's fact surface (reference's 70k-chunk production
corpus is not in its repo), the judge/fact-checker run offline
(token-overlap, not gemini-2.5-pro), and strategies c/d run without a
live web client.

Run on the real chip:
  PYTHONPATH="$PYTHONPATH:/root/repo" python scripts/quality_loop.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(msg):
    print(f"[quality_loop] {msg}", file=sys.stderr, flush=True)


def vector_arm_citation_at_10(store, embed_fn, bank) -> float:
    """Encoder-quality proxy: fraction of bank queries whose golden-
    citation document appears in the EXACT cosine top-10 (vector arm
    alone, no lexical/tag help). Measures the embedding space, not the
    hybrid pipeline."""
    from mobius_rag_tpu.eval_harness.run import _citation_match

    vecs = np.asarray(store.index.vectors, np.float32)
    valid = np.asarray(store.index.valid) > 0
    scored = []
    for q in bank.queries:
        gc = (q.expected.get("golden_citation") or {}).get("document")
        if not gc:
            continue
        qv = embed_fn([q.query])[0]
        qv = qv / max(np.linalg.norm(qv), 1e-9)
        sims = vecs @ qv
        sims[~valid[: len(sims)]] = -1e30
        top = np.argsort(-sims)[:10]
        hit = False
        for row in top:
            rec = store.record(int(row))
            if rec and (_citation_match(gc, rec.filename) or
                        _citation_match(gc, rec.doc_id)):
                hit = True
                break
        scored.append(hit)
    return round(sum(scored) / len(scored), 4) if scored else 0.0


def rebuild_with_encoder(store, lexicon, embed_fn, cfg):
    """Re-embed every live record with a new encoder and rebuild the
    index (encoder-version swap = full republish, the embedding-space-
    drift contract in models/checkpoint.py)."""
    from mobius_rag_tpu.index.store import ChunkStore

    recs = [r for r in store.records if r is not None]
    texts = [r.text for r in recs]
    embs = embed_fn(texts)
    new_store = ChunkStore(cfg)
    for r, e in zip(recs, embs):
        r.embedding = np.asarray(e, np.float32)
    new_store.add_chunks(recs)
    return new_store


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "eval_artifacts"))
    ap.add_argument("--distractor-docs", type=int, default=1200)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--train-batch", type=int, default=64)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--write-priors", action="store_true",
                    help="overwrite data/router_priors.json from calibration")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import jax

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.eval_harness.bank import load_bank
    from mobius_rag_tpu.eval_harness.calibrate import calibrate
    from mobius_rag_tpu.eval_harness.derive_priors import derive_priors
    from mobius_rag_tpu.eval_harness.fixture_corpus import (
        adversarial_corpus, build_fixture_stack, derive_selectivity,
        distractor_corpus)
    from mobius_rag_tpu.eval_harness.matrix import run_gate_on_bank
    from mobius_rag_tpu.eval_harness.run import run_eval
    from mobius_rag_tpu.testing import hash_embed

    cfg = get_config()
    log(f"backend={jax.default_backend()} devices={jax.devices()}")

    artifact: dict = {
        "round": 3,
        "backend": jax.default_backend(),
        "banks": {},
        "caveats": [
            "Corpus authored from the bank's fact surface (the reference's "
            "~70k-chunk production corpus is not in its repo). Round 3 adds "
            "the BLIND pass (cmhc_blind): near-miss number-perturbed and "
            "forbidden-fact trap documents sharing the queries' payers/tags "
            "compete inside the same filters, so recall saturation is no "
            "longer structural and precision/forbidden-hit-rate are scored.",
            "Judge + fact-checker run OFFLINE (token-overlap matcher with "
            "frame-vocabulary normalization), not the reference's locked "
            "gemini-2.5-pro judge.",
            "Strategies c/d degrade without a live web client (zero-egress "
            "pod); their calibration cells measure the corpus-backed path.",
            "Offline stack is deterministic: repeat runs are identical, so "
            "σ-bands collapse to 0 (reference σ comes from LLM-judge noise).",
        ],
    }

    # ---- 1-2. core-scale eval (hash encoder) -----------------------------
    log("building fixture stack (hash encoder)…")
    agent, engine, store, pipeline, info = build_fixture_stack()
    lexicon = engine.lexicon
    artifact["corpus_core"] = info
    bank_cmhc = load_bank("cmhc")

    # Contour expectations for the core bank (round-3 item: populate
    # contour_match_rate): every cmhc query is answerable from the
    # authored corpus BY CONSTRUCTION, so the gate should classify each
    # as in-corpus (EXACT, or VICINITY when only the neighborhood of
    # the tag combination is covered). This pins gate regressions on
    # known-answerable queries; it makes no blind-corpus claim.
    for q in bank_cmhc.queries:
        q.expected.setdefault("expected_contour", ["EXACT", "VICINITY"])

    out_core = run_eval(agent, bank_cmhc)
    artifact["banks"]["cmhc_core"] = {
        "aggregates": out_core.aggregates,
        "per_query": [{k: r[k] for k in
                       ("query_id", "chunk_recall", "judge_verdict",
                        "strategy_chain", "latency_ms")} for r in out_core.results],
    }
    log(f"core cmhc: recall={out_core.aggregates['mean_chunk_recall']} "
        f"citation={out_core.aggregates['citation_rate']}")

    # ---- 3. scale with distractors ---------------------------------------
    log(f"adding {args.distractor_docs} distractor docs…")
    recs = distractor_corpus(args.distractor_docs, lexicon, cfg)
    store.add_chunks(recs)
    n_docs = derive_selectivity(store, lexicon)
    agent._tag_docs_cache = None  # corpus changed → rebuild gate probe index
    artifact["corpus_scaled"] = {"chunks": store.size, "documents": n_docs}

    out_scaled = run_eval(agent, bank_cmhc)
    artifact["banks"]["cmhc_scaled"] = {
        "aggregates": out_scaled.aggregates,
        "per_query": [{k: r[k] for k in
                       ("query_id", "chunk_recall", "judge_verdict",
                        "strategy_chain", "latency_ms")} for r in out_scaled.results],
    }
    log(f"scaled cmhc ({store.size} chunks): "
        f"recall={out_scaled.aggregates['mean_chunk_recall']} "
        f"citation={out_scaled.aggregates['citation_rate']} "
        f"p50={out_scaled.aggregates['latency_ms_median']}ms")

    smoke = run_eval(agent, load_bank("cmhc_smoke"))
    artifact["banks"]["cmhc_smoke_scaled"] = {"aggregates": smoke.aggregates}

    # ---- 3b. BLIND pass: adversarial traps in the corpus -------------------
    # (round-3 item 5: make the quality claim falsifiable — chunk recall
    # < 1.0 is now possible, and wrong-number/forbidden content competes
    # inside the same payer/tag filters.)
    log("adding adversarial traps (near-miss numbers + forbidden facts)…")
    traps = adversarial_corpus(bank_cmhc, lexicon, cfg)
    store.add_chunks(traps)
    derive_selectivity(store, lexicon)
    agent._tag_docs_cache = None
    n_near = sum(1 for r in traps if r.extra.get("trap") == "near_miss")
    n_forb = len(traps) - n_near
    artifact["corpus_blind"] = {"chunks": store.size,
                                "trap_near_miss_chunks": n_near,
                                "trap_forbidden_chunks": n_forb}
    out_blind = run_eval(agent, bank_cmhc)
    artifact["banks"]["cmhc_blind"] = {
        "aggregates": out_blind.aggregates,
        "per_query": [{k: r.get(k) for k in
                       ("query_id", "chunk_recall", "judge_verdict",
                        "retrieval_precision", "trap_near_miss_hits",
                        "trap_forbidden_hit", "latency_ms")}
                      for r in out_blind.results],
    }
    log(f"blind cmhc: recall={out_blind.aggregates['mean_chunk_recall']} "
        f"precision={out_blind.aggregates.get('retrieval_precision_mean')} "
        f"forbidden_hit_rate={out_blind.aggregates.get('forbidden_hit_rate')}")

    # ---- 4. gate-contour bank ---------------------------------------------
    gate_out = run_gate_on_bank(agent, "gate_contours")
    artifact["banks"]["gate_contours"] = gate_out
    log(f"gate contours: match_rate={gate_out['match_rate']}")

    # ---- 5. calibration matrix + priors ------------------------------------
    log("calibration (forced a/b/c/d/s + natural)…")
    calib = calibrate(agent, bank_cmhc)
    artifact["calibration"] = calib
    priors_path = os.path.join(REPO, "mobius_rag_tpu", "data",
                               "router_priors.json")
    derived = derive_priors(calib["matrix"], calib["calib_id"],
                            out_path=priors_path if args.write_priors
                            else os.path.join(args.out, "derived_priors.json"))
    artifact["derived_priors"] = derived
    log(f"calibration per-strategy: "
        f"{ {k: v.get('mean_chunk_recall') for k, v in calib['per_run'].items()} }")

    # ---- 6. trained-encoder pass --------------------------------------------
    if not args.skip_train:
        from mobius_rag_tpu.models.checkpoint import save_encoder
        from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel
        from mobius_rag_tpu.models.train import train_encoder_on_corpus

        enc_cfg = EncoderConfig(
            vocab_size=16384, num_layers=4, num_heads=8, model_dim=512,
            mlp_dim=2048, max_seq=128, out_dim=cfg.embed_dim)
        log(f"training encoder on corpus ICT pairs "
            f"({args.train_steps} steps, batch {args.train_batch})…")
        import jax as _jax

        from mobius_rag_tpu.parallel.mesh import make_train_mesh

        n_dev = len(_jax.devices())
        mesh = make_train_mesh(dp=n_dev, tp=1) if n_dev > 1 else \
            make_train_mesh(dp=1, tp=1)
        params, history = train_encoder_on_corpus(
            store, cfg=enc_cfg, steps=args.train_steps,
            batch=args.train_batch, mesh=mesh)
        artifact["encoder_training"] = {
            "config": dataclasses.asdict(enc_cfg),
            "history_tail": history[-5:],
        }
        ckpt_dir = os.path.join(cfg.data_dir, "encoder_r3")
        save_encoder(ckpt_dir, jax.device_get(params), enc_cfg)
        artifact["encoder_checkpoint"] = ckpt_dir
        log(f"train done: {history[-1]}")

        model = EncoderModel(enc_cfg, jax.device_get(params))
        trained_store = rebuild_with_encoder(store, lexicon, model, cfg)
        derive_selectivity(trained_store, lexicon)

        from mobius_rag_tpu.query.agent import CorpusSearchAgent
        from mobius_rag_tpu.query.engine import SearchEngine

        trained_engine = SearchEngine(trained_store, lexicon, cfg=cfg,
                                      embed_fn=model)
        trained_agent = CorpusSearchAgent(trained_engine)
        out_trained = run_eval(trained_agent, bank_cmhc)
        artifact["banks"]["cmhc_trained_encoder"] = {
            "aggregates": out_trained.aggregates}
        artifact["vector_arm_citation_at_10"] = {
            "hash_encoder": vector_arm_citation_at_10(store, hash_embed, bank_cmhc),
            "trained_encoder": vector_arm_citation_at_10(
                trained_store, model, bank_cmhc),
        }
        log(f"trained-encoder cmhc: "
            f"recall={out_trained.aggregates['mean_chunk_recall']} "
            f"vector-arm cite@10={artifact['vector_arm_citation_at_10']}")

    # ---- 7. comparison vs BASELINE -------------------------------------------
    ref = {
        "strategy_a_recall": 0.405, "strategy_b_recall": 0.307,
        "strategy_c_recall": 0.092, "strategy_d_recall": 0.408,
        "router_natural_recall": 0.435, "oracle_recall": 0.598,
        "strategy_a_latency_median_s": 1.1,
        "router_natural_latency_median_s": 5.5,
        "source": "BASELINE.md (eval/calibration/CALIBRATION_BASELINE.md:59-87)",
    }
    ours = {
        name: run.get("mean_chunk_recall")
        for name, run in artifact["calibration"]["per_run"].items()
    }
    artifact["baseline_comparison"] = {
        "reference": ref,
        "ours_scaled_corpus": {
            "per_strategy_recall": ours,
            "natural_latency_median_ms":
                out_scaled.aggregates["latency_ms_median"],
        },
    }

    path = os.path.join(args.out, "EVAL_r3_cmhc.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, default=str)
    log(f"artifact written: {path}")
    print(json.dumps({
        "cmhc_scaled_recall": out_scaled.aggregates["mean_chunk_recall"],
        "cmhc_blind_recall": out_blind.aggregates["mean_chunk_recall"],
        "blind_precision": out_blind.aggregates.get("retrieval_precision_mean"),
        "forbidden_hit_rate": out_blind.aggregates.get("forbidden_hit_rate"),
        "contour_match_core": out_scaled.aggregates.get("contour_match_rate"),
        "citation_rate": out_scaled.aggregates["citation_rate"],
        "gate_contour_match": gate_out["match_rate"],
        "per_strategy": ours,
        "artifact": path,
    }))


if __name__ == "__main__":
    main()
