"""Round-4 eval driver — VERDICT r3 items 4, 5, 6 in one run.

Item 5 (an eval that can fail): the lexicon-free paraphrase bank
(data/bank_cmhc_paraphrase.yaml) runs through the full agent over the
blind corpus (distractors + adversarial traps) — recall < 1.0 is
possible by construction. Routing: calibrate → re-derive priors →
re-run, reporting routing_match_rate before/after, plus the
oracle/headroom computation (analyze_matrix) the reference treats as
its central calibration number (CANONICAL_STRATEGY_BASELINE.md §3).

Item 6 (encoder proven on real text): hold out every paragraph the
paraphrase bank targets plus a random 20% of corpus_cmhc paragraphs,
train the ICT encoder on the REMAINING text only, re-embed everything,
and score the paraphrase bank via the VECTOR ARM ONLY (pure cosine
top-10 — tag_mode/lexical dead by bank construction) for the trained
encoder vs the hash baseline. Held-out targets mean the encoder can't
have memorized the answer paragraphs.

Item 4 (σ-banded baselines): n runs per strategy (a / b / natural),
each over a RE-DRAWN distractor+trap corpus (different seed) — the
offline judge is deterministic, so corpus resampling is the variance
source (the reference's σ comes from LLM-judge noise; documented in
the artifact). Publishes mean ± σ and 2σ bands.

Writes eval_artifacts/EVAL_r4_cmhc.json and
eval_artifacts/CANONICAL_r4.json. Run (CPU mesh or chip):
  PYTHONPATH="$PYTHONPATH:/root/repo" python scripts/eval_r4.py
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

if "--cpu" in sys.argv:
    # set the config before any backend-initializing call (an ambient
    # JAX_PLATFORMS may already name the GPU).
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")


def log(msg):
    print(f"[eval_r4] {msg}", file=sys.stderr, flush=True)


def vector_only_scores(store, embed_fn, bank, k: int = 10):
    """Pure-cosine top-k over the store — the vector arm in isolation.
    Returns per-query rows + aggregates: citation@k (golden doc in the
    top-k) and fact_recall@k (must_facts found in top-k chunk texts)."""
    from mobius_rag_tpu.eval_harness.fact_checker import check_facts
    from mobius_rag_tpu.eval_harness.run import _citation_match

    vecs = np.asarray(store.index.vectors, np.float32)
    valid = np.asarray(store.index.valid) > 0
    rows, cites, recalls = [], [], []
    for q in bank.queries:
        qv = embed_fn([q.query])[0].astype(np.float32)
        qv /= max(np.linalg.norm(qv), 1e-9)
        sims = vecs @ qv
        sims[~valid[: len(sims)]] = -1e30
        top = np.argsort(-sims)[:k]
        recs = [store.record(int(r)) for r in top]
        recs = [r for r in recs if r is not None]
        gc = (q.expected.get("golden_citation") or {}).get("document", "")
        cite = any(_citation_match(gc, r.filename) or
                   _citation_match(gc, r.doc_id) for r in recs)
        fc = check_facts(q.must_facts, [r.text for r in recs])
        rows.append({"query_id": q.id, "citation_at_k": cite,
                     "fact_recall_at_k": fc.recall})
        cites.append(cite)
        recalls.append(fc.recall)
    return {
        "citation_at_10": round(sum(cites) / len(cites), 4),
        "fact_recall_at_10": round(sum(recalls) / len(recalls), 4),
        "per_query": rows,
    }


def build_blind_stack(seed: int, n_distractors: int):
    """Fixture stack + seeded distractors + adversarial traps (the
    round-3 blind-corpus recipe with a controllable draw)."""
    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.eval_harness.bank import load_bank
    from mobius_rag_tpu.eval_harness.fixture_corpus import (
        adversarial_corpus, build_fixture_stack, derive_selectivity,
        distractor_corpus)

    cfg = get_config()
    agent, engine, store, pipeline, info = build_fixture_stack()
    lexicon = engine.lexicon
    bank = load_bank("cmhc")
    store.add_chunks(distractor_corpus(n_distractors, lexicon, cfg,
                                       seed=seed))
    store.add_chunks(adversarial_corpus(bank, lexicon, cfg))
    derive_selectivity(store, lexicon)
    agent._tag_docs_cache = None
    return agent, engine, store, lexicon, bank


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "eval_artifacts"))
    ap.add_argument("--distractor-docs", type=int, default=1200)
    ap.add_argument("--sigma-runs", type=int, default=6)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--skip-sigma", action="store_true")
    ap.add_argument("--skip-encoder", action="store_true")
    ap.add_argument("--write-priors", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import jax

    from mobius_rag_tpu.config import get_config
    from mobius_rag_tpu.eval_harness.bank import load_bank
    from mobius_rag_tpu.eval_harness.calibrate import calibrate
    from mobius_rag_tpu.eval_harness.derive_priors import derive_priors
    from mobius_rag_tpu.eval_harness.matrix import analyze_matrix, run_matrix
    from mobius_rag_tpu.eval_harness.run import run_eval
    from mobius_rag_tpu.testing import hash_embed

    cfg = get_config()
    log(f"backend={jax.default_backend()} devices={len(jax.devices())}")
    artifact: dict = {"round": 4, "backend": jax.default_backend()}
    path = os.path.join(args.out, "EVAL_r4_cmhc.json")

    def save():
        # incremental checkpointing: a killed run keeps its finished
        # sections (merge-preserving: never drop keys an earlier or
        # parallel invocation already landed)
        merged = {}
        if os.path.exists(path):
            try:
                merged = json.load(open(path))
            except Exception:
                merged = {}
        merged.update(artifact)
        with open(path, "w") as f:
            json.dump(merged, f, indent=1, default=str)

    # ---- item 5: paraphrase bank + routing loop ---------------------------
    agent, engine, store, lexicon, bank_cmhc = build_blind_stack(
        7, args.distractor_docs)
    bank_para = load_bank("cmhc_paraphrase")

    out_para = run_eval(agent, bank_para)
    artifact["paraphrase_full_agent"] = {
        "aggregates": out_para.aggregates,
        "per_query": [{k: r.get(k) for k in
                       ("query_id", "chunk_recall", "judge_verdict",
                        "strategy_chain", "latency_ms")}
                      for r in out_para.results],
    }
    log(f"paraphrase (full agent): "
        f"recall={out_para.aggregates['mean_chunk_recall']} "
        f"citation={out_para.aggregates['citation_rate']}")
    save()

    out_core = run_eval(agent, bank_cmhc)
    routing_before = out_core.aggregates.get("routing_match_rate")
    log(f"core routing_match_rate BEFORE: {routing_before}")

    log("calibrating + re-deriving priors…")
    calib = calibrate(agent, bank_cmhc)
    priors_path = os.path.join(REPO, "mobius_rag_tpu", "data",
                               "router_priors.json")
    derived = derive_priors(
        calib["matrix"], calib["calib_id"],
        out_path=priors_path if args.write_priors
        else os.path.join(args.out, "derived_priors_r4.json"))
    artifact["derived_priors"] = {"cells": len(derived.get("priors", {})),
                                  "written_to": priors_path
                                  if args.write_priors else "artifact-only"}
    if args.write_priors:
        from mobius_rag_tpu.query.router import Router

        agent.router = Router(version=agent.router.version)
        out_core2 = run_eval(agent, bank_cmhc)
        routing_after = out_core2.aggregates.get("routing_match_rate")
    else:
        out_core2 = out_core
        routing_after = routing_before
    log(f"core routing_match_rate AFTER: {routing_after}")
    artifact["routing"] = {
        "match_rate_before": routing_before,
        "match_rate_after": routing_after,
        "mismatches": [
            {"query_id": r["query_id"],
             "expected": r["checks"]["routing"]["expected"],
             "chain": r["checks"]["routing"]["chain"]}
            for r in out_core2.results
            if r.get("checks", {}).get("routing")
            and not r["checks"]["routing"]["ok"]],
    }

    # oracle / headroom (the reference's central calibration number).
    # Run it on BOTH banks: the core bank saturates at recall 1.0 by
    # corpus construction (headroom degenerates to 0), so the
    # paraphrase bank — where arms genuinely differ — carries the
    # meaningful oracle/headroom figure.
    matrix = run_matrix(agent, bank_cmhc, strategies=("a", "b", "c", "d"))
    analysis = analyze_matrix(
        matrix, natural_run={"mean_chunk_recall":
                             out_core2.aggregates["mean_chunk_recall"]})
    para_matrix = run_matrix(agent, bank_para,
                             strategies=("a", "b", "c", "d"))
    para_analysis = analyze_matrix(
        para_matrix, natural_run={"mean_chunk_recall":
                                  out_para.aggregates["mean_chunk_recall"]})
    artifact["oracle_headroom_paraphrase"] = {
        k: para_analysis[k] for k in ("oracle_recall", "natural_recall",
                                      "routing_headroom", "arm_stats",
                                      "winner_distribution")}
    log(f"paraphrase oracle={para_analysis['oracle_recall']} "
        f"natural={para_analysis['natural_recall']} "
        f"headroom={para_analysis['routing_headroom']}")
    save()
    artifact["oracle_headroom"] = {
        k: analysis[k] for k in ("oracle_recall", "natural_recall",
                                 "routing_headroom", "arm_stats",
                                 "winner_distribution")}
    router_beats_every_arm = all(
        out_core2.aggregates["mean_chunk_recall"] >=
        st["mean_recall"] for st in analysis["arm_stats"].values())
    artifact["oracle_headroom"]["router_beats_every_single_arm"] = \
        router_beats_every_arm
    save()
    log(f"oracle={analysis['oracle_recall']} "
        f"natural={analysis['natural_recall']} "
        f"headroom={analysis['routing_headroom']} "
        f"router_beats_all_arms={router_beats_every_arm}")

    # ---- item 6: encoder proven on real text ------------------------------
    if not args.skip_encoder:
        from mobius_rag_tpu.eval_harness.fact_checker import check_facts
        from mobius_rag_tpu.index.store import ChunkStore
        from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel
        from mobius_rag_tpu.models.train import train_encoder_on_corpus
        from mobius_rag_tpu.parallel.mesh import make_train_mesh

        recs = [r for r in store.records if r is not None]
        # hold out: every paragraph containing a paraphrase-bank
        # must_fact (the targets) + a random 20%
        rng = np.random.default_rng(11)
        target_rows = set()
        for q in bank_para.queries:
            for i, r in enumerate(recs):
                if check_facts(q.must_facts, [r.text]).recall > 0:
                    target_rows.add(i)
        extra = rng.choice(len(recs), size=len(recs) // 5, replace=False)
        held = target_rows | set(int(x) for x in extra)
        train_recs = [r for i, r in enumerate(recs) if i not in held]
        log(f"encoder holdout: {len(held)} of {len(recs)} paragraphs "
            f"held out ({len(target_rows)} bank targets)")

        train_store = ChunkStore(cfg, capacity=len(train_recs) + 64)
        import copy

        train_store.add_chunks([copy.copy(r) for r in train_recs])
        enc_cfg = EncoderConfig(
            vocab_size=16384, num_layers=4, num_heads=8, model_dim=512,
            mlp_dim=2048, max_seq=128, out_dim=cfg.embed_dim)
        params, history = train_encoder_on_corpus(
            train_store, cfg=enc_cfg, steps=args.train_steps, batch=64,
            mesh=make_train_mesh(dp=1, tp=1))
        log(f"ICT train done: {history[-1]}")
        model = EncoderModel(enc_cfg, jax.device_get(params))

        # re-embed EVERYTHING (train + held-out) with each encoder
        def embed_store(fn):
            s = ChunkStore(cfg, capacity=len(recs) + 64)
            rs = [copy.copy(r) for r in recs]
            embs = fn([r.text for r in rs])
            for r, e in zip(rs, embs):
                r.embedding = np.asarray(e, np.float32)
            s.add_chunks(rs)
            return s

        trained_scores = vector_only_scores(embed_store(model), model,
                                            bank_para)
        hash_scores = vector_only_scores(embed_store(hash_embed), hash_embed,
                                         bank_para)
        artifact["encoder_real_text"] = {
            "holdout": {"held_paragraphs": len(held),
                        "bank_target_paragraphs": len(target_rows),
                        "train_paragraphs": len(train_recs)},
            "train_history_tail": history[-3:],
            "vector_arm_only": {"trained": trained_scores,
                                "hash_baseline": hash_scores},
        }
        log(f"vector-arm-only (paraphrase bank): trained "
            f"cite@10={trained_scores['citation_at_10']} "
            f"recall@10={trained_scores['fact_recall_at_10']} | hash "
            f"cite@10={hash_scores['citation_at_10']} "
            f"recall@10={hash_scores['fact_recall_at_10']}")
        save()

    # ---- item 4: σ-banded baseline ----------------------------------------
    if not args.skip_sigma:
        series: dict[str, list[float]] = {"a": [], "b": [], "natural": []}
        lat_series: dict[str, list[float]] = {k: [] for k in series}
        for i in range(args.sigma_runs):
            seed = 100 + i
            ag, _, _, _, bank_i = build_blind_stack(seed,
                                                    args.distractor_docs)
            for strat in series:
                out = run_eval(ag, bank_i,
                               forced_mode=None if strat == "natural"
                               else strat)
                series[strat].append(out.aggregates["mean_chunk_recall"])
                lat_series[strat].append(
                    out.aggregates["latency_ms_median"])
            log(f"σ run {i + 1}/{args.sigma_runs} (seed {seed}): "
                f"{ {k: v[-1] for k, v in series.items()} }")
            artifact["sigma_runs_partial"] = {k: list(v)
                                              for k, v in series.items()}
            save()
        bands = {}
        for strat, vals in series.items():
            mu = statistics.mean(vals)
            sd = statistics.pstdev(vals)
            bands[strat] = {
                "n": len(vals), "mean": round(mu, 4), "sigma": round(sd, 4),
                "band_2sigma": [round(mu - 2 * sd, 4),
                                round(mu + 2 * sd, 4)],
                "runs": [round(v, 4) for v in vals],
                "latency_ms_median_mean": round(
                    statistics.mean(lat_series[strat]), 1),
            }
        canonical = {
            "methodology": (
                "n same-fingerprint runs per strategy over RE-DRAWN "
                "distractor+trap corpora (seeds 100..); the offline "
                "judge is deterministic, so corpus resampling supplies "
                "the variance the reference gets from LLM-judge noise "
                "(CANONICAL_STRATEGY_BASELINE.md §1). 2σ bands per "
                "strategy; oracle/headroom from analyze_matrix on the "
                "fixed seed-7 corpus."),
            "bands": bands,
            "oracle_headroom": artifact["oracle_headroom"],
            "reference_bands": {
                "a": {"mean": 0.434, "sigma": 0.045, "n": 6},
                "b": {"mean": 0.241, "sigma": 0.007, "n": 6},
                "natural_range": [0.435, 0.543],
                "source": "BASELINE.md / CANONICAL_STRATEGY_BASELINE.md",
            },
        }
        with open(os.path.join(args.out, "CANONICAL_r4.json"), "w") as f:
            json.dump(canonical, f, indent=1, default=str)
        artifact["sigma_bands"] = bands
        log(f"σ bands: { {k: (v['mean'], v['sigma']) for k, v in bands.items()} }")

    artifact.pop("sigma_runs_partial", None)
    save()
    log(f"artifact written: {path}")
    print(json.dumps({
        "paraphrase_recall": out_para.aggregates["mean_chunk_recall"],
        "routing_match_before": routing_before,
        "routing_match_after": routing_after,
        "oracle_recall": analysis["oracle_recall"],
        "routing_headroom": analysis["routing_headroom"],
        "artifact": path,
    }))


if __name__ == "__main__":
    main()
