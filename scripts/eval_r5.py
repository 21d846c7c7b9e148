"""Round-5 eval campaign (VERDICT r4 items 3/5/6 umbrella):

1. σ-banded strategy baselines at n=6 over RE-DRAWN distractor+trap
   corpora — on the 51-query paraphrase bank (the eval that can fail;
   the core bank saturates at 1.0 by construction) — matching the
   reference's n=6 methodology (CANONICAL_STRATEGY_BASELINE.md §1).
2. Gate-contour probes (para048-051) scored by contour_match_rate.
3. Priors derivation that MOVES: the six redraws' calibration matrices
   pool via merge_matrices (n sums across passes), then derive_priors
   emits per-cell before/after deltas — updated_cells must be > 0 or
   the artifact says exactly which gate blocked each cell.
4. Oracle/headroom on the paraphrase bank from the pooled forced runs.

CPU-only (--cpu default true here: the chip belongs to the 10M/encoder
campaigns; the agent stack is host-side at fixture scale).

Usage: PYTHONPATH=$PYTHONPATH:/root/repo python scripts/eval_r5.py \
           [--sigma-runs 6] [--distractors 400]
Writes eval_artifacts/EVAL_r5.json + eval_artifacts/CANONICAL_r5.json
incrementally.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sigma-runs", type=int, default=6)
    ap.add_argument("--distractors", type=int, default=400)
    ap.add_argument("--write-priors", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="run on the default accelerator (default: the "
                         "CPU backend, leaving the card free)")
    ap.add_argument("--out", default=os.path.join(REPO, "eval_artifacts"))
    args = ap.parse_args()

    import jax

    if not args.device:
        jax.config.update("jax_platforms", "cpu")

    from eval_r4 import build_blind_stack
    from mobius_rag_tpu.eval_harness.bank import load_bank
    from mobius_rag_tpu.eval_harness.calibrate import calibrate
    from mobius_rag_tpu.eval_harness.derive_priors import (derive_priors,
                                                           merge_matrices)
    from mobius_rag_tpu.eval_harness.run import run_eval

    bank_full = load_bank("cmhc_paraphrase")
    scoreable = dataclasses.replace(bank_full, queries=[
        q for q in bank_full.queries if q.must_facts])
    probes = dataclasses.replace(bank_full, queries=[
        q for q in bank_full.queries
        if q.expected.get("expected_contour")])
    log(f"paraphrase bank: {len(scoreable.queries)} scoreable, "
        f"{len(probes.queries)} contour probes")

    artifact: dict = {"round": 5, "sigma_runs": args.sigma_runs,
                      "bank_queries": len(scoreable.queries)}
    path = os.path.join(args.out, "EVAL_r5.json")

    def save():
        os.makedirs(args.out, exist_ok=True)
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1, default=str)

    series: dict[str, list[float]] = {"a": [], "b": [], "natural": []}
    lat_series: dict[str, list[float]] = {k: [] for k in series}
    contour_rates: list[float] = []
    matrices = []
    oracle_runs: list[float] = []
    calib_id = None
    for i in range(args.sigma_runs):
        seed = 500 + i
        t0 = time.perf_counter()
        ag, _, _, _, _ = build_blind_stack(seed, args.distractors)
        for strat in series:
            out = run_eval(ag, scoreable,
                           forced_mode=None if strat == "natural" else strat)
            series[strat].append(out.aggregates["mean_chunk_recall"])
            lat_series[strat].append(out.aggregates["latency_ms_median"])
        probe_out = run_eval(ag, probes)
        contour_rates.append(probe_out.aggregates.get("contour_match_rate"))
        # full forced-fan calibration on the same redraw — the matrix
        # pools across redraws for the priors derivation below
        cal = calibrate(ag, scoreable)
        matrices.append(cal["matrix"])
        oracle_runs.append(cal["oracle_recall"])
        calib_id = cal["calib_id"]
        log(f"σ run {i + 1}/{args.sigma_runs} (seed {seed}, "
            f"{time.perf_counter() - t0:.0f}s): "
            f"{ {k: round(v[-1], 3) for k, v in series.items()} } "
            f"contours={contour_rates[-1]} oracle={oracle_runs[-1]:.3f}")
        artifact["sigma_runs_partial"] = {k: list(v)
                                          for k, v in series.items()}
        save()

    bands = {}
    for strat, vals in series.items():
        mu = statistics.mean(vals)
        sd = statistics.pstdev(vals)
        bands[strat] = {
            "n": len(vals), "mean": round(mu, 4), "sigma": round(sd, 4),
            "band_2sigma": [round(mu - 2 * sd, 4), round(mu + 2 * sd, 4)],
            "runs": [round(v, 4) for v in vals],
            "latency_ms_median_mean": round(
                statistics.mean(lat_series[strat]), 1),
        }
    oracle_mu = statistics.mean(oracle_runs)
    natural_mu = bands["natural"]["mean"]
    artifact["sigma_bands"] = bands
    artifact["contour_match_rates"] = contour_rates
    artifact["oracle_headroom"] = {
        "oracle_recall_mean": round(oracle_mu, 4),
        "oracle_runs": [round(v, 4) for v in oracle_runs],
        "natural_recall_mean": natural_mu,
        "routing_headroom": round(oracle_mu - natural_mu, 4),
    }
    save()

    # ---- priors derivation that moves -----------------------------------
    merged = merge_matrices(matrices)
    priors_path = os.path.join(REPO, "mobius_rag_tpu", "data",
                               "router_priors.json")
    derived = derive_priors(
        merged, calib_id or "r5",
        out_path=priors_path if args.write_priors
        else os.path.join(args.out, "derived_priors_r5.json"))
    artifact["derived_priors"] = {
        "updated_cells": derived["updated_cells"],
        "deltas": derived["deltas"],
        "skipped": derived["skipped"][:40],
        "pooled_from_matrices": len(matrices),
        "written_to": derived["path"],
    }
    save()
    log(f"priors: {derived['updated_cells']} cells updated "
        f"({len(derived['deltas'])} deltas recorded)")

    canonical = {
        "methodology": (
            f"n={args.sigma_runs} same-fingerprint runs per strategy over "
            "RE-DRAWN distractor+trap corpora (seeds 500..) on the "
            f"{len(scoreable.queries)}-query paraphrase bank — the only "
            "bank whose recall sits off the 1.0 ceiling, so its bands "
            "carry regression sensitivity; the offline judge is "
            "deterministic, corpus resampling supplies the variance the "
            "reference gets from LLM-judge noise "
            "(CANONICAL_STRATEGY_BASELINE.md §1). Contour probes scored "
            "separately by contour_match_rate. Priors pooled across all "
            "redraws before derivation (derive_priors min_n honored)."),
        "bands": bands,
        "contour_match_rates": contour_rates,
        "oracle_headroom": artifact["oracle_headroom"],
        "derived_priors_summary": {
            "updated_cells": derived["updated_cells"],
            "n_deltas": len(derived["deltas"])},
        "reference_bands": {
            "a": {"mean": 0.434, "sigma": 0.045, "n": 6},
            "b": {"mean": 0.241, "sigma": 0.007, "n": 6},
            "natural_range": [0.435, 0.543],
            "source": "BASELINE.md / CANONICAL_STRATEGY_BASELINE.md",
        },
        "r4_baseline": {"a": [0.384, 0.016], "b": [0.375, 0.018],
                        "natural": [0.384, 0.016], "n": 4,
                        "bank_queries": 14},
    }
    with open(os.path.join(args.out, "CANONICAL_r5.json"), "w") as f:
        json.dump(canonical, f, indent=1, default=str)
    artifact.pop("sigma_runs_partial", None)
    save()
    print(json.dumps({
        "natural": bands["natural"]["mean"],
        "a": bands["a"]["mean"], "b": bands["b"]["mean"],
        "oracle": round(oracle_mu, 4),
        "headroom": artifact["oracle_headroom"]["routing_headroom"],
        "updated_cells": derived["updated_cells"],
    }))


if __name__ == "__main__":
    main()
