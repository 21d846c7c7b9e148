"""Per-stage device profiling for the compiled search pipeline.

The reference logs per-arm SQL timings into search_events
(corpus_search.py:3187) and eval/time_cmhc.py breaks a query's wall
time into bm25/rerank arms. The device analogue (SURVEY §5.1's stated
equivalent: "jax profiler traces + per-kernel timing in the same
search_id-keyed structure") must measure DEVICE stages — the serving
telemetry only records host-side prepare/device/assemble, which is
blind exactly where the time goes once host prep is fast.

Two mechanisms:

- :func:`profile_engine` — staged timing by compiled sub-programs. The
  full pipeline is ONE fused XLA program, so stage boundaries are
  measured by running progressively larger prefixes (each arm alone,
  all arms, arms+fusion+rerank) and differencing the medians. Every
  timing ends in ``jax.block_until_ready`` on the whole result. Results fold
  into the telemetry store as a ``profile`` search_event, search_id-
  keyed like every other event.
- :func:`capture_trace` — a real ``jax.profiler.trace`` around N
  queries, written under the data dir for TensorBoard/xprof.

Served at ``POST /admin/profile`` (api/extended.py).
"""
from __future__ import annotations

import functools
import os
import time
import uuid
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from mobius_rag_tpu.query import engine as eng


def _sync(x) -> None:
    """Wait until every array of the result is computed."""
    jax.block_until_ready(x)


def _timed(fn, iters: int = 5) -> float:
    """Median wall ms of fn() with completion forced; one warm call
    first (compile)."""
    _sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


@functools.partial(jax.jit, static_argnames=("k", "m", "which"))
def _arm_prefix(index, q, k: int, m: int, which: str):
    """Sub-programs for stage attribution. `which` picks the prefix:
    filters | vector | lexical | dtag | arms (all three + signals)."""
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    strict, relaxed, open_mask, meta_ok = eng.filter_masks(index, q)
    if which == "filters":
        return strict.sum() + relaxed.sum() + open_mask.sum() + meta_ok.sum()
    strict_total = strict.sum(axis=1)[:, None]
    penalty = eng.gate_penalty(strict, relaxed, open_mask, q, k, strict_total)
    cos, lex_raw, dtag_scores, _, _ = eng.arm_scores(
        index, q, k, penalty=penalty, meta_ok=meta_ok,
        strict_count=strict_total[:, 0])
    if which == "vector":
        vals, idx = jax.lax.top_k(cos + penalty, m)
        return vals.sum() + idx.sum()
    if which == "lexical":
        scores = jnp.where(lex_raw > 0, lex_raw, eng.NEG_INF) + penalty
        vals, idx = jax.lax.top_k(scores, m)
        return vals.sum() + idx.sum()
    if which == "dtag":
        vals, idx = jax.lax.top_k(dtag_scores, m)
        return vals.sum() + idx.sum()
    # "arms": the full candidate stage incl. signal gathers
    vals, gidx, sigs, st = eng.arm_candidates(index, q, k, m)
    return vals.sum() + gidx.sum() + sigs.sum() + st.sum()


def profile_engine(engine, reqs: Sequence, k: int | None = None,
                   iters: int = 5) -> dict[str, Any]:
    """Stage-attributed device timings for one query batch through the
    single-chip compiled pipeline. Returns ms medians per stage plus the
    host prepare/assemble costs, and records a search_id-keyed
    ``profile`` event when the engine has a telemetry store attached."""
    cfg = engine.cfg
    k = k or cfg.default_k
    if engine.sharded is not None:
        raise ValueError("profile_engine runs the single-chip pipeline; "
                         "detach the sharded engine to profile per-stage")
    ann = engine.ensure_ann()

    t0 = time.perf_counter()
    q, exps = engine.prepare_batch(reqs)
    prepare_ms = (time.perf_counter() - t0) * 1e3

    index = engine.store.index
    c = int(index.valid.shape[0])
    m = min(k * cfg.over_fetch, c)

    stages: dict[str, float] = {}
    if ann is None:  # per-arm prefixes exist only for the exact scan
        for which in ("filters", "vector", "lexical", "dtag", "arms"):
            stages[which] = _timed(
                lambda w=which: _arm_prefix(index, q, k, m, w), iters)
    full = _timed(
        lambda: eng._search_compiled(index, q, k, cfg.over_fetch, cfg.rrf_k,
                                     ann, cfg.ivf_nprobe), iters)
    stages["full_pipeline"] = full

    out = eng.unpack_out(jax.device_get(
        eng._search_compiled(index, q, k, cfg.over_fetch, cfg.rrf_k, ann,
                             cfg.ivf_nprobe)), k)
    t0 = time.perf_counter()
    engine._assemble(list(reqs), exps, out, k)
    assemble_ms = (time.perf_counter() - t0) * 1e3

    derived = {}
    if "arms" in stages:
        # differences are approximate: XLA fuses across the prefix
        # boundary in the full program, so the parts can sum past the
        # whole — report both, never hide the fusion effect
        derived = {
            "signals_ms": max(0.0, stages["arms"]
                              - max(stages["vector"], stages["lexical"],
                                    stages["dtag"])),
            "fusion_rerank_ms": max(0.0, full - stages["arms"]),
        }
    profile = {
        "profile_id": uuid.uuid4().hex[:12],
        "batch": len(reqs),
        "k": k,
        "corpus_rows": c,
        "backend": engine.vector_backend,
        "host_prepare_ms": round(prepare_ms, 3),
        "host_assemble_ms": round(assemble_ms, 3),
        "device_stages_ms": {s: round(v, 3) for s, v in stages.items()},
        **{key: round(v, 3) for key, v in derived.items()},
        "iters": iters,
        "note": ("stage prefixes are separately-compiled programs; the "
                 "full pipeline fuses across their boundaries, so parts "
                 "may not sum to the whole"),
    }
    if engine.telemetry is not None:
        engine.telemetry.record_search_event(
            query=f"[profile {profile['profile_id']}]", mode="profile",
            timings={"prepare": prepare_ms, "assemble": assemble_ms,
                     **{f"dev_{s}": v for s, v in stages.items()}},
            arms={}, expansion=[], results=[],
            extra={"profile": profile},
        )
    return profile


def capture_trace(engine, reqs: Sequence, k: int | None = None,
                  n_batches: int = 4, logdir: str | None = None) -> dict:
    """jax.profiler trace around N query batches. Returns the trace dir
    (TensorBoard `xprof`-readable) or the failure reason."""
    from mobius_rag_tpu.config import get_config

    k = k or engine.cfg.default_k
    logdir = logdir or os.path.join(get_config().data_dir, "profiles",
                                    time.strftime("%Y%m%d-%H%M%S"))
    engine.search(list(reqs), k=k)  # warm/compile outside the trace
    try:
        os.makedirs(logdir, exist_ok=True)
        with jax.profiler.trace(logdir):
            for _ in range(n_batches):
                engine.search(list(reqs), k=k)
        return {"ok": True, "trace_dir": logdir, "batches": n_batches}
    except Exception as e:  # pragma: no cover — profiler-dependent
        return {"ok": False, "error": str(e), "trace_dir": logdir}
