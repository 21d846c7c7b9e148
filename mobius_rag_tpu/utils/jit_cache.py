"""Persistent XLA compilation cache wiring.

XLA compiles of the wide fused serving programs dominate cold-start
wall time. JAX ships a persistent compilation cache that serializes
compiled executables to disk keyed on (HLO, compile options, backend);
enabling it turns every process restart after the first into a cache
hit, the same role the reference's long-lived uvicorn workers play for
its per-process prepared-statement caches (reference: app/database.py
pool reuse — there the "compile" being amortized is Postgres planning).

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this
  module sets no directory (nor a size bound if
  ``JAX_COMPILATION_CACHE_MAX_SIZE`` is set too);
- otherwise: one fixed directory inside the checkout,
  :data:`DEFAULT_DIR` (``.jax_cache/``, git-ignored). A fixed path
  matters: the path is part of what JAX keys on, so a moving
  directory never hits.

Opt-out via ``MRAG_JIT_CACHE=0``; bound on-disk size via
``MRAG_JIT_CACHE_MAX_SIZE`` bytes (JAX LRU-evicts past the bound;
default 4 GiB). Idempotent and safe to call from multiple entry points
(engine construction, encoder construction, bench/smoke mains, test
conftest).

The enabled/disabled decision is memoized for the life of the process:
a first-call failure (e.g. an unwritable checkout) latches the cache
off, and later env changes are ignored. That is by design — flipping
jax_compilation_cache_dir mid-process would split compiled state
across directories. Tests use :func:`_reset`.
"""
from __future__ import annotations

import logging
import os

_log = logging.getLogger("mobius_rag_tpu.jit_cache")
_enabled: bool | None = None

_DEFAULT_MAX_SIZE = 4 * 1024**3
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def _reset() -> None:
    """Clear the process memo (tests only; see module docstring)."""
    global _enabled
    _enabled = None


def enable_persistent_cache() -> bool:
    """Turn on JAX's persistent compilation cache (see module docstring
    for where it lives).

    Returns True when the cache is active (now or from an earlier
    call), False when disabled by env or unsupported by this JAX.
    """
    global _enabled
    if _enabled is not None:
        return _enabled
    if os.getenv("MRAG_JIT_CACHE", "1").strip().lower() in ("0", "false", "no", "off"):
        _enabled = False
        return False
    try:
        import jax

        env_dir = os.getenv("JAX_COMPILATION_CACHE_DIR", "").strip()
        cache_dir = env_dir or DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        if not env_dir:
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        # Cache everything that took >=1s to compile (programs below
        # that cost more in disk round-trips than in recompiles); no
        # size floor.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        if not os.getenv("JAX_COMPILATION_CACHE_MAX_SIZE"):
            jax.config.update(
                "jax_compilation_cache_max_size",
                int(os.getenv("MRAG_JIT_CACHE_MAX_SIZE",
                              str(_DEFAULT_MAX_SIZE))))
        _enabled = True
        _log.info("persistent XLA compilation cache at %s", cache_dir)
    except Exception as exc:  # pragma: no cover - depends on jax build
        # Never let cache plumbing break serving; fall back to in-memory.
        _log.warning("persistent compilation cache unavailable: %s", exc)
        _enabled = False
    return _enabled
