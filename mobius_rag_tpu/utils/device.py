"""What a measurement runs on: the GPU check and the card's label.

Benchmarks and smoke runs measure the GPU. A run that finds no GPU
fails here instead of falling back to the CPU, so a CPU number can
never be reported under a device metric's name.
"""
from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def require_gpu():
    """Return ``jax.devices()`` when the default device is a GPU; raise
    RuntimeError naming what JAX found otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devices[0].platform} "
            f"({devices[0].device_kind}); this run measures the GPU and "
            "does not fall back to another device")
    return devices


def device_summary() -> dict:
    """The default device as JAX reports it: platform, kind, count."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_label() -> str:
    """``nvidia-smi``'s name and power limit for each card, one line
    per card, read in a child process that stays off JAX. The power
    limit belongs beside every number: a card set below its maximum
    runs slower under load."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def measurement_device() -> dict:
    """Start of every benchmark: refuse a non-GPU device, turn on the
    persistent compile cache, and return the device as JAX reports it
    plus the card's label, for the benchmark to print beside its
    numbers."""
    from mobius_rag_tpu.utils import jit_cache

    require_gpu()
    jit_cache.enable_persistent_cache()
    return {**device_summary(), "card": card_label()}
