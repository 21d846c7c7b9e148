"""Test environment: force an 8-device virtual CPU mesh so sharding tests
(parallel/) run without accelerator hardware. Must run before jax
initializes a backend."""
import os

# Force CPU even when the ambient environment selects a GPU — tests need
# the 8-device virtual mesh. Set both env (for subprocesses) and config
# (in case jax was imported before this file ran).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Small shapes for tests — keep device arrays tiny.
os.environ.setdefault("MRAG_EMBED_DIM", "256")
os.environ.setdefault("MRAG_INITIAL_CAPACITY", "1024")
os.environ.setdefault("MRAG_LEXICAL_BUCKETS", "2048")
# Hermetic data dir: default-path sqlite stores (queue/eval/telemetry/
# curator) must not leak across test runs or into ~/.mobius_rag_tpu.
import tempfile

os.environ["MRAG_DATA_DIR"] = tempfile.mkdtemp(prefix="mrag-tests-")
# Persistent XLA compilation cache: the suite's wall time is dominated
# by CPU-backend compiles; cache them across runs in a test-owned fixed
# directory of the checkout (git-ignored), apart from the serving
# cache, so suite runs neither pollute serving state nor depend on it.
TEST_JIT_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache", "tests")
os.environ["JAX_COMPILATION_CACHE_DIR"] = TEST_JIT_CACHE

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update(
    "jax_num_cpu_devices", 8
)
jax.config.update("jax_compilation_cache_dir", TEST_JIT_CACHE)

import numpy as np
import pytest

from mobius_rag_tpu.utils import jit_cache

jit_cache.enable_persistent_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
