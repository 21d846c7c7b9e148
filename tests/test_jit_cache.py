"""Persistent-compilation-cache wiring: idempotent, env-gated, and
actually pointed at JAX_COMPILATION_CACHE_DIR or the fixed default."""
import os

import jax

from mobius_rag_tpu.utils import jit_cache


def test_enabled_sets_dir_and_size_bound():
    # conftest already enabled it (first caller in-process wins).
    assert jit_cache.enable_persistent_cache() is True
    d = jax.config.jax_compilation_cache_dir
    assert d and os.path.isdir(d)
    # conftest points tests at the test-owned cache dir through
    # JAX_COMPILATION_CACHE_DIR, not the serving default.
    assert d == os.environ["JAX_COMPILATION_CACHE_DIR"]
    assert d != jit_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_max_size > 0


def test_env_opt_out_disables(monkeypatch):
    monkeypatch.setattr(jit_cache, "_enabled", None)
    monkeypatch.setenv("MRAG_JIT_CACHE", "0")
    assert jit_cache.enable_persistent_cache() is False
    # memo latches the decision for repeat callers
    monkeypatch.delenv("MRAG_JIT_CACHE")
    assert jit_cache.enable_persistent_cache() is False


def test_reset_clears_memo(monkeypatch):
    monkeypatch.setattr(jit_cache, "_enabled", False)
    jit_cache._reset()
    assert jit_cache._enabled is None
    assert jit_cache.enable_persistent_cache() is True


def test_custom_size_bound(monkeypatch):
    jit_cache._reset()
    monkeypatch.setenv("MRAG_JIT_CACHE_MAX_SIZE", "123456789")
    try:
        assert jit_cache.enable_persistent_cache() is True
        assert jax.config.jax_compilation_cache_max_size == 123456789
    finally:
        jit_cache._reset()
        monkeypatch.delenv("MRAG_JIT_CACHE_MAX_SIZE")
        jit_cache.enable_persistent_cache()


def test_engine_construction_invokes_cache():
    # SearchEngine.__init__ calls enable_persistent_cache(); the module
    # memo means this is just "doesn't raise and stays consistent".
    from mobius_rag_tpu.index.store import ChunkStore
    from mobius_rag_tpu.query.engine import SearchEngine
    from mobius_rag_tpu.testing import sample_lexicon, toy_corpus

    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex)[:4])
    eng = SearchEngine(store, lex)
    assert eng is not None
    assert jit_cache._enabled is not None


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    monkeypatch.setattr(jit_cache, "_enabled", None)
    return calls


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: no
    directory is set in code (nor a size bound when JAX's own
    JAX_COMPILATION_CACHE_MAX_SIZE is set too)."""
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_MAX_SIZE", "1000")
    assert jit_cache.enable_persistent_cache() is True
    assert "jax_compilation_cache_dir" not in calls
    assert "jax_compilation_cache_max_size" not in calls
    assert (tmp_path / "c").is_dir()


def test_fixed_default_inside_checkout(monkeypatch):
    """Without the env var the cache lands in one fixed, git-ignored
    directory of the checkout."""
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jit_cache.enable_persistent_cache() is True
    assert calls["jax_compilation_cache_dir"] == jit_cache.DEFAULT_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jit_cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
