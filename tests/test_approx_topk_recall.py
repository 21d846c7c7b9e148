"""approx_max_k option contract (cfg.ann_approx_topk).

The probed scans' final top-k optionally uses jax.lax.approx_max_k.
The default is EXACT (0.0). XLA's CPU and GPU backends lower
approx_max_k to an exact top-k (its fallback form), so on them the
option cannot change results. These tests pin:
- the default is OFF (0.0);
- merged_topk on the CPU parity mesh stays EXACT regardless of the
  approx setting (bitwise mesh parity);
- the engine's end-to-end results are identical either way on the CPU
  mesh (same gating).
"""
import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.config import get_config
from mobius_rag_tpu.ops.topk import merged_topk


def test_default_is_exact(monkeypatch):
    monkeypatch.delenv("MRAG_ANN_APPROX_TOPK", raising=False)
    cfg = get_config()
    assert cfg.ann_approx_topk == 0.0


def test_cpu_backend_stays_exact():
    assert jax.default_backend() == "cpu"
    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.normal(size=(4, 512)).astype(np.float32))
    ids = jnp.broadcast_to(jnp.arange(512, dtype=jnp.int32)[None], (4, 512))
    v_exact, i_exact = merged_topk(vals, ids, 16, approx_recall=0.0)
    v_appr, i_appr = merged_topk(vals, ids, 16, approx_recall=0.95)
    np.testing.assert_array_equal(np.asarray(i_exact), np.asarray(i_appr))
    np.testing.assert_array_equal(np.asarray(v_exact), np.asarray(v_appr))


def test_engine_results_identical_on_cpu_mesh(monkeypatch):
    from mobius_rag_tpu.index.store import ChunkStore
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus

    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex))
    req = [QueryRequest(query="timely filing deadline claims",
                        tag_mode="none")]

    def run(approx):
        monkeypatch.setenv("MRAG_ANN_APPROX_TOPK", str(approx))
        eng = SearchEngine(store, lex, embed_fn=hash_embed)
        res = eng.search(req, k=5)[0]
        return [(h.row, round(h.score, 6)) for h in res.hits]

    assert run(0.0) == run(0.95)
