"""Numerical parity of the masked cosine top-k ops against a numpy
brute-force oracle (the role pgvector exact scan plays for the reference;
test strategy mirrors SURVEY §4 tier 1: pure kernel tests vs numpy)."""
import numpy as np
import pytest

from mobius_rag_tpu.ops.topk import NEG_INF, cosine_topk_blocked, cosine_topk_xla


def _oracle(vectors, queries, penalty, k):
    scores = queries @ vectors.T + penalty[None, :]
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    return vals, idx


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("impl", [cosine_topk_xla, cosine_topk_blocked])
@pytest.mark.parametrize("n,b,k", [(1000, 4, 10), (513, 1, 7), (2048, 32, 25)])
def test_topk_matches_oracle(rng, impl, n, b, k):
    d = 256
    vectors = _normalize(rng.standard_normal((n, d)).astype(np.float32))
    queries = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    penalty = np.zeros(n, np.float32)
    vals, idx = impl(vectors, queries, penalty, k)
    ovals, _ = _oracle(vectors, queries, penalty, k)
    # Compare scores (indices can differ on exact ties).
    np.testing.assert_allclose(np.asarray(vals), ovals, atol=2e-3)
    # And the returned indices reproduce the returned scores.
    rescore = np.take_along_axis(queries @ vectors.T, np.asarray(idx), axis=1)
    np.testing.assert_allclose(np.asarray(vals), rescore, atol=2e-3)


@pytest.mark.parametrize("impl", [cosine_topk_xla, cosine_topk_blocked])
def test_topk_respects_mask(rng, impl):
    n, d, b, k = 600, 256, 3, 15
    vectors = _normalize(rng.standard_normal((n, d)).astype(np.float32))
    queries = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    penalty = np.zeros(n, np.float32)
    blocked = rng.choice(n, size=500, replace=False)
    penalty[blocked] = NEG_INF
    allowed = np.setdiff1d(np.arange(n), blocked)
    vals, idx = impl(vectors, queries, penalty, k)
    idx = np.asarray(idx)
    vals = np.asarray(vals)
    live = vals > NEG_INF / 2
    assert live.all()  # 100 allowed rows > k
    assert np.isin(idx[live], allowed).all()


@pytest.mark.parametrize("impl", [cosine_topk_xla, cosine_topk_blocked])
def test_topk_fewer_live_than_k(rng, impl):
    n, d, b, k = 300, 256, 2, 10
    vectors = _normalize(rng.standard_normal((n, d)).astype(np.float32))
    queries = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    penalty = np.full(n, NEG_INF, np.float32)
    penalty[:4] = 0.0
    vals, idx = impl(vectors, queries, penalty, k)
    vals = np.asarray(vals)
    live = vals > NEG_INF / 2
    assert (live.sum(axis=1) == 4).all()
    assert np.isin(np.asarray(idx)[live], np.arange(4)).all()


def test_topk_bf16_vectors_close(rng):
    import jax.numpy as jnp

    n, d, b, k = 1024, 256, 4, 10
    vectors = _normalize(rng.standard_normal((n, d)).astype(np.float32))
    queries = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    penalty = np.zeros(n, np.float32)
    vals32, idx32 = cosine_topk_xla(vectors, queries, penalty, k)
    vals16, idx16 = cosine_topk_xla(jnp.asarray(vectors, jnp.bfloat16), queries, penalty, k)
    # recall@10 of bf16 storage vs fp32 exact should be near-perfect
    r = np.mean([
        len(set(map(int, a)) & set(map(int, b))) / k
        for a, b in zip(np.asarray(idx32), np.asarray(idx16))
    ])
    assert r >= 0.9
    np.testing.assert_allclose(np.asarray(vals16), np.asarray(vals32), atol=2e-2)


def test_topk_blocked_matches_xla(rng):
    from mobius_rag_tpu.ops.topk import cosine_topk_blocked

    n, d, b, k = 5000, 256, 4, 10
    v = rng.standard_normal((n, d)).astype("float32")
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype("float32")
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pen = np.zeros(n, np.float32)
    pen[100:200] = NEG_INF  # gated range
    ev, ei = cosine_topk_xla(v, q, pen, k)
    bv, bi = cosine_topk_blocked(v, q, pen, k, block=512)
    np.testing.assert_allclose(np.asarray(bv), np.asarray(ev), atol=1e-5)
    assert (np.asarray(bi) == np.asarray(ei)).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_topk_xla_low_precision_storage(rng, dtype):
    """bf16 and int8 chunk matrices: the scan widens to float32 at
    HIGHEST precision, so scores equal a float64 oracle over the same
    stored values up to float32 summation error (1e-5 at D=256)."""
    import jax.numpy as jnp

    n, d, b, k = 700, 256, 4, 10
    vectors = _normalize(rng.standard_normal((n, d)).astype(np.float32))
    queries = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    if dtype == "int8":
        stored = np.clip(np.round(vectors * 127 / np.abs(vectors).max()),
                         -127, 127).astype(np.int8)
        dev = jnp.asarray(stored)
        ref = stored.astype(np.float64)
    else:
        dev = jnp.asarray(vectors, jnp.bfloat16)
        ref = np.asarray(dev.astype(jnp.float32), np.float64)
    penalty = np.zeros(n, np.float32)
    vals, idx = cosine_topk_xla(dev, queries, penalty, k)
    want = queries.astype(np.float64) @ ref.T
    got = np.take_along_axis(want, np.asarray(idx), axis=1)
    np.testing.assert_allclose(np.asarray(vals), got, rtol=1e-5, atol=1e-5)
    kth = np.sort(want, axis=1)[:, -k]
    assert (got >= kth[:, None] - 1e-5).all()


def test_topk_xla_wide_k(rng):
    """k past 128 (the host-residency funnel widths): exact and sorted."""
    n, d, b, k = 2000, 64, 3, 300
    vectors = _normalize(rng.standard_normal((n, d)).astype(np.float32))
    queries = _normalize(rng.standard_normal((b, d)).astype(np.float32))
    penalty = np.zeros(n, np.float32)
    penalty[::7] = NEG_INF
    vals, idx = cosine_topk_xla(vectors, queries, penalty, k)
    ovals, _ = _oracle(vectors, queries, penalty, k)
    vals = np.asarray(vals)
    assert vals.shape == (b, k)
    np.testing.assert_allclose(vals, ovals, atol=1e-5)
    assert (np.diff(vals, axis=1) <= 0).all()
    assert not np.isin(np.asarray(idx), np.arange(0, n, 7)).any()
