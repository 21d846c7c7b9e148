"""The XLA probed scans against plain references: the gated scan's
filter gate against a numpy evaluation of engine.filter_masks semantics
(testing.numpy_filter_gate) at each tag level, and the int8 block dots
against int32 numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobius_rag_tpu.index.ivf import IVFIndex
from mobius_rag_tpu.index.store import DeviceIndex
from mobius_rag_tpu.ops.proj import (PackedProj, ProjGate, block_dots,
                                     encode_qmeta, proj_search_gated,
                                     proj_search_packed, query_side)
from mobius_rag_tpu.ops.topk import NEG_INF
from mobius_rag_tpu.testing import numpy_filter_gate

N, D, P, B, TW, K = 600, 64, 32, 4, 2, 12


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    cols = {
        "valid": (rng.random(N) > 0.05).astype(np.float32),
        "authority": np.where(rng.random(N) > 0.8, 1.0, 0.25).astype(np.float32),
        "payer": rng.integers(-1, 3, N).astype(np.int32),
        "state": rng.integers(-1, 2, N).astype(np.int32),
        "program": rng.integers(-1, 2, N).astype(np.int32),
        "j_tags": rng.integers(0, 2**16, (N, TW)).astype(np.uint32),
        "d_tags": rng.integers(0, 2**16, (N, TW)).astype(np.uint32),
        "p_tags": rng.integers(0, 2**16, (N, TW)).astype(np.uint32),
    }
    ix = DeviceIndex(
        vectors=jnp.zeros((0, D), jnp.float32),
        vec_scales=jnp.ones((N,), jnp.float32),
        doc_id=jnp.zeros((N,), jnp.int32),
        length_score=jnp.zeros((N,), jnp.float32),
        phrase_bits=jnp.zeros((N, 1), jnp.uint32),
        **{key: jnp.asarray(v) for key, v in cols.items()},
    )
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ivf = IVFIndex.build(jnp.asarray(vecs), nlist=8, iters=4)
    pp = PackedProj.from_ivf(ivf, jnp.asarray(vecs), p=P)
    gate = ProjGate.build(pp, ix)
    return cols, vecs, pp, gate, rng


def _queries(vecs, rng, level):
    """Queries whose tag bits above `level` are zero — the contract under
    which the engine picks that static tag level (_batch_tag_level)."""
    def bits():
        return rng.integers(0, 2**8, (B, TW)).astype(np.uint32)

    zero = np.zeros((B, TW), np.uint32)
    return {
        "vec": vecs[:B] + 0.01,
        "payer": np.array([0, -1, 1, -2], np.int32),
        "state": np.array([-1, 0, -1, -1], np.int32),
        "program": np.array([-1, -1, 0, -1], np.int32),
        "tag_mode": np.array([0, 1, 2, 0], np.int32),
        "inherit_authority": np.array([1, 0, 0, 0], np.float32),
        "j_bits": bits() if level >= 1 else zero,
        "d_bits": bits() if level >= 2 else zero,
        "p_bits": bits() if level >= 2 else zero,
    }


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gated_scan_matches_numpy_gate(table, level):
    """Full probe: the candidate-local gate must admit exactly the rows
    the numpy reference admits, so the gated scan equals the ungated
    scan run with the reference's [B, C] penalty."""
    cols, vecs, pp, gate, rng = table
    q = _queries(vecs, rng, level)
    ok = numpy_filter_gate(cols, q, K)  # [B, N]
    # tag_mode 0 with k=0 never relaxes: the strict mask alone
    strict = numpy_filter_gate(cols, dict(q, tag_mode=np.zeros(B, np.int32)), 0)
    strict_total = strict.sum(axis=1)
    qmeta, qbits = encode_qmeta({key: jnp.asarray(v) for key, v in q.items()},
                                jnp.asarray(strict_total >= K))
    nprobe = pp.nlist
    gv, gi = proj_search_gated(pp, gate.words, jnp.asarray(q["vec"]), qmeta,
                               qbits, K, nprobe, tag_level=level, tw=TW)
    penalty = np.where(ok, 0.0, NEG_INF).astype(np.float32)
    rv, ri = proj_search_packed(pp, jnp.asarray(q["vec"]),
                                jnp.asarray(penalty), K, nprobe)
    gv, gi, rv, ri = map(np.asarray, (gv, gi, rv, ri))
    live = rv > NEG_INF / 2
    np.testing.assert_array_equal(gv > NEG_INF / 2, live)
    # every eligible row is probed, so the live count is min(k, eligible)
    np.testing.assert_array_equal(live.sum(axis=1),
                                  np.minimum(ok.sum(axis=1), K))
    # float32 scores: the same products summed in the same order
    np.testing.assert_allclose(gv[live], rv[live], rtol=1e-6)
    np.testing.assert_array_equal(gi[live], ri[live])
    for b in range(B):
        assert ok[b, gi[b][live[b]]].all()


@pytest.mark.parametrize("case", ["random", "extremes"])
def test_block_dots_bitwise(case):
    rng = np.random.default_rng(1)
    b, pad, p = 3, 40, 256
    if case == "random":
        blk = rng.integers(-127, 128, (b, pad, p)).astype(np.int8)
        q8 = rng.integers(-127, 128, (b, p)).astype(np.int8)
    else:
        # every product at its extreme: sums reach ±p·128², far past
        # what int16 or a bf16/f16 accumulator holds exactly
        blk = np.where(rng.random((b, pad, p)) > 0.5, -128, 127).astype(np.int8)
        blk[0] = -128
        q8 = np.full((b, p), -128, np.int8)
        q8[1] = 127
    got = np.asarray(block_dots(jnp.asarray(blk), jnp.asarray(q8)))
    want = np.einsum("bsp,bp->bs", blk.astype(np.int32), q8.astype(np.int32))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "extremes":
        assert want[0].max() == p * 128 * 128


def test_scan_dots_on_built_table(table):
    """The raw dots the scans compute over a built table's probed blocks
    equal int32 numpy over the same codes and query code."""
    _, vecs, pp, _, _ = table
    _, probe, q8, _ = jax.jit(query_side, static_argnums=2)(
        pp, jnp.asarray(vecs[:B]), 3)
    codes = np.asarray(pp.codes)
    probe, q8 = np.asarray(probe), np.asarray(q8)
    for j in range(probe.shape[1]):
        blk = codes[probe[:, j]]
        got = np.asarray(block_dots(jnp.asarray(blk), jnp.asarray(q8)))
        want = np.einsum("bsp,bp->bs", blk.astype(np.int32),
                         q8.astype(np.int32))
        np.testing.assert_array_equal(got, want)
