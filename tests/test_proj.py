"""Projected-residual ANN backend (ops/proj.py) + the host-residency
funnel (MRAG_HOST_FUNNEL): the int8-matmul config-5 vector arm.

Mirrors tests/test_pq.py's structure: op-level parity at full probe,
engine-level two-stage recall on graded near-duplicates, sharded
stacking parity, persistence round-trip."""
import dataclasses

import numpy as np
import pytest

from mobius_rag_tpu.config import get_config
from mobius_rag_tpu.index.ivf import IVFIndex
from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
from mobius_rag_tpu.ops.proj import (PackedProj, proj_search_packed,
                                     stack_shard_proj)
from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus

DIM = int(get_config().embed_dim)


def _unit_rows(rng, n, d=DIM):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _host_cfg(**kw):
    kw.setdefault("vector_backend", "proj")
    return dataclasses.replace(
        get_config(), vector_residency="host", vector_dtype="int8",
        ivf_nprobe=10 ** 6, **kw)


# ---------------------------------------------------------------------------
# op level
# ---------------------------------------------------------------------------

def test_full_rank_full_probe_matches_exact(rng):
    """p = D makes the projection a pure rotation: at full probe the
    only approximation left is int8 quantization — top-k must track the
    exact scan near-perfectly."""
    import jax.numpy as jnp

    n, k = 400, 10
    vecs = _unit_rows(rng, n)
    ivf = IVFIndex.build(vecs, nlist=8)
    pp = PackedProj.from_ivf(ivf, vecs, p=DIM)
    q = _unit_rows(rng, 8)
    vals, idx = proj_search_packed(pp, jnp.asarray(q),
                                   jnp.zeros((n,), jnp.float32),
                                   k, nprobe=ivf.nlist)
    exact = np.argsort(-(q @ vecs.T), axis=1)[:, :k]
    rec = np.mean([len(set(map(int, idx[i])) & set(map(int, exact[i]))) / k
                   for i in range(len(q))])
    assert rec >= 0.95, rec
    # returned values approximate the true cosine for the top hits
    top_true = np.take_along_axis(q @ vecs.T, np.asarray(idx), axis=1)
    np.testing.assert_allclose(np.asarray(vals), top_true, atol=0.05)


def test_truncated_rank_beats_chance_and_respects_penalty(rng):
    import jax.numpy as jnp

    n, k = 600, 10
    vecs = _unit_rows(rng, n)
    ivf = IVFIndex.build(vecs, nlist=8)
    pp = PackedProj.from_ivf(ivf, vecs, p=DIM // 4)
    q = _unit_rows(rng, 4)
    pen = np.zeros((n,), np.float32)
    blocked = set(range(0, n, 3))
    pen[list(blocked)] = -1e30
    _, idx = proj_search_packed(pp, jnp.asarray(q), jnp.asarray(pen),
                                k, nprobe=ivf.nlist)
    assert not (set(map(int, np.asarray(idx).ravel())) & blocked)


def test_codes_are_p_bytes_per_row(rng):
    vecs = _unit_rows(rng, 256)
    ivf = IVFIndex.build(vecs, nlist=4)
    pp = PackedProj.from_ivf(ivf, vecs, p=64)
    assert pp.bytes_per_row == 64
    assert pp.codes.dtype == np.int8


def test_stack_shard_proj_shapes(rng):
    shards = []
    for s in range(2):
        vecs = _unit_rows(rng, 200 + 40 * s)
        ivf = IVFIndex.build(vecs, nlist=4 + 4 * s)
        shards.append(PackedProj.from_ivf(ivf, vecs, p=32))
    st = stack_shard_proj(shards)
    assert st.codes.shape[0] == 2  # leading shard axis
    assert st.codes.shape[-1] == 32
    assert st.proj.shape == (2, 32, DIM)


def test_ann_io_roundtrip(tmp_path, rng):
    from mobius_rag_tpu.index.ann_io import load_ann, save_ann

    vecs = _unit_rows(rng, 300)
    ivf = IVFIndex.build(vecs, nlist=8)
    pp = PackedProj.from_ivf(ivf, vecs, p=64)
    path = str(tmp_path / "ann.npz")
    save_ann(pp, path, meta={"backend": "proj", "rows": 300})
    back, meta = load_ann(path)
    assert isinstance(back, PackedProj)
    assert meta["backend"] == "proj"
    for f in PackedProj.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(pp, f)))
    assert (back.nlist, back.pad, back.base_nlist) == (
        pp.nlist, pp.pad, pp.base_nlist)


# ---------------------------------------------------------------------------
# engine level (host residency + funnel)
# ---------------------------------------------------------------------------

def test_host_residency_proj_matches_dense(rng):
    lex = sample_lexicon()
    dev_store = ChunkStore()
    dev_store.add_chunks(toy_corpus(lex, pad_docs=120))
    host_store = ChunkStore(_host_cfg())
    host_store.add_chunks(toy_corpus(lex, pad_docs=120))
    dense = SearchEngine(dev_store, lex, embed_fn=hash_embed)
    hosty = SearchEngine(host_store, lex, cfg=host_store.cfg,
                         embed_fn=hash_embed)
    queries = [
        QueryRequest(query="What is the timely filing deadline for Sunshine "
                           "Health FL Medicaid claims?"),
        QueryRequest(query="prior authorization for durable medical equipment"),
        QueryRequest(query="molina eligibility verification", payer="molina"),
    ]
    recalls = []
    for q in queries:
        a = dense.search(q, k=8)[0]
        b = hosty.search(q, k=8)[0]
        assert b.hits, q.query
        ia = {h.chunk_id for h in a.hits}
        ib = {h.chunk_id for h in b.hits}
        recalls.append(len(ia & ib) / max(len(ia), 1))
        assert -1.01 <= b.hits[0].signals["cosine"] <= 1.01
    assert float(np.mean(recalls)) >= 0.8, recalls


def test_funnel_two_stage_recall_on_graded_neardups(rng):
    """proj candidate generation at TRUNCATED rank + the funnel-wide
    exact host re-rank recovers the exact top-k on the graded
    near-duplicate geometry (the structure that floods narrow funnels —
    this is the 10M failure mode at test scale)."""
    nb, T = 300, 4
    base = _unit_rows(rng, nb)
    recs = []
    for t, eps in enumerate((0.0, 0.05, 0.12, 0.25)):
        v = base + eps * rng.standard_normal((nb, DIM)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        for i in range(nb):
            recs.append(ChunkRecord(
                chunk_id=f"g{t}-{i}", doc_id=f"gd{i}", text=f"row {t} {i}",
                embedding=v[i], authority_level=0))
    cfg = _host_cfg(over_fetch=2, host_funnel=256, proj_p=DIM // 4)
    store = ChunkStore(cfg)
    store.add_chunks(recs)
    eng = SearchEngine(store, sample_lexicon(), cfg=cfg,
                       embed_fn=hash_embed)
    k = 8
    q_rows = rng.choice(nb, 16, replace=False)
    qv = base[q_rows] + 0.02 * rng.standard_normal(
        (16, DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    hv = store.host_vectors[:store.size].astype(np.float32) \
        * store.host_scales[:store.size][:, None]
    oracle = np.argsort(-(qv @ hv.T), axis=1)[:, :k]
    res = eng.search(
        [QueryRequest(query="", embedding=qv[i], tag_mode="none",
                      mode="recall")
         for i in range(16)], k=k)
    recalls = []
    for i, r in enumerate(res):
        got = {h.row for h in r.hits}
        recalls.append(len(got & set(map(int, oracle[i]))) / k)
        # no duplicate rows despite the fused+funnel union
        assert len(got) == len(r.hits)
    assert float(np.mean(recalls)) >= 0.9, recalls


def test_funnel_wider_is_no_worse(rng):
    """Recall vs the exact oracle is monotone-ish in funnel width: the
    wide funnel must never lose hits the narrow fused set had."""
    nb = 400
    base = _unit_rows(rng, nb)
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i}", text=f"r {i}",
                        embedding=base[i], authority_level=0)
            for i in range(nb)]
    qv = base[:8] + 0.05 * rng.standard_normal((8, DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    recs_q = [QueryRequest(query="", embedding=qv[i], tag_mode="none",
                           mode="recall") for i in range(8)]

    def recall_at(funnel):
        cfg = _host_cfg(over_fetch=2, host_funnel=funnel, proj_p=32)
        store = ChunkStore(cfg)
        store.add_chunks(recs)
        eng = SearchEngine(store, sample_lexicon(), cfg=cfg,
                           embed_fn=hash_embed)
        hv = store.host_vectors[:store.size].astype(np.float32) \
            * store.host_scales[:store.size][:, None]
        oracle = np.argsort(-(qv @ hv.T), axis=1)[:, :8]
        res = eng.search(recs_q, k=8)
        return float(np.mean([
            len({h.row for h in r.hits} & set(map(int, oracle[i]))) / 8
            for i, r in enumerate(res)]))

    narrow, wide = recall_at(16), recall_at(256)
    assert wide >= narrow - 1e-9, (narrow, wide)
    assert wide >= 0.9, wide


def test_pipelined_matches_sync_with_funnel(rng):
    lex = sample_lexicon()
    store = ChunkStore(_host_cfg(host_funnel=64))
    store.add_chunks(toy_corpus(lex, pad_docs=64))
    eng = SearchEngine(store, lex, cfg=store.cfg, embed_fn=hash_embed)
    reqs = [QueryRequest(query="timely filing deadline"),
            QueryRequest(query="prior authorization dme")]
    sync = [eng.search(r, k=5)[0] for r in reqs]
    piped = eng.search_pipelined([[r] for r in reqs], k=5)
    for a, bl in zip(sync, piped):
        assert [h.chunk_id for h in a.hits] == [h.chunk_id for h in bl[0].hits]


def test_sharded_proj_allowed_under_host_residency():
    from mobius_rag_tpu.parallel.mesh import make_mesh
    from mobius_rag_tpu.parallel.sharded import ShardedEngine

    lex = sample_lexicon()
    store = ChunkStore(_host_cfg())
    store.add_chunks(toy_corpus(lex, pad_docs=16))
    with pytest.raises(ValueError, match="proj"):
        ShardedEngine(store, mesh=make_mesh(8), vector_backend="exact")
    se = ShardedEngine(store, mesh=make_mesh(8), cfg=store.cfg)
    assert se.vector_backend == "proj"


def test_sharded_proj_serving_matches_single_chip():
    """Mesh serving with per-shard proj tables + funnel == the
    single-chip host-residency engine's results (same store, same
    queries) — the sharded config-5 contract of test_sharded_host.py,
    proj edition."""
    from mobius_rag_tpu.parallel.mesh import make_mesh
    from mobius_rag_tpu.parallel.sharded import ShardedEngine

    lex = sample_lexicon()
    cfg = _host_cfg(host_funnel=64)
    store = ChunkStore(cfg)
    store.add_chunks(toy_corpus(lex, pad_docs=96))
    eng = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed)
    sh = ShardedEngine(store, mesh=make_mesh(8), cfg=cfg)
    queries = [
        QueryRequest(query="timely filing deadline sunshine health"),
        QueryRequest(query="prior authorization for dme"),
    ]
    for q in queries:
        single = eng.search(q, k=6)[0]
        mesh_r = sh.search(eng, q, k=6)[0]
        assert [h.chunk_id for h in mesh_r.hits] \
            == [h.chunk_id for h in single.hits], q.query


def test_builders_block_size_invariant(rng):
    """fill_cluster_packed rewrite (round-3 session 9): the single-shot
    reshape path and the multi-block scatter path (including the
    shifted-back overlap tail when cpb doesn't divide nlist) must
    produce bitwise-identical tables — for all three packed builders.
    Catches any mis-scatter of the OOM fix that replaced the flat-buffer
    + slice/reshape tail (peak-HBM 3x -> 1x at 10M)."""
    from mobius_rag_tpu.index.ivf import PackedIVF
    from mobius_rag_tpu.ops.pq import PackedPQ

    import jax.numpy as jnp

    v = jnp.asarray(_unit_rows(rng, 3000))
    ivf = IVFIndex.build(v, np.ones(3000, np.float32), nlist=16)
    # pad ~ 2*3000/16 = 375; block=800 -> cpb=2, 16/2 divides evenly;
    # block=1200 -> cpb=3, 16 % 3 != 0 exercises the overlap tail
    for build in (
        lambda blk: PackedIVF.from_ivf(ivf, v, block=blk),
        lambda blk: PackedPQ.from_ivf(ivf, v, m=64, block=blk),
        lambda blk: PackedProj.from_ivf(ivf, v, p=64, block=blk),
    ):
        big = build(10_000_000)
        for blk in (800, 1200):
            small = build(blk)
            for f in big.FIELDS:
                a = np.asarray(getattr(big, f))
                b = np.asarray(getattr(small, f))
                assert a.shape == b.shape
                assert np.array_equal(a, b), f
