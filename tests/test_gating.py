"""Candidate-local gating (query/gating.py + ops/proj.py ProjGate /
proj_search_gated): parity against the dense [B, C] pipeline on tagged
corpora — the filter gate, the lexical and d-tag arms, and the full
engine must agree between MRAG_GATING=dense and =local."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobius_rag_tpu.config import get_config
from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
from mobius_rag_tpu.ingest.featurize import featurize_chunk
from mobius_rag_tpu.ops.proj import PackedProj, ProjGate, encode_qmeta
from mobius_rag_tpu.ops.topk import NEG_INF
from mobius_rag_tpu.query import engine as eng
from mobius_rag_tpu.query import gating
from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus


def _cfg(**kw):
    return dataclasses.replace(
        get_config(), vector_backend="proj", ivf_nlist=8, ivf_nprobe=8,
        proj_p=64, lexical_format="sparse", **kw)


@pytest.fixture(scope="module")
def corpus():
    lex = sample_lexicon()
    recs = toy_corpus(lex, pad_docs=150)
    # enrich metadata variety: regulators (authority 4, no payer),
    # multi-state rows, rows with no tags at all
    for i, r in enumerate(recs):
        if i % 11 == 0:
            r.payer = ""
            r.authority_level = 4
        if i % 7 == 0:
            r.state = "TX"
    return lex, recs


@pytest.fixture(scope="module")
def stores(corpus):
    lex, recs = corpus
    dense_store = ChunkStore(_cfg(gating="dense"))
    dense_store.add_chunks(recs)
    local_store = ChunkStore(_cfg(gating="local"))
    local_store.add_chunks(recs)
    return lex, dense_store, local_store


QUERIES = [
    QueryRequest(query="timely filing deadline for claims",
                 payer="sunshine_health", tag_mode="strict"),
    QueryRequest(query="prior authorization for durable medical equipment",
                 tag_mode="relaxed"),
    QueryRequest(query="eligibility verification", payer="molina",
                 state="FL", tag_mode="none"),
    QueryRequest(query="grievances and appeals timeline",
                 payer="nonexistent_payer", tag_mode="strict"),
    QueryRequest(query="provider credentialing requirements",
                 payer="sunshine_health", inherit_authority=True,
                 tag_mode="strict"),
]


def _prep(engine, reqs):
    q, exps = engine.prepare_batch(reqs)
    return {k: jnp.asarray(v) for k, v in q.items()}, exps


def test_strict_counts_matches_dense(stores):
    lex, dense_store, _ = stores
    engine = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                          embed_fn=hash_embed)
    q, _ = _prep(engine, QUERIES)
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    strict, _, _, _ = eng.filter_masks(dense_store.index, q)
    want = np.asarray(strict.sum(axis=1))
    got = np.asarray(gating.strict_counts(dense_store.index, q))
    np.testing.assert_array_equal(got, want)


def test_gated_scan_matches_penalized_scan(stores):
    """proj_search_gated (XLA path) ≡ proj_search_packed with the dense
    gate penalty, for every live candidate."""
    lex, dense_store, _ = stores
    engine = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                          embed_fn=hash_embed)
    ann = engine.ensure_ann()
    assert isinstance(ann, PackedProj)
    q, _ = _prep(engine, QUERIES)
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    k = 10

    strict, relaxed, open_mask, _ = eng.filter_masks(dense_store.index, q)
    strict_total = strict.sum(axis=1, keepdims=True)
    penalty = eng.gate_penalty(strict, relaxed, open_mask, q, k)
    from mobius_rag_tpu.ops.proj import proj_search_packed

    v_ref, i_ref = proj_search_packed(ann, q["vec"], penalty, k, 8)

    gate = ProjGate.build(ann, dense_store.index)
    qmeta, qbits = encode_qmeta(q, strict_total[:, 0] >= k)
    from mobius_rag_tpu.ops.proj import proj_search_gated

    v_new, i_new = proj_search_gated(
        ann, gate.words, q["vec"], qmeta, qbits,
        k, 8, tag_level=2, tw=dense_store.index.j_tags.shape[1])
    live = np.asarray(v_ref) > NEG_INF / 2
    np.testing.assert_allclose(np.asarray(v_new)[live],
                               np.asarray(v_ref)[live], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i_new)[live],
                                  np.asarray(i_ref)[live])


def test_lexical_local_matches_dense(stores):
    lex, dense_store, _ = stores
    engine = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                          embed_fn=hash_embed)
    q, _ = _prep(engine, QUERIES)
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    k, m = 10, 20
    index = dense_store.index

    strict, relaxed, open_mask, _ = eng.filter_masks(index, q)
    strict_total = strict.sum(axis=1, keepdims=True)
    penalty = eng.gate_penalty(strict, relaxed, open_mask, q, k)
    lex_raw = eng.lexical_raw(index, q)
    lex_scores = jnp.where(lex_raw > 0, lex_raw, NEG_INF) + penalty
    v_ref, i_ref = jax.lax.top_k(lex_scores, m)

    qmeta, qbits = encode_qmeta(q, strict_total[:, 0] >= k)
    v_new, i_new, lex_best = gating.lexical_candidates_local(
        index, q, qmeta, qbits, m, tag_level=2)
    live = np.asarray(v_ref) > NEG_INF / 2
    live_new = np.asarray(v_new) > NEG_INF / 2
    np.testing.assert_array_equal(live, live_new)
    np.testing.assert_allclose(np.asarray(v_new)[live],
                               np.asarray(v_ref)[live],
                               rtol=1e-4, atol=1e-5)
    # ids may swap within float-tied scores; compare as per-query sets
    for b in range(live.shape[0]):
        assert (set(np.asarray(i_new)[b][live[b]].tolist())
                == set(np.asarray(i_ref)[b][live[b]].tolist()))
    ref_best = np.asarray(jnp.max(
        jnp.where(v_ref > NEG_INF / 2, v_ref, 0.0), axis=1))
    np.testing.assert_allclose(np.asarray(lex_best), ref_best,
                               rtol=1e-4, atol=1e-5)


def test_dtag_local_matches_dense(stores):
    lex, dense_store, _ = stores
    engine = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                          embed_fn=hash_embed)
    q, _ = _prep(engine, QUERIES)
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    index = dense_store.index
    m = 20

    _, _, _, meta_ok = eng.filter_masks(index, q)
    dtag_scores = eng.dtag_raw(index, q, meta_ok)
    v_ref, i_ref = jax.lax.top_k(dtag_scores, m)

    dtp = gating.DTagPostings.build(index, pd=512)
    qmeta, _ = encode_qmeta(q, jnp.ones(q["payer"].shape[0], jnp.bool_))
    v_new, i_new = gating.dtag_candidates_local(dtp.as_tuple(), q, qmeta, m)
    live = np.asarray(v_ref) > NEG_INF / 2
    live_new = np.asarray(v_new) > NEG_INF / 2
    np.testing.assert_array_equal(live, live_new)
    np.testing.assert_allclose(np.asarray(v_new)[live],
                               np.asarray(v_ref)[live], rtol=1e-6)
    # authority ties make id order impl-defined; compare (score, set)
    for b in range(live.shape[0]):
        assert (set(np.asarray(i_new)[b][live_new[b]].tolist())
                == set(np.asarray(i_ref)[b][live[b]].tolist()))


def test_engine_parity_local_vs_dense(stores):
    lex, dense_store, local_store = stores
    dense = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                         embed_fn=hash_embed)
    local = SearchEngine(local_store, lex, cfg=local_store.cfg,
                         embed_fn=hash_embed)
    assert local._local_gating_active()
    assert not dense._local_gating_active()
    ra = dense.search(QUERIES, k=8)
    rb = local.search(QUERIES, k=8)
    for a, b in zip(ra, rb):
        ia = [h.chunk_id for h in a.hits]
        ib = [h.chunk_id for h in b.hits]
        assert set(ia) == set(ib), (a.query, ia, ib)
        for ha, hb in zip(a.hits, b.hits):
            assert abs(ha.score - hb.score) < 1e-3
        assert (a.telemetry["strict_count"] == b.telemetry["strict_count"])


def test_engine_local_streaming_insert_delete(stores):
    """Incremental inserts/deletes must update the gate pack: a freshly
    published row is served under its payer filter; a deleted row
    disappears."""
    lex, _, _ = stores
    store = ChunkStore(_cfg(gating="local"))
    store.add_chunks(toy_corpus(lex, pad_docs=60))
    engine = SearchEngine(store, lex, cfg=store.cfg, embed_fn=hash_embed)
    engine.search(QueryRequest(query="warm up"), k=5)
    text = "Xylophone rider reimburses tuning forks within 45 days."
    emb = hash_embed([text])[0]
    store.add_chunks([ChunkRecord(
        chunk_id="fresh-1", doc_id="fresh-doc", source_id="fresh-s1",
        text=text, embedding=emb / np.linalg.norm(emb),
        payer="sunshine_health", state="FL")])
    res = engine.search(QueryRequest(
        query=text, embedding=emb, payer="sunshine_health",
        tag_mode="none"), k=5)[0]
    assert any(h.chunk_id == "fresh-1" for h in res.hits)
    # wrong payer must not serve it in strict mode
    res2 = engine.search(QueryRequest(
        query=text, embedding=emb, payer="molina",
        tag_mode="strict"), k=5)[0]
    assert all(h.chunk_id != "fresh-1" for h in res2.hits)
    store.delete_by_document("fresh-doc")
    res3 = engine.search(QueryRequest(
        query=text, embedding=emb, payer="sunshine_health",
        tag_mode="none"), k=5)[0]
    assert all(h.chunk_id != "fresh-1" for h in res3.hits)


def test_strict_counts_blocked_matches_naive(stores):
    """The lax.scan block reduction (corpus > _COUNT_BLOCK) must equal
    the one-shot form — forced by shrinking the block size."""
    lex, dense_store, _ = stores
    engine = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                          embed_fn=hash_embed)
    q, _ = _prep(engine, QUERIES)
    q = dict(q, vec=q["vec"].astype(jnp.float32))
    want = np.asarray(gating.strict_counts(dense_store.index, q))
    import unittest.mock as mock
    with mock.patch.object(gating, "_COUNT_BLOCK", 64):
        got = np.asarray(gating.strict_counts(dense_store.index, q))
    np.testing.assert_array_equal(got, want)


def test_strict_count_host_cache(stores):
    """The served path bakes host-cached strict counts into the batch:
    same results as the in-graph count, cache hits on repeats, and
    invalidation when the store's generation moves."""
    lex, _, local_store = stores
    engine = SearchEngine(local_store, lex, cfg=local_store.cfg,
                          embed_fn=hash_embed)
    r1 = engine.search(QUERIES, k=8)
    assert engine._strict_cache, "strict-count cache never populated"
    n_cached = len(engine._strict_cache)
    r2 = engine.search(QUERIES, k=8)  # all hits now
    assert len(engine._strict_cache) == n_cached
    for a, b in zip(r1, r2):
        assert [h.chunk_id for h in a.hits] == [h.chunk_id for h in b.hits]
        assert a.telemetry["strict_count"] == b.telemetry["strict_count"]
    # strict counts equal the dense engine's
    dense_store = stores[1]
    dense = SearchEngine(dense_store, lex, cfg=dense_store.cfg,
                         embed_fn=hash_embed)
    rd = dense.search(QUERIES, k=8)
    for a, d in zip(r2, rd):
        assert a.telemetry["strict_count"] == d.telemetry["strict_count"]
    # generation bump invalidates (new signature tuples)
    text = "Yodel rider reimburses alpine horns within 10 days."
    emb = hash_embed([text])[0]
    local_store.add_chunks([ChunkRecord(
        chunk_id="y1", doc_id="ydoc", source_id="ys1", text=text,
        embedding=emb / np.linalg.norm(emb), payer="sunshine_health",
        state="FL")])
    r3 = engine.search(QUERIES, k=8)
    assert len(engine._strict_cache) > n_cached
    sc_new = r3[0].telemetry["strict_count"]
    assert sc_new == r2[0].telemetry["strict_count"] + 1  # one more eligible row
