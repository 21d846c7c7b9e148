"""Sharded serving under host vector residency (config 5 × multi-chip):
HBM holds per-shard residual-PQ tables (each shard clusters + encodes
its OWN host int8 rows); the allgather merge returns k·over_fetch fused
candidates; the exact re-rank runs from the (mesh-agnostic) host matrix.
This is the 10M-per-card regime scaled across cards: ~4×10M rows on
four cards with device memory holding codes only."""
import dataclasses

import numpy as np
import pytest

from mobius_rag_tpu.config import get_config
from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
from mobius_rag_tpu.ingest.featurize import featurize_chunk
from mobius_rag_tpu.parallel.mesh import make_mesh, make_serve_mesh
from mobius_rag_tpu.parallel.sharded import ShardedEngine
from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus


def _host_cfg(**kw):
    return dataclasses.replace(
        get_config(), vector_residency="host", vector_dtype="int8",
        vector_backend="pq", ivf_nprobe=10 ** 6, **kw)


QUERIES = [
    QueryRequest(query="What is the timely filing deadline for Sunshine "
                       "Health FL Medicaid claims?"),
    QueryRequest(query="prior authorization for durable medical equipment"),
    QueryRequest(query="molina eligibility verification", payer="molina"),
]


@pytest.fixture(scope="module")
def setup():
    lex = sample_lexicon()
    cfg = _host_cfg()
    store = ChunkStore(cfg)
    store.add_chunks(toy_corpus(lex, pad_docs=120))
    single = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed)
    se = ShardedEngine(store, mesh=make_mesh(8), cfg=cfg)
    serving = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed,
                           sharded=se)
    return lex, store, single, se, serving


def test_non_pq_backend_refused(setup):
    lex, store, *_ = setup
    with pytest.raises(ValueError, match="pq"):
        ShardedEngine(store, mesh=make_mesh(8), cfg=store.cfg,
                      vector_backend="ivf")
    se = ShardedEngine(store, mesh=make_mesh(8), cfg=store.cfg)
    with pytest.raises(ValueError, match="pq"):
        se.set_vector_backend("exact")


def test_sharded_host_builds_codes_only_shards(setup):
    lex, store, single, se, serving = setup
    assert store.index.vectors.shape[0] == 0
    ann = se.ensure_ann()
    assert ann is not None
    # the merged+host-reranked search serves the right documents
    res = serving.search(QUERIES[0], k=8)[0]
    assert res.hits and res.hits[0].doc_id == "sunshine_provider_manual"
    # host re-rank recomputed exact cosine (not an ADC artifact)
    assert -1.01 <= res.hits[0].signals["cosine"] <= 1.01


def test_sharded_host_tracks_single_chip_host(setup):
    """Per-shard clustering differs from global clustering, but full
    probe + the exact host re-rank over the widened candidate set must
    track the single-chip host-residency engine closely."""
    lex, store, single, se, serving = setup
    recalls = []
    for q in QUERIES:
        a = single.search(q, k=8)[0]
        b = serving.search(q, k=8)[0]
        assert b.hits, q.query
        ia = {h.chunk_id for h in a.hits}
        ib = {h.chunk_id for h in b.hits}
        recalls.append(len(ia & ib) / max(len(ia), 1))
    assert float(np.mean(recalls)) >= 0.8, recalls


def test_sharded_host_via_sharded_search_api(setup):
    lex, store, single, se, serving = setup
    res = se.search(single, QUERIES[0], k=5)[0]
    assert res.hits and res.hits[0].doc_id == "sunshine_provider_manual"


def test_sharded_host_pipelined(setup):
    lex, store, single, se, serving = setup
    batches = [[QUERIES[0]], [QUERIES[1]]]
    mono = single.search_pipelined(batches, k=5)
    shrd = serving.search_pipelined(batches, k=5)
    for mb, sb in zip(mono, shrd):
        for mr, sr in zip(mb, sb):
            ia = {h.chunk_id for h in mr.hits}
            ib = {h.chunk_id for h in sr.hits}
            assert len(ia & ib) / max(len(ia), 1) >= 0.6, (ia, ib)


def test_sharded_host_on_2d_mesh():
    """Host residency composes with the data×shard mesh."""
    lex = sample_lexicon()
    cfg = _host_cfg()
    store = ChunkStore(cfg)
    store.add_chunks(toy_corpus(lex, pad_docs=64))
    se = ShardedEngine(store, mesh=make_serve_mesh(2, 4), cfg=cfg)
    serving = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed,
                           sharded=se)
    res = serving.search(QUERIES, k=5)  # 3 queries over dp=2: pad path
    assert res[0].hits and res[0].hits[0].doc_id == "sunshine_provider_manual"


def test_sharded_host_republish():
    """Publish after construction rebuilds the per-shard PQ tables (the
    generation gate) and the new doc serves through the mesh."""
    lex = sample_lexicon()
    cfg = _host_cfg()
    store = ChunkStore(cfg)
    store.add_chunks(toy_corpus(lex, pad_docs=32))
    se = ShardedEngine(store, mesh=make_mesh(8), cfg=cfg)
    serving = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed,
                           sharded=se)
    serving.search(QUERIES[0], k=5)  # builds the first ANN generation
    gen0 = se._ann_generation

    text = ("Zephyr Plan zymurgy benefit requires prior authorization "
            "before the first fermentation consult.")
    rec = featurize_chunk(ChunkRecord(
        chunk_id="zephyr-c0", doc_id="zephyr_doc", text=text,
        embedding=hash_embed([text])[0]), lex)
    store.publish_document("zephyr_doc", [rec])
    res = serving.search(
        QueryRequest(query="zymurgy benefit fermentation consult"), k=5)[0]
    assert any(h.doc_id == "zephyr_doc" for h in res.hits)
    assert se._ann_generation != gen0  # tables rebuilt, not stale
