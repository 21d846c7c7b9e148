"""Per-stage device profiling surface (SURVEY §5.1 device equivalent:
per-kernel/stage timings in the search_id-keyed telemetry structure)."""
import asyncio

import pytest
from aiohttp.test_utils import TestClient, TestServer

from mobius_rag_tpu.api.server import AppContext, build_app
from mobius_rag_tpu.observability import TelemetryStore
from mobius_rag_tpu.index.store import ChunkStore
from mobius_rag_tpu.profiling import profile_engine
from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus


def test_profile_engine_stages(tmp_path):
    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex, pad_docs=64))
    telemetry = TelemetryStore(str(tmp_path / "tel.sqlite"))
    eng = SearchEngine(store, lex, embed_fn=hash_embed, telemetry=telemetry)
    reqs = [QueryRequest(query="timely filing deadline"),
            QueryRequest(query="prior authorization for dme")]
    p = profile_engine(eng, reqs, k=5, iters=2)
    stages = p["device_stages_ms"]
    for s in ("filters", "vector", "lexical", "dtag", "arms", "full_pipeline"):
        assert s in stages and stages[s] >= 0.0, s
    assert p["host_prepare_ms"] >= 0 and p["host_assemble_ms"] >= 0
    assert p["corpus_rows"] == store.capacity
    # folded into the search_id-keyed telemetry
    telemetry.flush()
    events = telemetry.recent_search_events(5)
    assert any(e.get("mode") == "profile" for e in events)


def test_profile_endpoint():
    ctx = AppContext.build(embed_fn=hash_embed, lexicon=sample_lexicon())
    ctx.store.add_chunks(toy_corpus(ctx.engine.lexicon))

    async def scenario():
        client = TestClient(TestServer(build_app(ctx)))
        await client.start_server()
        try:
            r = await client.post("/admin/profile", json={"iters": 1, "k": 5})
            assert r.status == 200
            body = await r.json()
            assert "full_pipeline" in body["profile"]["device_stages_ms"]
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(scenario())
