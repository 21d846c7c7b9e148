"""Blind quality-loop machinery (round 3): adversarial trap corpus +
retrieval precision / forbidden-hit scoring in run_eval."""
import numpy as np
import pytest

from mobius_rag_tpu.eval_harness.bank import load_bank
from mobius_rag_tpu.eval_harness.fixture_corpus import (_perturb_numbers,
                                                        adversarial_corpus)
from mobius_rag_tpu.eval_harness.run import run_eval
from mobius_rag_tpu.index.store import ChunkStore
from mobius_rag_tpu.query.agent import CorpusSearchAgent
from mobius_rag_tpu.query.engine import SearchEngine
from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus


def test_perturb_numbers_changes_every_number():
    rng = np.random.default_rng(0)
    out = _perturb_numbers("180 days for participating, 365 for non-par", rng)
    assert out is not None and "180" not in out and "365" not in out
    assert _perturb_numbers("no numbers here", rng) is None


def test_adversarial_corpus_shapes():
    lex = sample_lexicon()
    recs = adversarial_corpus("toy", lex)
    assert recs, "no trap records generated"
    kinds = {r.extra["trap"] for r in recs}
    assert kinds == {"near_miss", "forbidden"}
    near = [r for r in recs if r.extra["trap"] == "near_miss"]
    # near-miss rows carry the query's payer so strict filters admit them
    assert any(r.payer == "sunshine_health" for r in near)
    assert all(r.doc_id.startswith("trap_") for r in recs)
    # traps are featurized like ordinary chunks (tags + lexical weights)
    assert any(r.lexical_weights for r in recs)


def test_run_eval_reports_trap_metrics():
    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex, pad_docs=16))
    # plant one forbidden trap that matches the toy bank's first query
    from mobius_rag_tpu.index.store import ChunkRecord
    from mobius_rag_tpu.ingest.featurize import featurize_chunk

    text = ("Sunshine Health FL Medicaid provider policy: No timely filing "
            "limit applies; claims may be submitted at any time.")
    trap = featurize_chunk(ChunkRecord(
        chunk_id="trap_forbidden_toy-c0", doc_id="trap_forbidden_toy",
        text=text, embedding=hash_embed([text])[0],
        payer="sunshine_health", state="FL"), lex)
    trap.extra["trap"] = "forbidden"
    store.add_chunks([trap])

    agent = CorpusSearchAgent(SearchEngine(store, lex, embed_fn=hash_embed))
    out = run_eval(agent, "toy")
    agg = out.aggregates
    assert agg["warmup_excluded_cold_compile"] is True
    assert "retrieval_precision_mean" in agg and "forbidden_hit_rate" in agg
    # the trap text is a near-duplicate of the timely-filing query's
    # surface — it should surface for at least one query, making the
    # forbidden-hit machinery observable (non-zero) on the toy corpus
    assert agg["forbidden_hit_rate"] is not None
    per = {r["query_id"]: r for r in out.results}
    assert all("retrieval_precision" in r or r.get("refused")
               for r in out.results)


def test_run_eval_no_trap_fields_without_traps():
    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex, pad_docs=8))
    agent = CorpusSearchAgent(SearchEngine(store, lex, embed_fn=hash_embed))
    out = run_eval(agent, "toy")
    assert "retrieval_precision_mean" not in out.aggregates


def _hit(doc_id, text, score):
    from mobius_rag_tpu.query.engine import SearchHit

    return SearchHit(row=0, chunk_id=f"{doc_id}-c0", doc_id=doc_id, text=text,
                     score=score, similarity=score, signals={}, metadata={})


@pytest.fixture(scope="module")
def toy_agent():
    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex, pad_docs=8))
    return CorpusSearchAgent(SearchEngine(store, lex, embed_fn=hash_embed))


def test_filter_conflicting_drops_perturbed_duplicate(toy_agent):
    real = _hit("manual", "Timely filing: claims must be submitted within "
                          "180 days of the date of service.", 0.9)
    trap = _hit("trap_nearmiss_1", "Timely filing: claims must be submitted "
                                   "within 90 days of the date of service.", 0.7)
    other = _hit("manual2", "Prior authorization is required for H2019 "
                            "after 26 units per year.", 0.6)
    kept, conflicts = toy_agent._filter_conflicting([real, trap, other])
    assert [h.doc_id for h in kept] == ["manual", "manual2"]
    assert conflicts and conflicts[0]["dropped_doc"] == "trap_nearmiss_1"
    assert conflicts[0]["kept_doc"] == "manual"
    assert "90" in conflicts[0]["dropped_nums"]


def test_filter_conflicting_keeps_distinct_passages(toy_agent):
    a = _hit("m1", "Timely filing is 180 days for participating providers.", 0.9)
    b = _hit("m2", "Reimbursement for H0015 is 91.32 per diem under the "
                   "behavioral health fee schedule.", 0.8)
    kept, conflicts = toy_agent._filter_conflicting([a, b])
    assert len(kept) == 2 and not conflicts


def test_synthesize_excludes_conflicting_number(toy_agent):
    real = _hit("manual", "Timely filing: claims must be submitted within "
                          "180 days of the date of service.", 0.9)
    trap = _hit("trap_nearmiss_1", "Timely filing: claims must be submitted "
                                   "within 90 days of the date of service.", 0.7)
    ans = toy_agent._synthesize("timely filing limit?", [real, trap])
    assert "180" in ans and "90 days" not in ans
    assert toy_agent._synth_conflicts


def test_answer_forbidden_rate_aggregate(toy_agent):
    out = run_eval(toy_agent, "toy")
    # toy bank queries may or may not declare forbidden facts; the key
    # must exist either way, and per-query answer_forbidden is None
    # exactly when the query has no forbidden rubric entries
    assert "answer_forbidden_rate" in out.aggregates
    bank = load_bank("toy")
    forb = {q.id: bool(q.forbidden_facts) for q in bank.queries}
    for r in out.results:
        assert (r["answer_forbidden"] is not None) == forb[r["query_id"]]
