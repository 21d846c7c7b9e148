"""Quickstart: upload a document, ask the retrieval agent.

    PYTHONPATH="$PYTHONPATH:." python examples/quickstart.py

Uses the deterministic hash encoder so it runs anywhere; swap
`hash_embed` for `EncoderModel()` (or `get_embedding_provider().embed`)
to encode on the GPU.
"""
from mobius_rag_tpu.api.server import AppContext
from mobius_rag_tpu.query.agent import AgentRequest
from mobius_rag_tpu.testing import hash_embed, sample_lexicon

MANUAL = b"""SUNSHINE HEALTH PROVIDER MANUAL

TIMELY FILING
Participating providers must submit initial claims within 180 days
from the date of service. Non-participating providers have 365 days.

PRIOR AUTHORIZATION
Residential substance use treatment under H0019 requires prior
authorization from Sunshine Health.
"""


def main() -> None:
    ctx = AppContext.build(embed_fn=hash_embed, lexicon=sample_lexicon())

    up = ctx.pipeline.upload(MANUAL, "sunshine_manual.txt",
                             payer="Sunshine Health", state="FL",
                             authority_level=4, instant=True)
    print(f"uploaded {up.doc_id}: {ctx.store.size} chunks published")

    for query in [
        "What is the timely filing deadline for Sunshine Health claims?",
        "Does H0019 need prior auth?",
        "what's a good pizza place nearby",  # → refused (out of scope)
    ]:
        res = ctx.agent.run(AgentRequest(query=query))
        print(f"\nQ: {query}")
        print(f"   chain={res.strategy_chain} contour={res.gate['contour']} "
              f"confidence={res.confidence_label}")
        print(f"   A: {res.answer[:140]}")


if __name__ == "__main__":
    main()
