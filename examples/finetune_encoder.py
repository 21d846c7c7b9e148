"""Fine-tune the on-device encoder on YOUR corpus and re-embed.

The full native loop the reference cannot do (its embeddings are rented
from an API): mine ICT pairs from the published corpus → contrastive
dp×tp training → checkpoint → re-embed and republish.

    PYTHONPATH="$PYTHONPATH:." python examples/finetune_encoder.py
"""
import jax

from mobius_rag_tpu.index.store import ChunkStore
from mobius_rag_tpu.models.checkpoint import save_encoder
from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel
from mobius_rag_tpu.models.train import train_encoder_on_corpus
from mobius_rag_tpu.testing import sample_lexicon, toy_corpus


def main() -> None:
    lex = sample_lexicon()
    store = ChunkStore()
    store.add_chunks(toy_corpus(lex))
    print(f"corpus: {store.size} chunks; devices: {jax.devices()}")

    cfg = EncoderConfig.tiny()  # use EncoderConfig.from_env() for real runs
    params, history = train_encoder_on_corpus(store, cfg=cfg, steps=20,
                                              batch=8, log_every=5)
    for h in history:
        print(f"step {h['step']:>4}  loss {h['loss']:.4f}  acc {h['accuracy']:.2f}")

    save_encoder("/tmp/encoder_ckpt", jax.device_get(params), cfg)
    print("checkpointed to /tmp/encoder_ckpt")

    # re-embed the corpus with the tuned encoder (publish back per doc)
    model = EncoderModel(cfg, params=jax.device_get(params))
    by_doc: dict[str, list] = {}
    for rec in store.records:
        if rec is not None:
            by_doc.setdefault(rec.doc_id, []).append(rec)
    for doc_id, recs in by_doc.items():
        vecs = model([r.text for r in recs])
        for r, v in zip(recs, vecs):
            r.embedding = v
        store.publish_document(doc_id, recs)
    print(f"re-embedded + republished {store.size} chunks with the tuned encoder")


if __name__ == "__main__":
    main()
