"""On-device embed throughput — the "chunks/sec embed" companion
metric (BASELINE.md §6), on one GPU.

What the reference can do: Vertex ``gemini-embedding-001`` is ONE input
per request (embedding_provider.py:89), batch-50 jobs logging items/s
per batch (embedding_worker.py:269-272) — wire-latency-bound, typically
single-digit items/s per worker. The on-device encoder deletes that
bottleneck: a 12L/768d bf16 transformer encoding batches straight into
the HBM index.

Measures on the GPU (fails without one):
1. cold-start compile time of the serving encode program;
2. warm encode throughput (texts/s) over realistic policy paragraphs,
   batch ladder × {seq-bucketed, full-512-pad} (encoder.py
   _SEQ_BUCKETS);
3. end-to-end ingest rate (extract → chunk → featurize/Aho-Corasick →
   encode → publish) through IngestPipeline.upload(instant=True),
   chunks/sec.

Writes eval_artifacts/BENCH_embed_throughput.json; prints one JSON
line. Usage: python bench_embed.py
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("MRAG_ENCODER_BATCH_BUCKETS", "1,8,32,128,512")
os.environ.setdefault("MRAG_DATA_DIR", os.path.join(
    tempfile.gettempdir(), "mrag-bench-embed"))

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


PARA = [
    "Participating providers must submit initial claims within {n} days "
    "of the date of service. Corrected claims must be received within "
    "{m} days of the remittance advice date and must include the "
    "original claim number in the appropriate field.",
    "Prior authorization is required for {svc}. Requests are reviewed "
    "within {n} calendar days of receipt of complete clinical "
    "documentation; expedited requests are decided within {m} hours "
    "when the standard timeframe could jeopardize the member's health.",
    "Provider disputes must be filed within {n} calendar days of the "
    "explanation of payment. Disputes submitted without the required "
    "documentation will be returned without a decision.",
    "Telehealth services for {svc} must be billed with the appropriate "
    "modifier and place-of-service code combination listed in the "
    "billing guide. Audio-only visits follow the state policy.",
    "Members may change primary care providers up to once per month. "
    "Eligibility should be verified through the provider portal before "
    "each visit because enrollment can change monthly.",
]
SVCS = ["intensive outpatient services", "residential treatment",
        "applied behavior analysis", "durable medical equipment",
        "partial hospitalization", "skilled nursing care"]


def gen_paragraphs(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = PARA[i % len(PARA)]
        out.append(t.format(n=int(rng.choice([30, 60, 90, 180, 365])),
                            m=int(rng.choice([24, 48, 72, 90])),
                            svc=SVCS[int(rng.integers(len(SVCS)))]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--texts", type=int, default=20_000)
    ap.add_argument("--docs", type=int, default=40)
    ap.add_argument("--ckpt", default=os.path.expanduser(
        "~/.mobius_rag_tpu/encoder_r2"))
    args = ap.parse_args()

    import jax

    from mobius_rag_tpu.models import encoder as enc_mod
    from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel

    from mobius_rag_tpu.utils.device import measurement_device

    device = measurement_device()
    log(f"device={device}")

    # Production-size encoder (12L/768d/seq512/out1536). Throughput is
    # params-value-independent; the trained checkpoint (4L small config)
    # is benched separately as "trained_ckpt" for the serving-geometry
    # number the recall pipeline actually uses.
    cfg = EncoderConfig()
    texts = gen_paragraphs(args.texts)

    t0 = time.perf_counter()
    model = EncoderModel(cfg)
    t_init = time.perf_counter() - t0

    t0 = time.perf_counter()
    model(texts[:1])
    t_cold = time.perf_counter() - t0
    log(f"init {t_init:.1f}s, cold batch-1 compile+run {t_cold:.1f}s")

    def throughput(m, n_texts, batch, label):
        blocks = [texts[i:i + batch] for i in range(0, n_texts, batch)]
        m(blocks[0])  # warm this shape
        t0 = time.perf_counter()
        for blk in blocks:
            m(blk)
        dt = time.perf_counter() - t0
        r = n_texts / dt
        log(f"  {label}: batch {batch}: {r:.0f} texts/s ({dt:.1f}s)")
        return r

    results = {}
    for batch in (32, 128, 512):
        results[f"b{batch}_seqbucket"] = round(
            throughput(model, args.texts, batch, "seq-bucketed"), 1)
    # full-pad comparison (the pre-r4 behavior)
    orig = enc_mod._SEQ_BUCKETS
    enc_mod._SEQ_BUCKETS = ()
    try:
        results["b128_fullpad"] = round(
            throughput(model, min(args.texts, 4096), 128, "full-512-pad"), 1)
    finally:
        enc_mod._SEQ_BUCKETS = orig

    # trained checkpoint (the recall pipeline's encoder), if present
    trained = None
    if os.path.isdir(args.ckpt):
        from mobius_rag_tpu.models.checkpoint import load_encoder

        params, tcfg = load_encoder(args.ckpt)
        tmodel = EncoderModel(tcfg, params)
        trained = round(throughput(tmodel, args.texts, 512, "trained-ckpt"), 1)

    # ---- end-to-end ingest: extract→chunk→tag→encode→publish --------------
    from mobius_rag_tpu.index.store import ChunkStore
    from mobius_rag_tpu.ingest.pipeline import IngestPipeline
    from mobius_rag_tpu.query.lexicon import Lexicon
    from mobius_rag_tpu.testing import sample_lexicon

    lexicon = sample_lexicon()
    store = ChunkStore(capacity=max(65_536, args.docs * 600))
    pipeline = IngestPipeline(store, lexicon, model)
    paras = gen_paragraphs(400, seed=7)
    doc_text = "POLICY MANUAL\n\n" + "\n\n".join(paras)
    data = doc_text.encode()
    pipeline.upload(data + b" warm", "warm.txt", payer="aetna",
                    state="FL", instant=True)  # warm all shapes
    t0 = time.perf_counter()
    total_chunks = 0
    for d in range(args.docs):
        res = pipeline.upload(data + f" v{d}".encode(), f"doc{d}.txt",
                              payer="aetna", state="FL", instant=True)
        total_chunks += len(store.rows_for_document(res.doc_id))
    t_ing = time.perf_counter() - t0
    ingest_rate = total_chunks / t_ing
    log(f"ingest e2e: {total_chunks} chunks in {t_ing:.1f}s "
        f"= {ingest_rate:.0f} chunks/s (extract+chunk+tag+encode+publish)")

    best = max(v for k, v in results.items() if k.endswith("seqbucket"))
    art = {
        "metric": "embed_throughput_onchip_texts_per_s",
        "value": best,
        "unit": "texts/sec",
        "device": device,
        "vs_baseline": None,
        "encoder": {"layers": cfg.num_layers, "model_dim": cfg.model_dim,
                    "max_seq": cfg.max_seq, "out_dim": cfg.out_dim,
                    "dtype": cfg.dtype},
        "encode_throughput": results,
        "trained_ckpt_b512": trained,
        "cold_start_s": {"init": round(t_init, 1),
                         "first_call": round(t_cold, 1)},
        "ingest_e2e_chunks_per_s": round(ingest_rate, 1),
        "ingest_e2e_chunks": total_chunks,
        "note": ("Prod-size (12L/768d bf16, seq 512, out 1536) encoder on "
                 "one chip; seq-bucketed batches (MRAG_ENCODER_SEQ_BUCKETS) "
                 "vs the full-512-pad pre-r4 path. Reference comparison: "
                 "Vertex gemini-embedding-001 is 1 input/request "
                 "(embedding_provider.py:89) behind batch-50 workers "
                 "(embedding_worker.py:221-272) — wire-bound, no published "
                 "figure. ingest_e2e = full pipeline incl. Aho-Corasick "
                 "tagging + featurize + publish to the device index."),
    }
    print(json.dumps({"metric": art["metric"], "value": art["value"],
                      "unit": art["unit"],
                      "ingest_e2e_chunks_per_s": art["ingest_e2e_chunks_per_s"]}))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "eval_artifacts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "BENCH_embed_throughput.json"), "w") as f:
        json.dump(art, f, indent=1)


if __name__ == "__main__":
    main()
