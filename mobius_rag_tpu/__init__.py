"""mobius_rag_tpu — a retrieval framework on JAX, run on NVIDIA GPUs.

A ground-up rebuild of the capabilities of Mobius-RAG (a production
healthcare-policy RAG platform: ingest → chunk → tag → embed → publish →
multi-strategy retrieval agent → eval/calibration) built on JAX:

- The retrieval core is a **device-resident vector + tag index** (`index/`)
  queried by a **single compiled XLA pipeline** (`query/`, `ops/`):
  fused filter-then-score cosine top-k, hashed-term lexical scoring, RRF
  fusion, and a signal-weighted reranker — replacing the reference's
  Postgres pgvector `<=>` scans and tsvector FTS
  (reference: app/services/corpus_search.py, app/services/vector_store.py).
- Corpora beyond one card shard across devices via `shard_map` with an
  all-gather top-k merge (`parallel/`).
- Embeddings come from an on-device batched encoder (`models/`) instead of
  external embedding APIs (reference: app/services/embedding_provider.py).
- Ingest (chunking, Path-B lexicon tagging with a native Aho-Corasick,
  incremental resume) lives in `ingest/` + `cpp/`
  (reference: app/worker/, app/services/policy_path_b.py).
- The eval harness (`eval_harness/`) consumes the reference's YAML query
  banks unchanged as the parity oracle (reference: eval/run.py).
"""

__version__ = "0.1.0"

from mobius_rag_tpu.config import Config, get_config  # noqa: F401
