"""Environment-driven configuration, single-sourced at import like the
reference's app/config.py (env vars → module constants, hosted-mode
fail-fast validation that collects all problems at once;
reference: app/config.py:24-232).

Differences: config carries device/mesh/dtype/index-layout
knobs instead of DB pool sizes, and validation checks shape alignment
(embedding dim, tile sizes, tag-word counts) instead of DSNs.
"""
from __future__ import annotations

import dataclasses
import os
from functools import lru_cache


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name, "").strip()
    return int(raw) if raw else default


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name, "").strip()
    return float(raw) if raw else default


def _env_bool(name: str, default: bool = False) -> bool:
    raw = os.getenv(name, "").strip().lower()
    if not raw:
        return default
    return raw in ("1", "true", "yes", "on")


def _env_str(name: str, default: str) -> str:
    return os.getenv(name, "").strip() or default


@dataclasses.dataclass(frozen=True)
class Config:
    """All framework tunables. Frozen; construct via :func:`get_config`."""

    # ---- index layout -------------------------------------------------
    # Embedding dimension. The reference pins 1536 (Vertex
    # gemini-embedding-001; app/services/embedding_provider.py:95-100).
    # Must be a multiple of 128 (validate()).
    embed_dim: int = _env_int("MRAG_EMBED_DIM", 1536)
    # Initial device-array capacity (rows). Grows by doubling.
    initial_capacity: int = _env_int("MRAG_INITIAL_CAPACITY", 8192)
    # Tag-bitset width in 32-bit words per kind (j/d/p). 8 words = 256
    # tags/kind; the reference lexicon has 231 total curated tags
    # (app/services/corpus_search_lexicon.py:4).
    tag_words: int = _env_int("MRAG_TAG_WORDS", 8)
    # Lexicon-phrase presence bitset width in 32-bit words. 64 words =
    # 2048 distinct phrases tracked per chunk for the on-device
    # coverage/rerank signal.
    phrase_words: int = _env_int("MRAG_PHRASE_WORDS", 64)
    # Hashed-term buckets for the device lexical (BM25-style) arm.
    lexical_buckets: int = _env_int("MRAG_LEXICAL_BUCKETS", 16384)
    # Lexical storage layout: "dense" keeps a bucket-major [H, C] weight
    # matrix (fastest at ≤~500k chunks); "sparse" keeps padded postings
    # [H, P] (cols + weights) scored by scatter-add — memory scales with
    # nonzeros instead of H*C, lifting the dense layout's 1M-chunk HBM
    # ceiling (dense [16384, 1M] bf16 = 33 GB; sparse ≈ nnz * 6 bytes).
    lexical_format: str = _env_str("MRAG_LEXICAL_FORMAT", "dense")
    # Sparse postings-per-bucket: initial width (doubles on overflow) and
    # hard cap (beyond it the lowest-weight postings are pruned, i.e.
    # impact-ordered truncation).
    lexical_postings_init: int = _env_int("MRAG_LEXICAL_POSTINGS_INIT", 64)
    lexical_postings_max: int = _env_int("MRAG_LEXICAL_POSTINGS_MAX", 8192)
    # Storage dtype for the chunk matrix: "float32" | "bfloat16" | "int8"
    # (int8 = symmetric per-row quantization; scales live in vec_scales).
    vector_dtype: str = _env_str("MRAG_VECTOR_DTYPE", "float32")
    # Vector-arm scan backend: "exact" (full masked matmul — the default
    # and the ≤~1M-rows production path), "ivf" (coarse-quantized probed
    # scan over the same chunk matrix), or "packed" (cluster-contiguous
    # int8 blocks — the ≥2M regime). The reference's equivalent is
    # pgvector HNSW as the production scan (vector_store.py:274-287).
    vector_backend: str = _env_str("MRAG_VECTOR_BACKEND", "exact")
    # IVF knobs: clusters (0 = sqrt(N) auto) and probed clusters/query.
    ivf_nlist: int = _env_int("MRAG_IVF_NLIST", 0)
    ivf_nprobe: int = _env_int("MRAG_IVF_NPROBE", 32)
    # Auto-nprobe: when > 0, ANN builds calibrate nprobe per corpus by
    # probing until recall@k vs the exact scan clears this floor on a
    # self-query sample (ivf.calibrate_nprobe) — nprobe stops being a
    # static guess. 0 = use ivf_nprobe as-is.
    ivf_target_recall: float = _env_float("MRAG_IVF_TARGET_RECALL", 0.0)
    # "pq" backend (the 10M-rows/chip config-5 regime): residual product-
    # quantized codes as the vector-arm candidate generator — pq_m bytes
    # per row in HBM — with the engine's signal gather doing the exact
    # cosine re-rank of the over-fetched candidates.
    pq_m: int = _env_int("MRAG_PQ_M", 96)
    # "proj" backend: int8 PCA-projected residual codes (proj_p bytes/
    # row) scored as dense int8 matmuls instead of LUT-PQ ADC's
    # per-element table gathers (see ops/proj.py).
    proj_p: int = _env_int("MRAG_PROJ_P", 256)
    # Host-residency funnel width: the vector arm's top-W candidate list
    # handed (with its rerank signals) to the exact host re-rank, on top
    # of the fused top-(k·over_fetch) set. At 10M rows the approximate
    # scores' error band covers many more competitors than at 1M, so
    # recall is funnel-width-bound — widening W is how the two-stage
    # design buys recall back (0 = auto: max(512, k·over_fetch)).
    host_funnel: int = _env_int("MRAG_HOST_FUNNEL", 0)
    # Approximate final top-k inside the probed scans (proj backend):
    # per-element recall target for jax.lax.approx_max_k. 0 = exact
    # lax.top_k, the default. XLA's CPU and GPU backends lower
    # approx_max_k to an exact top-k, so on them any value returns the
    # exact result; the option is queued for removal (ROADMAP 3.2).
    ann_approx_topk: float = _env_float("MRAG_ANN_APPROX_TOPK", 0.0)
    # Streaming-insert headroom for the proj backend: EMPTY always-probed
    # slabs appended at build so published rows encode into free slots
    # instead of re-running the k-means build (a full rebuild re-runs
    # host k-means over every row, with buffers that compete with
    # serving; the reference's pgvector HNSW inserts incrementally —
    # republish is its steady state, publish.py:27-481). Headroom =
    # slabs × cluster pad; exhausting it falls back to a full rebuild.
    # 0 disables.
    ann_reserve_slabs: int = _env_int("MRAG_ANN_RESERVE_SLABS", 2)
    # Filter-gate evaluation: "dense" materializes the [B, C]
    # eligibility masks + penalty (the ≤~1M default), "local" evaluates
    # the gate candidate-locally — inside the probed scan for
    # the vector arm, on the postings union for the lexical arm, and
    # over per-tag inverted postings for the d-tag arm (query/gating.py;
    # requires the proj backend). "auto" = local exactly in the
    # host-residency proj regime, where the dense masks are [B, C]
    # buffers over every row of the corpus.
    gating: str = _env_str("MRAG_GATING", "auto")
    # Candidate-local d-tag arm: per-tag postings width (top-Pd members
    # by authority; a tag with more live members than this serves its
    # highest-authority subset — see gating.DTagPostings).
    dtag_postings: int = _env_int("MRAG_DTAG_POSTINGS", 4096)
    # Vector payload residency: "device" keeps the chunk matrix in HBM
    # (every config through ~8M int8 rows); "host" is the 10M regime —
    # HBM holds ONLY the PQ codes, the int8 rows live in host RAM and
    # serve the post-fusion exact re-rank (the two-stage IVFADC shape:
    # candidate generation on device, k·over_fetch row gathers on host).
    vector_residency: str = _env_str("MRAG_VECTOR_RESIDENCY", "device")

    # ---- search tunables (semantics mirrored from the reference) ------
    # RRF k constant (Cormack 2009) — app/services/corpus_search.py:397.
    rrf_k: int = _env_int("MRAG_RRF_K", 60)
    # Per-arm over-fetch multiplier before fusion (tie-crowding guard;
    # app/services/corpus_search.py:1453-1457).
    over_fetch: int = _env_int("MRAG_OVER_FETCH", 4)
    # Default top-k.
    default_k: int = _env_int("MRAG_DEFAULT_K", 10)
    # Pipelined-search fetch groups: the stacked device→host result
    # fetch splits into this many transfers so host assembly of group g
    # overlaps the device execution + transfer of group g+1 (1 = single
    # stacked fetch).
    pipeline_fetch_groups: int = _env_int("MRAG_PIPELINE_FETCH_GROUPS", 2)
    # Pipelined-search batch merging: fuse up to this many SAME-SIZE
    # batches into one wider program invocation (1 put + 1 dispatch +
    # 1 fetch replace N of each, and one [N·B, D] matmul instead of N
    # narrow ones). Whether the per-call overhead it saves matters on a
    # GPU host is not measured (ROADMAP 3.1). Scores are per-query, so
    # results are bit-identical to the unmerged path (pinned by test).
    # 1 = off.
    pipeline_merge: int = _env_int("MRAG_PIPELINE_MERGE", 1)
    # Vector-arm minimum cosine similarity post-filter.
    min_similarity: float = _env_float("MRAG_MIN_SIMILARITY", 0.0)
    # Confidence label thresholds (corpus_search.py:380-384).
    confidence_high: float = _env_float("MRAG_CONFIDENCE_HIGH", 0.55)
    confidence_medium: float = _env_float("MRAG_CONFIDENCE_MEDIUM", 0.35)
    confidence_low: float = _env_float("MRAG_CONFIDENCE_LOW", 0.18)
    # Max lexicon entries contributing to one query
    # (corpus_search_lexicon.py:47).
    max_lexicon_entries_per_query: int = _env_int("MRAG_MAX_LEXICON_ENTRIES", 12)

    # ---- mesh / parallel ----------------------------------------------
    # Name of the corpus-shard mesh axis.
    shard_axis: str = _env_str("MRAG_SHARD_AXIS", "shard")
    # Number of corpus shards; 0 → one shard per local device.
    num_shards: int = _env_int("MRAG_NUM_SHARDS", 0)
    # Query data-parallel groups for sharded serving (>1 builds a 2D
    # data×shard mesh: the corpus replicates over `data` and the query
    # batch splits over it — the corpus-fits-a-subset regime).
    serve_dp: int = _env_int("MRAG_SERVE_DP", 1)

    # ---- encoder model -------------------------------------------------
    encoder_vocab_size: int = _env_int("MRAG_ENCODER_VOCAB", 32768)
    encoder_layers: int = _env_int("MRAG_ENCODER_LAYERS", 12)
    encoder_heads: int = _env_int("MRAG_ENCODER_HEADS", 12)
    encoder_model_dim: int = _env_int("MRAG_ENCODER_MODEL_DIM", 768)
    encoder_mlp_dim: int = _env_int("MRAG_ENCODER_MLP_DIM", 3072)
    encoder_max_seq: int = _env_int("MRAG_ENCODER_MAX_SEQ", 512)

    # ---- paths ----------------------------------------------------------
    # Where checkpoints/snapshots are written.
    data_dir: str = _env_str("MRAG_DATA_DIR", os.path.expanduser("~/.mobius_rag_tpu"))
    # Reference eval banks (read-only; consumed as-is as the parity oracle).
    eval_bank_dir: str = _env_str("MRAG_EVAL_BANK_DIR", "/root/reference/eval")
    # Curated lexicon loaded by server/worker entrypoints. Defaults to the
    # packaged full lexicon (206 entries); the 17-entry sample lexicon is
    # for tests only and entrypoints never fall back to it.
    lexicon_path: str = _env_str(
        "MRAG_LEXICON_PATH",
        os.path.join(os.path.dirname(__file__), "data", "lexicon_full.yaml"))
    # Optional cross-encoder reranker checkpoint dir; when set, serving
    # entrypoints attach it to the engine (rescores the hybrid top-k —
    # the reference's rerank-v1.3 "joint scoring" upgrade path).
    cross_encoder_ckpt: str = _env_str("MRAG_CROSS_ENCODER_CKPT", "")

    def validate(self) -> list[str]:
        """Collect-all validation (mirrors the reference's
        assert_hosted_config style, app/config.py:176-231)."""
        problems: list[str] = []
        if self.embed_dim % 128 != 0:
            problems.append(
                f"MRAG_EMBED_DIM={self.embed_dim} must be a multiple of 128 "
                "(layout rule of the packed index tables)"
            )
        if self.vector_dtype not in ("float32", "bfloat16", "int8"):
            problems.append(
                f"MRAG_VECTOR_DTYPE={self.vector_dtype!r} must be "
                "float32|bfloat16|int8"
            )
        if self.lexical_buckets % 128 != 0:
            problems.append(
                f"MRAG_LEXICAL_BUCKETS={self.lexical_buckets} must be a "
                "multiple of 128"
            )
        if self.lexical_format not in ("dense", "sparse"):
            problems.append(
                f"MRAG_LEXICAL_FORMAT={self.lexical_format!r} must be "
                "dense|sparse"
            )
        if self.vector_backend not in ("exact", "ivf", "packed", "pq",
                                       "proj"):
            problems.append(
                f"MRAG_VECTOR_BACKEND={self.vector_backend!r} must be "
                "exact|ivf|packed|pq|proj"
            )
        if self.vector_residency not in ("device", "host"):
            problems.append(
                f"MRAG_VECTOR_RESIDENCY={self.vector_residency!r} must be "
                "device|host"
            )
        if self.vector_residency == "host" and self.vector_backend not in (
                "pq", "proj"):
            problems.append(
                "MRAG_VECTOR_RESIDENCY=host requires MRAG_VECTOR_BACKEND="
                "pq|proj (no dense device matrix exists to scan exactly)"
            )
        if self.vector_residency == "host" and self.vector_dtype != "int8":
            problems.append(
                "MRAG_VECTOR_RESIDENCY=host requires MRAG_VECTOR_DTYPE=int8 "
                "(the host payload is the int8 re-rank matrix)"
            )
        if not (8 <= self.lexical_postings_init <= self.lexical_postings_max):
            problems.append(
                "MRAG_LEXICAL_POSTINGS_INIT must be in "
                f"[8, MRAG_LEXICAL_POSTINGS_MAX={self.lexical_postings_max}]"
            )
        if self.tag_words <= 0 or self.phrase_words <= 0:
            problems.append("tag_words and phrase_words must be positive")
        if self.gating not in ("auto", "dense", "local"):
            problems.append(
                f"MRAG_GATING={self.gating!r} must be auto|dense|local")
        if self.dtag_postings < 8:
            problems.append("MRAG_DTAG_POSTINGS must be >= 8")
        if self.initial_capacity < 128:
            problems.append("MRAG_INITIAL_CAPACITY must be >= 128")
        return problems

    def assert_valid(self) -> None:
        problems = self.validate()
        if problems:
            raise ValueError(
                "invalid mobius_rag_tpu config:\n  - " + "\n  - ".join(problems)
            )


@lru_cache(maxsize=1)
def get_config() -> Config:
    cfg = Config()
    cfg.assert_valid()
    return cfg
