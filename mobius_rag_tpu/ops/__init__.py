from mobius_rag_tpu.ops.topk import cosine_topk_blocked, cosine_topk_xla  # noqa: F401
