"""Cross-encoder reranker — the second on-device model family.

The reference's reranker is a fixed linear blend of six signals
(corpus_search.py:1909); this model family goes beyond parity: a
transformer that reads [CLS] query [SEP] chunk jointly and scores
relevance from the CLS state. Applied as an optional final stage over
the hybrid pipeline's top-k (cheap: k ≈ 10-40 pairs per query, batched
on the device), trained on the same ICT pairs the bi-encoder mines.

Reuses the encoder's transformer blocks/params layout (models/encoder.py)
with a scalar score head instead of the projection.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.models.encoder import EncoderConfig, _block, _rms_norm, init_params
from mobius_rag_tpu.models.tokenizer import CLS_ID, PAD_ID, SEP_ID, HashTokenizer


@dataclasses.dataclass(frozen=True)
class CrossEncoderConfig:
    base: EncoderConfig

    @classmethod
    def tiny(cls) -> "CrossEncoderConfig":
        return cls(base=EncoderConfig.tiny())


def init_cross_params(cfg: CrossEncoderConfig, key: jax.Array) -> dict:
    k1, k2 = jax.random.split(key)
    params = init_params(cfg.base, k1)
    del params["proj"]  # no embedding projection — scalar head instead
    params["score_head"] = 0.02 * jax.random.normal(
        k2, (cfg.base.model_dim, 1), jnp.float32)
    return params


def score_pairs(params: dict, tokens: jnp.ndarray, cfg: CrossEncoderConfig) -> jnp.ndarray:
    """tokens [B, L] ([CLS] q [SEP] d, padded) → relevance logits [B]."""
    base = cfg.base
    dt = jnp.bfloat16 if base.dtype == "bfloat16" else jnp.float32
    b, l = tokens.shape
    mask = tokens != PAD_ID
    x = params["embed"].astype(dt)[tokens] + params["pos"].astype(dt)[None, :l]
    for layer in params["layers"]:
        x = _block(x, mask, layer, base)
    x = _rms_norm(x, params["ln_f_scale"])
    cls_state = x[:, 0].astype(jnp.float32)  # [B, dm]
    return (cls_state @ params["score_head"])[:, 0]


@functools.partial(jax.jit, static_argnames=("cfg",))
def score_pairs_jit(params, tokens, cfg: CrossEncoderConfig):
    return score_pairs(params, tokens, cfg)


def encode_pair(tokenizer: HashTokenizer, query: str, doc: str) -> np.ndarray:
    """[CLS] query-tokens [SEP] doc-tokens, truncating the doc side."""
    q_ids = tokenizer.encode(query)
    d_ids = tokenizer.encode(doc)
    q_body = q_ids[(q_ids != PAD_ID) & (q_ids != CLS_ID)]
    d_body = d_ids[(d_ids != PAD_ID) & (d_ids != CLS_ID)]
    max_len = tokenizer.max_len
    q_keep = q_body[: max(1, max_len // 3)]
    out = np.full(max_len, PAD_ID, np.int32)
    out[0] = CLS_ID
    pos = 1
    out[pos:pos + len(q_keep)] = q_keep
    pos += len(q_keep)
    if pos < max_len:
        out[pos] = SEP_ID
        pos += 1
    d_keep = d_body[: max_len - pos]
    out[pos:pos + len(d_keep)] = d_keep
    return out


class CrossEncoderModel:
    """Host handle: (query, [texts]) → relevance scores. Plugged into
    SearchEngine(cross_encoder=...) to rescore the hybrid top-k."""

    def __init__(self, cfg: CrossEncoderConfig | None = None,
                 params: dict | None = None, seed: int = 0):
        self.cfg = cfg or CrossEncoderConfig(EncoderConfig.from_env())
        if params is None:
            params = init_cross_params(self.cfg, jax.random.PRNGKey(seed))
        # Commit once — host-resident checkpoint trees would otherwise be
        # re-uploaded on every score_pairs_jit dispatch (see encoder.py).
        self.params = jax.device_put(params)
        self.tokenizer = HashTokenizer(self.cfg.base.vocab_size,
                                       self.cfg.base.max_seq)

    def __call__(self, query: str, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0,), np.float32)
        pairs = np.stack([encode_pair(self.tokenizer, query, t) for t in texts])
        # pad batch to a bucket so rescoring never recompiles per k
        b = len(texts)
        b_pad = 8 if b <= 8 else ((b + 31) // 32) * 32
        if b_pad != b:
            pairs = np.pad(pairs, ((0, b_pad - b), (0, 0)))
        out = score_pairs_jit(self.params, jnp.asarray(pairs), self.cfg)
        return np.asarray(out)[:b]


def make_cross_train_step(cfg: CrossEncoderConfig, learning_rate: float = 1e-4):
    """Pairwise training: positives are ICT (query, source-paragraph)
    pairs; negatives are the batch shifted by one. Margin ranking loss."""
    import optax

    opt = optax.adamw(learning_rate)

    def loss_fn(params, pos_tokens, neg_tokens):
        s_pos = score_pairs(params, pos_tokens, cfg)
        s_neg = score_pairs(params, neg_tokens, cfg)
        loss = jnp.mean(jnp.maximum(0.0, 1.0 - s_pos + s_neg))
        acc = jnp.mean((s_pos > s_neg).astype(jnp.float32))
        return loss, acc

    @jax.jit
    def step(params, opt_state, pos_tokens, neg_tokens):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, pos_tokens, neg_tokens)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "accuracy": acc}

    return step, opt.init


def train_cross_encoder_on_corpus(store, *, cfg: CrossEncoderConfig | None = None,
                                  steps: int = 50, batch: int = 16, seed: int = 0):
    """Mine ICT pairs → pairwise margin training. Returns (params, history)."""
    from mobius_rag_tpu.models.data import mine_ict_pairs

    cfg = cfg or CrossEncoderConfig.tiny()
    tokenizer = HashTokenizer(cfg.base.vocab_size, cfg.base.max_seq)
    pairs = mine_ict_pairs(store, max_pairs=steps * batch * 2, seed=seed)
    if len(pairs) < batch:
        raise ValueError(f"corpus too small ({len(pairs)} pairs)")
    step, opt_init = make_cross_train_step(cfg)
    params = init_cross_params(cfg, jax.random.PRNGKey(seed))
    opt_state = opt_init(params)
    rng = np.random.default_rng(seed)
    history = []
    for s in range(steps):
        idx = rng.choice(len(pairs), batch, replace=False)
        pos = np.stack([encode_pair(tokenizer, pairs[i][0], pairs[i][1])
                        for i in idx])
        neg = np.stack([encode_pair(tokenizer, pairs[i][0],
                                    pairs[idx[(j + 1) % batch]][1])
                        for j, i in enumerate(idx)])
        params, opt_state, m = step(params, opt_state, jnp.asarray(pos),
                                    jnp.asarray(neg))
        if (s + 1) % 10 == 0 or s + 1 == steps:
            history.append({"step": s + 1,
                            **{k: float(v) for k, v in jax.device_get(m).items()}})
    return params, history
