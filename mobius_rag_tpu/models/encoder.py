"""Transformer text encoder, run on the device.

Replaces the reference's external embedding providers (OpenAI batch-100 /
Vertex gemini-embedding-001 batch-1; app/services/embedding_provider.py:
24-149) with an on-device batched encoder that writes embeddings straight
into the chunk index — removing the reference's dominant ingest
bottleneck (1 request/input) and query-embed latency (~5-6 s cold,
corpus_search.py:434-443).

Pure-JAX pytree params (no framework dep) so sharding annotations are
explicit: see PARAM_SPECS — embeddings/MLP/attention shard over the
``tp`` mesh axis, everything else replicates; the batch shards over
``dp``. Compute in bfloat16 (tensor-core native), params and layernorm math in
float32, mean-pool over valid tokens, linear projection to the index
dimension, L2-normalize.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from mobius_rag_tpu.config import get_config
from mobius_rag_tpu.models.tokenizer import PAD_ID


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    num_layers: int = 12
    num_heads: int = 12
    model_dim: int = 768
    mlp_dim: int = 3072
    max_seq: int = 512
    out_dim: int = 1536
    dtype: str = "bfloat16"  # activation dtype
    # Hybrid anchor (round 5): embedding = normalize(bag-of-tokens
    # random projection + |alpha| * transformer output). The anchor is a
    # FIXED seeded projection (stop_gradient; adamw's decay moves it
    # ~0.25% over a full run — negligible), so at alpha=0 the model
    # EQUALS the hash baseline and training can only add semantics on
    # top of exact token overlap. A from-scratch 4-layer ICT model on a
    # ~5k-paragraph corpus cannot otherwise out-rank bag-of-words on
    # lexicon-free paraphrases (EVAL_r4/EVAL_r5 plain runs) — the
    # reference's bar is a trillion-token pretrained API embedder, and
    # the anchor supplies the lexical prior pretraining would.
    hybrid_anchor: bool = False

    @classmethod
    def from_env(cls) -> "EncoderConfig":
        cfg = get_config()
        return cls(
            vocab_size=cfg.encoder_vocab_size,
            num_layers=cfg.encoder_layers,
            num_heads=cfg.encoder_heads,
            model_dim=cfg.encoder_model_dim,
            mlp_dim=cfg.encoder_mlp_dim,
            max_seq=cfg.encoder_max_seq,
            out_dim=cfg.embed_dim,
        )

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Small config for tests / dryruns."""
        return cls(vocab_size=1024, num_layers=2, num_heads=4,
                   model_dim=128, mlp_dim=256, max_seq=64, out_dim=256)


def init_params(cfg: EncoderConfig, key: jax.Array) -> dict:
    ks = jax.random.split(key, 4 + cfg.num_layers)
    dm, dh = cfg.model_dim, cfg.model_dim // cfg.num_heads
    scale = 0.02

    def dense(k, shape):
        return scale * jax.random.normal(k, shape, jnp.float32)

    layers = []
    for i in range(cfg.num_layers):
        lk = jax.random.split(ks[4 + i], 4)
        layers.append({
            "ln1_scale": jnp.ones((dm,), jnp.float32),
            "ln2_scale": jnp.ones((dm,), jnp.float32),
            "qkv": dense(lk[0], (dm, 3, cfg.num_heads, dh)),
            "attn_out": dense(lk[1], (cfg.num_heads, dh, dm)),
            "mlp_in": dense(lk[2], (dm, cfg.mlp_dim)),
            "mlp_out": dense(lk[3], (cfg.mlp_dim, dm)),
        })
    params = {
        "embed": dense(ks[0], (cfg.vocab_size, dm)),
        "pos": dense(ks[1], (cfg.max_seq, dm)),
        "ln_f_scale": jnp.ones((dm,), jnp.float32),
        "proj": dense(ks[2], (dm, cfg.out_dim)),
        "layers": layers,
    }
    if cfg.hybrid_anchor:
        ak = jax.random.fold_in(ks[3], 777)
        params["anchor_proj"] = jax.random.normal(
            ak, (cfg.vocab_size, cfg.out_dim), jnp.float32
        ) / (cfg.out_dim ** 0.5)
        params["alpha"] = jnp.asarray(0.5, jnp.float32)
    return params


def param_specs(cfg: EncoderConfig) -> dict:
    """PartitionSpecs per parameter for a ("dp", "tp") mesh — the
    megatron-style TP layout: split heads / MLP hidden / vocab over tp;
    XLA inserts the all-reduces at attn_out / mlp_out."""
    layer = {
        "ln1_scale": P(),
        "ln2_scale": P(),
        "qkv": P(None, None, "tp", None),
        "attn_out": P("tp", None, None),
        "mlp_in": P(None, "tp"),
        "mlp_out": P("tp", None),
    }
    specs = {
        "embed": P(None, "tp"),
        "pos": P(None, "tp"),
        "ln_f_scale": P(),
        "proj": P(None, "tp"),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if cfg.hybrid_anchor:
        specs["anchor_proj"] = P(None, "tp")
        specs["alpha"] = P()
    return specs


def _rms_norm(x, scale):
    x32 = x.astype(jnp.float32)
    var = jnp.mean(x32 * x32, axis=-1, keepdims=True)
    return (x32 * jax.lax.rsqrt(var + 1e-6) * scale).astype(x.dtype)


def _block(x, mask, layer, cfg: EncoderConfig):
    b, l, dm = x.shape
    h, dh = cfg.num_heads, dm // cfg.num_heads
    dt = x.dtype

    y = _rms_norm(x, layer["ln1_scale"])
    qkv = jnp.einsum("bld,dshe->bslhe", y, layer["qkv"].astype(dt))
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [B, L, H, Dh]
    logits = jnp.einsum("blhe,bmhe->bhlm", q, k) / np.sqrt(dh).astype(np.float32)
    neg = jnp.asarray(-1e30, logits.dtype)
    logits = jnp.where(mask[:, None, None, :], logits, neg)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(dt)
    ctx = jnp.einsum("bhlm,bmhe->blhe", probs, v)
    attn = jnp.einsum("blhe,hed->bld", ctx, layer["attn_out"].astype(dt))
    x = x + attn

    y = _rms_norm(x, layer["ln2_scale"])
    hmid = jax.nn.gelu(jnp.einsum("bld,df->blf", y, layer["mlp_in"].astype(dt)))
    x = x + jnp.einsum("blf,fd->bld", hmid, layer["mlp_out"].astype(dt))
    return x


def encode(params: dict, tokens: jnp.ndarray, cfg: EncoderConfig) -> jnp.ndarray:
    """tokens [B, L] int32 → L2-normalized embeddings [B, out_dim] f32."""
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    b, l = tokens.shape
    mask = tokens != PAD_ID  # [B, L]
    x = params["embed"].astype(dt)[tokens] + params["pos"].astype(dt)[None, :l]
    for layer in params["layers"]:
        x = _block(x, mask, layer, cfg)
    x = _rms_norm(x, params["ln_f_scale"])
    denom = jnp.maximum(mask.sum(axis=1, keepdims=True).astype(jnp.float32), 1.0)
    pooled = (x.astype(jnp.float32) * mask[..., None]).sum(axis=1) / denom
    out = pooled @ params["proj"]
    norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
    out = out / jnp.maximum(norm, 1e-6)
    if cfg.hybrid_anchor:
        e_fix = jax.lax.stop_gradient(params["anchor_proj"])
        bag = (e_fix[tokens] * mask[..., None]).sum(axis=1)  # tf-weighted
        bnorm = jnp.linalg.norm(bag, axis=-1, keepdims=True)
        bag = bag / jnp.maximum(bnorm, 1e-6)
        mix = bag + jnp.abs(params["alpha"]) * out
        mnorm = jnp.linalg.norm(mix, axis=-1, keepdims=True)
        out = mix / jnp.maximum(mnorm, 1e-6)
    return out


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_jit(params, tokens, cfg: EncoderConfig):
    return encode(params, tokens, cfg)


# Batch-size buckets: every distinct batch shape is a separate XLA
# compilation, so callers' ragged batch sizes
# are padded up to the nearest bucket and results sliced back.
# MRAG_ENCODER_BATCH_BUCKETS extends the ladder (e.g. "1,8,32,128,512"
# for bulk-ingest hosts where wider dispatches amortize per-call cost).
_BATCH_BUCKETS = tuple(
    int(x) for x in os.getenv("MRAG_ENCODER_BATCH_BUCKETS",
                              "1,8,32,128").split(","))

# Sequence buckets: chunks are ~100-200 tokens but the tokenizer pads to
# max_seq (512 default) — attention is O(L²) and the MLP O(L), so
# encoding at the 512 pad costs 2-4× the useful FLOPs. Each batch trims
# to the smallest bucket covering its longest text; PAD columns are
# masked out of attention AND pooling, so trimming them is exact (the
# parity test pins bucketed == full-length). MRAG_ENCODER_SEQ_BUCKETS=0
# disables (single full-length program).
_SEQ_BUCKETS = tuple(
    int(x) for x in os.getenv("MRAG_ENCODER_SEQ_BUCKETS",
                              "64,128,256").split(",") if int(x or 0) > 0)


class EncoderModel:
    """Host handle bundling config, params, tokenizer — the embed_fn
    plugged into SearchEngine / the ingest pipeline."""

    def __init__(self, cfg: EncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0):
        from mobius_rag_tpu.models.tokenizer import HashTokenizer
        from mobius_rag_tpu.utils import jit_cache

        jit_cache.enable_persistent_cache()
        self.cfg = cfg or EncoderConfig.from_env()
        if params is None:
            params = init_params(self.cfg, jax.random.PRNGKey(seed))
        # Commit params to device ONCE. Host-resident trees (checkpoint
        # loads, post-train device_get) would otherwise be re-uploaded on
        # every encode_jit dispatch (the whole parameter tree per call).
        self.params = jax.device_put(params)
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_seq)

    def _bucket(self, n: int) -> int:
        for b in _BATCH_BUCKETS:
            if n <= b:
                return b
        return ((n + _BATCH_BUCKETS[-1] - 1) // _BATCH_BUCKETS[-1]) * _BATCH_BUCKETS[-1]

    def _seq_bucket(self, tokens: np.ndarray) -> np.ndarray:
        """Trim a [B, max_seq] token block to the smallest seq bucket
        covering its longest text (exact: PAD columns are masked out of
        attention and pooling — see _SEQ_BUCKETS)."""
        if not _SEQ_BUCKETS:
            return tokens
        longest = int((tokens != 0).sum(axis=1).max()) if tokens.size else 0
        for sb in _SEQ_BUCKETS:
            if longest <= sb < tokens.shape[1]:
                return tokens[:, :sb]
        return tokens

    def __call__(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        out = np.zeros((len(texts), self.cfg.out_dim), np.float32)
        max_b = _BATCH_BUCKETS[-1]
        for off in range(0, len(texts), max_b):
            chunk = texts[off:off + max_b]
            tokens = self.tokenizer.encode_batch(chunk)
            b = self._bucket(len(chunk))
            if b != len(chunk):
                tokens = np.pad(tokens, ((0, b - len(chunk)), (0, 0)))
            tokens = self._seq_bucket(tokens)
            emb = encode_jit(self.params, jnp.asarray(tokens), self.cfg)
            out[off:off + len(chunk)] = np.asarray(emb)[: len(chunk)]
        return out


class MeshEncoderModel:
    """Data-parallel ingest encode over a `jax.sharding.Mesh` — the device
    form of the reference's N embedding workers × `FOR UPDATE SKIP
    LOCKED` queue (embedding_worker.py:393-431, SURVEY §2.9 last rows):
    instead of N processes racing over Postgres row locks, ONE process
    shards the token batch across the mesh's first axis, replicates the
    encoder params, and lets XLA run the same jitted forward as an SPMD
    program. Batch-parallel encode needs no collectives; per-row results
    are bit-comparable to the single-device encoder.

    Drop-in embed_fn: plug into IngestPipeline / OnChipProvider exactly
    like EncoderModel.
    """

    def __init__(self, mesh, cfg: EncoderConfig | None = None,
                 params: dict | None = None, seed: int = 0):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mobius_rag_tpu.models.tokenizer import HashTokenizer
        from mobius_rag_tpu.utils import jit_cache

        jit_cache.enable_persistent_cache()
        self.cfg = cfg or EncoderConfig.from_env()
        if params is None:
            params = init_params(self.cfg, jax.random.PRNGKey(seed))
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.dp = int(mesh.devices.shape[0])
        # params replicated once; the batch dim shards over the dp axis
        self._repl = NamedSharding(mesh, P())
        self._batch_shard = NamedSharding(mesh, P(self.axis, None))
        self.params = jax.device_put(params, self._repl)
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_seq)

    def _bucket(self, n: int) -> int:
        # same compile-bucket ladder as EncoderModel, rounded up so the
        # leading dim always divides evenly across the dp axis
        for b in _BATCH_BUCKETS:
            if n <= b and b % self.dp == 0:
                return b
        step = max(_BATCH_BUCKETS[-1], self.dp)
        return ((n + step - 1) // step) * step

    def __call__(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        out = np.zeros((len(texts), self.cfg.out_dim), np.float32)
        max_b = max(_BATCH_BUCKETS[-1], self.dp)
        for off in range(0, len(texts), max_b):
            chunk = texts[off:off + max_b]
            tokens = self.tokenizer.encode_batch(chunk)
            b = self._bucket(len(chunk))
            if b != len(chunk):
                tokens = np.pad(tokens, ((0, b - len(chunk)), (0, 0)))
            tokens = EncoderModel._seq_bucket(self, tokens)
            sharded = jax.device_put(jnp.asarray(tokens), self._batch_shard)
            emb = encode_jit(self.params, sharded, self.cfg)
            out[off:off + len(chunk)] = np.asarray(emb)[: len(chunk)]
        return out
