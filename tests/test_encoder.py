"""Encoder model + sharded contrastive training tests (tiny config)."""
import jax
import numpy as np

from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel, encode_jit, init_params
from mobius_rag_tpu.models.tokenizer import CLS_ID, PAD_ID, HashTokenizer
from mobius_rag_tpu.models.train import train_demo
from mobius_rag_tpu.parallel.mesh import make_train_mesh


def test_tokenizer_shapes_and_determinism():
    tok = HashTokenizer(vocab_size=1024, max_len=16)
    a = tok.encode("timely filing deadline for claims")
    b = tok.encode("timely filing deadline for claims")
    np.testing.assert_array_equal(a, b)
    assert a[0] == CLS_ID
    assert a.shape == (16,)
    assert (a >= 0).all() and (a < 1024).all()
    # same stems → same ids
    c = tok.encode("timely filings deadlines for claim")
    assert a[1] == c[1]


def test_encoder_output_normalized():
    cfg = EncoderConfig.tiny()
    model = EncoderModel(cfg)
    out = model(["prior authorization for DME", "timely filing deadline"])
    assert out.shape == (2, cfg.out_dim)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    # similar texts more similar than dissimilar ones
    out2 = model(["prior authorization for dme equipment",
                  "completely different astronomy topic stars galaxies"])
    sim_close = out[0] @ out2[0]
    sim_far = out[0] @ out2[1]
    assert sim_close > sim_far


def test_encoder_pad_invariance():
    cfg = EncoderConfig.tiny()
    model = EncoderModel(cfg)
    import jax.numpy as jnp
    short = model.tokenizer.encode_batch(["hello world"])
    # same text with extra pad shouldn't change the embedding
    e1 = np.asarray(encode_jit(model.params, jnp.asarray(short), cfg))
    assert short[0, 3] == PAD_ID  # rest is pad
    e2 = model(["hello world"])
    np.testing.assert_allclose(e1, e2, atol=1e-4)


def test_train_step_sharded_loss_decreases():
    mesh = make_train_mesh(dp=4, tp=2)
    history = train_demo(num_steps=8, mesh=mesh, batch=16)
    losses = [h["loss"] for h in history]
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_train_wide_tp_mesh():
    # tp must divide num_heads (4 in the tiny config)
    mesh = make_train_mesh(dp=2, tp=4)
    history = train_demo(num_steps=2, mesh=mesh, batch=8)
    assert np.isfinite(history[-1]["loss"])


def test_host_params_committed_to_device_once():
    """Constructing a model from host numpy params (the checkpoint-load /
    post-train path) must commit them to device at __init__ — otherwise
    every encode_jit dispatch re-uploads the full tree (~88 MB for the
    prod config)."""
    cfg = EncoderConfig.tiny()
    host_params = jax.device_get(init_params(cfg, jax.random.PRNGKey(0)))
    assert isinstance(jax.tree_util.tree_leaves(host_params)[0], np.ndarray)
    model = EncoderModel(cfg, host_params)
    for leaf in jax.tree_util.tree_leaves(model.params):
        assert isinstance(leaf, jax.Array)
    out = model(["device resident params"])
    assert out.shape == (1, cfg.out_dim)

    from mobius_rag_tpu.models.cross_encoder import CrossEncoderConfig, CrossEncoderModel, init_cross_params
    ccfg = CrossEncoderConfig(cfg)
    chost = jax.device_get(init_cross_params(ccfg, jax.random.PRNGKey(0)))
    cmodel = CrossEncoderModel(ccfg, chost)
    for leaf in jax.tree_util.tree_leaves(cmodel.params):
        assert isinstance(leaf, jax.Array)


def test_mesh_encoder_parity_and_ingest():
    """MeshEncoderModel (data-parallel encode over the mesh — the device
    form of the reference's N embedding workers × SKIP LOCKED queue,
    embedding_worker.py:393-431) must reproduce the single-device
    encoder per row AND serve as the pipeline embed_fn end-to-end."""
    from mobius_rag_tpu.models.encoder import MeshEncoderModel
    from mobius_rag_tpu.parallel.mesh import make_mesh

    cfg = EncoderConfig.tiny()
    mesh = make_mesh(8)
    single = EncoderModel(cfg)
    dp = MeshEncoderModel(mesh, cfg)

    # ragged sizes exercise every padding branch (sub-dp, non-multiple)
    for n in (1, 3, 8, 17):
        texts = [f"timely filing rule variant {i}" for i in range(n)]
        a, b = single(texts), dp(texts)
        assert a.shape == b.shape == (n, cfg.out_dim)
        assert np.abs(a - b).max() < 1e-5

    # embed_fn contract: drive a publish→search through the engine
    from mobius_rag_tpu.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu.ingest.featurize import featurize_chunk
    from mobius_rag_tpu.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu.testing import sample_lexicon

    lex = sample_lexicon()
    store = ChunkStore(capacity=256)
    texts = ["Sunshine Health timely filing is 180 days.",
             "Aetna requires prior authorization for H2019.",
             "Molina claims dispute window is 90 days."]
    vecs = dp(texts)
    store.add_chunks([
        featurize_chunk(ChunkRecord(chunk_id=f"m-c{i}", doc_id=f"m{i}",
                                    text=t, embedding=vecs[i]), lex)
        for i, t in enumerate(texts)])
    eng = SearchEngine(store, lex, embed_fn=dp)
    res = eng.search(QueryRequest(query="timely filing deadline"), k=2)[0]
    assert res.hits and res.hits[0].chunk_id == "m-c0"


def test_seq_bucketing_matches_full_length(monkeypatch):
    """Trimming PAD columns to a seq bucket is exact: masked attention +
    masked pooling make PAD positions inert (encoder.py _SEQ_BUCKETS)."""
    import numpy as np

    from mobius_rag_tpu.models import encoder as enc_mod
    from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel

    cfg = EncoderConfig.tiny()
    model = EncoderModel(cfg, seed=3)
    texts = ["timely filing deadline", "prior authorization for H0019",
             "a much longer paragraph about claims submission windows "
             "and corrected claim resubmission requirements"]

    monkeypatch.setattr(enc_mod, "_SEQ_BUCKETS", ())
    full = model(texts)
    monkeypatch.setattr(enc_mod, "_SEQ_BUCKETS", (8, 16, 32))
    bucketed = model(texts)
    np.testing.assert_allclose(bucketed, full, rtol=2e-5, atol=2e-6)

    # the short batch really did take a narrower program
    toks = model.tokenizer.encode_batch(texts[:2])
    assert model._seq_bucket(toks).shape[1] <= 16


def test_seq_bucket_selection_bounds():
    from mobius_rag_tpu.models import encoder as enc_mod
    from mobius_rag_tpu.models.encoder import EncoderConfig, EncoderModel
    import numpy as np

    cfg = EncoderConfig.tiny()
    model = EncoderModel(cfg, seed=0)
    if not enc_mod._SEQ_BUCKETS:
        return
    # all-PAD block trims to the smallest bucket; over-long stays full
    empty = np.zeros((2, cfg.max_seq), np.int32)
    assert model._seq_bucket(empty).shape[1] == min(
        b for b in enc_mod._SEQ_BUCKETS if b < cfg.max_seq or True)


def test_hybrid_anchor_alpha_zero_equals_bag():
    """hybrid_anchor contract: at alpha=0 the embedding IS the fixed
    bag-of-tokens projection — the model can never score below the
    hash-projection baseline family by construction (round-5 encoder
    campaign, EVAL_r5_encoder.json)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mobius_rag_tpu.models.encoder import (EncoderConfig, EncoderModel,
                                               encode)

    cfg = dataclasses.replace(EncoderConfig.tiny(), hybrid_anchor=True)
    m = EncoderModel(cfg)
    assert "anchor_proj" in m.params and "alpha" in m.params
    toks = m.tokenizer.encode_batch(
        ["timely filing deadline for claims submission"])
    p0 = dict(m.params)
    p0["alpha"] = jnp.asarray(0.0)
    bag_only = np.asarray(encode(p0, jnp.asarray(toks), cfg))[0]
    e = np.asarray(m.params["anchor_proj"])
    live = toks[0][toks[0] != 0]
    ref = e[live].sum(0)
    ref = ref / np.linalg.norm(ref)
    np.testing.assert_allclose(bag_only, ref, atol=1e-5)
    # alpha>0 changes the embedding but keeps it unit-norm
    full = np.asarray(encode(m.params, jnp.asarray(toks), cfg))[0]
    assert abs(np.linalg.norm(full) - 1.0) < 1e-4
    assert np.abs(full - bag_only).max() > 1e-3
