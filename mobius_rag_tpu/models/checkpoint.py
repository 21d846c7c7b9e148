"""Encoder parameter checkpointing (orbax-backed, npz fallback).

The reference has no model weights to checkpoint (embeddings are
rented); here the encoder is a first-class artifact: params + config
saved together so a snapshot of the INDEX (built with encoder X) can
always be paired with encoder X at serving time — embedding-space drift
between encoder versions is this build's analogue of the reference's
rag↔chat drift class (SURVEY §5.5)."""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np

from mobius_rag_tpu.models.encoder import EncoderConfig


def save_encoder(path: str, params: dict, cfg: EncoderConfig, *,
                 kind: str = "bi") -> None:
    """kind: 'bi' (embedding encoder) or 'cross' (reranker)."""
    os.makedirs(path, exist_ok=True)
    try:
        import orbax.checkpoint as ocp

        ckpt = ocp.PyTreeCheckpointer()
        ckpt.save(os.path.join(os.path.abspath(path), "params"), params, force=True)
        backend = "orbax"
    except Exception:
        # npz fallback: flatten the pytree
        flat, treedef = jax.tree_util.tree_flatten(params)
        np.savez_compressed(
            os.path.join(path, "params.npz"),
            **{f"p{i}": np.asarray(x) for i, x in enumerate(flat)},
        )
        backend = "npz"
    with open(os.path.join(path, "encoder.json"), "w") as f:
        json.dump({"backend": backend, "kind": kind,
                   "config": dataclasses.asdict(cfg)}, f)


def load_encoder(path: str) -> tuple[dict, EncoderConfig]:
    with open(os.path.join(path, "encoder.json")) as f:
        meta = json.load(f)
    cfg = EncoderConfig(**meta["config"])
    if meta["backend"] == "orbax":
        import orbax.checkpoint as ocp

        ckpt = ocp.PyTreeCheckpointer()
        params = ckpt.restore(os.path.join(os.path.abspath(path), "params"))
    else:
        if meta.get("kind") == "cross":
            from mobius_rag_tpu.models.cross_encoder import (CrossEncoderConfig,
                                                             init_cross_params)

            template = init_cross_params(CrossEncoderConfig(cfg),
                                         jax.random.PRNGKey(0))
        else:
            from mobius_rag_tpu.models.encoder import init_params

            template = init_params(cfg, jax.random.PRNGKey(0))
        flat, treedef = jax.tree_util.tree_flatten(template)
        data = np.load(os.path.join(path, "params.npz"))
        params = jax.tree_util.tree_unflatten(
            treedef, [data[f"p{i}"] for i in range(len(flat))]
        )
    return params, cfg
