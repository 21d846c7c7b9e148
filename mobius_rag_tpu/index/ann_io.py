"""ANN table persistence — serving restarts reload IVF / packed / PQ
tables instead of re-running k-means.

Reference parity: the reference's ANN structure (pgvector HNSW,
migrations/add_pgvector_columns.py) is durable in Postgres — a backend
restart never rebuilds it. Here the tables are device arrays built from
the chunk matrix (index/ivf.py, ops/pq.py), so without persistence every
restore pays the full k-means + assignment + packing build (minutes at
the 10M config). All three table classes are jax pytrees with a FIELDS
tuple + static aux, so one generic npz writer covers them.

Pairing contract: an ann.npz is only valid for the snapshot it was
written with — load_ann validates class/backend and the row count, and
callers write both files in the same /admin/snapshot call.
"""
from __future__ import annotations

import json
from typing import Any

import jax
import numpy as np

_HEADER_KEY = "__header__"

# Upload granularity for restore: arrays go up in ~256 MB chunks that
# scatter into a donated device buffer, so peak device memory stays
# buffer + one chunk, not 2x the array. Whether chunking still pays on a
# GPU host (a single device_put streams over PCIe) is not measured
# (ROADMAP 3.1).
_PUT_CHUNK_BYTES = 256 << 20


def _chunked_device_put(a: np.ndarray):
    if a.nbytes <= _PUT_CHUNK_BYTES or a.ndim == 0:
        return jax.device_put(a)
    import functools

    import jax.numpy as jnp

    rows_per = max(1, _PUT_CHUNK_BYTES // max(a.nbytes // a.shape[0], 1))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scatter(buf, chunk, off):
        return jax.lax.dynamic_update_slice_in_dim(buf, chunk, off, axis=0)

    buf = jnp.zeros(a.shape, a.dtype)
    for i, off in enumerate(range(0, a.shape[0], rows_per)):
        buf = scatter(buf, jax.device_put(a[off:off + rows_per]),
                      jnp.int32(off))
        if i % 4 == 3:  # periodic sync keeps the transport queue bounded
            jax.device_get(buf[0, ...].ravel()[0])
    return buf


def _classes() -> dict[str, Any]:
    from mobius_rag_tpu.index.ivf import IVFIndex, PackedIVF
    from mobius_rag_tpu.ops.pq import PackedPQ
    from mobius_rag_tpu.ops.proj import PackedProj

    return {c.__name__: c for c in (IVFIndex, PackedIVF, PackedPQ,
                                    PackedProj)}


def save_ann(ann: Any, path: str, *, meta: dict[str, Any] | None = None) -> None:
    """Serialize one ANN table object (IVFIndex/PackedIVF/PackedPQ) to
    an .npz with a JSON header carrying the static aux + caller meta."""
    name = type(ann).__name__
    if name not in _classes():
        raise ValueError(f"unsupported ANN table type {name}")
    leaves, aux = ann.tree_flatten()
    arrays = {f: np.asarray(jax.device_get(a))
              for f, a in zip(type(ann).FIELDS, leaves)}
    header = {"class": name, "aux": list(aux), "meta": meta or {}}
    np.savez(path, **{_HEADER_KEY: np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)}, **arrays)


def load_ann(path: str, *, to_device: bool = True) -> tuple[Any, dict[str, Any]]:
    """Load (ann, meta). Arrays go straight to the default device unless
    to_device=False (host inspection)."""
    z = np.load(path, allow_pickle=False)
    header = json.loads(bytes(z[_HEADER_KEY]).decode())
    cls = _classes().get(header["class"])
    if cls is None:
        raise ValueError(f"unknown ANN table class {header['class']!r}")
    children = []
    host_arrays = {}
    for f in cls.FIELDS:
        a = z[f]
        host_arrays[f] = a
        children.append(_chunked_device_put(a) if to_device else a)
    aux = tuple(header["aux"])
    ann = cls.tree_unflatten(aux, children)
    if header["class"] == "PackedProj":
        # host slot-layout mirrors keep the engine's incremental
        # insert path (reserved slabs) alive across restores
        ann.build_rowids = np.array(host_arrays["rowids"])
        ann.build_valid = np.array(host_arrays["valid"])
    return ann, header.get("meta", {})
