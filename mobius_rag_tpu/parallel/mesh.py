"""Device-mesh construction helpers.

The reference's only scale-out mechanism is N worker processes around a
shared Postgres (SURVEY §2.10); here scale-out is a jax.sharding.Mesh —
the corpus shards across the ``shard`` axis, and the encoder trains
over ``dp``/``tp`` axes (models/train.py).

The mesh follows the algorithm, not a link topology (the cards of one
host are joined all to all):

- The 2D serve mesh carries the per-query allgather merge of per-shard
  top-k candidates — the only collective on the query path
  (parallel/sharded.py) — along ``shard``. The ``data`` axis needs NO
  query-path collective at all: each data group scans its own corpus
  replica.
- Corpora beyond one host's device + host memory split at the HOST
  layer instead: one NamespaceRegistry namespace per host with the
  RemoteIndexClient RPC fan-out + host-side RRF merge (index/service
  .py) — the traffic between hosts is then k results/query, not
  candidates (parallel/slices.py).
- Ingest/publish crosses hosts through the durable host queue (the
  reference's Postgres-bus role), never through device collectives."""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(num_shards: int = 0, axis: str = "shard", devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = num_shards or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} shards but only {len(devices)} devices")
    return Mesh(np.array(devices[:n]), (axis,))


def make_serve_mesh(dp: int, num_shards: int = 0, *,
                    data_axis: str = "data", shard_axis: str = "shard",
                    devices=None) -> Mesh:
    """2D serving mesh: the corpus shards over ``shard_axis`` and is
    REPLICATED over ``data_axis``; the query batch splits over
    ``data_axis``. The scaling-book shape for 'corpus fits a subset of
    the slice': spend leftover chips on query parallelism instead of
    thinner shards (each data group scans its own replica — query
    throughput scales with dp at unchanged per-query latency)."""
    devices = list(devices if devices is not None else jax.devices())
    n = num_shards or len(devices) // max(dp, 1)
    if dp * n > len(devices):
        raise ValueError(f"dp*shards={dp * n} > {len(devices)} devices")
    if dp < 1 or n < 1:
        raise ValueError(f"dp={dp} and shards={n} must be >= 1")
    grid = np.array(devices[: dp * n]).reshape(dp, n)
    return Mesh(grid, (data_axis, shard_axis))


def make_train_mesh(dp: int, tp: int, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if dp * tp > len(devices):
        raise ValueError(f"dp*tp={dp * tp} > {len(devices)} devices")
    grid = np.array(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(grid, ("dp", "tp"))
