"""Durable index serving: remote-publish RPC instead of the snapshot hop.

Worker publishes used to reach the serving process via snapshot +
reload. This module kills that hop: the serving
process (api.server) exposes /internal/* index endpoints, and
:class:`RemoteIndexClient` is a ChunkStore-shaped client the embedding
worker plugs in unchanged (it only uses embedded_source_ids /
delete_by_document / publish_document / add_chunks). A publish lands in
the live device index immediately — and an attached ShardedEngine
refreshes through the store's mutation listeners — which is the
reference's publish contract (app/services/publish.py:27-481) without a
Postgres in the middle.

Wire format: ChunkRecord fields as JSON; embeddings as base64 float32
(1536-dim f32 ≈ 8 KB/chunk — fine for publish-grain traffic).
"""
from __future__ import annotations

import base64
import json
import urllib.parse
import urllib.request
from typing import Any, Sequence

import numpy as np

from mobius_rag_tpu.index.store import ChunkRecord

_FIELDS = ("chunk_id", "doc_id", "text", "source_id", "authority_level",
           "payer", "state", "program", "filename", "section_path",
           "summary", "page", "j_tags", "d_tags", "p_tags", "phrase_ids",
           "neighbor_text", "extra")


def record_to_wire(rec: ChunkRecord) -> dict[str, Any]:
    d = {f: getattr(rec, f) for f in _FIELDS}
    emb = np.asarray(rec.embedding, np.float32)
    d["embedding_b64"] = base64.b64encode(emb.tobytes()).decode()
    d["lexical_weights"] = {str(k): v for k, v in rec.lexical_weights.items()}
    return d


def record_from_wire(d: dict[str, Any]) -> ChunkRecord:
    emb = np.frombuffer(base64.b64decode(d["embedding_b64"]), np.float32).copy()
    kw = {f: d.get(f) for f in _FIELDS if d.get(f) is not None}
    kw["lexical_weights"] = {int(k): float(v)
                             for k, v in (d.get("lexical_weights") or {}).items()}
    return ChunkRecord(embedding=emb, **kw)


class RemoteIndexClient:
    """ChunkStore-shaped RPC client for the serving process's /internal
    index endpoints — the embedding worker's drop-in remote store."""

    def __init__(self, base_url: str, *, timeout_s: float = 60.0,
                 admin_key: str = ""):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.headers = {"Content-Type": "application/json"}
        if admin_key:
            self.headers["X-Admin-Key"] = admin_key

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, method="POST",
            data=json.dumps(payload).encode(), headers=self.headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def _get(self, path: str) -> dict:
        req = urllib.request.Request(self.base_url + path, headers=self.headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    # -- the ChunkStore surface the workers use ----------------------------

    def embedded_source_ids(self, doc_id: str) -> set[str]:
        out = self._get("/internal/index/source_ids/"
                        + urllib.parse.quote(doc_id, safe=""))
        return set(out["source_ids"])

    def delete_by_document(self, doc_id: str) -> int:
        return self._post("/internal/index/delete",
                          {"doc_id": doc_id})["deleted_chunks"]

    def publish_document(self, doc_id: str, recs: Sequence[ChunkRecord]) -> list[int]:
        out = self._post("/internal/index/publish", {
            "doc_id": doc_id,
            "records": [record_to_wire(r) for r in recs]})
        return out["rows"]

    def add_chunks(self, recs: Sequence[ChunkRecord]) -> list[int]:
        out = self._post("/internal/index/add_chunks", {
            "records": [record_to_wire(r) for r in recs]})
        return out["rows"]
