"""Device-resident chunk index — the on-device replacement for the
reference's ``rag_published_embeddings`` Postgres table
(reference: app/models.py:242-280) and its pgvector/GIN indexes.

Layout (all fixed-capacity device arrays; capacity doubles on overflow,
unused rows masked via ``valid`` — mutable-index-vs-jit is solved by
static shapes + masking, never by reshaping under jit):

  vectors      [C, D]   f32/bf16/int8  L2-normalized chunk embeddings
  vec_scales   [C]      f32       per-row dequant scales (1.0 unless int8)
  valid        [C]      f32       1.0 = live row, 0.0 = hole/pad
  doc_id       [C]      i32       int-coded document
  authority    [C]      f32       authority_level normalized to [0, 1]
  length_score [C]      f32       precomputed body-length signal
  payer/state/program [C] i32     int-coded canonical metadata
  j/d/p_tags   [C, TW]  u32       tag-membership bitsets (Path-B tags)
  phrase_bits  [C, PW]  u32       lexicon-phrase presence over the
                                  ENRICHED haystack (body + neighbors +
                                  doc metadata) — precomputed at ingest by
                                  Aho-Corasick so the reranker's coverage
                                  signal (corpus_search.py:1909 semantics)
                                  is a pure bit-AND-popcount on device
  lexical      [H, C]   bf16      hashed-term BM25 weights (field-weighted
                                  A/B/C/D like the reference's multi-field
                                  search_vec; migration
                                  rebuild_rag_published_fts_multifield.py).
                                  Stored TRANSPOSED (bucket-major) so the
                                  query path gathers only the few dozen
                                  buckets a query batch touches — ~130 MB
                                  instead of a 2.3 GB full-matrix read at
                                  70k chunks (queries are sparse in H)

Host side keeps the row ↔ chunk-record map (text, ids, display metadata)
for assembly; nothing host-side is on the query hot path before result
materialization.

Writes are publish-grain and idempotent: ``publish_document`` =
delete_by_document + append (the reference's DELETE+INSERT republish
contract, app/services/publish.py:27-481). Appends go through a jitted
fixed-size block writer (``lax.dynamic_update_slice``) so ingest never
recompiles.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mobius_rag_tpu.config import Config, get_config
from mobius_rag_tpu.utils import round_up

# Rows written per device scatter call; appends are padded up to this so
# the writer jit-compiles exactly once per array signature.
_WRITE_BLOCK = 256


def pack_bits(ids: Iterable[int], words: int) -> np.ndarray:
    """Pack small-int ids into a uint32 bitset of `words` words.

    Accumulates in a Python int and materializes once — numpy scalar
    shift/or per id cost ~2 µs each, which is minutes of pure Python
    across a 10M-record bulk_load (4 calls per record)."""
    acc = 0
    limit = words * 32
    for i in ids:
        if 0 <= i < limit:
            acc |= 1 << int(i)  # int(): numpy scalars overflow at 1<<63
    if acc == 0:
        return np.zeros(words, dtype=np.uint32)
    return np.frombuffer(acc.to_bytes(words * 4, "little"),
                         dtype=np.uint32).copy()


def unpack_bits(bits: np.ndarray) -> list[int]:
    out = []
    for w, word in enumerate(np.asarray(bits, dtype=np.uint32)):
        word = int(word)
        b = 0
        while word:
            if word & 1:
                out.append(w * 32 + b)
            word >>= 1
            b += 1
    return out


@dataclasses.dataclass
class ChunkRecord:
    """One published chunk — host-side record + everything needed to build
    its device row. Mirrors the reference's published-embedding row
    (app/models.py:242-280: denormalized doc metadata + embedding +
    chunk_{d,p,j}_tags) plus the precomputed device signals."""

    chunk_id: str
    doc_id: str
    text: str
    embedding: np.ndarray  # [D] (will be L2-normalized)
    source_id: str = ""  # embeddable-unit id, for incremental resume
    authority_level: int = 0  # 0..4 (higher = more authoritative)
    payer: str = ""
    state: str = ""
    program: str = ""
    filename: str = ""
    section_path: str = ""
    summary: str = ""
    page: int = 0
    j_tags: list[int] = dataclasses.field(default_factory=list)
    d_tags: list[int] = dataclasses.field(default_factory=list)
    p_tags: list[int] = dataclasses.field(default_factory=list)
    phrase_ids: list[int] = dataclasses.field(default_factory=list)
    lexical_weights: dict[int, float] = dataclasses.field(default_factory=dict)
    neighbor_text: str = ""
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


@jax.tree_util.register_pytree_node_class
class DeviceIndex:
    """The pytree of device arrays handed to compiled query pipelines.

    Two lexical layouts (Config.lexical_format):
      dense   — `lexical` [H, C] bf16 bucket-major weights (default)
      sparse  — `lex_cols` [H, P] i32 chunk rows (-1 pad) + `lex_wts`
                [H, P] bf16 weights; memory scales with postings, not
                H*C, lifting the dense layout's HBM ceiling at ≥1M rows.
    The instance's field tuple rides pytree aux data, so both layouts
    flow through the same jitted writers and query pipelines (layout is
    a static trace-time property)."""

    # canonical field order; an instance carries the subset it uses
    _CANON = (
        "vectors", "vec_scales", "valid", "doc_id", "authority", "length_score",
        "payer", "state", "program",
        "j_tags", "d_tags", "p_tags", "phrase_bits",
        "lexical", "lex_cols", "lex_wts",
    )
    # dense-layout field tuple (kept under the historical name)
    FIELDS = _CANON[:14]

    def __init__(self, **arrays):
        self.fields = tuple(f for f in self._CANON if f in arrays)
        if len(self.fields) != len(arrays):
            unknown = set(arrays) - set(self._CANON)
            raise ValueError(f"unknown DeviceIndex fields: {sorted(unknown)}")
        for f in self.fields:
            setattr(self, f, arrays[f])

    @staticmethod
    def chunk_axis(f: str) -> int | None:
        """Which axis of field `f` indexes chunks (None = no chunk axis —
        the sparse postings arrays are bucket-major and row-valued)."""
        if f == "lexical":
            return 1
        if f in ("lex_cols", "lex_wts"):
            return None
        return 0

    def tree_flatten(self):
        return tuple(getattr(self, f) for f in self.fields), self.fields

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(**dict(zip(aux, children)))

    def replace(self, **updates) -> "DeviceIndex":
        arrays = {f: getattr(self, f) for f in self.fields}
        arrays.update(updates)
        return DeviceIndex(**arrays)

    @property
    def capacity(self) -> int:
        # valid always spans the row capacity; vectors may be EMPTY
        # ([0, D]) under host residency (the 10M codes-only regime)
        return self.valid.shape[0]

    @classmethod
    def empty(cls, capacity: int, cfg: Config) -> "DeviceIndex":
        vec_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                     "int8": jnp.int8}[cfg.vector_dtype]
        c = capacity
        # host residency: no dense vector payload in HBM — the int8 rows
        # live in ChunkStore.host_vectors and HBM holds only PQ codes
        c_vec = 0 if cfg.vector_residency == "host" else c
        arrays = dict(
            vectors=jnp.zeros((c_vec, cfg.embed_dim), vec_dtype),
            vec_scales=jnp.ones((c,), jnp.float32),
            valid=jnp.zeros((c,), jnp.float32),
            doc_id=jnp.full((c,), -1, jnp.int32),
            authority=jnp.zeros((c,), jnp.float32),
            length_score=jnp.zeros((c,), jnp.float32),
            payer=jnp.full((c,), -1, jnp.int32),
            state=jnp.full((c,), -1, jnp.int32),
            program=jnp.full((c,), -1, jnp.int32),
            j_tags=jnp.zeros((c, cfg.tag_words), jnp.uint32),
            d_tags=jnp.zeros((c, cfg.tag_words), jnp.uint32),
            p_tags=jnp.zeros((c, cfg.tag_words), jnp.uint32),
            phrase_bits=jnp.zeros((c, cfg.phrase_words), jnp.uint32),
        )
        if cfg.lexical_format == "sparse":
            h, p = cfg.lexical_buckets, cfg.lexical_postings_init
            arrays["lex_cols"] = jnp.full((h, p), -1, jnp.int32)
            arrays["lex_wts"] = jnp.zeros((h, p), jnp.bfloat16)
        else:
            arrays["lexical"] = jnp.zeros((cfg.lexical_buckets, c), jnp.bfloat16)
        return cls(**arrays)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_block(index: DeviceIndex, start: jnp.ndarray, block: dict) -> DeviceIndex:
    """Write a fixed-size row block at dynamic offset `start` (donated
    in-place update; one compile per array signature). `lexical` is
    bucket-major [H, C], so its chunk-block writes land on axis 1;
    fields absent from `block` (the sparse postings arrays, which are
    updated by bucket not by row) pass through untouched."""
    new = {}
    for f in index.fields:
        arr = getattr(index, f)
        if f not in block:
            new[f] = arr
            continue
        upd = block[f].astype(arr.dtype)
        if f == "lexical":
            new[f] = jax.lax.dynamic_update_slice(arr, upd, (0, start))
        elif arr.ndim == 1:
            new[f] = jax.lax.dynamic_update_slice(arr, upd, (start,))
        else:
            new[f] = jax.lax.dynamic_update_slice(arr, upd, (start, 0))
    return DeviceIndex(**new)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_rows(index: DeviceIndex, rows: jnp.ndarray, block: dict) -> DeviceIndex:
    """Scatter-write a fixed-size row list (donated in-place update).
    The free-row-recycling counterpart of :func:`_write_block`: targets
    are arbitrary (recycled) rows, so writes go through `.at[rows].set`.
    `rows` is padded by REPEATING a real row — the duplicate writes carry
    identical values, so scatter order cannot corrupt anything. Every
    written field is fully overwritten, which also clears whatever the
    row's previous (deleted) occupant left behind."""
    new = {}
    for f in index.fields:
        arr = getattr(index, f)
        if f not in block:
            new[f] = arr
            continue
        upd = block[f].astype(arr.dtype)
        if f == "lexical":  # bucket-major [H, C]: column scatter
            new[f] = arr.at[:, rows].set(upd)
        else:
            new[f] = arr.at[rows].set(upd)
    return DeviceIndex(**new)


@functools.partial(jax.jit, donate_argnums=(0,))
def _clear_rows(index: DeviceIndex, rows: jnp.ndarray) -> DeviceIndex:
    """Mark a fixed-size padded list of rows invalid (rows < 0 are no-ops)."""
    safe = jnp.where(rows >= 0, rows, 0)
    keep = (rows >= 0).astype(jnp.float32)
    valid = index.valid.at[safe].multiply(1.0 - keep)
    return index.replace(valid=valid)


class _Interner:
    """String → dense int id (payer/state/program/doc interning)."""

    def __init__(self):
        self.to_id: dict[str, int] = {}
        self.to_str: list[str] = []

    def intern(self, s: str) -> int:
        if s not in self.to_id:
            self.to_id[s] = len(self.to_str)
            self.to_str.append(s)
        return self.to_id[s]

    def lookup(self, i: int) -> str:
        return self.to_str[i] if 0 <= i < len(self.to_str) else ""

    def state_dict(self):
        return {"to_str": self.to_str}

    def load_state(self, st):
        self.to_str = list(st["to_str"])
        self.to_id = {s: i for i, s in enumerate(self.to_str)}


# Authority levels normalize to [0,1] over a 0..4 scale (the reference
# scores authority_level through _authority_score, corpus_search.py).
_AUTH_MAX = 4.0


def _length_score(text: str) -> float:
    """Body-length signal in [0,1]: ramps to 1.0 at ~600 chars, flat after.
    (Same intent as the reference's _length_score: penalize stub rows,
    don't reward bloat.)"""
    return min(len(text) / 600.0, 1.0)


class ChunkStore:
    """Mutable host handle around a :class:`DeviceIndex`."""

    def __init__(self, cfg: Config | None = None, capacity: int | None = None):
        self.cfg = cfg or get_config()
        cap = round_up(capacity or self.cfg.initial_capacity, _WRITE_BLOCK)
        self.index = DeviceIndex.empty(cap, self.cfg)
        self.records: list[ChunkRecord | None] = []
        self.docs = _Interner()
        self.payers = _Interner()
        self.states = _Interner()
        self.programs = _Interner()
        self._doc_rows: dict[str, list[int]] = {}
        self._source_ids: dict[str, set[str]] = {}  # doc → embedded source ids
        self._free_rows: list[int] = []
        self._lexical_stats_cache: tuple[dict[int, int], int] | None = None
        # Write-generation counter + mutation listeners: every device-state
        # mutation bumps `generation` and notifies listeners with
        # (event, rows) so downstream mirrors (ShardedEngine, index
        # service) can stay current instead of silently serving stale
        # results (the reference's republish contract, publish.py:27-481,
        # has no "frozen at construction" copies anywhere).
        self.generation = 0
        self.listeners: list[Any] = []  # callables (event: str, rows: list[int])
        self._sparse_lexical = self.cfg.lexical_format == "sparse"
        # host residency (config 5): int8 rows + scales in host RAM —
        # candidate generation runs on PQ codes in HBM, the engine's
        # post-fusion exact re-rank gathers these rows
        self._host_residency = self.cfg.vector_residency == "host"
        if self._host_residency:
            self.host_vectors = np.zeros((cap, self.cfg.embed_dim), np.int8)
            self.host_scales = np.ones((cap,), np.float32)
        else:
            self.host_vectors = None
            self.host_scales = None
        if self._sparse_lexical:
            h, p = self.cfg.lexical_buckets, self.cfg.lexical_postings_init
            # host mirrors of lex_cols/lex_wts (postings packed left,
            # -1-padded) — writes mutate these, then sync to device
            self._lex_cols_np = np.full((h, p), -1, np.int32)
            self._lex_wts_np = np.zeros((h, p), np.float32)
            self._lex_fill = np.zeros(h, np.int64)

    # -- sizing ----------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self.records) - len(self._free_rows)

    @property
    def capacity(self) -> int:
        return self.index.capacity

    def _notify(self, event: str, rows: Sequence[int]) -> None:
        self.generation += 1
        for fn in self.listeners:
            fn(event, list(rows))

    def _ensure_capacity(self, extra: int) -> None:
        needed = len(self.records) + extra
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        old = jax.device_get(self.index)
        grown = {}
        for f in self.index.fields:
            arr = np.asarray(getattr(old, f))
            axis = DeviceIndex.chunk_axis(f)
            if axis is None:  # sparse postings don't scale with row capacity
                grown[f] = jnp.asarray(arr)
                continue
            if f == "vectors" and self._host_residency:
                grown[f] = jnp.asarray(arr)  # stays [0, D]
                continue
            shape = list(arr.shape)
            shape[axis] = new_cap - arr.shape[axis]
            pad = np.zeros(shape, arr.dtype)
            if f in ("doc_id", "payer", "state", "program"):
                pad.fill(-1)
            grown[f] = jnp.asarray(np.concatenate([arr, pad], axis=axis))
        self.index = DeviceIndex(**grown)
        if self._host_residency:
            hv = np.zeros((new_cap, self.cfg.embed_dim), np.int8)
            hv[: len(self.host_vectors)] = self.host_vectors
            hs = np.ones((new_cap,), np.float32)
            hs[: len(self.host_scales)] = self.host_scales
            self.host_vectors, self.host_scales = hv, hs
        self._notify("grow", [])

    # -- writes ------------------------------------------------------------

    def add_chunks(self, recs: Sequence[ChunkRecord]) -> list[int]:
        """Insert records; returns assigned device rows. Embeddings are
        L2-normalized here (pgvector cosine ordering is normalization-
        invariant; normalizing once at publish makes query-time scoring a
        pure dot product).

        Rows freed by deletes are RECYCLED before the record list grows
        (republish-heavy workloads — the reference's DELETE+INSERT
        steady state, publish.py:27-481 — would otherwise grow the
        device arrays without bound). Recycled rows are written through
        the scatter path (:func:`_write_rows`); fresh appends keep the
        contiguous block path."""
        if not recs:
            return []
        cfg = self.cfg
        # Validate before mutating any host state so a bad batch is atomic.
        for r in recs:
            emb = np.asarray(r.embedding, np.float32)
            if emb.shape != (cfg.embed_dim,):
                raise ValueError(
                    f"embedding shape {emb.shape} != ({cfg.embed_dim},) "
                    f"for chunk {r.chunk_id!r}"
                )
        n_rec = min(len(recs), len(self._free_rows))
        if n_rec:
            self._free_rows.sort()
            recycled, self._free_rows = (self._free_rows[:n_rec],
                                         self._free_rows[n_rec:])
            if self._sparse_lexical:
                # stale postings still reference the freed rows; scrub
                # them BEFORE the rows get new occupants, or old weights
                # would score the new content
                self._sparse_scrub_rows(recycled)
        else:
            recycled = []
        self._ensure_capacity(len(recs) - n_rec)
        rows = []
        start = len(self.records)
        for i, r in enumerate(recs):
            if i < n_rec:
                row = recycled[i]
                self.records[row] = r
            else:
                row = len(self.records)
                self.records.append(r)
            rows.append(row)
            self._doc_rows.setdefault(r.doc_id, []).append(row)
            if r.source_id:
                self._source_ids.setdefault(r.doc_id, set()).add(r.source_id)

        # Stage host blocks, then write in fixed-size device blocks.
        # With recycling an extra zero block is staged at the tail so the
        # append path always has zero (valid=0) rows to pad with.
        n = len(recs)
        n_pad = round_up(n, _WRITE_BLOCK) + (_WRITE_BLOCK if n_rec else 0)
        d = cfg.embed_dim
        vecs = np.zeros((n_pad, d), np.float32)
        vec_scales = np.ones((n_pad,), np.float32)
        valid = np.zeros((n_pad,), np.float32)
        doc_id = np.full((n_pad,), -1, np.int32)
        authority = np.zeros((n_pad,), np.float32)
        length_score = np.zeros((n_pad,), np.float32)
        payer = np.full((n_pad,), -1, np.int32)
        state = np.full((n_pad,), -1, np.int32)
        program = np.full((n_pad,), -1, np.int32)
        j_tags = np.zeros((n_pad, cfg.tag_words), np.uint32)
        d_tags = np.zeros((n_pad, cfg.tag_words), np.uint32)
        p_tags = np.zeros((n_pad, cfg.tag_words), np.uint32)
        phrase_bits = np.zeros((n_pad, cfg.phrase_words), np.uint32)
        if self._sparse_lexical:
            postings: dict[int, list[tuple[int, float]]] = {}
        else:
            lexical = np.zeros((cfg.lexical_buckets, n_pad), np.float32)  # bucket-major

        for i, r in enumerate(recs):
            v = np.asarray(r.embedding, np.float32)
            norm = float(np.linalg.norm(v))
            v = v / norm if norm > 0 else v
            if cfg.vector_dtype == "int8":
                max_abs = float(np.abs(v).max())
                scale = max_abs / 127.0 if max_abs > 0 else 1.0
                vecs[i] = np.clip(np.round(v / scale), -127, 127)
                vec_scales[i] = scale
            else:
                vecs[i] = v
            valid[i] = 1.0
            doc_id[i] = self.docs.intern(r.doc_id)
            authority[i] = min(max(r.authority_level, 0), _AUTH_MAX) / _AUTH_MAX
            length_score[i] = _length_score(r.text)
            payer[i] = self.payers.intern(r.payer) if r.payer else -1
            state[i] = self.states.intern(r.state) if r.state else -1
            program[i] = self.programs.intern(r.program) if r.program else -1
            j_tags[i] = pack_bits(r.j_tags, cfg.tag_words)
            d_tags[i] = pack_bits(r.d_tags, cfg.tag_words)
            p_tags[i] = pack_bits(r.p_tags, cfg.tag_words)
            phrase_bits[i] = pack_bits(r.phrase_ids, cfg.phrase_words)
            if self._sparse_lexical:
                for bucket, w in r.lexical_weights.items():
                    postings.setdefault(bucket % cfg.lexical_buckets, []) \
                        .append((rows[i], float(w)))
            else:
                for bucket, w in r.lexical_weights.items():
                    lexical[bucket % cfg.lexical_buckets, i] += w

        staged = {
            "vectors": vecs, "vec_scales": vec_scales, "valid": valid,
            "doc_id": doc_id, "authority": authority,
            "length_score": length_score, "payer": payer, "state": state,
            "program": program, "j_tags": j_tags, "d_tags": d_tags,
            "p_tags": p_tags, "phrase_bits": phrase_bits,
        }

        if self._host_residency:
            # int8 rows + scales land in host RAM; the device index
            # carries no dense payload (PQ codes are built by ensure_ann)
            row_arr = np.asarray(rows)
            self.host_vectors[row_arr] = vecs[:n].astype(np.int8)
            self.host_scales[row_arr] = vec_scales[:n]
            staged.pop("vectors")

        def block_of(sel: np.ndarray) -> dict:
            block = {f: jnp.asarray(a[sel]) for f, a in staged.items()}
            if not self._sparse_lexical:
                block["lexical"] = jnp.asarray(lexical[:, sel])
            return block

        if n_rec:
            # recycled rows: scatter writes (targets are arbitrary rows);
            # pads repeat the last real (row, value) pair — harmless
            r_pad = round_up(n_rec, _WRITE_BLOCK)
            tgt = np.full(r_pad, rows[n_rec - 1], np.int32)
            tgt[:n_rec] = rows[:n_rec]
            sel = np.full(r_pad, n_rec - 1, np.int64)
            sel[:n_rec] = np.arange(n_rec)
            for off in range(0, r_pad, _WRITE_BLOCK):
                self.index = _write_rows(
                    self.index, jnp.asarray(tgt[off:off + _WRITE_BLOCK]),
                    block_of(sel[off:off + _WRITE_BLOCK]))
        n_app = n - n_rec
        for off in range(0, round_up(n_app, _WRITE_BLOCK) if n_app else 0,
                         _WRITE_BLOCK):
            # pads clip into the zero-staged tail (valid=0 rows)
            sel = np.minimum(n_rec + off + np.arange(_WRITE_BLOCK), n_pad - 1)
            self.index = _write_block(self.index, jnp.int32(start + off),
                                      block_of(sel))
        if self._sparse_lexical:
            self._sparse_add(postings)
        self._lexical_stats_cache = None
        self._notify("add", rows)
        return rows

    # -- sparse-lexical maintenance ---------------------------------------

    def _sparse_scrub_rows(self, rows: Sequence[int]) -> None:
        """Remove every posting that references `rows` (host mirrors +
        device sync). Called before deleted rows are RECYCLED: until
        then dead postings are harmless (the valid mask gates them), but
        once the row has a new occupant an old posting would score the
        new content with the old weight."""
        target = np.asarray(sorted(rows), np.int32)
        mask = np.isin(self._lex_cols_np, target)
        touched = np.nonzero(mask.any(axis=1))[0]
        if len(touched) == 0:
            return
        self._lex_cols_np[mask] = -1
        self._lex_wts_np[mask] = 0.0
        # fill counts keep the holes (compaction reclaims them lazily)
        self._sync_sparse_device(list(touched))

    def _sparse_compact(self, bucket: int) -> None:
        """Repack a bucket's postings, dropping holes and rows that were
        deleted (and not yet recycled — recycled rows had their stale
        postings scrubbed in _sparse_scrub_rows, so a live record here
        means a live posting)."""
        fill = int(self._lex_fill[bucket])
        cols = self._lex_cols_np[bucket, :fill]
        wts = self._lex_wts_np[bucket, :fill]
        live = np.array([0 <= c < len(self.records)
                         and self.records[c] is not None for c in cols],
                        dtype=bool)
        keep = int(live.sum())
        self._lex_cols_np[bucket, :keep] = cols[live]
        self._lex_wts_np[bucket, :keep] = wts[live]
        self._lex_cols_np[bucket, keep:] = -1
        self._lex_wts_np[bucket, keep:] = 0.0
        self._lex_fill[bucket] = keep

    def _sparse_grow(self) -> None:
        """Double the postings width P (host mirrors only; device sync
        happens in the caller)."""
        h, p = self._lex_cols_np.shape
        cols = np.full((h, p * 2), -1, np.int32)
        wts = np.zeros((h, p * 2), np.float32)
        cols[:, :p] = self._lex_cols_np
        wts[:, :p] = self._lex_wts_np
        self._lex_cols_np, self._lex_wts_np = cols, wts

    def _sparse_add(self, postings: dict[int, list[tuple[int, float]]]) -> None:
        """Append postings to their buckets; compact (scrub dead rows)
        then double P on overflow, and at the P cap prune the lowest-
        weight postings (impact-ordered truncation, the device analogue
        of FTS index pruning)."""
        if not postings:
            return
        p_max = self.cfg.lexical_postings_max
        grew = False
        for b, posts in postings.items():
            need = int(self._lex_fill[b]) + len(posts)
            if need > self._lex_cols_np.shape[1]:
                self._sparse_compact(b)
                need = int(self._lex_fill[b]) + len(posts)
            while need > self._lex_cols_np.shape[1] and \
                    self._lex_cols_np.shape[1] < p_max:
                self._sparse_grow()
                grew = True
            p = self._lex_cols_np.shape[1]
            if need > p:  # at cap: keep the p heaviest postings
                fill = int(self._lex_fill[b])
                cols = np.concatenate([self._lex_cols_np[b, :fill],
                                       np.array([c for c, _ in posts], np.int32)])
                wts = np.concatenate([self._lex_wts_np[b, :fill],
                                      np.array([w for _, w in posts], np.float32)])
                top = np.argsort(-wts, kind="stable")[:p]
                self._lex_cols_np[b] = cols[top]
                self._lex_wts_np[b] = wts[top]
                self._lex_fill[b] = p
            else:
                fill = int(self._lex_fill[b])
                for c, w in posts:
                    self._lex_cols_np[b, fill] = c
                    self._lex_wts_np[b, fill] = w
                    fill += 1
                self._lex_fill[b] = fill
        self._sync_sparse_device(None if grew else sorted(postings))

    def _sync_sparse_device(self, buckets: Sequence[int] | None) -> None:
        """Push host postings mirrors to the device index. `buckets`
        limits the update to touched rows (padded to a power of two so
        the scatter compiles O(log) times); None re-uploads everything
        (P changed shape)."""
        if buckets is None:
            self.index = self.index.replace(
                lex_cols=jnp.asarray(self._lex_cols_np),
                lex_wts=jnp.asarray(self._lex_wts_np, jnp.bfloat16),
            )
            return
        t = len(buckets)
        t_pad = 1
        while t_pad < t:
            t_pad *= 2
        idx = np.full(t_pad, buckets[0], np.int32)
        idx[:t] = buckets
        jidx = jnp.asarray(idx)
        self.index = self.index.replace(
            lex_cols=self.index.lex_cols.at[jidx].set(
                jnp.asarray(self._lex_cols_np[idx])),
            lex_wts=self.index.lex_wts.at[jidx].set(
                jnp.asarray(self._lex_wts_np[idx], jnp.bfloat16)),
        )

    def bulk_load(self, recs: Sequence[ChunkRecord], *, vectors=None, lexical=None) -> list[int]:
        """Mass-ingest fast path: one device_put per field instead of
        block-wise scatter writes. Only valid on an empty store.

        `vectors` [N, D] and/or `lexical` [N, H] may be given directly
        (host numpy or device arrays, already row-aligned with `recs`);
        otherwise they're taken from the records. Vectors are assumed
        L2-normalized when passed as an array."""
        if self.records:
            raise ValueError("bulk_load requires an empty store")
        cfg = self.cfg
        n = len(recs)
        cap = round_up(max(n, cfg.initial_capacity), _WRITE_BLOCK)

        doc_id = np.full(cap, -1, np.int32)
        authority = np.zeros(cap, np.float32)
        length_score = np.zeros(cap, np.float32)
        payer = np.full(cap, -1, np.int32)
        state = np.full(cap, -1, np.int32)
        program = np.full(cap, -1, np.int32)
        valid = np.zeros(cap, np.float32)
        j_tags = np.zeros((cap, cfg.tag_words), np.uint32)
        d_tags = np.zeros((cap, cfg.tag_words), np.uint32)
        p_tags = np.zeros((cap, cfg.tag_words), np.uint32)
        phrase_bits = np.zeros((cap, cfg.phrase_words), np.uint32)

        for i, r in enumerate(recs):
            self.records.append(r)
            self._doc_rows.setdefault(r.doc_id, []).append(i)
            if r.source_id:
                self._source_ids.setdefault(r.doc_id, set()).add(r.source_id)
            valid[i] = 1.0
            doc_id[i] = self.docs.intern(r.doc_id)
            authority[i] = min(max(r.authority_level, 0), _AUTH_MAX) / _AUTH_MAX
            length_score[i] = _length_score(r.text)
            payer[i] = self.payers.intern(r.payer) if r.payer else -1
            state[i] = self.states.intern(r.state) if r.state else -1
            program[i] = self.programs.intern(r.program) if r.program else -1
            # arrays are pre-zeroed: skip pack_bits for empty tag lists
            # (4·N calls are real minutes at 10M records)
            if r.j_tags:
                j_tags[i] = pack_bits(r.j_tags, cfg.tag_words)
            if r.d_tags:
                d_tags[i] = pack_bits(r.d_tags, cfg.tag_words)
            if r.p_tags:
                p_tags[i] = pack_bits(r.p_tags, cfg.tag_words)
            if r.phrase_ids:
                phrase_bits[i] = pack_bits(r.phrase_ids, cfg.phrase_words)

        vec_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                     "int8": jnp.int8}[cfg.vector_dtype]
        if vectors is None:
            vectors = np.zeros((n, cfg.embed_dim), np.float32)
            for i, r in enumerate(recs):
                v = np.asarray(r.embedding, np.float32)
                nv = float(np.linalg.norm(v))
                vectors[i] = v / nv if nv > 0 else v
        scales_arr = jnp.ones((cap,), jnp.float32)
        if self._host_residency:
            # host residency: quantized rows land in host RAM; the device
            # index keeps NO dense payload. `vectors` may be host numpy
            # (f32/int8) or a device array (quantize on device, stream
            # the int8 rows down blockwise — a quarter of the f32 bytes).
            from mobius_rag_tpu.ops.quant import _quantize_block

            hv = np.zeros((cap, cfg.embed_dim), np.int8)
            hs = np.ones((cap,), np.float32)
            if isinstance(vectors, jax.Array):
                blk = 250_000
                for off in range(0, n, blk):
                    hi = min(off + blk, n)
                    q8, qs = _quantize_block(
                        vectors[off:hi].astype(jnp.float32))
                    hv[off:hi] = np.asarray(jax.device_get(q8))
                    hs[off:hi] = np.asarray(jax.device_get(qs))
            elif np.asarray(vectors).dtype == np.int8:
                hv[:n] = np.asarray(vectors)[:n]
            else:
                v32 = np.asarray(vectors[:n], np.float32)
                maxabs = np.abs(v32).max(axis=1)
                hs[:n] = np.where(maxabs > 0, maxabs / 127.0, 1.0)
                hv[:n] = np.clip(np.round(v32 / hs[:n, None]), -127, 127)
            self.host_vectors, self.host_scales = hv, hs
            vec_arr = jnp.zeros((0, cfg.embed_dim), jnp.int8)
            scales_arr = jnp.asarray(hs)
        elif cfg.vector_dtype == "int8":
            from mobius_rag_tpu.ops.quant import quantize_rows

            qv, qs = quantize_rows(jnp.asarray(vectors))
            vec_arr = jnp.zeros((cap, cfg.embed_dim), jnp.int8).at[:n].set(qv[:n])
            scales_arr = scales_arr.at[:n].set(qs[:n])
        elif isinstance(vectors, jax.Array):
            # DEVICE-resident ingest fast path: vectors produced on the
            # device (the encoder's own output) stay there — no
            # device→host→device round-trip.
            # Pad + cast on device; the transient is 2x the array, not
            # the 5x of the zeros+at[].set form.
            vec_arr = jnp.zeros((cap, cfg.embed_dim), vec_dtype)
            vec_arr = jax.lax.dynamic_update_slice(
                vec_arr, vectors[:n].astype(vec_dtype), (0, 0))
        else:
            # Cast + pad on HOST, one device_put: the zeros+at[].set form
            # put ~5x the array size in flight on device (f32 source cast
            # on device + zeros + set output) — at 1M×1536 that transient
            # spike is what kept the full 1M hybrid from fitting alongside
            # its own search program.
            host_vec = np.zeros((cap, cfg.embed_dim), np.dtype(vec_dtype))
            host_vec[:n] = np.asarray(vectors[:n], host_vec.dtype)
            vec_arr = jnp.asarray(host_vec)
            del host_vec
        arrays = dict(
            vectors=vec_arr, vec_scales=scales_arr,
            valid=jnp.asarray(valid), doc_id=jnp.asarray(doc_id),
            authority=jnp.asarray(authority), length_score=jnp.asarray(length_score),
            payer=jnp.asarray(payer), state=jnp.asarray(state),
            program=jnp.asarray(program), j_tags=jnp.asarray(j_tags),
            d_tags=jnp.asarray(d_tags), p_tags=jnp.asarray(p_tags),
            phrase_bits=jnp.asarray(phrase_bits),
        )
        if self._sparse_lexical:
            postings: dict[int, list[tuple[int, float]]] = {}
            if lexical is not None:
                lex_np = np.asarray(lexical, np.float32)  # [N, H] row-major
                rows_nz, buckets_nz = np.nonzero(lex_np)
                for i, b in zip(rows_nz.tolist(), buckets_nz.tolist()):
                    postings.setdefault(int(b) % cfg.lexical_buckets, []) \
                        .append((int(i), float(lex_np[i, b])))
            else:
                for i, r in enumerate(recs):
                    for bucket, w in r.lexical_weights.items():
                        postings.setdefault(bucket % cfg.lexical_buckets, []) \
                            .append((i, float(w)))
            arrays["lex_cols"] = self.index.lex_cols  # placeholder, synced below
            arrays["lex_wts"] = self.index.lex_wts
            self.index = DeviceIndex(**arrays)
            self._sparse_add(postings)
        else:
            if lexical is None:
                # Build only the nonzero prefix host-side (sparse-friendly).
                last = 0
                for i, r in enumerate(recs):
                    if r.lexical_weights:
                        last = i + 1
                lex_np = np.zeros((last, cfg.lexical_buckets), np.float32)
                for i, r in enumerate(recs[:last]):
                    for bucket, w in r.lexical_weights.items():
                        lex_np[i, bucket % cfg.lexical_buckets] += w
                lexical = lex_np
            # external API stays row-major [N, H]; storage is bucket-major [H, C]
            lex_arr = jnp.zeros((cfg.lexical_buckets, cap), jnp.bfloat16)
            if lexical.shape[0] > 0:
                lex_arr = lex_arr.at[:, : lexical.shape[0]].set(
                    jnp.asarray(lexical, jnp.bfloat16).T
                )
            arrays["lexical"] = lex_arr
            self.index = DeviceIndex(**arrays)
        self._lexical_stats_cache = None
        self._notify("bulk", list(range(n)))
        return list(range(n))

    def delete_by_document(self, doc_id: str) -> int:
        """Invalidate all live rows of a document (the reference's
        delete_by_document / republish-DELETE half)."""
        rows = [r for r in self._doc_rows.pop(doc_id, []) if self.records[r] is not None]
        if not rows:
            self._source_ids.pop(doc_id, None)
            return 0
        for r in rows:
            self.records[r] = None
            self._free_rows.append(r)
        self._source_ids.pop(doc_id, None)
        n_pad = round_up(len(rows), _WRITE_BLOCK)
        padded = np.full((n_pad,), -1, np.int32)
        padded[: len(rows)] = rows
        for off in range(0, n_pad, _WRITE_BLOCK):
            self.index = _clear_rows(self.index, jnp.asarray(padded[off:off + _WRITE_BLOCK]))
        self._lexical_stats_cache = None
        self._notify("delete", rows)
        return len(rows)

    def invalidate_rows(self, rows: Sequence[int]) -> int:
        """Force-clear device rows regardless of host-record state — the
        integrity remediation path for device-only ghosts."""
        rows = [r for r in rows if 0 <= r < self.capacity]
        if not rows:
            return 0
        for r in rows:
            if r < len(self.records) and self.records[r] is not None:
                rec = self.records[r]
                self.records[r] = None
                self._free_rows.append(r)
                if rec.doc_id in self._doc_rows and r in self._doc_rows[rec.doc_id]:
                    self._doc_rows[rec.doc_id].remove(r)
        n_pad = round_up(len(rows), _WRITE_BLOCK)
        padded = np.full((n_pad,), -1, np.int32)
        padded[: len(rows)] = rows
        for off in range(0, n_pad, _WRITE_BLOCK):
            self.index = _clear_rows(self.index, jnp.asarray(padded[off:off + _WRITE_BLOCK]))
        self._lexical_stats_cache = None
        self._notify("delete", rows)
        return len(rows)

    def publish_document(self, doc_id: str, recs: Sequence[ChunkRecord]) -> list[int]:
        """Idempotent republish: DELETE+INSERT with integrity verification
        (publish.py:27-481 contract — the reference verifies row counts and
        tag-join coverage after every publish; here the device row count
        for the doc must equal the record count or the publish raises)."""
        self.delete_by_document(doc_id)
        rows = self.add_chunks(recs)
        live = [r for r in self._doc_rows.get(doc_id, [])
                if self.records[r] is not None]
        if len(live) != len(recs):
            raise RuntimeError(
                f"publish integrity: {doc_id!r} expected {len(recs)} live rows, "
                f"found {len(live)}")
        return rows

    @property
    def free_row_count(self) -> int:
        """Reusable (deleted) device rows — the vacuum report's free-slot
        figure; add_chunks recycles these before growing the index."""
        return len(self._free_rows)

    def rows_for_document(self, doc_id: str) -> list[int]:
        """Live device rows of a document (browse/facts surfaces)."""
        return [r for r in self._doc_rows.get(doc_id, [])
                if self.records[r] is not None]

    def embedded_source_ids(self, doc_id: str) -> set[str]:
        """Which embeddable-unit source_ids are already live for this doc —
        the incremental-resume diff contract (embedding_worker.py:187-203)."""
        return set(self._source_ids.get(doc_id, set()))

    def lexical_stats(self) -> tuple[dict[int, int], int]:
        """(bucket → live-chunk document frequency, live chunk count) for
        query-side IDF. Cached; invalidated by add/delete."""
        if self._lexical_stats_cache is None:
            df: dict[int, int] = {}
            n = 0
            for r in self.records:
                if r is None:
                    continue
                n += 1
                for b in r.lexical_weights:
                    key = b % self.cfg.lexical_buckets
                    df[key] = df.get(key, 0) + 1
            self._lexical_stats_cache = (df, n)
        return self._lexical_stats_cache

    # -- reads -------------------------------------------------------------

    def record(self, row: int) -> ChunkRecord | None:
        if 0 <= row < len(self.records):
            return self.records[row]
        return None

    def doc_name(self, doc_int: int) -> str:
        return self.docs.lookup(doc_int)

    # -- snapshot / resume ---------------------------------------------------

    def snapshot(self, path: str) -> None:
        """Durable checkpoint: device arrays + host record map. The device
        analogue of the reference's per-batch-commit durability
        (embedding_worker.py:215-266)."""
        os.makedirs(path, exist_ok=True)
        host = jax.device_get(self.index)
        arrays = {f: np.asarray(getattr(host, f)) for f in self.index.fields}
        # bf16 has no numpy dtype — store as uint16 bit pattern.
        meta_dtypes = {}
        for f, a in arrays.items():
            if a.dtype == jnp.bfloat16:
                arrays[f] = a.view(np.uint16)
                meta_dtypes[f] = "bfloat16"
        np.savez_compressed(os.path.join(path, "index.npz"), **arrays)
        if self.host_vectors is not None:
            # config-5 host residency: the int8 re-rank matrix lives in
            # host RAM, not in index.npz — persist it uncompressed
            # (np.save streams; 15 GB at 10M would choke zip compression)
            np.save(os.path.join(path, "host_vectors.npy"), self.host_vectors)
            np.save(os.path.join(path, "host_scales.npy"), self.host_scales)
        recs = []
        for r in self.records:
            if r is None:
                recs.append(None)
            else:
                d = dataclasses.asdict(r)
                d["embedding"] = None  # lives in index.npz
                d["lexical_weights"] = {str(k): v for k, v in d["lexical_weights"].items()}
                recs.append(d)
        state = {
            "version": 1,
            "records": recs,
            "free_rows": self._free_rows,
            "doc_rows": self._doc_rows,
            "source_ids": {k: sorted(v) for k, v in self._source_ids.items()},
            "interners": {
                "docs": self.docs.state_dict(),
                "payers": self.payers.state_dict(),
                "states": self.states.state_dict(),
                "programs": self.programs.state_dict(),
            },
            "bf16_fields": meta_dtypes,
            "config": {
                "embed_dim": self.cfg.embed_dim,
                "tag_words": self.cfg.tag_words,
                "phrase_words": self.cfg.phrase_words,
                "lexical_buckets": self.cfg.lexical_buckets,
                "lexical_format": self.cfg.lexical_format,
                "vector_residency": self.cfg.vector_residency,
            },
        }
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump(state, f)

    # Snapshot format versions this build can read. Older versions get an
    # in-place upgrade ladder at restore (the reference's 64 idempotent
    # migrations collapse to this because snapshots are self-contained —
    # there is no shared live schema to migrate, only files to upgrade).
    SNAPSHOT_VERSION = 1
    # version → fn(state) -> state; v0 = pre-versioned snapshots whose
    # layout is identical to v1 (the field was merely absent)
    _SNAPSHOT_UPGRADES: dict[int, Any] = {
        0: staticmethod(lambda state: {**state, "version": 1}),
    }

    @classmethod
    def restore(cls, path: str, cfg: Config | None = None) -> "ChunkStore":
        with open(os.path.join(path, "store.json")) as f:
            state = json.load(f)
        version = int(state.get("version", 0))
        if version > cls.SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {version} is newer than this build "
                f"supports ({cls.SNAPSHOT_VERSION}) — upgrade the framework")
        while version < cls.SNAPSHOT_VERSION:
            upgrade = cls._SNAPSHOT_UPGRADES.get(version)
            if upgrade is None:
                raise ValueError(f"no upgrade path from snapshot version "
                                 f"{version}")
            state = upgrade(state)
            version = int(state["version"])
        cfg = cfg or get_config()
        for key, val in state["config"].items():
            if key == "lexical_format" and getattr(cfg, key, "dense") != val:
                raise ValueError(
                    f"snapshot lexical_format={val!r} != config "
                    f"{getattr(cfg, key, 'dense')!r} (set MRAG_LEXICAL_FORMAT)"
                )
            if key == "vector_residency":
                if getattr(cfg, key, "device") != val:
                    raise ValueError(
                        f"snapshot vector_residency={val!r} != config "
                        f"{getattr(cfg, key, 'device')!r} (set "
                        f"MRAG_VECTOR_RESIDENCY)")
                continue
            if key != "lexical_format" and getattr(cfg, key) != val:
                raise ValueError(
                    f"snapshot {key}={val} != config {getattr(cfg, key)}"
                )
        data = np.load(os.path.join(path, "index.npz"))
        arrays = {}
        for f in DeviceIndex._CANON:
            if f not in data.files:
                continue
            a = data[f]
            if state["bf16_fields"].get(f) == "bfloat16":
                a = a.view(jnp.bfloat16)
            arrays[f] = jnp.asarray(a)
        # capacity from the always-full-length valid mask — under host
        # residency the vectors array is deliberately 0-row
        store = cls(cfg, capacity=arrays["valid"].shape[0])
        store.index = DeviceIndex(**arrays)
        if store._host_residency:
            hv_path = os.path.join(path, "host_vectors.npy")
            if not os.path.exists(hv_path):
                raise ValueError(
                    "host-residency snapshot is missing host_vectors.npy "
                    "(written by snapshots of this build; pre-fix "
                    "host-residency snapshots are unrecoverable)")
            store.host_vectors = np.load(hv_path)
            store.host_scales = np.load(os.path.join(path, "host_scales.npy"))
        if store._sparse_lexical:
            # rebuild host postings mirrors from the restored device arrays
            store._lex_cols_np = np.asarray(arrays["lex_cols"])
            store._lex_wts_np = np.asarray(arrays["lex_wts"],
                                           dtype=np.float32)
            store._lex_fill = (store._lex_cols_np >= 0).sum(axis=1)
        # Rehydrate record embeddings from the restored device vectors:
        # publish-from-records paths (retag, nightly retag, integrity
        # remediation) treat record embeddings as authoritative, so a
        # restored store with zeroed embeddings would silently overwrite
        # live vectors with zeros on the next republish — or be dropped
        # wholesale by integrity_remediate's zero-norm check.
        if store._host_residency:
            # record embeddings rehydrate from the HOST matrix — the
            # device vectors array is empty in this regime
            vecs_host = store.host_vectors
            scales_host = store.host_scales
            int8_vecs = True
        else:
            vecs_host = data["vectors"]
            if state["bf16_fields"].get("vectors") == "bfloat16":
                vecs_host = vecs_host.view(jnp.bfloat16)
            int8_vecs = vecs_host.dtype == np.int8
            scales_host = data["vec_scales"] if int8_vecs else None
        store.records = []
        for i, d in enumerate(state["records"]):
            if d is None:
                store.records.append(None)
            else:
                if int8_vecs:
                    emb = vecs_host[i].astype(np.float32) * float(scales_host[i])
                else:
                    emb = vecs_host[i]  # row view; normalized at snapshot time
                d["embedding"] = emb
                d["lexical_weights"] = {int(k): v for k, v in d["lexical_weights"].items()}
                store.records.append(ChunkRecord(**d))
        store._free_rows = list(state["free_rows"])
        store._doc_rows = {k: list(v) for k, v in state["doc_rows"].items()}
        store._source_ids = {k: set(v) for k, v in state["source_ids"].items()}
        store.docs.load_state(state["interners"]["docs"])
        store.payers.load_state(state["interners"]["payers"])
        store.states.load_state(state["interners"]["states"])
        store.programs.load_state(state["interners"]["programs"])
        return store
