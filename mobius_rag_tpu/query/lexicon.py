"""Curated tag lexicon + query expansion.

Semantics mirror the reference's lexicon expansion
(app/services/corpus_search_lexicon.py): a curated set of tagged entries
(kind j = jurisdiction/payor, d = domain, p = process), each carrying
strong phrases + aliases; a query is matched against every entry's
phrases (word-boundary substring, case-insensitive); matched entries
contribute their full phrase bag as expansion, capped at
``max_entries_per_query`` (12), with generic single words suppressed via
a stoplist.

Differences: the lexicon is the *compile-time registry* for
the device index — it assigns every entry a stable tag id (bit position
in the j/d/p bitsets) and every distinct phrase a stable phrase id (bit
position in ``phrase_bits``), so ingest tagging and the on-device
coverage/rerank signals share one id space. The lexicon is file-backed
(YAML/JSON) instead of a Postgres table.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable

import yaml

# Generic single words that add no retrieval signal alone
# (corpus_search_lexicon.py:_SINGLE_WORD_STOPLIST).
SINGLE_WORD_STOPLIST = frozenset({
    "provider", "providers", "policy", "policies",
    "rule", "rules", "requirement", "requirements",
    "information", "info", "details", "general", "specific",
    "covered", "coverage", "applies", "apply",
    "process", "guideline", "guidelines",
    "service", "services", "plan", "plans",
    "member", "members", "patient", "patients",
    "client", "clients", "notice", "section",
    "program", "programs", "benefit", "benefits",
    "criteria", "procedure", "procedures",
    "standard", "standards", "update", "updates",
})

_KINDS = ("j", "d", "p")


def _norm(p: Any) -> str:
    return p.strip().lower() if isinstance(p, str) else ""


@dataclasses.dataclass
class LexiconEntry:
    kind: str  # "j" | "d" | "p"
    code: str  # e.g. "benefits.dme" (kind-local)
    phrases: list[str]  # normalized, deduped: strong_phrases ∪ aliases ∪ leaf
    tag_id: int = -1  # bit position within the kind's bitset
    selectivity: float = 0.8  # IDF-style discrimination weight

    @property
    def full_code(self) -> str:
        return f"{self.kind}:{self.code}"


@dataclasses.dataclass
class LexiconExpansion:
    """Result of expanding one query (field names follow the reference)."""

    matched_codes: list[str] = dataclasses.field(default_factory=list)
    expansion_phrases: list[str] = dataclasses.field(default_factory=list)
    domain_tags: list[str] = dataclasses.field(default_factory=list)
    jurisdiction_tags: list[str] = dataclasses.field(default_factory=list)
    process_tags: list[str] = dataclasses.field(default_factory=list)
    log: list[str] = dataclasses.field(default_factory=list)
    # Additions: device-id views of the match.
    tag_ids: dict[str, list[int]] = dataclasses.field(
        default_factory=lambda: {"j": [], "d": [], "p": []}
    )
    # (phrase_id, selectivity weight, j-tag id or -1) per required phrase —
    # feeds the on-device coverage signal.
    phrase_slots: list[tuple[int, float, int]] = dataclasses.field(default_factory=list)


class Lexicon:
    def __init__(self, entries: Iterable[LexiconEntry], *, max_entries_per_query: int = 12):
        self.entries: list[LexiconEntry] = []
        self.max_entries_per_query = max_entries_per_query
        self.phrase_ids: dict[str, int] = {}
        self._by_kind_count = {k: 0 for k in _KINDS}
        self._phrase_index: list[tuple[re.Pattern, LexiconEntry, str]] = []
        # Serving-hot-path expansion LRU (same role as the reference's
        # 5-min in-process lexicon cache, corpus_search_lexicon.py:362):
        # the lexicon is static at serving time, so expansion is a pure
        # function of the query string. Invalidated on any entry or
        # selectivity change. Expansions are returned SHARED — they are
        # read-only by contract (no caller mutates a LexiconExpansion).
        self._expand_cache: "dict[str, LexiconExpansion]" = {}
        self._expand_cache_max = 4096
        for e in entries:
            self.add_entry(e)

    # -- construction -----------------------------------------------------

    def add_entry(self, e: LexiconEntry) -> LexiconEntry:
        if e.kind not in _KINDS:
            raise ValueError(f"bad lexicon kind {e.kind!r}")
        leaf = e.code.split(".")[-1].replace("_", " ")
        bag: list[str] = []
        for p in list(e.phrases) + [leaf]:
            np_ = _norm(p)
            if np_ and np_ not in bag:
                bag.append(np_)
        e = dataclasses.replace(e, phrases=bag)
        self._expand_cache.clear()
        if e.tag_id < 0:
            e.tag_id = self._by_kind_count[e.kind]
        self._by_kind_count[e.kind] = max(self._by_kind_count[e.kind], e.tag_id + 1)
        self.entries.append(e)
        for p in e.phrases:
            if p not in self.phrase_ids:
                self.phrase_ids[p] = len(self.phrase_ids)
            # Word-boundary substring match, like matching a phrase inside
            # the query text.
            pat = re.compile(r"(?<![a-z0-9])" + re.escape(p) + r"(?![a-z0-9])")
            self._phrase_index.append((pat, e, p))
        return e

    @classmethod
    def from_yaml(cls, path: str, **kw) -> "Lexicon":
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        entries = []
        for item in raw.get("entries", []):
            entries.append(
                LexiconEntry(
                    kind=item["kind"],
                    code=item["code"],
                    phrases=[*(item.get("strong_phrases") or []), *(item.get("aliases") or [])],
                    selectivity=float(item.get("selectivity", 0.8)),
                )
            )
        return cls(entries, **kw)

    # -- bulk matching (native Aho-Corasick) ---------------------------------

    def phrase_table(self) -> tuple[list[str], dict[int, list[tuple[str, int]]]]:
        """(phrases ordered by phrase_id, phrase_id → [(kind, tag_id)]).
        Cached; invalidated when entries are added."""
        cached = getattr(self, "_phrase_table", None)
        if cached is not None and cached[0] == len(self.phrase_ids):
            return cached[1], cached[2]
        ordered = [""] * len(self.phrase_ids)
        for p, pid in self.phrase_ids.items():
            ordered[pid] = p
        owners: dict[int, list[tuple[str, int]]] = {}
        for e in self.entries:
            for p in e.phrases:
                owners.setdefault(self.phrase_ids[p], []).append((e.kind, e.tag_id))
        self._phrase_table = (len(self.phrase_ids), ordered, owners)
        return ordered, owners

    @property
    def matcher(self):
        """Cached native Aho-Corasick over all phrases (pattern id ==
        phrase id) — the bulk-ingest fast path for Path-B tagging."""
        cached = getattr(self, "_matcher", None)
        if cached is None or cached[0] != len(self.phrase_ids):
            from mobius_rag_tpu.ingest.aho import AhoCorasick

            ordered, _ = self.phrase_table()
            cached = (len(self.phrase_ids), AhoCorasick(ordered))
            self._matcher = cached
        return cached[1]

    # -- lookups ------------------------------------------------------------

    def phrase_id(self, phrase: str) -> int:
        return self.phrase_ids.get(_norm(phrase), -1)

    def entry_by_code(self, full_code: str) -> LexiconEntry | None:
        for e in self.entries:
            if e.full_code == full_code:
                return e
        return None

    @property
    def num_phrases(self) -> int:
        return len(self.phrase_ids)

    def tag_count(self, kind: str) -> int:
        return self._by_kind_count[kind]

    # -- corpus-derived selectivity ------------------------------------------

    def set_tag_doc_counts(self, counts: dict[str, int], n_docs: int) -> None:
        """Derive IDF-style selectivity from corpus doc counts per tag —
        rarer tags discriminate harder (the agent's selectivity partition,
        corpus_search_agent.py:1131-1221). counts keys are full codes."""
        import math

        if n_docs <= 0:
            return
        self._expand_cache.clear()
        for e in self.entries:
            df = counts.get(e.full_code, 0)
            if df > 0:
                e.selectivity = max(
                    0.1, min(1.0, 1.0 - math.log1p(df) / math.log1p(n_docs + 1))
                )

    # -- expansion --------------------------------------------------------

    def expand(self, query: str) -> LexiconExpansion:
        """Match query text against entry phrases (native Aho-Corasick —
        this runs per query on the serving hot path); aggregate
        expansion. Entry order and the 12-entry cap follow the
        reference's iterate-in-curation-order semantics."""
        cached = self._expand_cache.get(query)
        if cached is not None:
            return cached
        out = LexiconExpansion()
        hit_ids = self.matcher.match_set(query)
        ordered, _ = self.phrase_table()
        # Reject generic single words per the stoplist; multi-word
        # phrases containing them still match.
        hit_phrases = {
            ordered[pid] for pid in hit_ids
            if " " in ordered[pid] or ordered[pid] not in SINGLE_WORD_STOPLIST
        }
        matched: list[tuple[LexiconEntry, str]] = []
        for entry in self.entries:
            first = next((p for p in entry.phrases if p in hit_phrases), None)
            if first is not None:
                matched.append((entry, first))
                if len(matched) >= self.max_entries_per_query:
                    break

        phrase_bag: list[str] = []
        for entry, hit in matched:
            out.matched_codes.append(entry.full_code)
            out.log.append(f"matched {hit!r} → {entry.full_code}")
            kind_list = {
                "d": out.domain_tags,
                "j": out.jurisdiction_tags,
                "p": out.process_tags,
            }[entry.kind]
            kind_list.append(entry.full_code)
            out.tag_ids[entry.kind].append(entry.tag_id)
            jtag = entry.tag_id if entry.kind == "j" else -1
            for p in entry.phrases:
                if p not in phrase_bag:
                    phrase_bag.append(p)
                    out.phrase_slots.append((self.phrase_ids[p], entry.selectivity, jtag))
        out.expansion_phrases = phrase_bag
        if len(self._expand_cache) >= self._expand_cache_max:
            self._expand_cache.pop(next(iter(self._expand_cache)))
        self._expand_cache[query] = out
        return out
