"""Tokenization, light stemming, and term hashing.

The reference leans on Postgres ``to_tsvector('english', ...)`` for
stemming/stopwords (migration rebuild_rag_published_fts_multifield.py).
Here the same role is played by a self-contained tokenizer + suffix
stemmer + feature hash. Exact Postgres-snowball parity is NOT required —
what matters is that ingest and query use the *same* normalization, and
that retrieval overlap with an exact host-side BM25 stays high (tested in
tests/test_lexical.py).

Stopword/noise lists mirror the reference's semantics:
- question lead-phrase stripping + noise quantifiers
  (corpus_search.py:_normalize_bm25_query, _BM25_NOISE)
- FTS stopwords excluded from selective filtering but harmless in
  scoring (corpus_search.py:_FTS_STOP)
"""
from __future__ import annotations

import functools
import re
import zlib

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# Question lead phrases stripped before lexical scoring
# (reference behavior: corpus_search.py:_QUESTION_LEAD/_normalize_bm25_query).
_QUESTION_LEAD = re.compile(
    r"^\s*(?:(?:how\s+(?:many|much|long|do|does|can|should)|what(?:'s|\s+is|\s+are)?|"
    r"when\s+(?:is|are|do|does|can|should)|where\s+(?:is|are|do|can)|"
    r"who\s+(?:is|are|do|can)|why\s+(?:is|are|do|does)|"
    r"do(?:es)?|can|could|should|would|is|are|tell\s+me(?:\s+about)?|"
    r"i\s+(?:need|want)\s+to\s+know)\b\s*)+",
    re.IGNORECASE,
)

NOISE_WORDS = frozenset({
    "many", "much", "often", "several", "various", "certain",
    "few", "some", "any", "every", "all", "most", "more",
})

STOPWORDS = frozenset({
    "a", "an", "the", "and", "or", "but", "not", "is", "are", "was", "were",
    "be", "been", "being", "do", "does", "did", "have", "has", "had",
    "i", "me", "my", "we", "our", "you", "your", "he", "she", "it", "they",
    "to", "of", "in", "for", "on", "with", "at", "by", "from", "up",
    "about", "into", "through", "during", "until", "against", "among",
    "when", "where", "who", "which", "what", "that", "this", "these", "those",
    "can", "will", "just", "should", "would", "could", "use", "used", "using",
    "may", "how", "why", "if", "than", "so", "as", "such", "also",
})


@functools.lru_cache(maxsize=65536)
def stem(word: str) -> str:
    """Porter-lite suffix stripper. Deliberately conservative: collapses
    plural/verbal/adverbial suffixes so query and document inflections
    meet, without the full snowball rule table. Cached: natural-language
    vocabulary is small and Zipf-distributed, so the suffix-rule cascade
    runs once per distinct word instead of once per occurrence."""
    w = word
    if len(w) > 4 and w.endswith("ies"):
        w = w[:-3] + "y"
    elif len(w) > 4 and w.endswith("sses"):
        w = w[:-2]
    elif len(w) > 3 and w.endswith("s") and not w.endswith(("ss", "us", "is")):
        w = w[:-1]
    for suf, repl in (("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
                      ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
                      ("biliti", "ble"), ("icate", "ic"), ("ative", ""),
                      ("alize", "al"), ("ment", ""), ("ness", "")):
        if len(w) > len(suf) + 3 and w.endswith(suf):
            w = w[: -len(suf)] + repl
            break
    if len(w) > 5 and w.endswith("ing"):
        base = w[:-3]
        if len(base) >= 3:
            w = base[:-1] if len(base) > 3 and base[-1] == base[-2] else base
    elif len(w) > 4 and w.endswith("ed"):
        base = w[:-2]
        if len(base) >= 3:
            w = base[:-1] if len(base) > 3 and base[-1] == base[-2] else base
    if len(w) > 4 and w.endswith("ly"):
        w = w[:-2]
    return w


def tokenize(text: str, *, stemmed: bool = True, drop_stopwords: bool = False) -> list[str]:
    toks = _TOKEN_RE.findall(text.lower())
    if drop_stopwords:
        toks = [t for t in toks if t not in STOPWORDS]
    if stemmed:
        toks = [stem(t) for t in toks]
    return toks


@functools.lru_cache(maxsize=32768)
def tokenize_terms(text: str, *, drop_stopwords: bool = False) -> tuple[str, ...]:
    """Cached stemmed-token tuple for a (short) text. Serving-hot-path
    variant of :func:`tokenize` for strings that repeat across queries —
    lexicon expansion phrases above all (a 12-entry expansion re-tokenizes
    the same static phrase bag on every request)."""
    return tuple(tokenize(text, drop_stopwords=drop_stopwords))


def normalize_query(query: str) -> str:
    """Strip question lead phrases and noise quantifiers; never returns
    empty (falls back to the original) — reference semantics
    (corpus_search.py:_normalize_bm25_query)."""
    q = _QUESTION_LEAD.sub(" ", query)
    words = [w for w in q.split() if w.lower() not in NOISE_WORDS]
    normalized = " ".join(words).strip()
    return normalized or query


def hash_bucket(term: str, num_buckets: int) -> int:
    """Stable term → bucket hash (crc32; process-independent, so snapshots
    stay valid across runs — unlike Python's salted hash())."""
    return zlib.crc32(term.encode("utf-8")) % num_buckets
