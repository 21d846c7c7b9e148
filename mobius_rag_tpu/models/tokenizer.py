"""Hash tokenizer: text → fixed-length id sequences with no external
vocabulary file. Words are normalized by the same stemmer the lexical arm
uses, then hashed into a fixed id space (ids 2..V-1; 0=pad, 1=CLS).

Rationale: the reference delegates tokenization to external embedding
APIs (app/services/embedding_provider.py); a self-contained tokenizer
keeps the on-device encoder dependency-free and deterministic. Swap in a
learned subword vocab by implementing the same (encode_batch) interface.
"""
from __future__ import annotations

import numpy as np

from mobius_rag_tpu.query.text import tokenize

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2  # used by the cross-encoder's [CLS] q [SEP] d packing
_RESERVED = 3


class HashTokenizer:
    def __init__(self, vocab_size: int, max_len: int):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def encode(self, text: str) -> np.ndarray:
        import zlib

        ids = [CLS_ID]
        for tok in tokenize(text):
            h = _RESERVED + zlib.crc32(tok.encode()) % (self.vocab_size - _RESERVED)
            ids.append(h)
            if len(ids) >= self.max_len:
                break
        out = np.full(self.max_len, PAD_ID, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])
