"""Ngram index: bloom filters over character n-grams for LIKE pruning.

Reference analog: the ngram variant of the bloom index (NgramArgs,
src/query/storages/common/index/src/bloom_index.rs:649) consulted for
LIKE '%...%' predicates during block pruning. A block can be skipped when
any n-gram of a literal pattern segment is absent from the block's gram
filter.
"""

from __future__ import annotations

import re
import zlib
from typing import List, Optional, Set

import numpy as np

from .bloom import BloomFilter

DEFAULT_GRAM = 3


def ngrams(text: str, n: int = DEFAULT_GRAM) -> Set[str]:
    t = text.lower()
    if len(t) < n:
        return set()
    return {t[i:i + n] for i in range(len(t) - n + 1)}


def _gram_hashes(grams) -> np.ndarray:
    return np.array([zlib.crc32(g.encode("utf-8")) for g in sorted(grams)],
                    dtype=np.uint64)


def build_ngram_filter(col, n: int = DEFAULT_GRAM) -> Optional[BloomFilter]:
    """Build the per-block gram filter for a string column."""
    from ..expression import StringData
    if not isinstance(col.data, StringData):
        return None
    grams: Set[str] = set()
    validity = col.validity
    for i, v in enumerate(col.data.to_pylist()):
        if v is None or (validity is not None and not validity[i]):
            continue
        grams |= ngrams(v, n)
    if not grams:
        return None
    return BloomFilter.build(_gram_hashes(grams))


def pattern_grams(pattern: str, n: int = DEFAULT_GRAM) -> Set[str]:
    """Grams of the literal segments of a LIKE pattern ('%'/'_' split,
    backslash escapes honored)."""
    segments: List[str] = []
    cur: List[str] = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            cur.append(pattern[i + 1])
            i += 2
            continue
        if c in ("%", "_"):
            if cur:
                segments.append("".join(cur))
                cur = []
        else:
            cur.append(c)
        i += 1
    if cur:
        segments.append("".join(cur))
    out: Set[str] = set()
    for s in segments:
        out |= ngrams(s, n)
    return out


def filter_may_match(flt: BloomFilter, pattern: str, n: int = DEFAULT_GRAM) -> bool:
    """False => the block can NOT contain a row matching the pattern."""
    grams = pattern_grams(pattern, n)
    if not grams:
        return True  # nothing selective in the pattern
    for h in _gram_hashes(grams):
        if not flt.contains_hash(int(h)):
            return False
    return True
