"""Tokenizers for the inverted index.

Mirrors the reference's tokenizer stack (reference:
src/query/storages/fuse/src/io/write/inverted_index_writer.rs:347-456:
``english`` = Simple + LowerCaser [+ english_stop + english_stemmer],
``chinese`` = Jieba + LowerCaser [+ chinese_stop]). Jieba isn't available
here; CJK text falls back to per-codepoint tokens (a standard unigram
fallback).
"""

from __future__ import annotations

import re
from typing import List

_WORD_RE = re.compile(r"[A-Za-z0-9_]+")
_CJK_RE = re.compile(r"[一-鿿぀-ヿ가-힯]")

# the classic Lucene/tantivy english stop set
ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split())

_stemmer = None


def _get_stemmer():
    global _stemmer
    if _stemmer is None:
        from nltk.stem import PorterStemmer
        _stemmer = PorterStemmer()
    return _stemmer


def tokenize_text(text: str, tokenizer: str = "english",
                  filters: List[str] = ()) -> List[str]:
    """Lowercased token stream. ``filters``: subset of
    {english_stop, english_stemmer, chinese_stop}."""
    if text is None:
        return []
    tokens: List[str] = []
    lowered = text.lower()
    # latin words
    for m in _WORD_RE.finditer(lowered):
        tokens.append((m.start(), m.group()))
    # CJK codepoints (jieba fallback)
    for m in _CJK_RE.finditer(lowered):
        tokens.append((m.start(), m.group()))
    tokens.sort(key=lambda t: t[0])
    out = [t for _, t in tokens]
    if "english_stop" in filters or "chinese_stop" in filters:
        out = [t for t in out if t not in ENGLISH_STOPWORDS]
    if "english_stemmer" in filters:
        stem = _get_stemmer().stem
        out = [stem(t) for t in out]
    return out


def tokenize_docs(texts, tokenizer: str = "english",
                  filters: List[str] = ()) -> List[List[str]]:
    """Batch tokenization for the ingest path.

    Uses the native C++ analyzer (native/tokenize.cpp — the analog of
    tantivy's native analyzer stack) when built; stemming runs in Python
    over a per-batch cache so index-side stems match query-side stems
    (both NLTK) exactly. Falls back to the per-doc Python tokenizer.
    """
    from ... import native
    stop = ENGLISH_STOPWORDS if ("english_stop" in filters
                                 or "chinese_stop" in filters) else None
    out = native.tokenize_batch(texts, stop)
    if out is None:
        return [tokenize_text(t, tokenizer, filters) for t in texts]
    if "english_stemmer" in filters:
        stem = _get_stemmer().stem
        cache: dict = {}
        out = [[cache[t] if t in cache else cache.setdefault(t, stem(t))
                for t in toks] for toks in out]
    return out


def parse_filters(options: dict) -> List[str]:
    raw = options.get("filters", "")
    return [f.strip() for f in raw.split(",") if f.strip()]
