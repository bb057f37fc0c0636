"""ctypes loader for the native (C++) runtime pieces.

The shared library is built from native/ with `make` (g++); if it is
missing we build it on first use, and if no toolchain is available every
caller falls back to the pure-Python path — the native layer is an
accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdbtpu_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR],
                               capture_output=True, check=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.dbtpu_csv_count.restype = ctypes.c_int
        lib.dbtpu_csv_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_char,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.dbtpu_csv_scan.restype = ctypes.c_int
        lib.dbtpu_csv_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_char,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        try:
            lib.dbtpu_stopset_new.restype = ctypes.c_void_p
            lib.dbtpu_stopset_new.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.dbtpu_stopset_free.argtypes = [ctypes.c_void_p]
            lib.dbtpu_tokenize_count.restype = ctypes.c_int
            lib.dbtpu_tokenize_count.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.dbtpu_tokenize_fill.restype = ctypes.c_int
            lib.dbtpu_tokenize_fill.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.dbtpu_analyze.restype = ctypes.c_void_p
            lib.dbtpu_analyze.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_void_p]
            for g in ("n_tokens", "n_terms", "term_bytes"):
                fn = getattr(lib, f"dbtpu_analysis_{g}")
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p]
            lib.dbtpu_analysis_fill.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.dbtpu_analysis_free.argtypes = [ctypes.c_void_p]
            lib.dbtpu_factorize_strings.restype = ctypes.c_int64
            lib.dbtpu_factorize_strings.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
            lib.dbtpu_string_index_new.restype = ctypes.c_void_p
            lib.dbtpu_string_index_new.argtypes = [
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
            lib.dbtpu_string_index_size.restype = ctypes.c_int64
            lib.dbtpu_string_index_size.argtypes = [ctypes.c_void_p]
            lib.dbtpu_string_index_lookup.restype = None
            lib.dbtpu_string_index_lookup.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
            lib.dbtpu_string_index_free.restype = None
            lib.dbtpu_string_index_free.argtypes = [ctypes.c_void_p]
            lib.dbtpu_copy_slices.restype = None
            lib.dbtpu_copy_slices.argtypes = [
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
            lib.dbtpu_take_strings.restype = None
            lib.dbtpu_take_strings.argtypes = [
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        except AttributeError:
            pass  # stale .so without the tokenizer: csv path still works
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def tokenize_batch(texts, stopwords=None):
    """Native batch tokenization (lowercase + word/CJK split + stop
    filter). Returns list-of-token-lists, or None when unavailable.

    The per-document Python loop (regex findall per row) is the ingest
    hot loop this replaces — the analog of tantivy's native analyzer.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dbtpu_tokenize_count"):
        return None
    encoded = [(t or "").encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    data = b"".join(encoded)
    stop_handle = None
    try:
        if stopwords:
            blob = "\n".join(sorted(stopwords)).encode("utf-8")
            stop_handle = lib.dbtpu_stopset_new(blob, len(blob))
        n_tok = ctypes.c_int64(0)
        n_bytes = ctypes.c_int64(0)
        rc = lib.dbtpu_tokenize_count(data, offsets, len(encoded),
                                      stop_handle, ctypes.byref(n_tok),
                                      ctypes.byref(n_bytes))
        if rc != 0:
            return None
        out_bytes = ctypes.create_string_buffer(max(n_bytes.value, 1))
        lens = np.empty(max(n_tok.value, 1), np.int32)
        docs = np.empty(max(n_tok.value, 1), np.int32)
        rc = lib.dbtpu_tokenize_fill(data, offsets, len(encoded),
                                     stop_handle, out_bytes, lens, docs)
        if rc != 0:
            return None
    finally:
        if stop_handle:
            lib.dbtpu_stopset_free(stop_handle)
    out = [[] for _ in encoded]
    raw = out_bytes.raw
    pos = 0
    for i in range(n_tok.value):
        ln = int(lens[i])
        out[int(docs[i])].append(raw[pos:pos + ln].decode("utf-8"))
        pos += ln
    return out


def analyze_batch(texts, stopwords=None):
    """One-pass native analysis with in-C++ vocab dedup.

    Returns (terms: List[str] in first-seen order, tok_term: int32 array,
    tok_doc: int32 array) or None when unavailable. Python only decodes
    the unique-term dictionary; postings become numpy over the id arrays.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dbtpu_analyze"):
        return None
    encoded = [(t or "").encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    data = b"".join(encoded)
    stop_handle = None
    handle = None
    try:
        if stopwords:
            blob = "\n".join(sorted(stopwords)).encode("utf-8")
            stop_handle = lib.dbtpu_stopset_new(blob, len(blob))
        handle = lib.dbtpu_analyze(data, offsets, len(encoded), stop_handle)
        n_tok = lib.dbtpu_analysis_n_tokens(handle)
        n_terms = lib.dbtpu_analysis_n_terms(handle)
        n_bytes = lib.dbtpu_analysis_term_bytes(handle)
        blob_out = ctypes.create_string_buffer(max(int(n_bytes), 1))
        term_lens = np.empty(max(int(n_terms), 1), np.int32)
        tok_term = np.empty(max(int(n_tok), 1), np.int32)
        tok_doc = np.empty(max(int(n_tok), 1), np.int32)
        lib.dbtpu_analysis_fill(handle, blob_out, term_lens, tok_term, tok_doc)
    finally:
        if handle:
            lib.dbtpu_analysis_free(handle)
        if stop_handle:
            lib.dbtpu_stopset_free(stop_handle)
    raw = blob_out.raw
    terms = []
    pos = 0
    for i in range(int(n_terms)):
        ln = int(term_lens[i])
        terms.append(raw[pos:pos + ln].decode("utf-8"))
        pos += ln
    return terms, tok_term[:int(n_tok)], tok_doc[:int(n_tok)]


def factorize_strings(offsets: np.ndarray, data: np.ndarray):
    """Dense int64 codes for a StringData column without decoding.

    Returns codes (int64 [n]) or None when the native library is absent.
    The group-by/distinct/join key path (the reference's short-string
    hashtable specialization).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dbtpu_factorize_strings"):
        return None
    n = len(offsets) - 1
    codes = np.empty(max(n, 1), np.int64)
    buf = np.ascontiguousarray(data).tobytes()
    offs = np.ascontiguousarray(offsets, np.int64)
    lib.dbtpu_factorize_strings(buf, offs, n, codes)
    return codes[:n]


class StringIndex:
    """Persistent byte-level string->code hash index (the join build
    hashtable). ``codes`` holds the build rows' dense codes; ``lookup``
    maps probe rows to build codes (-1 = absent) without decoding."""

    def __init__(self, handle, codes: np.ndarray, lib):
        self._handle = handle
        self._lib = lib
        self.codes = codes
        self.n_distinct = int(lib.dbtpu_string_index_size(handle))

    def lookup(self, offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
        n = len(offsets) - 1
        out = np.empty(max(n, 1), np.int64)
        self._lib.dbtpu_string_index_lookup(
            self._handle, np.ascontiguousarray(data, np.uint8),
            np.ascontiguousarray(offsets, np.int64), n, out)
        return out[:n]

    def __del__(self):  # pragma: no cover - GC timing
        try:
            if self._handle:
                self._lib.dbtpu_string_index_free(self._handle)
                self._handle = None
        except Exception:
            pass


def string_index(offsets: np.ndarray, data: np.ndarray):
    """Build a StringIndex over a string column, or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "dbtpu_string_index_new"):
        return None
    n = len(offsets) - 1
    codes = np.empty(max(n, 1), np.int64)
    handle = lib.dbtpu_string_index_new(
        np.ascontiguousarray(data, np.uint8),
        np.ascontiguousarray(offsets, np.int64), n, codes)
    if not handle:
        return None
    return StringIndex(handle, codes[:n], lib)


def take_strings(offsets: np.ndarray, data: np.ndarray, idx: np.ndarray):
    """Gather rows of an arrow-layout binary column natively.

    Returns (out_offsets, out_data) or None when the native library (or
    this symbol, for a stale .so) is unavailable. The row-length cumsum
    stays in numpy; the byte shuffle is one memcpy per row in C.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dbtpu_take_strings"):
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    lens = offs[1:] - offs[:-1]
    out_offsets = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens[idx], out=out_offsets[1:])
    total = int(out_offsets[-1])
    out_data = np.empty(max(total, 1), np.uint8)
    lib.dbtpu_take_strings(np.ascontiguousarray(data, np.uint8), offs,
                           idx, len(idx), out_offsets, out_data)
    return out_offsets, out_data[:total]


def copy_slices(data: np.ndarray, src_starts: np.ndarray,
                out_lens: np.ndarray):
    """Copy per-row byte slices natively: row i is
    ``data[src_starts[i] : src_starts[i]+out_lens[i]]``.

    Returns (out_offsets, out_data) or None when unavailable. Backs the
    vectorized substr/left/right string kernels on ASCII columns.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dbtpu_copy_slices"):
        return None
    n = len(src_starts)
    out_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(out_lens, out=out_offsets[1:])
    total = int(out_offsets[-1])
    out_data = np.empty(max(total, 1), np.uint8)
    lib.dbtpu_copy_slices(np.ascontiguousarray(data, np.uint8),
                          np.ascontiguousarray(src_starts, np.int64),
                          out_offsets, n, out_data)
    return out_offsets, out_data[:total]


def csv_scan(data: bytes, delim: str = ",", quote: str = '"'):
    """Tokenize a CSV buffer natively.

    Returns (starts, lens, quoted, row_ends) int64/uint8 numpy arrays, or
    None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(data)
    rows = ctypes.c_int64(0)
    fields = ctypes.c_int64(0)
    rc = lib.dbtpu_csv_count(data, n, delim.encode()[0:1], quote.encode()[0:1],
                             ctypes.byref(rows), ctypes.byref(fields))
    if rc != 0:
        return None
    nf, nr = fields.value, rows.value
    starts = np.empty(nf, np.int64)
    lens = np.empty(nf, np.int64)
    quoted = np.empty(nf, np.uint8)
    row_ends = np.empty(nr, np.int64)
    rc = lib.dbtpu_csv_scan(data, n, delim.encode()[0:1], quote.encode()[0:1],
                            starts, lens, quoted, row_ends)
    if rc != 0:
        return None
    return starts, lens, quoted, row_ends
