"""Vectorized key machinery for group-by / distinct / hash join.

The reference's group/join hashtables (src/common/hashtable — open
addressing with short-string specialization) map here onto C-speed
factorization: pandas ``factorize`` assigns dense per-column codes, and
``np.unique`` over the stacked code records yields composite group ids.
Per-row Python loops run only over the (small) set of distinct keys.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..expression import Column

NULL_CODE = -1


def key_values(col: Column) -> np.ndarray:
    """A 1-D array of the column's values suitable for hashing: numeric
    payloads pass through; everything else becomes an object array."""
    data = col.data
    if isinstance(data, np.ndarray) and data.ndim == 1 \
            and data.dtype != object:
        return data
    if hasattr(data, "as_object_array"):  # StringData: cached decode
        return data.as_object_array()
    return np.asarray(col.to_pylist(), dtype=object)


def factorize_column(col: Column) -> np.ndarray:
    """Dense int64 codes per row; NULLs get NULL_CODE. Codes are
    block-local (not comparable across calls)."""
    import pandas as pd
    from ..expression.column import StringData
    data = col.data
    if isinstance(data, StringData):
        # native byte-level factorize: no per-row decode (the reference's
        # short-string hashtable specialization, native/tokenize.cpp)
        codes = data.codes()
        if codes is not None:
            if col.validity is not None:
                codes = np.where(col.validity, codes, NULL_CODE)
            return codes
    vals = key_values(col)
    codes = None
    if isinstance(vals, np.ndarray) and vals.dtype.kind in "iu" \
            and len(vals) >= 65536:
        # dense-range integer keys (PK/FK ids): presence-array rank codes
        # beat the hash factorize ~10x (O(range) scan vs per-row hashing)
        lo, hi = int(vals.min()), int(vals.max())
        rng = hi - lo + 1
        if rng <= max(4 * len(vals), 1 << 22):
            present = np.zeros(rng, np.bool_)
            present[vals - lo] = True
            mapping = np.cumsum(present, dtype=np.int64) - 1
            codes = mapping[vals - lo]
    if codes is None:
        codes, _ = pd.factorize(vals, use_na_sentinel=True)
        codes = codes.astype(np.int64, copy=False)
    if col.validity is not None:
        codes = np.where(col.validity, codes, NULL_CODE)
    return codes


def composite_group(codes_list: List[np.ndarray]) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Composite dense group ids over one or more code arrays.

    Returns (local_gid [n], rep_row_idx [g]) where ``rep_row_idx[k]`` is
    the first row of group k. NULL codes group together (SQL GROUP BY
    semantics: NULLs form one group).
    """
    import pandas as pd
    n = len(codes_list[0])
    if len(codes_list) == 1:
        comb = codes_list[0]
    else:
        # pack per-column codes into one int64 (hash-based, no sort);
        # +1 shifts NULL_CODE to 0 so packing stays non-negative
        sizes = [int(c.max(initial=-1)) + 2 for c in codes_list]
        total = 1
        overflow = False
        for s in sizes:
            total *= s
            if total > (1 << 62):
                overflow = True
                break
        if overflow:
            stacked = np.ascontiguousarray(np.stack(codes_list, axis=1))
            rec = stacked.view([("", np.int64)] * len(codes_list)).reshape(n)
            _, idx, inv = np.unique(rec, return_index=True,
                                    return_inverse=True)
            return inv.astype(np.int64, copy=False).reshape(-1), idx
        comb = codes_list[0] + 1
        for c, s in zip(codes_list[1:], sizes[1:]):
            comb = comb * s + (c + 1)
    gids, uniq = pd.factorize(comb)
    gids = gids.astype(np.int64, copy=False)
    g = len(uniq)
    # first-occurrence row per group: reversed scatter, last write wins
    rep = np.empty(g, np.int64)
    rep[gids[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
    return gids, rep


def hashable_rows(cols: List[Column], idx: np.ndarray) -> list:
    """Key tuples for the given row indices, built column-wise (one
    vectorized take per column + one C-level zip) — the per-row
    Column.get path costs ~10x more at high key cardinality."""
    idx = np.asarray(idx, np.int64)
    parts = []
    for c in cols:
        vals = key_values(c)[idx]
        lst = vals.tolist()
        if c.validity is not None:
            vmask = c.validity[idx]
            lst = [v if ok else None for v, ok in zip(lst, vmask.tolist())]
        if lst and isinstance(lst[0], (list, np.ndarray)):
            lst = [tuple(v) if isinstance(v, list) else tuple(v.tolist())
                   for v in lst]
        parts.append(lst)
    return list(zip(*parts))


def hashable_row(cols: List[Column], i: int) -> tuple:
    out = []
    for c in cols:
        v = c.get(int(i))
        if isinstance(v, np.ndarray):
            v = tuple(v.tolist())
        elif isinstance(v, list):
            v = tuple(v)
        out.append(v)
    return tuple(out)


def _shared_codes(bcol: Column, pcol: Column) -> Tuple[np.ndarray,
                                                       np.ndarray, bool]:
    """One key-column pair -> comparable 1-D arrays for build and probe
    rows (equal values compare equal ACROSS the two arrays). Strings go
    through the native byte-level factorizer on the concatenated column
    (no per-row decode); mixed/object values share one pd.factorize.

    The third element is True when the arrays are DENSE codes (int64 in
    [0, n_distinct) over the union) — bincount-addressable directly."""
    import pandas as pd
    from ..expression.column import StringData
    bd, pdta = bcol.data, pcol.data
    if isinstance(bd, StringData) and isinstance(pdta, StringData):
        cat = StringData.concat([bd, pdta])
        codes = cat.codes()
        if codes is not None:
            return codes[:len(bd)], codes[len(bd):], True
    bv, pv = key_values(bcol), key_values(pcol)
    if bv.dtype == pv.dtype and bv.dtype != object:
        return bv, pv, False
    codes, _ = pd.factorize(np.concatenate([bv, pv]),
                            use_na_sentinel=False)
    codes = codes.astype(np.int64, copy=False)
    return codes[:len(bv)], codes[len(bv):], True


class _ColLookup:
    """Per-key-column build-side code mapping with probe lookup.

    Strings use the persistent native byte-hash index; everything else a
    pandas factorize + Index (C hashtables both ways)."""

    def __init__(self, col: Column):
        from ..expression.column import DictStringData, StringData
        self._si = None
        self._index = None
        self._dict = None
        data = col.data
        if isinstance(data, DictStringData):
            # dictionary-coded build side: codes ARE the hash state; a
            # probe sharing the dict object needs no lookup at all
            self._dict = data._dict
            self.codes = data._codes
            self.n_distinct = len(data._dict)
            return
        if isinstance(data, StringData):
            from .. import native
            si = native.string_index(data.offsets, data.data)
            if si is not None:
                self._si = si
                self.codes = si.codes
                self.n_distinct = si.n_distinct
                return
        import pandas as pd
        vals = key_values(col)
        codes, uniq = pd.factorize(vals, use_na_sentinel=False)
        self.codes = codes.astype(np.int64, copy=False)
        self.n_distinct = len(uniq)
        self._index = pd.Index(uniq)

    def lookup(self, col: Column):
        """Probe codes (-1 = absent from build), or None when this probe
        column's representation can't ride the built structure."""
        from ..expression.column import DictStringData, StringData
        if self._dict is not None:
            if isinstance(col.data, DictStringData) \
                    and col.data._dict is self._dict:
                return col.data._codes
            if not isinstance(col.data, StringData):
                return None
            # different dictionary: map probe values into build codes by
            # indexing the build DICTIONARY (distinct values only)
            import pandas as pd
            idx = pd.Index(self._dict.as_object_array())
            dv = col.data.dict_view()
            if dv is not None:
                m = idx.get_indexer(dv[0].as_object_array())
                return m[dv[1]]
            return idx.get_indexer(key_values(col))
        if self._si is not None:
            if not isinstance(col.data, StringData):
                return None
            return self._si.lookup(col.data.offsets, col.data.data)
        return self._index.get_indexer(key_values(col))


class JoinMatcher:
    """Build-once equi-join hash state, probed per streaming block
    (reference: the join hashtable built in the build phase and probed
    per block, src/common/hashtable). Unlike ``match_indices`` the build
    side is factorized and CSR-laid-out ONCE; each probe block pays only
    its own hash lookups."""

    def __init__(self, build_keys: List[Column]):
        import pandas as pd
        self.build_keys = list(build_keys)
        m = len(build_keys[0]) if build_keys else 0
        self.m = m
        bnull = np.zeros(m, np.bool_)
        for c in build_keys:
            if c.validity is not None:
                bnull |= ~c.validity
        self._lookups = [_ColLookup(c) for c in build_keys]
        d_b = self._lookups[0].codes
        u = self._lookups[0].n_distinct
        self._steps = []  # (multiplier, pd.Index of packed) per extra col
        for lk in self._lookups[1:]:
            mult = lk.n_distinct + 1
            packed = d_b * mult + lk.codes
            codes, uniqs = pd.factorize(packed)
            d_b = codes.astype(np.int64, copy=False)
            self._steps.append((mult, pd.Index(uniqs)))
            u = len(uniqs)
        self.g = max(u, 1)
        bsel = None
        bkf = d_b
        if bnull.any():
            bsel = np.flatnonzero(~bnull)
            bkf = d_b[bsel]
        self._bsel = bsel
        counts = np.bincount(bkf, minlength=self.g) if len(bkf) \
            else np.zeros(self.g, np.int64)
        self._counts = counts
        self._unique = int(counts.max(initial=0)) <= 1
        if self._unique:
            pos_of = np.zeros(self.g, np.int64)
            if len(bkf):
                pos_of[bkf] = bsel if bsel is not None \
                    else np.arange(m, dtype=np.int64)
            self._pos_of = pos_of
        else:
            starts = np.zeros(self.g + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            try:  # O(n) counting sort
                from pandas.core.sorting import get_group_index_sorter
                order = get_group_index_sorter(
                    np.ascontiguousarray(bkf, np.int64), self.g)
            except Exception:
                order = np.argsort(bkf, kind="stable")
            self._starts = starts
            self._order = order
            self._bkf_len = len(bkf)

    @staticmethod
    def build(build_keys):
        if not build_keys or not len(build_keys[0]):
            return None
        try:
            return JoinMatcher(build_keys)
        except Exception:
            return None

    def probe(self, probe_keys: List[Column]
              ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(probe_keys[0]) if probe_keys else 0
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if self.m == 0 or n == 0:
            return empty
        d_p = self._lookups[0].lookup(probe_keys[0])
        if d_p is None:
            return match_indices(self.build_keys, probe_keys)
        invalid = d_p < 0
        for (mult, index), lk, col in zip(self._steps, self._lookups[1:],
                                          probe_keys[1:]):
            cp = lk.lookup(col)
            if cp is None:
                return match_indices(self.build_keys, probe_keys)
            invalid = invalid | (cp < 0)
            packed = np.where(d_p < 0, 0, d_p) * mult \
                + np.where(cp < 0, 0, cp)
            d_p = index.get_indexer(packed)
            invalid = invalid | (d_p < 0)
        for c in probe_keys:
            if c.validity is not None:
                invalid = invalid | ~c.validity
        safe = np.where(d_p < 0, 0, d_p)
        cnt_p = np.where(invalid, 0, self._counts[safe])
        if self._unique:
            lidx = np.flatnonzero(cnt_p)
            if not len(lidx):
                return empty
            return lidx, self._pos_of[safe[lidx]]
        total_pairs = int(cnt_p.sum())
        if total_pairs == 0:
            return empty
        lidx = np.repeat(np.arange(n, dtype=np.int64), cnt_p)
        csum = np.cumsum(cnt_p) - cnt_p
        shift = self._starts[safe] - csum
        rpos = self._order[np.repeat(shift, cnt_p)
                           + np.arange(total_pairs, dtype=np.int64)]
        ridx = self._bsel[rpos] if self._bsel is not None else rpos
        return lidx, ridx.astype(np.int64, copy=False)


def match_indices(build_keys: List[Column], probe_keys: List[Column]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized equi-join matching (the reference's lookup join
    hashtable, src/common/hashtable, as a factorize + CSR gather).

    Returns (lidx, ridx): for every probe row with >=1 build match, one
    entry per (probe row, build row) pair, ordered by probe row (then
    build row). Rows with NULL in any key never match (SQL equality).

    The build side is factorized into dense group ids and laid out as a
    CSR run per id (stable argsort); each probe row hash-looks-up its id
    and gathers its run — all C-speed numpy, and the output needs no
    final sort because runs are emitted in probe-row order with
    build-row-ascending runs.
    """
    import pandas as pd
    m = len(build_keys[0]) if build_keys else 0
    n = len(probe_keys[0]) if probe_keys else 0
    if m == 0 or n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bnull = np.zeros(m, np.bool_)
    pnull = np.zeros(n, np.bool_)
    for c in build_keys:
        if c.validity is not None:
            bnull |= ~c.validity
    for c in probe_keys:
        if c.validity is not None:
            pnull |= ~c.validity

    pairs = [_shared_codes(b, p) for b, p in zip(build_keys, probe_keys)]
    if len(pairs) == 1:
        bk, pk, dense = pairs[0]
    else:
        # pack per-column shared codes into one int64 key when ranges
        # fit; otherwise unique over the stacked record view
        sizes = []
        overflow = False
        total = 1
        for b, p, _ in pairs:
            if b.dtype == object or not np.issubdtype(b.dtype, np.integer):
                overflow = True
                break
            hi = max(int(b.max(initial=-1)), int(p.max(initial=-1)))
            lo = min(int(b.min(initial=0)), int(p.min(initial=0)))
            if lo < 0:
                overflow = True
                break
            sizes.append(hi + 2)
            total *= hi + 2
            if total > (1 << 62):
                overflow = True
                break
        if not overflow:
            bk = pairs[0][0].astype(np.int64, copy=True) + 1
            pk = pairs[0][1].astype(np.int64, copy=True) + 1
            for (b, p, _), s in zip(pairs[1:], sizes[1:]):
                bk = bk * s + (b + 1)
                pk = pk * s + (p + 1)
            dense = False
        else:
            cols = [np.concatenate([b, p]).astype(np.int64)
                    if (b.dtype != object and b.dtype == p.dtype
                        and np.issubdtype(b.dtype, np.integer))
                    else pd.factorize(np.concatenate([b, p]),
                                      use_na_sentinel=False)[0]
                    .astype(np.int64)
                    for b, p, _ in pairs]
            stacked = np.ascontiguousarray(np.stack(cols, axis=1))
            rec = stacked.view([("", np.int64)] * len(cols)).reshape(m + n)
            _, inv = np.unique(rec, return_inverse=True)
            inv = inv.astype(np.int64, copy=False).reshape(-1)
            bk, pk, dense = inv[:m], inv[m:], True

    if not dense:
        codes, _ = pd.factorize(np.concatenate([bk, pk]),
                                use_na_sentinel=False)
        codes = codes.astype(np.int64, copy=False)
        bk, pk = codes[:m], codes[m:]

    bsel = None
    bkf = bk
    if bnull.any():
        bsel = np.flatnonzero(~bnull)
        bkf = bk[bsel]
        if not len(bkf):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    g = int(max(bk.max(initial=-1), pk.max(initial=-1))) + 1
    counts = np.bincount(bkf, minlength=g)
    cnt_p = counts[pk]
    if pnull.any():
        cnt_p = np.where(pnull, 0, cnt_p)

    if int(counts.max(initial=0)) <= 1:
        # unique build keys (PK-FK joins): at most one match per probe
        # row — direct code->row scatter map, no sort, no run expansion
        lidx = np.flatnonzero(cnt_p)
        if not len(lidx):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        pos_of = np.empty(g, np.int64)
        pos_of[bkf] = (bsel if bsel is not None
                       else np.arange(m, dtype=np.int64))
        return lidx, pos_of[pk[lidx]]

    total_pairs = int(cnt_p.sum())
    if total_pairs == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.zeros(g + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    try:  # O(n) counting sort (pandas groupsort_indexer)
        from pandas.core.sorting import get_group_index_sorter
        order = get_group_index_sorter(
            np.ascontiguousarray(bkf, np.int64), g)
    except Exception:
        order = np.argsort(bkf, kind="stable")
    lidx = np.repeat(np.arange(n, dtype=np.int64), cnt_p)
    # rpos[j] for pair j in probe row i's run = order[starts[g_i] +
    # (j - run_start_i)] — fold both terms into ONE repeated shift
    csum = np.cumsum(cnt_p) - cnt_p
    shift = starts[pk] - csum
    rpos = order[np.repeat(shift, cnt_p)
                 + np.arange(total_pairs, dtype=np.int64)]
    ridx = bsel[rpos] if bsel is not None else rpos
    return lidx, ridx.astype(np.int64, copy=False)
