"""Dense impact BM25 scores of a query batch over one block.

The reference's impact program (``databend_tpu/index/inverted/device.py``,
``_impact_topk_program`` / ``_impact_fused_topk_program``) builds the
``[tile, L, b, m]`` equality tensor of doc slots against query terms and
reduces it twice; XLA fuses that. ``impact_bm25_scores`` computes the same
``[b, n_pad]`` score matrix without it.

For doc ``d`` and query ``q``::

    score = f32(sum over terms j = 0..m-1, in f64, of the f32 products
                idf[q, j] * sat[d, s]   where term_ids[d, s] == qterms[q, j])
    out[q, d] = score                       if matched groups >= need[q]
                w_s * score + w_d * dist[q, d]   (when ``dist`` is given)
                -inf                        otherwise

A doc's score is a function of the set of its products, not of the query
positions they come from: an f32 product is an f64 value of 24 significant
bits, so the f64 sum of a query's products is exact, and the same in any
order, while the largest is less than ``2 ** (29 - log2(m))`` times the
smallest (beyond that the orders can differ in the last f64 bit, which the
one rounding to f32 keeps only at an f32 rounding boundary). Two docs whose
terms differ but whose (idf, sat) products are the same set tie, as they do
on the host's f64 BM25 (``index/inverted/reader.py``), and rank by
ascending row.

The query batch travels as ``qpack [b, m, 4]`` int32, one 16-byte entry
``{term id, idf (f32 bits), group id, vocabulary row}`` per query term
(``pack_query_terms``): the kernel reads an entry with one load. The terms of
one group are adjacent along ``j`` (``ImpactBM25._pack_queries`` lists them
group by group), so the number of matched groups is the number of runs of
equal group ids that hold at least one matching term. A term id occurs in at
most one slot of a doc (the doc-major layout writes each posting once); pad
docs and pad slots hold -2, pad terms -1 (group -1) and follow a query's real
terms, so padding never matches; ``sat`` holds no NaN.

The kernel looks each doc slot up once in the vocabulary of the batch
instead of comparing it with every query term. The queries run in units of
``gq`` queries and chunks of ``mc`` terms (``query_units``: a function of
``b`` and ``m`` alone, the whole batch up to ``b * m = UNIT_ENTRIES``); the
fourth word of an entry is the row of its term in the sorted distinct real
terms of its unit and chunk, -1 on pad terms. ``pack_query_terms`` computes
it on the host and checks it (``check_vocabulary``); the plain version does
not read it. ``_scores_plan`` adds how the launch is cut (strips of 32-doc
sub-strips, blocks a unit's items); ``chip_smoke.py`` prints it.

On a CUDA tensor ``impact_bm25_scores`` launches the hand-written kernel
``csrc/impact_bm25_scores.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version ``_impact_bm25_scores_plain``: the reference's composition,
one term column at a time and tiled over docs so that no intermediate passes
``PLAIN_BYTES``. Both round each product to f32, add the products in f64 and
round the sum to f32 once, without fused multiply-adds: the kernel's output
is bit-equal to the plain version's, and docs with equal sets of products
get equal scores (the tie rule of the top-k after it depends on that). The
reference's programs add in f32 through ``einsum``; this is a deliberate
difference (their tie order depends on the query positions).

``impact_bm25_topk`` is the function the serving path calls: the same scores
and their ``k`` largest per query, in ``jax.lax.top_k``'s order
(``ops.topk.topk_largest_lowest_index``), which is what the reference's
programs return. On a CUDA tensor it launches the selecting entry point of
the same source, which never writes the ``[b, n_pad]`` block: it scores
from the same table and keeps each query's top k in shared memory, cut
against a threshold the blocks share (``_topk_plan`` cuts the launch: the
scores kernel's units, queries a block, slots a query, strips, blocks); its
plain version ``_impact_bm25_topk_plain`` is the plain scores followed by
that top-k. Above ``MAX_K`` it runs ``impact_bm25_scores`` and the top-k instead
(a shape rule: each launch counts on its own wrapper).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda
from .topk import topk_largest_lowest_index

PLAIN_BYTES = 1 << 28     # the plain version's largest intermediate
MAX_SLOTS = 512           # the kernel keeps 32 docs x L slots in shared memory
MAX_K = 128               # the selecting kernel's largest k (its MAX_K)
UNIT_ENTRIES = 512        # the scores kernel's (query, term) entries a unit
CHUNKED_QUERIES = 8       # queries a unit of more than one chunk holds
SCORES_WARPS = 16         # warps of a scores block
MAX_SUBS = 8              # 32-doc sub-strips of a scores strip
SCORES_SMEM = 112 * 1024  # a scores block's shared memory: two an SM
FILL_BLOCKS = 2 * 132     # scores blocks the card holds at once
TOPK_SLOTS = 64           # quarter-warps of a selecting block: a slot each
TOPK_MAX_SUBS = 64        # 32-doc sub-strips of a selecting plan's strip
TOPK_SMEM = 220 * 1024    # a selecting block's shared memory: one an SM
SMS = 132                 # SMs of an H100 (the plan reads the card's)
NEG_INF = float("-inf")


def query_units(b: int, m: int):
    """``(gq, mc)``: the scores kernel takes the batch in units of ``gq``
    queries and each query's terms in chunks of ``mc``, ``gq * mc <=
    UNIT_ENTRIES``; all ``m`` terms in one chunk while ``CHUNKED_QUERIES``
    queries of them fit, else chunks of ``UNIT_ENTRIES // gq`` terms for
    units of that many queries, each carried across its chunks."""
    if m * min(b, CHUNKED_QUERIES) <= UNIT_ENTRIES:
        return min(b, UNIT_ENTRIES // m), m
    gq = min(b, CHUNKED_QUERIES)
    return gq, UNIT_ENTRIES // gq


class ScoresPlan(NamedTuple):
    """How ``impact_bm25_scores`` runs a shape: ``units`` of ``queries``
    queries (one row of blocks each), ``chunks`` of ``terms`` terms, strips
    of ``subs`` 32-doc sub-strips, a unit's (query, sub-strip) items, four
    to a warp, over ``qsplit`` blocks."""
    queries: int
    terms: int
    units: int
    chunks: int
    subs: int
    qsplit: int


def _scores_smem(gq: int, mc: int, subs: int) -> int:
    """csrc/impact_bm25_scores.cu:scores_smem: the table (gq * mc + 1 rows
    of 32 * subs + 4 floats), 12 bytes an entry, 12 a query."""
    return (gq * mc + 1) * (32 * subs + 4) * 4 + gq * mc * 12 + gq * 12


def _scores_plan(n_pad: int, b: int, m: int) -> ScoresPlan:
    """The units of ``query_units``; the most sub-strips (up to
    ``MAX_SUBS``) whose table fits ``SCORES_SMEM`` (with more than one
    chunk, one quad of items a warp); a unit's quads split over blocks
    while the strips alone do not fill the card."""
    gq, mc = query_units(b, m)
    units, chunks = -(-b // gq), -(-m // mc)
    subs = MAX_SUBS
    while subs > 1 and (_scores_smem(gq, mc, subs) > SCORES_SMEM
                        or 32 * subs >= 2 * n_pad
                        or (chunks > 1 and gq * subs > 4 * SCORES_WARPS)):
        subs //= 2
    strips = -(-n_pad // (32 * subs))
    qsplit = 1
    if chunks == 1 and strips * units < FILL_BLOCKS:
        quads = -(-gq * subs // 4)
        qsplit = min(-(-FILL_BLOCKS // (strips * units)),
                     -(-quads // SCORES_WARPS))
    return ScoresPlan(gq, mc, units, chunks, subs, qsplit)


def strip_subs(plan: ScoresPlan, rows: int) -> int:
    """The 32-doc sub-strips a strip of the kernel takes for a unit whose
    vocabulary has ``rows`` rows: with one chunk, the plan's strips widened
    (powers of two, up to ``MAX_SUBS``) while ``rows + 1`` table rows fit
    the table the plan sized (csrc/impact_bm25_scores.cu:scores_kernel)."""
    subs = plan.subs
    if plan.chunks > 1:
        return subs
    words = (plan.queries * plan.terms + 1) * (32 * subs + 4)
    fit = (words // (rows + 1) - 4) // 32
    while subs < MAX_SUBS and 2 * subs <= fit:
        subs *= 2
    return subs


class TopkPlan(NamedTuple):
    """How ``impact_bm25_topk`` runs a shape: the scores kernel's ``units``
    of ``queries`` queries and ``chunks`` of ``terms`` terms; ``group``
    queries of a unit a block (``qsplit`` blocks a unit's queries), each
    query in ``ways`` slots of a quarter-warp; strips of ``subs`` 32-doc
    sub-strips (a slot scores every ``ways``-th); buffers of ``32 * r``
    keys; ``blocks`` blocks walking the strips of each (unit, group)."""
    queries: int
    terms: int
    units: int
    chunks: int
    group: int
    qsplit: int
    subs: int
    ways: int
    r: int
    blocks: int


def _topk_smem(gq: int, mc: int, subs: int, slots: int, r: int) -> int:
    """csrc/impact_bm25_scores.cu:topk_smem: the scores kernel's table and
    staging, rounded to 16 bytes, then per slot 32 * r keys and a count."""
    return -(-_scores_smem(gq, mc, subs) // 16) * 16 + slots * (256 * r + 4)


def _topk_plan(n_pad: int, b: int, m: int, k: int, sms: int = SMS) -> TopkPlan:
    """The units of ``query_units``; the fewest blocks a unit's queries
    (each block builds the strip's table for its own), then the widest
    strips (up to ``TOPK_MAX_SUBS``, under twice the block) whose table and
    slot buffers fit ``TOPK_SMEM``; as many ways a query as fill the
    block's ``TOPK_SLOTS`` quarter-warps (with more than one chunk a slot
    carries its one item a strip: ways = subs); persistent blocks, one an
    SM over the units and groups, no more than the strips."""
    gq, mc = query_units(b, m)
    units, chunks = -(-b // gq), -(-m // mc)
    r = 2 if k <= 32 else 4 if k <= 96 else 8
    widest = TOPK_MAX_SUBS
    while widest > 1 and 32 * widest >= 2 * n_pad:
        widest //= 2
    for qsplit in range(-(-gq // TOPK_SLOTS), gq + 1):
        group = -(-gq // qsplit)
        subs = widest
        while subs >= 1:
            ways = min(1 << (TOPK_SLOTS // group).bit_length() - 1, subs)
            if chunks > 1:
                ways = subs
            if group * ways <= TOPK_SLOTS and _topk_smem(
                    gq, mc, subs, group * ways, r) <= TOPK_SMEM:
                strips = -(-n_pad // (32 * subs))
                blocks = max(1, min(strips, sms // (units * qsplit)))
                return TopkPlan(gq, mc, units, chunks, group, qsplit, subs,
                                ways, r, blocks)
            subs //= 2
    raise AssertionError("unreachable: one query a block always fits")


def _units(b: int, m: int) -> np.ndarray:
    """``[b, m]``: the (unit, chunk) each entry belongs to, numbered."""
    gq, mc = query_units(b, m)
    chunks = -(-m // mc)
    return (np.arange(b)[:, None] // gq) * chunks + np.arange(m)[None, :] // mc


def vocabulary_rows(qterms: np.ndarray) -> np.ndarray:
    """``[b, m]`` int32: the row of each real term in the sorted distinct real
    terms of its unit and chunk (``query_units``), -1 on pad terms."""
    b, m = qterms.shape
    real = qterms >= 0
    key = (_units(b, m).astype(np.int64) << 32) | qterms.astype(np.int64)
    uniq, inv = np.unique(key[real], return_inverse=True)
    unit = uniq >> 32
    rows = np.arange(len(uniq)) - np.searchsorted(unit, unit)
    out = np.full((b, m), -1, np.int32)
    out[real] = rows[inv.reshape(-1)]
    return out


def check_vocabulary(qpack: np.ndarray) -> None:
    """Raise ValueError unless the fourth word of every entry of ``qpack``
    ``[b, m, 4]`` is its term's row in the sorted distinct real terms of its
    unit and chunk, and -1 on pad terms: rows in range (below the number of
    distinct terms), consistent (one row a term, one term a row) and
    sorted (rows in the order of their terms)."""
    terms, rows = qpack[..., 0], qpack[..., 3]
    b, m = terms.shape
    real = terms >= 0
    if (rows[~real] != -1).any():
        raise ValueError("impact_bm25: vocabulary row of a pad term is not -1")
    unit = _units(b, m)[real]
    t, r = terms[real].astype(np.int64), rows[real].astype(np.int64)
    distinct = np.unique((unit.astype(np.int64) << 32) | t) >> 32
    size = np.bincount(distinct, minlength=int(unit.max(initial=-1)) + 1)
    if (r < 0).any() or (r >= size[unit]).any():
        raise ValueError("impact_bm25: vocabulary row out of range")
    order = np.lexsort((t, r, unit))
    unit, t, r = unit[order], t[order], r[order]
    same_unit = unit[1:] == unit[:-1]
    same_row = same_unit & (r[1:] == r[:-1])
    if (t[1:] != t[:-1])[same_row].any() \
            or (t[1:] == t[:-1])[same_unit & ~same_row].any():
        raise ValueError("impact_bm25: vocabulary inconsistent with the "
                         "query terms")
    if (t[1:] < t[:-1])[same_unit].any():
        raise ValueError("impact_bm25: vocabulary not sorted")


def pack_query_terms(qterms, idf, qgroup):
    """``qterms``, ``qgroup`` ``[b, m]`` int32 and ``idf [b, m]`` f32 (numpy
    arrays or tensors) -> ``qpack [b, m, 4]`` int32 of the same kind, on the
    same device, its vocabulary rows built and checked on the host."""
    if isinstance(qterms, torch.Tensor):
        return torch.from_numpy(pack_query_terms(
            *(t.cpu().numpy() for t in (qterms, idf, qgroup)))
        ).to(qterms.device)
    qpack = np.stack((qterms, idf.view(np.int32), qgroup,
                      vocabulary_rows(qterms)), axis=-1)
    check_vocabulary(qpack)
    return qpack


def _check_inputs(term_ids, sat, qpack, need, dist):
    if term_ids.ndim != 2 or sat.shape != term_ids.shape:
        raise ValueError("impact_bm25_scores: want term_ids and sat [n_pad, L]"
                         f", got {tuple(term_ids.shape)}, {tuple(sat.shape)}")
    if qpack.ndim != 3 or qpack.shape[2] != 4:
        raise ValueError("impact_bm25_scores: want qpack [b, m, 4], got "
                         f"{tuple(qpack.shape)}")
    b = qpack.shape[0]
    n_pad = term_ids.shape[0]
    if need.shape != (b,):
        raise ValueError(f"impact_bm25_scores: want need [{b}], got "
                         f"{tuple(need.shape)}")
    if dist is not None and dist.shape != (b, n_pad):
        raise ValueError(f"impact_bm25_scores: want dist [{b}, {n_pad}], got "
                         f"{tuple(dist.shape)}")
    ints, floats = (term_ids, qpack), (sat, need)
    if dist is not None:
        floats += (dist,)
    if any(t.dtype != torch.int32 for t in ints) \
            or any(t.dtype != torch.float32 for t in floats):
        raise TypeError("impact_bm25_scores: want int32 term_ids and qpack "
                        "and float32 sat, need and dist")
    if any(t.device != term_ids.device for t in ints + floats):
        raise ValueError("impact_bm25_scores: inputs on different devices")


def _impact_bm25_scores_plain(term_ids: torch.Tensor, sat: torch.Tensor,
                              qpack: torch.Tensor, need: torch.Tensor,
                              dist: Optional[torch.Tensor] = None,
                              w_s: float = 1.0,
                              w_d: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (see the module doc): per doc tile and term
    column ``j`` one ``[tile, L, b]`` compare-select, summed over the slots
    (at most one is non-zero, so that sum is exact); the f32 products add
    in f64, rounded to f32 once."""
    n_pad, slots = term_ids.shape
    b, m = qpack.shape[:2]
    dev = term_ids.device
    qterms, qgroup = qpack[..., 0], qpack[..., 2]
    idf = qpack[..., 1].view(torch.float32)
    tile = max(1, min(n_pad, PLAIN_BYTES // (4 * slots * b)))
    new_run = torch.ones((b, m), dtype=torch.bool, device=dev)
    new_run[:, 1:] = qgroup[:, 1:] != qgroup[:, :-1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((b, n_pad), dtype=torch.float32, device=dev)
    for s in range(0, n_pad, tile):
        ids = term_ids[s:s + tile, :, None]                   # [t, L, 1]
        st = sat[s:s + tile, :, None]
        t = ids.shape[0]
        score = torch.zeros((t, b), dtype=torch.float64, device=dev)
        groups = torch.zeros((t, b), dtype=torch.int32, device=dev)
        run_hit = torch.zeros((t, b), dtype=torch.bool, device=dev)
        for j in range(m):
            eq = ids == qterms[:, j]                          # [t, L, b]
            per_term = torch.where(eq, st, zero).sum(1)       # [t, b]
            score = score + (per_term * idf[:, j]).to(torch.float64)
            # a new group starts at j: close the run before it
            groups = groups + (run_hit & new_run[:, j])
            run_hit = (run_hit & ~new_run[:, j]) | eq.any(1)
        groups = groups + run_hit
        ok = groups.to(torch.float32) >= need
        score = score.to(torch.float32)
        if dist is not None:
            score = w_s * score + w_d * dist[:, s:s + tile].T
        out[:, s:s + tile] = torch.where(ok, score, NEG_INF).T
    return out


def _check_kernel_operands(what, term_ids, sat, qpack, need, dist):
    """What the CUDA entry points take beyond ``_check_inputs``."""
    if term_ids.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {term_ids.device}")
    n_pad, slots = term_ids.shape
    b, m = qpack.shape[:2]
    if slots % 8 or not 8 <= slots <= MAX_SLOTS or b < 1 or m < 1 or n_pad < 1:
        raise ValueError(f"{what}: the CUDA kernel needs L % 8 == "
                         f"0, 8 <= L <= {MAX_SLOTS}, b, m, n_pad >= 1 "
                         f"(L={slots}, b={b}, m={m}, n_pad={n_pad})")
    operands = {"term_ids": term_ids, "sat": sat, "qpack": qpack,
                "need": need}
    if dist is not None:
        operands["dist"] = dist
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name in ("term_ids", "sat", "qpack"):        # read as 16-byte vectors
        if operands[name].data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start at a "
                             "multiple of 16 bytes")


def _raise_on(lib, what, err):
    if err:
        msg = lib.impact_bm25_scores_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def impact_bm25_scores(term_ids: torch.Tensor, sat: torch.Tensor,
                       qpack: torch.Tensor, need: torch.Tensor,
                       dist: Optional[torch.Tensor] = None,
                       w_s: float = 1.0, w_d: float = 0.0) -> torch.Tensor:
    """``[b, n_pad]`` f32 scores (see the module doc).

    term_ids ``[n_pad, L]`` int32 and sat ``[n_pad, L]`` f32: the block's
    doc-major layout; qpack ``[b, m, 4]`` int32 (``pack_query_terms``: the
    kernel trusts its vocabulary rows, which this wrapper does not read) and
    need ``[b]`` f32: the packed query batch; dist ``[b, n_pad]`` f32 with the
    weights ``w_s``, ``w_d`` for the fused text+vector ranking."""
    _check_inputs(term_ids, sat, qpack, need, dist)
    if term_ids.device.type == "cpu":
        return _impact_bm25_scores_plain(term_ids, sat, qpack, need, dist,
                                         w_s, w_d)
    _check_kernel_operands("impact_bm25_scores", term_ids, sat, qpack, need,
                           dist)
    n_pad, slots = term_ids.shape
    b, m = qpack.shape[:2]
    plan = _scores_plan(n_pad, b, m)
    lib = _launcher()
    out = torch.empty((b, n_pad), dtype=torch.float32, device=term_ids.device)
    with torch.cuda.device(term_ids.device):
        stream = torch.cuda.current_stream(term_ids.device).cuda_stream
        err = lib.impact_bm25_scores_launch(
            term_ids.data_ptr(), sat.data_ptr(), qpack.data_ptr(),
            need.data_ptr(), dist.data_ptr() if dist is not None else None,
            float(w_s), float(w_d), out.data_ptr(), n_pad, slots, b, m,
            plan.queries, plan.terms, plan.subs, plan.qsplit, stream)
    _raise_on(lib, "impact_bm25_scores", err)
    impact_bm25_scores.launches += 1
    return out


impact_bm25_scores.launches = 0


def _impact_bm25_topk_plain(term_ids: torch.Tensor, sat: torch.Tensor,
                            qpack: torch.Tensor, need: torch.Tensor, k: int,
                            dist: Optional[torch.Tensor] = None,
                            w_s: float = 1.0, w_d: float = 0.0):
    """Plain PyTorch version of ``impact_bm25_topk``: the plain scores, then
    the tie-rule top-k."""
    return topk_largest_lowest_index(
        _impact_bm25_scores_plain(term_ids, sat, qpack, need, dist, w_s, w_d),
        k)


def impact_bm25_topk(term_ids: torch.Tensor, sat: torch.Tensor,
                     qpack: torch.Tensor, need: torch.Tensor, k: int,
                     dist: Optional[torch.Tensor] = None, w_s: float = 1.0,
                     w_d: float = 0.0):
    """The ``k`` largest scores per query and their docs -> (vals ``[b, k]``
    f32, ids ``[b, k]`` int64), in ``jax.lax.top_k``'s order; operands as
    :func:`impact_bm25_scores`, ``1 <= k <= n_pad``. Above ``MAX_K`` the
    scores and the tie-rule top-k run apart."""
    _check_inputs(term_ids, sat, qpack, need, dist)
    n_pad, slots = term_ids.shape
    if not 1 <= k <= n_pad:
        raise ValueError(f"impact_bm25_topk: want 1 <= k <= n_pad, got k={k}"
                         f", n_pad={n_pad}")
    if k > MAX_K:
        return topk_largest_lowest_index(
            impact_bm25_scores(term_ids, sat, qpack, need, dist, w_s, w_d), k)
    if term_ids.device.type == "cpu":
        return _impact_bm25_topk_plain(term_ids, sat, qpack, need, k, dist,
                                       w_s, w_d)
    _check_kernel_operands("impact_bm25_topk", term_ids, sat, qpack, need,
                           dist)
    b, m = qpack.shape[:2]
    lib = _launcher()
    dev = term_ids.device
    plan = _topk_plan(n_pad, b, m, k, _sms(dev))
    # the blocks' top k per query, then a threshold per query
    part = torch.empty(b * (plan.blocks * k + 1), dtype=torch.int64,
                       device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.impact_bm25_topk_launch(
            term_ids.data_ptr(), sat.data_ptr(), qpack.data_ptr(),
            need.data_ptr(), dist.data_ptr() if dist is not None else None,
            float(w_s), float(w_d), part.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), n_pad, slots, b, m, k, plan.queries, plan.terms,
            plan.subs, plan.group, plan.ways, plan.blocks, stream)
    _raise_on(lib, "impact_bm25_topk", err)
    impact_bm25_topk.launches += 1
    return vals, ids


impact_bm25_topk.launches = 0

# the C interface of csrc/impact_bm25_scores.cu: term_ids, sat, qpack, need,
# dist (or NULL); w_s, w_d; out; n_pad, L, b, m; the plan's queries, terms,
# subs and qsplit; stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# impact_bm25_topk_launch: the same operands; w_s, w_d; part, vals, ids;
# n_pad, L, b, m, k; the plan's queries, terms, subs, group, ways and
# blocks; stream
_TOPK_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.cache
def _sms(device: torch.device) -> int:
    """The card's SMs, which the selecting plan's persistent blocks fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _launcher() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = _cuda.load("impact_bm25_scores")
    lib.impact_bm25_scores_launch.argtypes = _LAUNCH_ARGTYPES
    lib.impact_bm25_scores_launch.restype = ctypes.c_int
    lib.impact_bm25_topk_launch.argtypes = _TOPK_ARGTYPES
    lib.impact_bm25_topk_launch.restype = ctypes.c_int
    lib.impact_bm25_topk_smem.argtypes = [ctypes.c_int] * 5
    lib.impact_bm25_topk_smem.restype = ctypes.c_longlong
    lib.impact_bm25_topk_budget.argtypes = []
    lib.impact_bm25_topk_budget.restype = ctypes.c_int
    lib.impact_bm25_topk_max_k.argtypes = []
    lib.impact_bm25_topk_max_k.restype = ctypes.c_int
    lib.impact_bm25_scores_unit_entries.argtypes = []
    lib.impact_bm25_scores_unit_entries.restype = ctypes.c_int
    lib.impact_bm25_scores_error_string.argtypes = [ctypes.c_int]
    lib.impact_bm25_scores_error_string.restype = ctypes.c_char_p
    if lib.impact_bm25_topk_max_k() != MAX_K \
            or lib.impact_bm25_scores_unit_entries() != UNIT_ENTRIES \
            or lib.impact_bm25_topk_budget() != TOPK_SMEM \
            or any(lib.impact_bm25_topk_smem(128, 4, 8, 64, r)
                   != _topk_smem(128, 4, 8, 64, r) for r in (2, 4, 8)):
        raise RuntimeError("csrc/impact_bm25_scores.cu and ops/impact_bm25.py "
                           "disagree on MAX_K, UNIT_ENTRIES or the selecting "
                           "kernel's shared memory")
    return lib
