"""Prepared / parameterized statements + the batched KNN serving path.

The reference re-plans every SQL request (servers/http/v1/query/
execute_state.rs:401 — parse, bind, optimize, build pipelines per query);
its KNN path is then µs-per-block HNSW inside compiled Rust
(hnsw_index/hnsw.rs:97-118), so per-query planning overhead is tolerable.
In Python the plan/dispatch overhead dominates (measured 39-88 ms/query
at 1M rows through ``ctx.sql``), so the TPU-native answer is to **bind
once and serve many**:

- ``PREPARE p FROM 'SELECT id FROM t ORDER BY l2_distance(emb, ?) LIMIT 10'``
  parses once; ``EXECUTE p USING ([..])`` substitutes parameters into the
  cached AST (no re-parse; the 1-10 KB vector literal never exists as text).
- When the statement matches the canonical KNN shape (single table, no
  filter, ASC distance ORDER BY + LIMIT, a defined VECTOR INDEX with the
  metric — the same gate as the binder rewrite, sql/binder.py
  ``_try_rewrite_vector``), it compiles to a **KnnServer**: the whole
  corpus as ONE HBM-resident ``[N, d]`` array + a host projection block,
  and ``execute_batch(Q[B, d])`` runs ONE jitted MXU top-k dispatch for
  all B queries (exactly the kernel the headline bench measures) and
  gathers B result sets host-side. Recall is 1.0 by construction (exact
  scan), matching ``vector_search_mode=auto``'s measured-faster routing.

In the port the serving programs run eagerly on torch: the whole-batch
scans are loops over 256-query chunks. A batch of more than one chunk with
``exact=False`` (unfiltered l2 or cosine) runs ``flash_topk``: the
hand-written group-min scan over a bf16 copy of the corpus, then an exact
f32 re-rank of the shortlisted groups. A batch of one chunk runs the exact
program in both modes, as in the reference. l1 has no matmul form and takes
the plain scan. A filtered statement cannot hand its per-query masks to the
flash kernel, so it selects with the exact top-k in both modes, and its
approximate answer is exact. Every exact selection is the hand-written
``ops.exact_topk.exact_topk_select`` on each query chunk's product block
(the filtered one with its row mask), and ranks equal distances by
ascending row id, as the reference's ``lax.top_k(-d, k)`` does.
``match()`` statements above
``_MatchServer.DEVICE_MIN_DOCS`` rows are served from per-block device BM25
scorers (``index/inverted/device.py``), text-only and fused with a vector
distance.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import backend
from ..errors import BadArguments, SemanticError
from ..expression import Column, DataBlock
from ..expression.schema import DataField
from ..types import Float32, VectorType
from ..sql import ast as A
from ..sql.binder import _DISTANCE_FNS
from ..sql.parser import Parser
from ..storage.fuse.table import (_QUERY_CHUNK, _exact_topk_program,
                                  _rescore_l2)
from ..utils.cache import CacheManager


# ---------------------------------------------------------------- substitution
def substitute_params(stmt: A.Statement, params: Sequence[Any]) -> A.Statement:
    """Deep-copy the AST with every ``Placeholder(i)`` replaced by
    ``Literal(params[i])``. Unbound placeholders raise."""
    stmt = copy.deepcopy(stmt)
    _subst_inplace(stmt, params)
    return stmt


def _to_literal(v: Any) -> A.Literal:
    if isinstance(v, np.ndarray):
        v = v.tolist()
    elif isinstance(v, (np.integer,)):
        v = int(v)
    elif isinstance(v, (np.floating,)):
        v = float(v)
    elif isinstance(v, tuple):
        v = list(v)
    return A.Literal(v)


def _subst_inplace(node: Any, params: Sequence[Any]) -> Any:
    """Returns the replacement for `node` (or `node` itself), mutating
    dataclass fields / list items in place."""
    if isinstance(node, A.Placeholder):
        if node.index >= len(params):
            raise BadArguments(
                f"prepared statement expects {node.index + 1} parameters, "
                f"got {len(params)}")
        return _to_literal(params[node.index])
    if isinstance(node, list):
        for i, x in enumerate(node):
            node[i] = _subst_inplace(x, params)
        return node
    if isinstance(node, tuple):
        return tuple(_subst_inplace(x, params) for x in node)
    if hasattr(node, "__dataclass_fields__"):
        for name in node.__dataclass_fields__:
            old = getattr(node, name)
            new = _subst_inplace(old, params)
            if new is not old:
                setattr(node, name, new)
        return node
    return node


def count_params(node: Any) -> int:
    """Highest placeholder index + 1 anywhere in the AST."""
    best = 0
    if isinstance(node, A.Placeholder):
        return node.index + 1
    if isinstance(node, (list, tuple)):
        for x in node:
            best = max(best, count_params(x))
        return best
    if hasattr(node, "__dataclass_fields__"):
        for name in node.__dataclass_fields__:
            best = max(best, count_params(getattr(node, name)))
    return best


# ------------------------------------------------------------- KNN fast path
@dataclass
class _ParamFilter:
    """One parameterized WHERE conjunct ``col <op> ?`` served on device:
    the column stays HBM-resident, each batch ships only [B] operands."""
    column: str
    op: str             # '=' '==' '!=' '<>' '<' '<=' '>' '>='
    param_index: int


@dataclass
class _KnnShape:
    database: Optional[str]
    table: str
    metric_fn: str      # l2_distance | cosine_distance | l1_distance
    column: str
    k: int
    # select items: ("col", name, out_name) | ("star", None, None)
    #             | ("score", None, out_name)
    items: List[tuple]
    param_index: int
    # every placeholder index bound to the query vector (order-by first);
    # all must receive equal values for the fast path to serve
    param_indices: List[int] = None
    # WHERE pushdown (BASELINE config 3): placeholder-free conjuncts fold
    # into ONE host-evaluated static mask at refresh; `col op ?` conjuncts
    # compare on device against resident columns (reference filter+index
    # pushdown, pushdown.rs:167-207)
    where_static: Optional[A.Expr] = None
    where_params: List[_ParamFilter] = None


_FILTER_OPS = {"=", "==", "!=", "<>", "<", "<=", ">", ">="}
_FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "==": "==", "!=": "!=", "<>": "<>"}


def _parse_knn_where(where: A.Expr):
    """Split a WHERE tree into (static_expr, [param_filters]) or None when
    any conjunct is outside the servable grammar. Static conjuncts are
    validated lazily at refresh (filter_eval raises Unsupported -> generic
    fallback); parameterized ones must be ``col op ?``."""
    from .filter_eval import split_conjuncts
    static: List[A.Expr] = []
    params: List[_ParamFilter] = []
    for c in split_conjuncts(where):
        if count_params(c) == 0:
            static.append(c)
            continue
        if isinstance(c, A.BinaryOp) and c.op in _FILTER_OPS:
            l, r, op = c.left, c.right, c.op
            if isinstance(l, A.Placeholder) and isinstance(r, A.ColumnRef):
                l, r, op = r, l, _FLIP_OP[op]
            if isinstance(l, A.ColumnRef) and isinstance(r, A.Placeholder):
                params.append(_ParamFilter(l.name, op, r.index))
                continue
        return None
    st = None
    for c in static:
        st = c if st is None else A.BinaryOp("AND", st, c)
    return st, params


def _dist_call_matches(e: A.FunctionCall, ref: A.FunctionCall) -> bool:
    """Same distance fn over the same (column, placeholder) pair."""
    if e.name.lower() != ref.name.lower() or len(e.args) != 2:
        return False
    def norm(args):
        a0, a1 = args
        if isinstance(a0, A.Placeholder) and isinstance(a1, A.ColumnRef):
            a0, a1 = a1, a0
        return a0, a1
    a0, a1 = norm(e.args)
    r0, r1 = norm(ref.args)
    # NOTE: the placeholder indices may differ (`?` is positional);
    # the server checks value equality at execute time and falls back
    # to the generic path when the two parameters are not the same vector
    return (isinstance(a0, A.ColumnRef) and isinstance(r0, A.ColumnRef)
            and a0.name.lower() == r0.name.lower()
            and isinstance(a1, A.Placeholder) and isinstance(r1, A.Placeholder))


def match_knn_shape(stmt: A.Statement) -> Optional[_KnnShape]:
    """Recognize `SELECT <cols> FROM t ORDER BY dist(col, ?) [ASC] LIMIT k`
    — the canonical KNN serving statement (reference KNN rewrite gate,
    type_check/vector.rs:70-120)."""
    if not isinstance(stmt, A.QueryStmt):
        return None
    q = stmt.query
    if q.ctes or q.offset is not None or len(q.order_by) != 1:
        return None
    if not isinstance(q.limit, A.Literal) or not isinstance(q.limit.value, int):
        return None
    body = q.body
    if not isinstance(body, A.SelectStmt):
        return None
    if (body.group_by or body.having
            or body.distinct or body.group_sets or body.qualify
            or body.group_all):
        return None
    if not isinstance(body.from_, A.TableName) or body.from_.at_snapshot:
        return None
    where_static, where_params = None, []
    if body.where is not None:
        parsed = _parse_knn_where(body.where)
        if parsed is None:
            return None
        where_static, where_params = parsed
    ob = q.order_by[0]
    if not ob.asc or ob.nulls_first:
        return None
    e = ob.expr
    if (not isinstance(e, A.FunctionCall)
            or e.name.lower() not in _DISTANCE_FNS or len(e.args) != 2):
        return None
    a0, a1 = e.args
    if isinstance(a0, A.Placeholder) and isinstance(a1, A.ColumnRef):
        a0, a1 = a1, a0
    if not (isinstance(a0, A.ColumnRef) and isinstance(a1, A.Placeholder)):
        return None
    items: List[tuple] = []
    indices = [a1.index]
    for it in body.items:
        ex = it.expr
        if isinstance(ex, A.Star):
            items.append(("star", None, None))
        elif isinstance(ex, A.ColumnRef):
            items.append(("col", ex.name, it.alias or ex.name))
        elif isinstance(ex, A.FunctionCall) and _dist_call_matches(ex, e):
            items.append(("score", None, it.alias or ex.name.lower()))
            ph = ex.args[1] if isinstance(ex.args[1], A.Placeholder) \
                else ex.args[0]
            indices.append(ph.index)
        else:
            return None
    return _KnnShape(body.from_.database, body.from_.name,
                     e.name.lower(), a0.name, int(q.limit.value),
                     items, a1.index, sorted(set(indices)),
                     where_static, where_params)


# flash_topk defaults of the reference (ops/flash_topk.py)
FLASH_TILE = 16384
FLASH_LANES = 128


def _cmp(op, c, v):
    if op in ("=", "=="):
        return c == v
    if op in ("!=", "<>"):
        return c != v
    if op == "<":
        return c < v
    if op == "<=":
        return c <= v
    if op == ">":
        return c > v
    return c >= v


def _scan_topk_program(Q: torch.Tensor, x: torch.Tensor, k: int, metric: str,
                       n_valid: int):
    """Whole-batch exact top-k: ``_exact_topk_program`` (one ``[chunk, N]``
    score block per query chunk) with the l2 corpus norms computed once.
    Returns device (vals ``[B, k]``, ids int32)."""
    norms = torch.sum(x * x, -1) if metric == "l2" else None
    return _exact_topk_program(Q, x, k, metric, n_valid, x_sq_norms=norms)


def _scan_topk_filtered_program(Q: torch.Tensor, x: torch.Tensor, k: int,
                                metric: str, n_valid: int, smask, fcols,
                                fvals, f_ops):
    """Filtered batched KNN (BASELINE config 3): a static row mask
    (host-evaluated WHERE conjuncts, uploaded once per snapshot) plus
    per-query ``col op ?`` comparisons against device-resident columns,
    composed per query chunk into the ``keep`` mask of
    ``ops.exact_topk.exact_topk``. Excluded rows score +inf; rows that
    survive with +inf are trimmed by the caller (a query may match fewer
    than k rows). Reference: filter + vector index pushdown,
    pushdown.rs:167-207."""
    from ..ops.exact_topk import exact_topk
    norms = torch.sum(x * x, -1) if metric == "l2" else None
    base = ((torch.arange(x.shape[0], device=x.device) < n_valid)
            & smask)[None, :]
    parts = []
    for start in range(0, Q.shape[0], _QUERY_CHUNK):
        qb = Q[start:start + _QUERY_CHUNK]
        m = base
        for op, col, fv in zip(f_ops, fcols, fvals):
            m = m & _cmp(op, col[None, :],
                         fv[start:start + _QUERY_CHUNK, None])
        parts.append(exact_topk(qb, x, k, metric, x_sq_norms=norms,
                                x_normalized=(metric == "cosine"),
                                keep=m.contiguous()))
    vals = torch.cat([v for v, _ in parts])
    ids = torch.cat([i for _, i in parts])
    if metric == "l2":
        # +inf marks "fewer than k matches" — survive the re-score
        vals = torch.where(torch.isinf(vals), vals, _rescore_l2(Q, x, ids))
    return vals, ids.to(torch.int32)


class _KnnServer:
    """Bound KNN serving state: the stacked HBM corpus + host projection
    block for one table snapshot; ONE device dispatch per query batch."""

    def __init__(self, ctx, shape: _KnnShape):
        self.ctx = ctx
        self.shape = shape
        self._snap_id: Optional[str] = None
        self._x = None              # [N, d] device array
        self._proj: Optional[DataBlock] = None
        self._proj_names: List[tuple] = []  # (src_name, out_name) per col item
        self._dim = 0
        self._n = 0
        # WHERE pushdown state (device-resident per snapshot)
        self._static_mask = None    # [N] bool device array (None = no WHERE)
        self._fcols: List[Any] = []      # per param filter: [N] device array
        self._fdicts: List[Optional[dict]] = []  # str value -> code maps
        self._fkinds: List[str] = []     # 'int' | 'float' | 'str'

    # Returns False when the fast path cannot serve (no index / view /
    # missing table state) — caller falls back to the generic path.
    def refresh(self) -> bool:
        sh = self.shape
        try:
            table = self.ctx.table(sh.table, sh.database)
        except Exception:
            return False
        info = getattr(table, "info", None)
        if info is None:
            return False
        self._table = table
        metric = _DISTANCE_FNS[sh.metric_fn]
        col_ok = False
        try:
            f = table.schema.field(sh.column)
        except Exception:
            return False
        vt = f.dtype.remove_nullable()
        if not isinstance(vt, VectorType):
            return False
        for idx in info.vector_indexes():
            distances = [m.strip() for m in
                         idx.options.get("distance", "cosine").split(",")]
            if idx.columns[0].lower() == sh.column.lower() \
                    and metric in distances:
                col_ok = True
                break
        if not col_ok:
            return False
        snap = table.read_snapshot()
        if snap is None:
            self._snap_id, self._n = None, 0
            return True
        if snap.snapshot_id == self._snap_id:
            return True
        metas = [m for seg in table.read_segments(snap) for m in seg.blocks]
        if not metas:
            self._snap_id, self._n = snap.snapshot_id, 0
            return True
        self._x, _ = table.stacked_device_vectors(
            metas, sh.column, normalized=(metric == "cosine"))
        self._dim = vt.dim
        self._n = sum(m.row_count for m in metas)
        # host projection block in corpus row order
        proj: List[tuple] = []
        for kind, name, out in sh.items:
            if kind == "star":
                for fname in table.schema.field_names():
                    proj.append((fname, fname))
            elif kind == "col":
                proj.append((table.schema.field(name).name, out))
        self._proj_names = proj
        src_names = list(dict.fromkeys(n for n, _ in proj))
        if src_names:
            self._proj = DataBlock.concat(
                [table.read_block(m, src_names) for m in metas])
        else:
            self._proj = None
        if not self._setup_filters(table, metas):
            return False
        self._table = table
        self._snap_id = snap.snapshot_id
        return True

    def _setup_filters(self, table, metas) -> bool:
        """Build the per-snapshot device state: the cache key of the
        snapshot's corpus (that of ``stacked_device_vectors``, for the flash
        state), then the WHERE state: one host-evaluated static mask +
        per-param-filter resident columns. Returns False (generic fallback)
        when the predicate or a column type is outside the servable
        grammar."""
        sh = self.shape
        self._corpus_key = (tuple(table.abs_path(m.location) for m in metas),
                            sh.column.lower(),
                            _DISTANCE_FNS[sh.metric_fn] == "cosine")
        self._static_mask, self._fcols = None, []
        self._fdicts, self._fkinds = [], []
        if sh.where_static is None and not sh.where_params:
            return True
        from .filter_eval import Unsupported, eval_mask, referenced_columns
        need = list(dict.fromkeys(
            referenced_columns(sh.where_static)
            + [pf.column.lower() for pf in (sh.where_params or [])]))
        cols = []
        for name in need:
            try:
                cols.append(table.schema.field(name).name)
            except Exception:
                return False
        fblock = DataBlock.concat([table.read_block(m, cols) for m in metas])
        if sh.where_static is not None:
            try:
                mask = eval_mask(fblock, sh.where_static)
            except Unsupported:
                return False
        else:
            mask = np.ones(len(fblock), bool)
        for pf in sh.where_params or []:
            col = fblock.column(table.schema.field(pf.column).name)
            if col.validity is not None:
                # NULL never satisfies any comparison
                mask = mask & col.validity
            data = col.data
            if isinstance(data, np.ndarray) and data.ndim == 1 \
                    and np.issubdtype(data.dtype, np.integer):
                if len(data) and (data.min() < -2**31
                                  or data.max() >= 2**31):
                    return False   # beyond device int32 — generic path
                self._fcols.append(backend.to_device(data.astype(np.int32)))
                self._fdicts.append(None)
                self._fkinds.append("int")
            elif isinstance(data, np.ndarray) and data.ndim == 1 \
                    and np.issubdtype(data.dtype, np.floating):
                self._fcols.append(backend.to_device(data.astype(np.float32)))
                self._fdicts.append(None)
                self._fkinds.append("float")
            elif hasattr(data, "as_object_array"):
                if pf.op not in ("=", "==", "!=", "<>"):
                    return False   # ordering on dictionary codes is wrong
                vals = data.as_object_array()
                uniq, codes = np.unique(vals, return_inverse=True)
                self._fcols.append(backend.to_device(codes.astype(np.int32)))
                self._fdicts.append({v: i for i, v in enumerate(uniq)})
                self._fkinds.append("str")
            else:
                return False
        self._static_mask = backend.to_device(np.asarray(mask, bool))
        return True

    def convert_filter_params(self, param_sets_cols: List[list]
                              ) -> Optional[List[np.ndarray]]:
        """Per param filter, the [B] operand array in device dtype; None
        when a value can't convert (caller falls back)."""
        out = []
        for j, vals in enumerate(param_sets_cols):
            kind = self._fkinds[j]
            try:
                if kind == "str":
                    d = self._fdicts[j]
                    arr = np.array([d.get(v, -1) for v in vals], np.int32)
                elif kind == "int":
                    arr = np.array([int(v) for v in vals], np.int64)
                    if len(arr) and (arr.min() < -2**31
                                     or arr.max() >= 2**31):
                        return None
                    arr = arr.astype(np.int32)
                else:
                    arr = np.array([float(v) for v in vals], np.float32)
            except (TypeError, ValueError):
                return None
            out.append(arr)
        return out

    @property
    def has_filters(self) -> bool:
        return (self.shape.where_static is not None
                or bool(self.shape.where_params))

    def _empty_fields(self) -> List[DataField]:
        """Output schema for an empty table (no corpus loaded yet)."""
        out = []
        for kind, name, outn in self.shape.items:
            if kind == "star":
                for f in self._table.schema.fields:
                    out.append(DataField(f.name, f.dtype))
            elif kind == "col":
                f = self._table.schema.field(name)
                out.append(DataField(outn, f.dtype))
            else:
                out.append(DataField(outn, Float32))
        return out

    def _fields(self) -> List[DataField]:
        out = []
        by_src = {}
        if self._proj is not None:
            by_src = dict(self._proj.items())
        for kind, name, outn in self.shape.items:
            if kind == "star":
                for fname in self._table.schema.field_names():
                    out.append(DataField(fname, by_src[fname].dtype))
            elif kind == "col":
                src = self._table.schema.field(name).name
                out.append(DataField(outn, by_src[src].dtype))
            else:
                out.append(DataField(outn, Float32))
        return out

    def _check_queries(self, queries: np.ndarray) -> np.ndarray:
        Q = np.asarray(queries, np.float32)
        if Q.ndim == 1:
            Q = Q[None, :]
        if self._n and Q.shape[1] != self._dim:
            raise SemanticError(
                f"{self.shape.metric_fn}: vector dims differ "
                f"({self._dim} vs {Q.shape[1]})")
        return Q

    def _flash_state(self):
        """(bf16 corpus padded to FLASH_TILE rows and D % 16 == 0, norms)
        for approximate serving. Built at the first approximate call on a
        snapshot and cached beside the stacked corpus, so the statements
        over one snapshot and column share one copy. l2 keeps exact f32
        norms; cosine uses the normalized corpus with zero norms (metric
        ip). Pad rows carry +inf norms."""
        x = self._x
        normalized = self._corpus_key[2]

        def load():
            from ..ops.flash_topk import pad_for_flash
            xb = x.to(torch.bfloat16)
            if x.shape[1] % 16:
                xb = torch.nn.functional.pad(xb, (0, 16 - x.shape[1] % 16))
            norms = x.new_zeros(x.shape[0]) if normalized \
                else torch.sum(x * x, -1)
            xb, norms, _ = pad_for_flash(xb, norms, FLASH_TILE)
            return xb.contiguous(), norms.contiguous()

        cm = CacheManager.instance().vector_columns
        return cm.get_or_load(("flash",) + self._corpus_key, load)

    def _flash_select(self, Q: torch.Tensor, metric: str, k: int):
        """Approximate top-k through flash_topk, per query chunk: l2 returns
        the square root of the exact squared distance, cosine ``1 - dot``."""
        from ..ops.distance import normalize
        from ..ops.flash_topk import flash_topk
        xb, norms = self._flash_state()
        vals, ids = [], []
        for qb in torch.split(Q, _QUERY_CHUNK):
            if metric == "cosine":
                qb = normalize(qb)
            v, i = flash_topk(qb, xb, norms, self._x, k,
                              "l2" if metric == "l2" else "ip",
                              tile=FLASH_TILE, buckets=FLASH_LANES,
                              n_valid=self._n)
            vals.append(torch.sqrt(torch.clamp_min(v, 0.0)) if metric == "l2"
                        else 1.0 + v)
            ids.append(i)
        return torch.cat(vals), torch.cat(ids).to(torch.int32)

    def _topk(self, Q: np.ndarray, exact: bool = True,
              fvals: Optional[List[np.ndarray]] = None):
        """Device top-k for the whole batch + ONE bulk projection gather.
        Returns (vals [B,k], ids [B,k], taken_all [B*k rows], k).
        ``exact=False`` on a batch of more than one 256-query chunk selects
        through ``flash_topk`` (unfiltered l2 / cosine); a batch of one
        chunk runs the exact program, as the reference does."""
        metric = _DISTANCE_FNS[self.shape.metric_fn]
        k = min(self.shape.k, self._n)
        if self._static_mask is not None:
            return self._topk_filtered(Q, exact, fvals or [], metric, k)
        Qd = backend.to_device(Q)
        if not exact and Q.shape[0] > _QUERY_CHUNK and self._n \
                and metric in ("l2", "cosine"):
            vals, ids = self._flash_select(Qd, metric, k)
        else:
            vals, ids = _scan_topk_program(Qd, self._x, k, metric, self._n)
        vals, ids = backend.to_numpy([vals, ids])
        # ONE bulk gather for all B result sets; per-query blocks are
        # zero-copy slices of it
        taken_all = (self._proj.take(ids.reshape(-1))
                     if self._proj is not None else None)
        return vals, ids, taken_all, k

    def _topk_filtered(self, Q: np.ndarray, exact: bool,
                       fvals: List[np.ndarray], metric: str, k: int):
        """Filtered variant: the static mask + per-query operand
        comparisons (see _scan_topk_filtered_program). Exact in both
        modes."""
        f_ops = tuple(pf.op for pf in self.shape.where_params or [])
        vals, ids = _scan_topk_filtered_program(
            backend.to_device(Q), self._x, k, metric, self._n,
            self._static_mask, self._fcols,
            [backend.to_device(v) for v in fvals], f_ops)
        vals, ids = backend.to_numpy([vals, ids])
        taken_all = (self._proj.take(ids.reshape(-1))
                     if self._proj is not None else None)
        return vals, ids, taken_all, k

    def _empty_result(self):
        from .session import QueryResult
        fields = self._empty_fields()
        return QueryResult(
            DataBlock([f.name for f in fields],
                      [Column.from_pylist([], f.dtype) for f in fields]),
            fields)

    def run_batch(self, queries: np.ndarray, exact: bool = True,
                  fvals: Optional[List[np.ndarray]] = None):
        from .session import QueryResult
        sh = self.shape
        Q = self._check_queries(queries)
        if self._n == 0:
            return [self._empty_result() for _ in range(Q.shape[0])]
        vals, ids, taken_all, k = self._topk(Q, exact, fvals)
        fields = self._fields()
        schema_names = self._table.schema.field_names()
        filtered = self._static_mask is not None
        out = []
        for b in range(Q.shape[0]):
            taken = (taken_all.slice(b * k, (b + 1) * k)
                     if taken_all is not None else None)
            keep = None
            vb = np.asarray(vals[b], np.float32)
            if filtered and not np.isfinite(vb).all():
                # fewer than k rows matched this query's predicate
                keep = np.isfinite(vb)
                vb = vb[keep]
                if taken is not None:
                    taken = taken.filter(keep)
            cols, names = [], []
            for kind, name, outn in sh.items:
                if kind == "star":
                    for fname in schema_names:
                        names.append(fname)
                        cols.append(taken.column(fname))
                elif kind == "col":
                    src = self._table.schema.field(name).name
                    names.append(outn)
                    cols.append(taken.column(src))
                else:
                    names.append(outn)
                    cols.append(Column(Float32, vb))
            out.append(QueryResult(DataBlock(names, cols), fields))
        return out

    def run_batch_block(self, queries: np.ndarray, exact: bool = True,
                        fvals: Optional[List[np.ndarray]] = None):
        """Bulk-serving mode: ONE QueryResult for the whole batch with a
        leading ``query_index`` column (row b*k+j belongs to query b, rank
        j). No per-query object churn — pure bulk numpy construction, the
        batch analog of the FAISS-style [B, k] return shape."""
        from ..types import Int64
        from .session import QueryResult
        sh = self.shape
        Q = self._check_queries(queries)
        B = Q.shape[0]
        if self._n == 0:
            fields = [DataField("query_index", Int64)] + self._empty_fields()
            return QueryResult(
                DataBlock([f.name for f in fields],
                          [Column.from_pylist([], f.dtype) for f in fields]),
                fields)
        vals, ids, taken_all, k = self._topk(Q, exact, fvals)
        qidx = np.repeat(np.arange(B, dtype=np.int64), k)
        flat_vals = np.ascontiguousarray(vals.reshape(-1), np.float32)
        if self._static_mask is not None and not np.isfinite(flat_vals).all():
            keep = np.isfinite(flat_vals)
            qidx, flat_vals = qidx[keep], flat_vals[keep]
            if taken_all is not None:
                taken_all = taken_all.filter(keep)
        names = ["query_index"]
        cols = [Column(Int64, qidx)]
        fields = [DataField("query_index", Int64)] + self._fields()
        for kind, name, outn in sh.items:
            if kind == "star":
                for fname in self._table.schema.field_names():
                    names.append(fname)
                    cols.append(taken_all.column(fname))
            elif kind == "col":
                src = self._table.schema.field(name).name
                names.append(outn)
                cols.append(taken_all.column(src))
            else:
                names.append(outn)
                cols.append(Column(Float32, flat_vals))
        return QueryResult(DataBlock(names, cols), fields)


# -------------------------------------------------------- match() fast path
@dataclass
class _MatchShape:
    """`SELECT .. FROM t WHERE match(col, ?) ORDER BY score() DESC LIMIT k`
    — the canonical full-text serving statement (reference: match()
    pushdown + tantivy TopDocs order_by_score,
    inverted_index_reader.rs:108-150)."""
    database: Optional[str]
    table: str
    column: Optional[str]
    k: int
    items: List[tuple]   # ("col",name,out) | ("star",..) | ("score",None,out)
    param_index: int
    fuzziness: Optional[int]
    operator: str
    # fusion (`ORDER BY a*score() + b*dist(emb, ?)`): weights are stored
    # maximization-normalized (ASC orders negate both)
    w_score: float = 1.0
    w_dist: float = 0.0
    emb_column: Optional[str] = None
    dist_fn: Optional[str] = None
    dist_param_index: Optional[int] = None

    @property
    def fused(self) -> bool:
        return self.emb_column is not None


def _parse_fused_order(e: A.Expr):
    """Parse a linear combination of score() and one distance call:
    ``[lit *] score() ± [lit *] dist(col, ?)`` in any order/sign.
    Returns (w_score, w_dist, dist_call) or None."""
    terms: List[tuple] = []

    def walk(node, sign):
        if isinstance(node, A.BinaryOp) and node.op in ("+", "-"):
            return (walk(node.left, sign)
                    and walk(node.right,
                             sign if node.op == "+" else -sign))
        if isinstance(node, A.UnaryOp) and node.op == "-":
            return walk(node.operand, -sign)
        coef, fn = 1.0, node
        if isinstance(node, A.BinaryOp) and node.op == "*":
            l, r = node.left, node.right
            if isinstance(l, A.Literal) and isinstance(l.value, (int, float)):
                coef, fn = float(l.value), r
            elif isinstance(r, A.Literal) \
                    and isinstance(r.value, (int, float)):
                coef, fn = float(r.value), l
            else:
                return False
        terms.append((sign * coef, fn))
        return True

    if not walk(e, 1.0):
        return None
    w_s, w_d, dist_call = 0.0, 0.0, None
    for coef, fn in terms:
        if isinstance(fn, A.FunctionCall) and fn.name.lower() == "score" \
                and not fn.args:
            w_s += coef
        elif isinstance(fn, A.FunctionCall) \
                and fn.name.lower() in ("cosine_distance", "l2_distance") \
                and len(fn.args) == 2 \
                and isinstance(fn.args[0], A.ColumnRef) \
                and isinstance(fn.args[1], A.Placeholder):
            if dist_call is not None:
                return None
            w_d += coef
            dist_call = fn
        else:
            return None
    if dist_call is None or w_d == 0.0:
        return None
    return w_s, w_d, dist_call


def match_match_shape(stmt: A.Statement) -> Optional[_MatchShape]:
    if not isinstance(stmt, A.QueryStmt):
        return None
    q = stmt.query
    if q.ctes or q.offset is not None or len(q.order_by) != 1:
        return None
    if not isinstance(q.limit, A.Literal) or not isinstance(q.limit.value, int):
        return None
    body = q.body
    if not isinstance(body, A.SelectStmt):
        return None
    if (body.group_by or body.having or body.distinct or body.group_sets
            or body.qualify or body.group_all):
        return None
    if not isinstance(body.from_, A.TableName) or body.from_.at_snapshot:
        return None
    ob = q.order_by[0]
    if ob.nulls_first:
        return None
    w_score, w_dist = 1.0, 0.0
    emb_col = dist_fn = dist_pidx = None
    if isinstance(ob.expr, A.FunctionCall) \
            and ob.expr.name.lower() == "score" and not ob.expr.args:
        if ob.asc:                     # pure BM25 orders DESC only
            return None
    else:
        fo = _parse_fused_order(ob.expr)
        if fo is None:
            return None
        w_score, w_dist, dist_call = fo
        if ob.asc:                     # normalize to maximization
            w_score, w_dist = -w_score, -w_dist
        emb_col = dist_call.args[0].name
        dist_fn = dist_call.name.lower()
        dist_pidx = dist_call.args[1].index
    w = body.where
    if not (isinstance(w, A.FunctionCall) and w.name.lower() == "match"
            and len(w.args) in (2, 3)):
        return None
    if not (isinstance(w.args[0], A.ColumnRef)
            and isinstance(w.args[1], A.Placeholder)):
        return None
    fuzziness, operator = None, "OR"
    if len(w.args) == 3:
        if not isinstance(w.args[2], A.Literal):
            return None
        for part in str(w.args[2].value).split(";"):
            if "=" in part:
                kk, v = part.split("=", 1)
                if kk.strip() == "fuzziness":
                    fuzziness = int(v)
                elif kk.strip() == "operator":
                    operator = v.strip().upper()
    items: List[tuple] = []
    for it in body.items:
        ex = it.expr
        if isinstance(ex, A.Star):
            items.append(("star", None, None))
        elif isinstance(ex, A.ColumnRef):
            items.append(("col", ex.name, it.alias or ex.name))
        elif isinstance(ex, A.FunctionCall) and ex.name.lower() == "score" \
                and not ex.args:
            if emb_col is not None:
                return None   # fused ranking has no per-row BM25 output
            items.append(("score", None, it.alias or "score()"))
        else:
            return None
    return _MatchShape(body.from_.database, body.from_.name, w.args[0].name,
                       int(q.limit.value), items, w.args[1].index,
                       fuzziness, operator, w_score, w_dist,
                       emb_col, dist_fn, dist_pidx)


class _MatchServer:
    """Bound full-text serving state: per-block device-resident ImpactBM25
    scorers (dense doc-major layout, index/inverted/device.py) + a host
    projection block. A batch of query strings tokenizes host-side and
    runs ONE scoring kernel and one top-k per block; per-query global top-k
    merges across blocks on host (k rows each). This is the SQL product path
    of the batched BM25 kernel (``ops.impact_bm25``)."""

    # below this corpus size the generic path scores on the host: served
    # match() beats it from the smallest table measured, 2,000 docs (B = 1:
    # 2.2-2.3 against 5.4-7.4 ms; B = 8: 2.3-2.4 against 28-43 ms; NVIDIA
    # H100 80GB HBM3, 700.00 W; chip_smoke.py --gates)
    DEVICE_MIN_DOCS = 2_000

    def __init__(self, ctx, shape: _MatchShape):
        self.ctx = ctx
        self.shape = shape
        self._snap_id: Optional[str] = None
        self._scorers: List[Any] = []
        self._readers: List[Any] = []
        self._bases: List[int] = []
        self._proj: Optional[DataBlock] = None
        self._n = 0

    def refresh(self) -> bool:
        from ..utils.cache import CacheManager
        from ..index.inverted.reader import InvertedBlockReader
        from ..index.inverted.device import ImpactBM25
        sh = self.shape
        try:
            table = self.ctx.table(sh.table, sh.database)
        except Exception:
            return False
        info = getattr(table, "info", None)
        if info is None:
            return False
        indexes = info.inverted_indexes()
        if not indexes:
            return False
        cols = [sh.column.lower()] if sh.column else []
        idx = next((i for i in indexes
                    if not cols or cols[0] in [c.lower() for c in i.columns]),
                   indexes[0] if not cols else None)
        if idx is None:
            return False
        self._table = table
        snap = table.read_snapshot()
        if snap is None:
            self._snap_id, self._n = None, 0
            return True
        if snap.snapshot_id == self._snap_id:
            return True
        metas = [m for seg in table.read_segments(snap) for m in seg.blocks]
        if not metas:
            self._snap_id, self._n = snap.snapshot_id, 0
            return True
        cm = CacheManager.instance().inverted_indexes
        readers, scorers, bases = [], [], []
        base = 0
        for m in metas:
            entry = m.inverted_indexes.get(idx.name)
            if entry is None:
                return False    # block not indexed yet: generic path
            path = table.abs_path(entry["location"])
            reader = cm.get_or_load(
                path, lambda p=path: InvertedBlockReader.load(p))
            scorer = getattr(reader, "_impact_scorer", None)
            if scorer is None:
                scorer = ImpactBM25.try_create(reader)
                reader._impact_scorer = scorer or False
            elif scorer is False:
                scorer = None
            if scorer is None and reader.n_docs >= self.DEVICE_MIN_DOCS:
                # CSR batch program as the fallback dense layout can't take
                scorer = reader._device_bm25()
            readers.append(reader)
            scorers.append(scorer)
            bases.append(base)
            base += m.row_count
        self._n = base
        if self._n < self.DEVICE_MIN_DOCS:
            return False        # host path below the gate
        if sh.fused and not self._setup_fusion(table, metas, scorers):
            return False
        self._readers, self._scorers, self._bases = readers, scorers, bases
        # host projection block in corpus row order
        proj_srcs = []
        for kind, name, out in sh.items:
            if kind == "star":
                proj_srcs.extend(table.schema.field_names())
            elif kind == "col":
                proj_srcs.append(table.schema.field(name).name)
        proj_srcs = list(dict.fromkeys(proj_srcs))
        self._proj = (DataBlock.concat(
            [table.read_block(m, proj_srcs) for m in metas])
            if proj_srcs else None)
        self._snap_id = snap.snapshot_id
        return True

    def _setup_fusion(self, table, metas, scorers) -> bool:
        """Per-block padded embedding slices, device-resident, for the
        fused text+vector program (cosine rows pre-normalized)."""
        from ..index.inverted.device import ImpactBM25
        sh = self.shape
        try:
            f = table.schema.field(sh.emb_column)
        except Exception:
            return False
        vt = f.dtype.remove_nullable()
        if not isinstance(vt, VectorType):
            return False
        self._dim = vt.dim
        metric = _DISTANCE_FNS[sh.dist_fn]
        embs = []
        for m, scorer in zip(metas, scorers):
            if not isinstance(scorer, ImpactBM25):
                return False   # the CSR fallback has no fused program
            e = np.asarray(table.read_block(m, [f.name])
                           .column(f.name).numpy(), np.float32)
            if metric == "cosine":
                e = e / np.maximum(
                    np.linalg.norm(e, axis=1, keepdims=True), 1e-30)
            pad = scorer.n_pad - e.shape[0]
            if pad:
                e = np.concatenate(
                    [e, np.zeros((pad, e.shape[1]), np.float32)])
            embs.append(backend.to_device(e))
        self._embs = embs
        return True

    # ---------------------------------------------------------- gate checks
    @staticmethod
    def _servable_text(t) -> bool:
        if not isinstance(t, str):
            return False
        t = t.strip()
        # quoted phrases need the positions path — generic fallback
        return not (len(t) >= 2 and t.startswith('"') and t.endswith('"'))

    def extract_batch(self, param_sets, param_count: int):
        """-> (texts, Q or None): the query strings and, for fused shapes,
        the [B, d] vector batch. None when the sets don't fit."""
        texts, vecs = [], []
        for ps in param_sets:
            if isinstance(ps, str):
                if param_count != 1:
                    return None
                texts.append(ps)
                continue
            if not isinstance(ps, (list, tuple)) or len(ps) != param_count:
                return None
            t = ps[self.shape.param_index]
            if not isinstance(t, str):
                return None
            texts.append(t)
            if self.shape.fused:
                try:
                    v = np.asarray(ps[self.shape.dist_param_index],
                                   np.float32)
                except (TypeError, ValueError):
                    return None
                if v.ndim != 1:
                    return None
                vecs.append(v)
        if self.shape.fused:
            if len(vecs) != len(texts) \
                    or any(v.shape != vecs[0].shape for v in vecs):
                return None
            return texts, np.stack(vecs)
        return texts, None

    def can_serve_texts(self, texts: List[str]) -> bool:
        return all(self._servable_text(t) for t in texts) and self.refresh()

    # ------------------------------------------------------------- serving
    def _term_groups(self, reader, tokens: List[str]) -> List[List[int]]:
        fz = self.shape.fuzziness
        if fz:
            return [reader.fuzzy_term_ids(t, int(fz)) for t in tokens]
        return [[reader.term_id(t)] for t in tokens]

    def run_batch(self, texts: List[str], Q: Optional[np.ndarray] = None
                  ) -> Optional[List["QueryResult"]]:
        """One device program per block for the whole batch; per-query
        top-k merge across blocks host-side. None -> caller falls back.
        Fused shapes take the [B, d] query-vector batch in ``Q`` and rank
        by the combined w_s*bm25 + w_d*dist (maximization-normalized)."""
        from ..index.inverted.tokenizer import tokenize_text
        from ..types import Int64
        from .session import QueryResult
        sh = self.shape
        k = sh.k
        B = len(texts)
        if self._n == 0:
            return [self._empty_result() for _ in range(B)]
        metric = None
        if sh.fused:
            if Q is None:
                return None
            Q = np.asarray(Q, np.float32)
            if Q.ndim != 2 or Q.shape[0] != B or Q.shape[1] != self._dim:
                return None
            metric = _DISTANCE_FNS[sh.dist_fn]
        tok_cache = {}
        r0 = self._readers[0]
        tokens_per_q = []
        for t in texts:
            key = t
            if key not in tok_cache:
                tok_cache[key] = tokenize_text(t, r0.tokenizer, r0.filters)
            tokens_per_q.append(tok_cache[key])
        # per-block batched scoring (device): dispatch EVERY block's
        # scoring first, then fetch: the card scores one block while the
        # host packs the next, and nothing waits in between. Small
        # unindexed-impact blocks score host-side.
        merged_rows = [[] for _ in range(B)]
        merged_scores = [[] for _ in range(B)]
        pending = []  # (scorer|None, handle_or_results)
        for bi, (reader, scorer, base) in enumerate(
                zip(self._readers, self._scorers, self._bases)):
            groups = [self._term_groups(reader, toks)
                      for toks in tokens_per_q]
            if sh.fused:
                pending.append((scorer, scorer.dispatch_fused_top_k_batch(
                    groups, k, sh.operator, self._embs[bi], Q,
                    sh.w_score, sh.w_dist, metric)))
            elif scorer is not None:
                pending.append((scorer, scorer.dispatch_top_k_batch(
                    groups, k, sh.operator)))
            else:
                results = []
                for tg in groups:
                    rows, scores = reader.bm25_scores(tg, sh.operator)
                    if len(rows) > k:
                        sel = np.argpartition(-scores, k - 1)[:k]
                        rows, scores = rows[sel], scores[sel]
                    results.append((rows, scores))
                pending.append((None, results))
        for (scorer, item), base in zip(pending, self._bases):
            results = item if scorer is None else scorer.collect(item)
            for qi, (rows, scores) in enumerate(results):
                if len(rows):
                    merged_rows[qi].append(rows + base)
                    merged_scores[qi].append(scores)
        out = []
        fields = self._fields()
        all_rows, all_scores, counts = [], [], []
        for qi in range(B):
            if merged_rows[qi]:
                rows = np.concatenate(merged_rows[qi])
                scores = np.concatenate(merged_scores[qi])
                order = np.argsort(-scores, kind="stable")[:k]
                rows, scores = rows[order], scores[order]
            else:
                rows = np.zeros(0, np.int64)
                scores = np.zeros(0, np.float32)
            all_rows.append(rows)
            all_scores.append(scores)
            counts.append(len(rows))
        # ONE bulk projection gather for the whole batch
        flat = np.concatenate(all_rows) if all_rows else np.zeros(0, np.int64)
        taken_all = self._proj.take(flat) if self._proj is not None else None
        off = 0
        schema_names = self._table.schema.field_names()
        for qi in range(B):
            cnt = counts[qi]
            taken = (taken_all.slice(off, off + cnt)
                     if taken_all is not None else None)
            off += cnt
            names, cols = [], []
            for kind, name, outn in sh.items:
                if kind == "star":
                    for fname in schema_names:
                        names.append(fname)
                        cols.append(taken.column(fname))
                elif kind == "col":
                    src = self._table.schema.field(name).name
                    names.append(outn)
                    cols.append(taken.column(src))
                else:
                    names.append(outn)
                    cols.append(Column(Float32, all_scores[qi]))
            out.append(QueryResult(DataBlock(names, cols), fields))
        return out

    def _fields(self) -> List[DataField]:
        out = []
        for kind, name, outn in self.shape.items:
            if kind == "star":
                for f in self._table.schema.fields:
                    out.append(DataField(f.name, f.dtype))
            elif kind == "col":
                f = self._table.schema.field(name)
                out.append(DataField(outn, f.dtype))
            else:
                out.append(DataField(outn, Float32))
        return out

    def _empty_result(self):
        from .session import QueryResult
        fields = self._fields()
        return QueryResult(
            DataBlock([f.name for f in fields],
                      [Column.from_pylist([], f.dtype) for f in fields]),
            fields)


# ------------------------------------------------------------------ statement
class PreparedStatement:
    """Parse-once / bind-once statement handle (``ctx.prepare(sql)``).

    ``execute(*params)`` substitutes into the cached AST — no re-parse.
    ``execute_batch`` serves B parameter sets; for the canonical KNN
    shape all B run as ONE device program (the product-path analog of
    the kernel benchmark batch)."""

    def __init__(self, ctx, sql: str):
        self.ctx = ctx
        self.sql = sql
        p = Parser(sql)
        self.stmt = p.parse()
        self.param_count = max(p.param_count, count_params(self.stmt))
        shape = match_knn_shape(self.stmt)
        self._knn = _KnnServer(ctx, shape) if shape is not None else None
        mshape = match_match_shape(self.stmt) if shape is None else None
        self._match = _MatchServer(ctx, mshape) if mshape is not None \
            else None

    def execute(self, *params) -> "QueryResult":
        if len(params) != self.param_count:
            raise BadArguments(
                f"prepared statement expects {self.param_count} parameters,"
                f" got {len(params)}")
        if self._knn is not None and self._params_agree(params) \
                and self._knn.refresh():
            if self._knn.has_filters:
                parsed = self._split_param_sets([params])
                if parsed is not None:
                    Q, fvals = parsed
                    return self._knn.run_batch(Q, fvals=fvals)[0]
            else:
                q = np.asarray(params[self._knn.shape.param_index],
                               np.float32)
                return self._knn.run_batch(
                    q[None, :] if q.ndim == 1 else q)[0]
        if self._match is not None:
            ext = self._match.extract_batch([params], self.param_count)
            if ext is not None and self._match.can_serve_texts(ext[0]):
                res = self._match.run_batch(ext[0], ext[1])
                if res is not None:
                    return res[0]
        stmt = substitute_params(self.stmt, params)
        return self.ctx._execute_statement(stmt)

    def execute_batch(self, param_sets, exact: bool = True
                      ) -> List["QueryResult"]:
        """``param_sets``: a list of per-execution parameter tuples, or —
        for single-parameter KNN statements — a ``[B, d]`` array of query
        vectors. Returns one QueryResult per execution. ``exact=False``
        selects with the TPU approx k-selector (recall_target 0.99,
        ~an order of magnitude cheaper than the full sort)."""
        if self._knn is not None and self._knn.refresh():
            if self._knn.has_filters:
                norm = self._normalize_sets(param_sets)
                parsed = self._split_param_sets(norm) if norm is not None \
                    else None
                if parsed is not None:
                    Q, fvals = parsed
                    return self._knn.run_batch(Q, exact, fvals)
            else:
                arr = self._as_query_matrix(param_sets)
                if arr is not None:
                    return self._knn.run_batch(arr, exact)
        if self._match is not None:
            ext = self._match.extract_batch(param_sets, self.param_count)
            if ext is not None and self._match.can_serve_texts(ext[0]):
                res = self._match.run_batch(ext[0], ext[1])
                if res is not None:
                    return res
        out = []
        for ps in param_sets:
            if not isinstance(ps, (list, tuple)):
                ps = (ps,)
            # a single vector parameter may be passed as the bare list
            if self.param_count == 1 and len(ps) != 1 \
                    and self._match is None:
                ps = (list(ps),)
            out.append(self.execute(*ps))
        return out

    def _normalize_sets(self, param_sets) -> Optional[List[tuple]]:
        out = []
        for ps in param_sets:
            if not isinstance(ps, (list, tuple)):
                return None
            if len(ps) != self.param_count:
                return None
            out.append(tuple(ps))
        return out

    def _split_param_sets(self, param_sets):
        """For filtered KNN statements: split full parameter tuples into
        (Q [B, d], per-filter operand arrays). None -> generic fallback."""
        sh = self._knn.shape
        pfs = sh.where_params or []
        rows, fraw = [], [[] for _ in pfs]
        vec_idx = sorted(set(sh.param_indices))
        for ps in param_sets:
            if not isinstance(ps, (list, tuple)) \
                    or len(ps) != self.param_count:
                return None
            try:
                vs = [np.asarray(ps[i], np.float32) for i in vec_idx]
            except (TypeError, ValueError):
                return None
            if vs[0].ndim != 1 \
                    or any(not np.array_equal(vs[0], v) for v in vs[1:]):
                return None
            rows.append(vs[0])
            for j, pf in enumerate(pfs):
                fraw[j].append(ps[pf.param_index])
        if not rows or any(r.shape != rows[0].shape for r in rows):
            return None
        fvals = self._knn.convert_filter_params(fraw)
        if fvals is None:
            return None
        return np.stack(rows), fvals

    def _params_agree(self, params) -> bool:
        """All placeholders bound to the query vector hold equal values."""
        idxs = self._knn.shape.param_indices
        if len(idxs) <= 1:
            return True
        first = np.asarray(params[idxs[0]], np.float32)
        return all(np.array_equal(first,
                                  np.asarray(params[i], np.float32))
                   for i in idxs[1:])

    def execute_batch_block(self, param_sets, exact: bool = True
                            ) -> "QueryResult":
        """Bulk-serving variant of ``execute_batch``: ONE result block for
        the whole batch with a leading ``query_index`` column. Only the
        KNN fast path supports it (raises otherwise) — this is the shape
        high-throughput serving loops should use."""
        if self._knn is None or not self._knn.refresh():
            raise BadArguments(
                "execute_batch_block requires the batched KNN fast path "
                "(single indexed table, ORDER BY distance LIMIT k)")
        if self._knn.has_filters:
            norm = self._normalize_sets(param_sets)
            parsed = self._split_param_sets(norm) if norm is not None \
                else None
            if parsed is None:
                raise BadArguments(
                    "execute_batch_block expects full parameter tuples "
                    "(query vector + filter operands)")
            Q, fvals = parsed
            return self._knn.run_batch_block(Q, exact, fvals)
        arr = self._as_query_matrix(param_sets)
        if arr is None:
            raise BadArguments(
                "execute_batch_block expects a [B, dim] batch of query "
                "vectors")
        return self._knn.run_batch_block(arr, exact)

    def _as_query_matrix(self, param_sets) -> Optional[np.ndarray]:
        """[B, d] f32 matrix when every param set is just one vector."""
        if self.param_count != len(self._knn.shape.param_indices):
            return None
        if self.param_count != 1:
            # same vector repeated across placeholders: accept tuples of
            # equal vectors, normalize to the single-vector form
            rows = []
            for ps in param_sets:
                if not isinstance(ps, (list, tuple)) \
                        or len(ps) != self.param_count:
                    return None
                vs = [np.asarray(p, np.float32) for p in ps]
                if any(not np.array_equal(vs[0], v) for v in vs[1:]):
                    return None
                rows.append(vs[0])
            if not rows or any(r.shape != rows[0].shape for r in rows):
                return None
            return np.stack(rows)
        if isinstance(param_sets, np.ndarray) and param_sets.ndim == 2:
            return np.asarray(param_sets, np.float32)
        rows = []
        for ps in param_sets:
            if isinstance(ps, (list, tuple)) and len(ps) == 1 \
                    and isinstance(ps[0], (list, tuple, np.ndarray)):
                ps = ps[0]
            if not isinstance(ps, (list, tuple, np.ndarray)):
                return None
            a = np.asarray(ps, dtype=np.float32)
            if a.ndim != 1:
                return None
            rows.append(a)
        if not rows or any(r.shape != rows[0].shape for r in rows):
            return None
        return np.stack(rows)
