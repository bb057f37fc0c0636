"""Binder: the reference ``sql/binder.py`` with one device seam replaced.

``Binder._finalize_scan`` asked JAX for the device count inside a
``try/except Exception``; without JAX that import failed and the exception
also skipped every setting after it. The port reads the count from torch and
applies every setting unguarded.
"""

import torch

from .._reference import exec_reference

exec_reference(globals(), "sql/binder.py")


def _finalize_scan(self, state, where_expr, sort_items, limit, bound_items):
    scan = state.scan
    if scan is None:
        return
    pd = scan.pushdown
    settings = self.session.settings
    if settings.get("enable_distributed_pruning"):
        pd.enable_distributed = torch.cuda.device_count() > 1
    pd.vector_search_mode = str(settings.get("vector_search_mode"))
    pd.vector_exact_scan_max_rows = int(
        settings.get("vector_exact_scan_max_rows"))
    pd.vector_host_scan_max_rows = int(
        settings.get("vector_host_scan_max_rows"))
    pd.enable_topn = bool(settings.get("enable_top_n"))
    if state.vector_rewrite is not None:
        pd.vector_index = state.vector_rewrite
        scan.internal_columns.append(VECTOR_SCORE_COL_NAME)

        def _is_score_col(name: str) -> bool:
            if name == VECTOR_SCORE_COL_NAME:
                return True
            e = next((e for n, e in bound_items if n == name), None)
            return isinstance(e, BoundColumn) and e.name == VECTOR_SCORE_COL_NAME

        first_sort_is_score = bool(sort_items) and \
            _is_score_col(sort_items[0].name) and sort_items[0].asc
        # mirror reference gating: HNSW prune only for
        # (no filter, ASC score order, limit)
        pd.vector_index.topk_asc = (
            where_expr is None and first_sort_is_score and limit is not None)
    if state.inverted_rewrite is not None:
        pd.inverted_index = state.inverted_rewrite
        scan.internal_columns.append(SEARCH_MATCHED_COL_NAME)
        if state.used_score_fn:
            pd.inverted_index.has_score = True
            scan.internal_columns.append(SEARCH_SCORE_COL_NAME)
    if limit is not None and isinstance(limit, A.Literal):
        lim = int(limit.value)
        if not sort_items and where_expr is None:
            pd.limit = lim
        elif sort_items:
            # topn pushdown: sort on plain columns or _vector_score
            first = sort_items[0]
            pd.order_by = [Range(first.name, first.asc)]
            pd.limit = lim


Binder._finalize_scan = _finalize_scan  # noqa: F821 (defined by the reference source)
