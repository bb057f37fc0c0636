"""Bound (typed) scalar expression IR.

The binder lowers AST expressions into this IR; the Evaluator executes it
over DataBlocks. Analog of the reference's ``Expr``/``ScalarExpr``
(reference: src/query/expression/src/expression.rs and
src/query/sql/src/planner/plans/scalar_expr.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..types import DataType


class ScalarExpr:
    dtype: DataType

    def children(self) -> List["ScalarExpr"]:
        return []

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()

    def display(self) -> str:
        raise NotImplementedError


@dataclass
class BoundColumn(ScalarExpr):
    name: str  # column name in the input block
    dtype: DataType
    table: Optional[str] = None

    def display(self) -> str:
        return self.name


@dataclass
class Constant(ScalarExpr):
    value: Any
    dtype: DataType

    def display(self) -> str:
        return repr(self.value)


@dataclass
class Func(ScalarExpr):
    name: str
    args: List[ScalarExpr]
    dtype: DataType

    def children(self):
        return self.args

    def display(self) -> str:
        return f"{self.name}({', '.join(a.display() for a in self.args)})"


@dataclass
class SequenceNext(ScalarExpr):
    """nextval(seq): allocates num_rows consecutive sequence values.

    ``allocator`` is bound by the planner to the session's SequenceManager
    (reference: async nextval lowered in the binder). Volatile: never
    constant-folded.
    """

    seq_name: str
    allocator: Any  # callable (n:int) -> np.int64 array
    dtype: DataType = None

    def display(self) -> str:
        return f"nextval({self.seq_name})"


@dataclass
class DictGet(ScalarExpr):
    """dict_get(dict, 'attr', key): per-row mapping lookup. The mapping is
    materialized at bind time from the dictionary source (host-side
    reference data; never enters device programs)."""

    dict_name: str
    attr: str
    key: "ScalarExpr" = None
    mapping: Any = None  # {key_value: attr_value}
    dtype: DataType = None

    def children(self):
        return [self.key]

    def display(self) -> str:
        return f"dict_get({self.dict_name}, '{self.attr}', {self.key.display()})"


@dataclass
class ArrayLambda(ScalarExpr):
    """Higher-order array function with an inline lambda (reference:
    lambda expressions in the type checker + the array lambda kernels in
    scalars/array.rs): map/filter/fold/count/any/all over array elements.

    ``body`` is bound against the outer scope plus the lambda parameters,
    which appear as columns named ``param_cols[i]`` in the element block
    the evaluator builds (outer columns repeated per element — closures
    work)."""

    kind: str               # map | filter | fold | count | any | all
    arr: ScalarExpr
    params: List[str]       # source-level parameter names
    param_cols: List[str]   # unique column names in the element block
    body: ScalarExpr
    elem_dtype: DataType = None
    init: Optional[ScalarExpr] = None  # fold only
    dtype: DataType = None

    def children(self):
        return [self.arr] + ([self.init] if self.init is not None else [])

    def display(self) -> str:
        ps = ", ".join(self.params)
        return (f"array_{self.kind}({self.arr.display()},"
                f" ({ps}) -> {self.body.display()})")


@dataclass
class CastExpr(ScalarExpr):
    arg: ScalarExpr
    dtype: DataType
    is_try: bool = False

    def children(self):
        return [self.arg]

    def display(self) -> str:
        return f"CAST({self.arg.display()} AS {self.dtype.sql_name()})"


@dataclass
class CaseExpr(ScalarExpr):
    conditions: List[ScalarExpr]
    results: List[ScalarExpr]
    else_result: Optional[ScalarExpr]
    dtype: DataType

    def children(self):
        out = list(self.conditions) + list(self.results)
        if self.else_result is not None:
            out.append(self.else_result)
        return out

    def display(self) -> str:
        return "CASE ... END"


def contains_column(e: ScalarExpr, name: str) -> bool:
    return any(isinstance(x, BoundColumn) and x.name.lower() == name.lower() for x in e.walk())


def referenced_columns(e: ScalarExpr) -> List[str]:
    seen = []
    for x in e.walk():
        if isinstance(x, BoundColumn) and x.name not in seen:
            seen.append(x.name)
    return seen
