"""Scalar function registry.

Analog of the reference's ``FunctionRegistry`` with typed registration
macros (reference: src/query/functions/src/lib.rs). Here a function is a
name + a type resolver + a vectorized numpy kernel. Null handling is
declarative: ``null_policy="propagate"`` (default) computes on payloads and
ORs validities; ``"custom"`` kernels see (columns, validities) and return
(payload, validity).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ...errors import UnknownFunction, SemanticError
from ...types import DataType


@dataclass
class ScalarFunction:
    name: str
    # resolve(arg_types) -> return DataType (non-null form), raises SemanticError on mismatch
    resolve: Callable[[List[DataType]], DataType]
    # kernel(*payloads, arg_types=..., n_rows=...) -> payload ndarray/StringData
    kernel: Callable
    null_policy: str = "propagate"  # propagate | custom
    # custom kernels: kernel(payloads, validities, arg_types, n_rows) -> (payload, validity|None)


class FunctionRegistry:
    def __init__(self):
        self._funcs: Dict[str, ScalarFunction] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, fn: ScalarFunction, aliases: List[str] = ()):  # type: ignore[assignment]
        self._funcs[fn.name] = fn
        for a in aliases:
            self._aliases[a] = fn.name

    def get(self, name: str) -> ScalarFunction:
        key = name.lower()
        key = self._aliases.get(key, key)
        if key not in self._funcs:
            raise UnknownFunction(f"unknown function {name!r}")
        return self._funcs[key]

    def contains(self, name: str) -> bool:
        key = name.lower()
        return key in self._funcs or key in self._aliases

    def names(self) -> List[str]:
        return sorted(self._funcs)


registry = FunctionRegistry()


def scalar_function(name: str, resolve, null_policy: str = "propagate",
                    aliases: List[str] = ()):  # type: ignore[assignment]
    """Decorator: register `kernel` under `name`."""

    def deco(kernel):
        registry.register(ScalarFunction(name, resolve, kernel, null_policy), aliases)
        return kernel

    return deco


# ---- shared resolvers -------------------------------------------------------

def fixed(return_type: DataType):
    def r(arg_types):
        return return_type
    return r


def require(n_args: int, name: str):
    def check(arg_types):
        if len(arg_types) != n_args:
            raise SemanticError(f"{name} expects {n_args} args, got {len(arg_types)}")
    return check
