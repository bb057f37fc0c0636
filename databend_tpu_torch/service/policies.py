"""Data masking + row access policies (EE).

Reference: src/query/ee_features/data_mask (masking policies applied to
column projections) and row access policy support; meta types in
src/meta/app/src/data_mask. Policies are SQL expressions stored in the
meta KV; the binder rewrites masked columns / appends policy filters at
scan time so masked data never reaches later operators — matching the
reference's bind-time policy application.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import BadArguments, UnknownPolicy

_MASK_PREFIX = "masking_policies/"
_ROW_PREFIX = "row_access_policies/"


@dataclass
class MaskingPolicy:
    name: str
    arg_name: str
    arg_type: str
    ret_type: str
    body: str  # SQL expression over arg_name (may call current_role())
    comment: str = ""
    created_ts: float = 0.0

    def to_dict(self):
        return {"name": self.name, "arg_name": self.arg_name,
                "arg_type": self.arg_type, "ret_type": self.ret_type,
                "body": self.body, "comment": self.comment,
                "created_ts": self.created_ts}

    @staticmethod
    def from_dict(d):
        return MaskingPolicy(d["name"], d["arg_name"], d["arg_type"],
                             d["ret_type"], d["body"], d.get("comment", ""),
                             d.get("created_ts", 0.0))


@dataclass
class RowAccessPolicy:
    name: str
    args: List[Tuple[str, str]] = field(default_factory=list)
    body: str = ""
    comment: str = ""
    created_ts: float = 0.0

    def to_dict(self):
        return {"name": self.name, "args": [list(a) for a in self.args],
                "body": self.body, "comment": self.comment,
                "created_ts": self.created_ts}

    @staticmethod
    def from_dict(d):
        return RowAccessPolicy(d["name"], [tuple(a) for a in d["args"]],
                               d["body"], d.get("comment", ""),
                               d.get("created_ts", 0.0))


class PolicyManager:
    def __init__(self, meta):
        self.meta = meta

    # ----------------------------------------------------------- masking
    def create_masking(self, p: MaskingPolicy, if_not_exists=False,
                       or_replace=False):
        key = _MASK_PREFIX + p.name.lower()
        got, _ = self.meta.get(key)
        if got is not None and not or_replace:
            if if_not_exists:
                return
            raise BadArguments(f"masking policy {p.name!r} already exists")
        p.created_ts = time.time()
        self.meta.upsert(key, p.to_dict())

    def drop_masking(self, name: str, if_exists=False):
        key = _MASK_PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is None:
            if if_exists:
                return
            raise UnknownPolicy(f"unknown masking policy {name!r}")
        self.meta.delete(key)

    def get_masking(self, name: str) -> MaskingPolicy:
        got, _ = self.meta.get(_MASK_PREFIX + name.lower())
        if got is None:
            raise UnknownPolicy(f"unknown masking policy {name!r}")
        return MaskingPolicy.from_dict(got)

    def list_masking(self) -> List[MaskingPolicy]:
        return sorted((MaskingPolicy.from_dict(v) for _, v, _
                       in self.meta.list_prefix(_MASK_PREFIX)),
                      key=lambda p: p.name)

    # -------------------------------------------------------- row access
    def create_row_access(self, p: RowAccessPolicy, if_not_exists=False,
                          or_replace=False):
        key = _ROW_PREFIX + p.name.lower()
        got, _ = self.meta.get(key)
        if got is not None and not or_replace:
            if if_not_exists:
                return
            raise BadArguments(f"row access policy {p.name!r} already exists")
        p.created_ts = time.time()
        self.meta.upsert(key, p.to_dict())

    def drop_row_access(self, name: str, if_exists=False):
        key = _ROW_PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is None:
            if if_exists:
                return
            raise UnknownPolicy(f"unknown row access policy {name!r}")
        self.meta.delete(key)

    def get_row_access(self, name: str) -> RowAccessPolicy:
        got, _ = self.meta.get(_ROW_PREFIX + name.lower())
        if got is None:
            raise UnknownPolicy(f"unknown row access policy {name!r}")
        return RowAccessPolicy.from_dict(got)

    def list_row_access(self) -> List[RowAccessPolicy]:
        return sorted((RowAccessPolicy.from_dict(v) for _, v, _
                       in self.meta.list_prefix(_ROW_PREFIX)),
                      key=lambda p: p.name)


def parse_policy_expr(body: str):
    """Parse a stored policy body back to an AST expression."""
    from ..sql.parser import Parser
    p = Parser(body)
    e = p.parse_expr()
    return e
