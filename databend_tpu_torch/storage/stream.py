"""Table streams (CDC).

Reference analog: src/query/storages/stream — a stream is a named
watermark into a table's snapshot chain; reading it returns the changes
since the watermark, and a successful DML that reads the stream advances
the watermark (transactional consumption).

This engine's DML model is append-only block rewrites, so the delta is
the set of blocks in segments added since the watermark, surfaced with
the standard ``change$action`` / ``change$row_id`` columns.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..errors import UnknownTable, _err
from ..expression import Column, DataBlock, DataField
from ..types import String

UnknownStream = _err("UnknownStream", 2730)

CHANGE_ACTION_COL = "change$action"
CHANGE_ROW_ID_COL = "change$row_id"


def _key(db: str, name: str) -> str:
    return f"streams/{db.lower()}/{name.lower()}"


class StreamManager:
    def __init__(self, session):
        self.s = session

    def create(self, db: str, name: str, table_db: str, table: str,
               if_not_exists: bool = False):
        t = self.s.table(table, table_db)  # validates the table exists
        cur, _ = self.s.meta.get(_key(db, name))
        if cur is not None:
            if if_not_exists:
                return
            raise UnknownStream(f"stream {name!r} already exists")
        head = t.read_snapshot()
        self.s.meta.upsert(_key(db, name), {
            "table_database": table_db or self.s.current_database,
            "table_name": table,
            "watermark": head.snapshot_id if head else None,
        })

    def drop(self, db: str, name: str, if_exists: bool = False):
        cur, _ = self.s.meta.get(_key(db, name))
        if cur is None:
            if if_exists:
                return
            raise UnknownStream(f"unknown stream {name!r}")
        self.s.meta.delete(_key(db, name))

    def get(self, db: str, name: str) -> Optional[dict]:
        v, _ = self.s.meta.get(_key(db, name))
        return v

    def list(self) -> List[Tuple[str, dict]]:
        return [(k[len("streams/"):], v) for k, v, _
                in self.s.meta.list_prefix("streams/")]

    # ------------------------------------------------------------------ read
    def read_delta(self, db: str, name: str) -> Tuple[DataBlock, List[DataField]]:
        info = self.get(db, name)
        if info is None:
            raise UnknownStream(f"unknown stream {name!r}")
        t = self.s.table(info["table_name"], info["table_database"])
        head = t.read_snapshot()
        wm_segments = set()
        if info["watermark"]:
            wm = t.read_snapshot(info["watermark"])
            wm_segments = set(wm.segments)
        fields = list(t.schema.fields) + [
            DataField(CHANGE_ACTION_COL, String),
            DataField(CHANGE_ROW_ID_COL, String)]
        blocks = []
        if head is not None:
            row_id = 0
            from .fuse.snapshot import SegmentInfo, read_json
            for seg_loc in head.segments:
                if seg_loc in wm_segments:
                    continue
                seg = SegmentInfo.from_dict(read_json(t.abs_path(seg_loc)))
                for meta in seg.blocks:
                    b = t.read_block(meta, t.schema.field_names())
                    n = b.num_rows
                    action = Column.from_pylist(["INSERT"] * n, String)
                    rid = Column.from_pylist(
                        [f"{meta.location}:{i}" for i in range(n)], String)
                    blocks.append(DataBlock(
                        b.names + [CHANGE_ACTION_COL, CHANGE_ROW_ID_COL],
                        b.columns + [action, rid], n))
                    row_id += n
        if not blocks:
            from ..expression.evaluator import constant_column
            empty = DataBlock(
                [f.name for f in fields],
                [constant_column(None, f.dtype.wrap_nullable(), 0)
                 for f in fields], 0)
            return empty, fields
        return DataBlock.concat(blocks), fields

    def advance(self, db: str, name: str):
        """Consume: move the watermark to the table head."""
        info = self.get(db, name)
        if info is None:
            return
        t = self.s.table(info["table_name"], info["table_database"])
        head = t.read_snapshot()
        info["watermark"] = head.snapshot_id if head else None
        self.s.meta.upsert(_key(db, name), info)
