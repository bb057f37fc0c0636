"""Catalog: databases, tables, index definitions over the meta KV store.

Analog of the reference's catalog layer (reference: src/query/catalog/ +
src/meta/api/src/api_impl/). Table metadata (schema, engine, indexes) lives
under ``db/{db}/table/{name}``; the mutable snapshot pointer lives under
``snapshot/{table_id}`` and is CAS-updated by commits (OCC).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..errors import (DatabaseAlreadyExists, IndexAlreadyExists,
                      TableVersionMismatched,
                      TableAlreadyExists, UnknownDatabase, UnknownIndex,
                      UnknownTable)
from ..expression.schema import TableSchema
from ..meta import MetaStore


@dataclass
class TableIndexDef:
    """CREATE [VECTOR|INVERTED|NGRAM] INDEX definition
    (reference: TableIndex in src/meta/app/src/schema/table.rs)."""

    name: str
    index_type: str  # VECTOR | INVERTED | NGRAM
    columns: List[str]
    options: Dict[str, str] = field(default_factory=dict)
    sync: bool = True

    def to_dict(self):
        return {"name": self.name, "index_type": self.index_type,
                "columns": self.columns, "options": self.options, "sync": self.sync}

    @staticmethod
    def from_dict(d):
        return TableIndexDef(d["name"], d["index_type"], d["columns"],
                             d.get("options", {}), d.get("sync", True))


@dataclass
class TableInfo:
    table_id: int
    database: str
    name: str
    schema: TableSchema
    engine: str = "FUSE"
    options: Dict[str, str] = field(default_factory=dict)
    cluster_by: List[str] = field(default_factory=list)
    indexes: Dict[str, TableIndexDef] = field(default_factory=dict)

    def to_dict(self):
        return {
            "table_id": self.table_id,
            "database": self.database,
            "name": self.name,
            "schema": self.schema.to_dict(),
            "engine": self.engine,
            "options": self.options,
            "cluster_by": self.cluster_by,
            "indexes": {k: v.to_dict() for k, v in self.indexes.items()},
        }

    @staticmethod
    def from_dict(d):
        return TableInfo(
            d["table_id"], d["database"], d["name"],
            TableSchema.from_dict(d["schema"]), d.get("engine", "FUSE"),
            d.get("options", {}), d.get("cluster_by", []),
            {k: TableIndexDef.from_dict(v) for k, v in d.get("indexes", {}).items()})

    def vector_indexes(self) -> List[TableIndexDef]:
        return [i for i in self.indexes.values() if i.index_type == "VECTOR"]

    def inverted_indexes(self) -> List[TableIndexDef]:
        return [i for i in self.indexes.values() if i.index_type == "INVERTED"]

    def ngram_indexes(self) -> List[TableIndexDef]:
        return [i for i in self.indexes.values() if i.index_type == "NGRAM"]


@dataclass
class DatabaseInfo:
    name: str
    db_id: int


class Catalog:
    def __init__(self, meta: MetaStore):
        self.meta = meta
        if self.get_database("default") is None:
            self.create_database("default", if_not_exists=True)

    # -------------------------------------------------------------- databases
    def create_database(self, name: str, if_not_exists: bool = False) -> None:
        key = f"db_meta/{name.lower()}"
        val, seq = self.meta.get(key)
        if val is not None:
            if if_not_exists:
                return
            raise DatabaseAlreadyExists(f"database {name!r} already exists")
        try:
            self.meta.upsert(
                key, {"name": name, "db_id": self.meta.next_id("db")}, 0)
        except TableVersionMismatched:
            # a concurrent session created it between our check and CAS
            # (e.g. two sessions bootstrapping 'default' on a fresh root)
            if not if_not_exists:
                raise DatabaseAlreadyExists(
                    f"database {name!r} already exists")

    def drop_database(self, name: str, if_exists: bool = False) -> None:
        key = f"db_meta/{name.lower()}"
        val, seq = self.meta.get(key)
        if val is None:
            if if_exists:
                return
            raise UnknownDatabase(f"unknown database {name!r}")
        for t in self.list_tables(name):
            self.drop_table(name, t.name)
        self.meta.delete(key)

    def get_database(self, name: str) -> Optional[DatabaseInfo]:
        val, _ = self.meta.get(f"db_meta/{name.lower()}")
        return DatabaseInfo(val["name"], val["db_id"]) if val else None

    def list_databases(self) -> List[DatabaseInfo]:
        return [DatabaseInfo(v["name"], v["db_id"])
                for _, v, _ in self.meta.list_prefix("db_meta/")]

    def _require_db(self, name: str):
        if self.get_database(name) is None:
            raise UnknownDatabase(f"unknown database {name!r}")

    # ----------------------------------------------------------------- tables
    def _tkey(self, db: str, name: str) -> str:
        return f"table_meta/{db.lower()}/{name.lower()}"

    def create_table(self, info: TableInfo, if_not_exists: bool = False) -> TableInfo:
        self._require_db(info.database)
        key = self._tkey(info.database, info.name)
        val, seq = self.meta.get(key)
        if val is not None:
            if if_not_exists:
                return TableInfo.from_dict(val)
            raise TableAlreadyExists(f"table {info.name!r} already exists")
        if info.table_id == 0:
            info.table_id = self.meta.next_id("table")
        try:
            self.meta.upsert(key, info.to_dict(), 0)
        except TableVersionMismatched:
            # lost the create race to a concurrent session
            if if_not_exists:
                val, _ = self.meta.get(key)
                return TableInfo.from_dict(val)
            raise TableAlreadyExists(f"table {info.name!r} already exists")
        return info

    def get_table(self, db: str, name: str) -> TableInfo:
        val, _ = self.meta.get(self._tkey(db, name))
        if val is None:
            self._require_db(db)
            raise UnknownTable(f"unknown table {db}.{name}")
        return TableInfo.from_dict(val)

    def table_exists(self, db: str, name: str) -> bool:
        val, _ = self.meta.get(self._tkey(db, name))
        return val is not None

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> Optional[TableInfo]:
        """Soft delete: the table meta + snapshot pointer move under
        ``dropped/`` so UNDROP can restore until VACUUM purges them
        (reference: drop/undrop with retention, interpreter_table_undrop)."""
        key = self._tkey(db, name)
        val, seq = self.meta.get(key)
        if val is None:
            if if_exists:
                return None
            raise UnknownTable(f"unknown table {db}.{name}")
        info = TableInfo.from_dict(val)
        snap, _ = self.meta.get(f"snapshot/{info.table_id}")
        self.meta.upsert(f"dropped/{db.lower()}/{name.lower()}",
                         {"info": val, "snapshot": snap})
        self.meta.delete(key)
        self.meta.delete(f"snapshot/{info.table_id}")
        return info

    def undrop_table(self, db: str, name: str) -> TableInfo:
        dkey = f"dropped/{db.lower()}/{name.lower()}"
        val, _ = self.meta.get(dkey)
        if val is None:
            raise UnknownTable(f"no dropped table {db}.{name} to undrop")
        if self.table_exists(db, name):
            raise TableAlreadyExists(
                f"table {name!r} already exists; rename it before UNDROP")
        info = TableInfo.from_dict(val["info"])
        self.meta.upsert(self._tkey(db, name), val["info"], 0)
        if val.get("snapshot") is not None:
            self.meta.upsert(f"snapshot/{info.table_id}", val["snapshot"])
        self.meta.delete(dkey)
        return info

    def rename_table(self, db: str, name: str, new_name: str) -> None:
        info = self.get_table(db, name)
        if self.table_exists(db, new_name):
            raise TableAlreadyExists(f"table {new_name!r} already exists")
        info.name = new_name
        self.meta.upsert(self._tkey(db, new_name), info.to_dict(), 0)
        self.meta.delete(self._tkey(db, name))

    def list_tables(self, db: str) -> List[TableInfo]:
        self._require_db(db)
        return [TableInfo.from_dict(v)
                for _, v, _ in self.meta.list_prefix(f"table_meta/{db.lower()}/")]

    def update_table(self, info: TableInfo) -> None:
        key = self._tkey(info.database, info.name)
        _, seq = self.meta.get(key)
        self.meta.upsert(key, info.to_dict(), seq)

    # ---------------------------------------------------------------- indexes
    def create_index(self, db: str, table: str, index: TableIndexDef,
                     if_not_exists: bool = False) -> TableInfo:
        info = self.get_table(db, table)
        if index.name in info.indexes:
            if if_not_exists:
                return info
            raise IndexAlreadyExists(f"index {index.name!r} already exists")
        for f in index.columns:
            info.schema.index_of(f)  # raises UnknownColumn
        info.indexes[index.name] = index
        self.update_table(info)
        return info

    def drop_index(self, db: str, table: Optional[str], name: str,
                   if_exists: bool = False) -> None:
        tables = [self.get_table(db, table)] if table else self.list_tables(db)
        for info in tables:
            if name in info.indexes:
                del info.indexes[name]
                self.update_table(info)
                return
        if not if_exists:
            raise UnknownIndex(f"unknown index {name!r}")

    # ------------------------------------------------------------- snapshots
    def get_snapshot_location(self, table_id: int):
        """Returns (location | None, seq) — seq feeds commit CAS."""
        val, seq = self.meta.get(f"snapshot/{table_id}")
        return (val, seq)

    def set_snapshot_location(self, table_id: int, location: str,
                              expected_seq: int) -> int:
        return self.meta.upsert(f"snapshot/{table_id}", location, expected_seq)
