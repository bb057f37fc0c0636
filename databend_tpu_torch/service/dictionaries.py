"""Dictionaries: key->attribute lookup tables + dict_get().

Reference: CREATE DICTIONARY (src/query/service/src/interpreters/
interpreter_dictionary_*.rs), meta types in src/meta/app/src/schema/
dictionary.rs, dict_get lowering in the binder (async function over
MySQL/Redis sources).

Sources here: ``TABLE(name='t' [database='db'])`` reads an internal table
(the in-warehouse analog used by tests); MYSQL/REDIS parse and store but
raise a clear error at lookup time — those connectors need network egress
this build does not have.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import BadArguments, UnknownDictionary, UnsupportedFeature

_PREFIX = "dictionaries/"


@dataclass
class DictionaryInfo:
    name: str
    columns: List[Tuple[str, str]] = field(default_factory=list)  # (name, type)
    primary_key: str = ""
    source_kind: str = "TABLE"
    source_opts: Dict[str, str] = field(default_factory=dict)
    comment: str = ""
    created_ts: float = 0.0

    def to_dict(self):
        return {"name": self.name, "columns": [list(c) for c in self.columns],
                "primary_key": self.primary_key,
                "source_kind": self.source_kind,
                "source_opts": dict(self.source_opts),
                "comment": self.comment, "created_ts": self.created_ts}

    @staticmethod
    def from_dict(d):
        return DictionaryInfo(d["name"], [tuple(c) for c in d["columns"]],
                              d["primary_key"], d["source_kind"],
                              dict(d["source_opts"]), d.get("comment", ""),
                              d.get("created_ts", 0.0))

    def ddl(self) -> str:
        cols = ", ".join(f"{n} {t}" for n, t in self.columns)
        opts = " ".join(f"{k}='{v}'" for k, v in sorted(self.source_opts.items()))
        return (f"CREATE DICTIONARY {self.name} ({cols}) "
                f"PRIMARY KEY {self.primary_key} "
                f"SOURCE({self.source_kind}({opts}))")


class DictionaryManager:
    def __init__(self, session):
        self.session = session
        self.meta = session.meta

    def create(self, info: DictionaryInfo, if_not_exists=False,
               or_replace=False):
        if not info.primary_key:
            raise BadArguments("dictionary requires PRIMARY KEY")
        if info.primary_key.lower() not in {c[0].lower() for c in info.columns}:
            raise BadArguments(
                f"primary key {info.primary_key!r} not in dictionary columns")
        key = _PREFIX + info.name.lower()
        got, _ = self.meta.get(key)
        if got is not None and not or_replace:
            if if_not_exists:
                return
            raise BadArguments(f"dictionary {info.name!r} already exists")
        info.created_ts = time.time()
        self.meta.upsert(key, info.to_dict())

    def drop(self, name: str, if_exists=False):
        key = _PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is None:
            if if_exists:
                return
            raise UnknownDictionary(f"unknown dictionary {name!r}")
        self.meta.delete(key)

    def get(self, name: str) -> DictionaryInfo:
        got, _ = self.meta.get(_PREFIX + name.lower())
        if got is None:
            raise UnknownDictionary(f"unknown dictionary {name!r}")
        return DictionaryInfo.from_dict(got)

    def list(self) -> List[DictionaryInfo]:
        return sorted((DictionaryInfo.from_dict(v) for _, v, _
                       in self.meta.list_prefix(_PREFIX)),
                      key=lambda d: d.name)

    def load_mapping(self, name: str, attr: str) -> Dict:
        """Materialize {primary_key_value: attr_value} for dict_get.

        The reference streams lookups to MySQL/Redis per batch; here the
        TABLE source loads once per query bind (dictionaries are small
        reference data by design)."""
        info = self.get(name)
        if attr.lower() not in {c[0].lower() for c in info.columns}:
            raise BadArguments(
                f"dictionary {name!r} has no attribute {attr!r}")
        if info.source_kind == "MYSQL":
            return self._load_mysql(info, attr)
        if info.source_kind == "REDIS":
            return self._load_redis(info, attr)
        if info.source_kind != "TABLE":
            raise BadArguments(f"unknown dictionary source {info.source_kind!r}")
        tname = info.source_opts.get("name")
        if not tname:
            raise BadArguments("TABLE source requires name='<table>'")
        tdb = info.source_opts.get("database")
        t = self.session.table(tname, tdb)
        from ..catalog.pushdown import PushDownInfo
        from ..pipeline.executor import execute_plan
        from ..sql.plans import Scan
        block = execute_plan(Scan(t, PushDownInfo()))
        keys = block.column(info.primary_key).to_pylist()
        vals = block.column(attr).to_pylist()
        return dict(zip(keys, vals))

    def _coerce_key(self, info: DictionaryInfo, raw: List):
        """Dictionary keys arrive as protocol strings; cast to the
        declared primary-key type so dict_get probe values match."""
        kt = next((t for n, t in info.columns
                   if n.lower() == info.primary_key.lower()), "STRING")
        kt = kt.upper()
        if any(x in kt for x in ("INT", "SERIAL")):
            return [None if v is None else int(v) for v in raw]
        if any(x in kt for x in ("FLOAT", "DOUBLE", "REAL")):
            return [None if v is None else float(v) for v in raw]
        return raw

    def _coerce_attr(self, info: DictionaryInfo, attr: str, raw: List):
        at = next((t for n, t in info.columns
                   if n.lower() == attr.lower()), "STRING").upper()
        if any(x in at for x in ("INT", "SERIAL")):
            return [None if v is None else int(v) for v in raw]
        if any(x in at for x in ("FLOAT", "DOUBLE", "REAL")):
            return [None if v is None else float(v) for v in raw]
        return raw

    def _load_mysql(self, info: DictionaryInfo, attr: str) -> Dict:
        """MYSQL source: one SELECT over the wire per bind (reference:
        sqlx MySQL connector behind dict_get; src/query/service
        dictionary lookups). Works against any MySQL-wire endpoint —
        including another databend_tpu node's MySQL front end."""
        from .mysql.client import MySQLClient
        o = info.source_opts
        host = o.get("host", "127.0.0.1")
        port = int(o.get("port", "3306"))
        table = o.get("table") or o.get("name")
        if not table:
            raise BadArguments("MYSQL source requires table='<table>'")
        db = o.get("db") or o.get("database") or ""
        cli = MySQLClient(host, port, o.get("username", "root"),
                          o.get("password", ""), db)
        try:
            _, rows = cli.query(
                f"SELECT {info.primary_key}, {attr} FROM {table}")
        finally:
            cli.close()
        keys = self._coerce_key(info, [r[0] for r in rows])
        vals = self._coerce_attr(info, attr, [r[1] for r in rows])
        return dict(zip(keys, vals))

    def _load_redis(self, info: DictionaryInfo, attr: str) -> Dict:
        """REDIS source: the keyspace IS the mapping — key -> value
        strings (reference: redis dictionary source is fixed at two
        STRING columns)."""
        from .redis_client import RedisClient
        o = info.source_opts
        cli = RedisClient(o.get("host", "127.0.0.1"),
                          int(o.get("port", "6379")))
        try:
            keys = cli.scan_all()
            vals = cli.mget(keys)
        finally:
            cli.close()
        ck = self._coerce_key(info, keys)
        cv = self._coerce_attr(info, attr, vals)
        return dict(zip(ck, cv))
