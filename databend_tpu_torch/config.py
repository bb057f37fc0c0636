"""Layered process configuration: defaults < toml file < env < CLI.

Reference analog: src/query/config (serfig-based InnerConfig/Config,
config.rs — builtin defaults overridden by file, then DATABEND_* env vars,
then clap CLI flags, with obsolete-key migration). Env prefix here is
``DATABEND_TPU_``; nested keys use ``__`` (e.g.
``DATABEND_TPU_QUERY__MAX_THREADS=4`` sets query.max_threads).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

from .errors import BadArguments

ENV_PREFIX = "DATABEND_TPU_"

# obsolete keys migrated (reference: config obsolete.rs)
_OBSOLETE = {
    "table_cache_enabled": None,                # dropped
    "max_query_log_size": ("query", "query_log_capacity"),
}


@dataclass
class QueryConfig:
    tenant_id: str = "default"
    max_threads: int = 8
    http_handler_host: str = "127.0.0.1"
    http_handler_port: int = 8124
    admin_api_address: str = "127.0.0.1:8080"
    query_log_capacity: int = 10000


@dataclass
class StorageConfig:
    type: str = "fs"
    data_path: str = ".databend_tpu"


@dataclass
class MetaConfig:
    embedded: bool = True
    endpoints: List[str] = field(default_factory=list)


@dataclass
class LogConfig:
    level: str = "INFO"
    dir: str = "logs"


@dataclass
class Config:
    query: QueryConfig = field(default_factory=QueryConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    meta: MetaConfig = field(default_factory=MetaConfig)
    log: LogConfig = field(default_factory=LogConfig)

    # -------------------------------------------------------------- loading
    @staticmethod
    def load(config_file: Optional[str] = None,
             env: Optional[Dict[str, str]] = None,
             argv: Optional[List[str]] = None) -> "Config":
        cfg = Config()
        if config_file:
            cfg._apply_file(config_file)
        cfg._apply_env(env if env is not None else dict(os.environ))
        if argv:
            cfg._apply_argv(argv)
        return cfg

    def _sections(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def _apply_pair(self, section: str, key: str, value):
        section = section.lower()
        key = key.lower()
        if key in _OBSOLETE or f"{section}.{key}" in _OBSOLETE:
            target = _OBSOLETE.get(key) or _OBSOLETE.get(f"{section}.{key}")
            if target is None:
                return  # silently dropped, like obsolete serfig keys
            section, key = target
        sec = self._sections().get(section)
        if sec is None:
            raise BadArguments(f"unknown config section {section!r}")
        if not hasattr(sec, key):
            raise BadArguments(f"unknown config key {section}.{key}")
        cur = getattr(sec, key)
        if isinstance(cur, bool):
            value = str(value).strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, list):
            if isinstance(value, str):
                value = [v for v in value.split(",") if v]
        setattr(sec, key, value)

    def _apply_file(self, path: str):
        import tomllib
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for section, kv in data.items():
            if not isinstance(kv, dict):
                raise BadArguments(f"top-level config key {section!r} must be a table")
            for k, v in kv.items():
                self._apply_pair(section, k, v)

    def _apply_env(self, env: Dict[str, str]):
        for k, v in env.items():
            if not k.startswith(ENV_PREFIX):
                continue
            rest = k[len(ENV_PREFIX):]
            if "__" not in rest:
                continue
            section, key = rest.split("__", 1)
            self._apply_pair(section, key, v)

    def _apply_argv(self, argv: List[str]):
        """--section-key=value or --section-key value (clap-style)."""
        i = 0
        while i < len(argv):
            a = argv[i]
            if not a.startswith("--"):
                raise BadArguments(f"unexpected argument {a!r}")
            body = a[2:]
            if "=" in body:
                name, value = body.split("=", 1)
            else:
                if i + 1 >= len(argv):
                    raise BadArguments(f"missing value for {a!r}")
                name, value = body, argv[i + 1]
                i += 1
            name = name.replace("-", "_")
            if "_" not in name:
                raise BadArguments(f"unknown flag {a!r}")
            section, key = name.split("_", 1)
            if section not in self._sections():
                # try longest-section match (e.g. storage_data_path)
                for s in self._sections():
                    if name.startswith(s + "_"):
                        section, key = s, name[len(s) + 1:]
                        break
            self._apply_pair(section, key, value)
            i += 1

    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for name, sec in self._sections().items():
            out[name] = {f.name: getattr(sec, f.name) for f in fields(sec)}
        return out
