"""Layered config for the meta-service process.

Reference analog: src/meta/cli-config (893 LoC) — databend-meta's own
config parsing, layered like the query binary's serfig stack (builtin
defaults < toml file < env < CLI flags). Here the env prefix is
``DATABEND_TPU_META_`` and CLI flags are ``--<key>`` with dashes; the
``--config-file`` flag (or ``DATABEND_TPU_META_CONFIG_FILE``) names the
toml layer, matching databend-meta's ``--config-file``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

from ..errors import BadArguments

ENV_PREFIX = "DATABEND_TPU_META_"


@dataclass
class MetaServerConfig:
    host: str = "127.0.0.1"
    port: int = 9191
    path: Optional[str] = None          # sqlite path; None = in-memory
    raft_id: Optional[str] = None       # enables raft when set
    raft_peers: Dict[str, str] = field(default_factory=dict)
    election_timeout_min: float = 0.4
    election_timeout_max: float = 0.8
    heartbeat_interval: float = 0.12
    log_level: str = "INFO"

    # ------------------------------------------------------------- layering
    @staticmethod
    def load(argv: Optional[List[str]] = None,
             env: Optional[Dict[str, str]] = None) -> "MetaServerConfig":
        argv = list(argv) if argv else []
        env = dict(os.environ) if env is None else env
        cfg = MetaServerConfig()
        # the config-file flag itself is resolved first (env < CLI)
        config_file = env.get(ENV_PREFIX + "CONFIG_FILE")
        rest: List[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("--config-file"):
                if "=" in a:
                    config_file = a.split("=", 1)[1]
                else:
                    if i + 1 >= len(argv):
                        raise BadArguments("missing value for --config-file")
                    config_file = argv[i + 1]
                    i += 1
            else:
                rest.append(a)
            i += 1
        if config_file:
            cfg._apply_file(config_file)
        cfg._apply_env(env)
        cfg._apply_argv(rest)
        return cfg

    def _apply(self, key: str, value) -> None:
        key = key.lower().replace("-", "_")
        if key == "config_file":
            return
        if not hasattr(self, key):
            raise BadArguments(f"unknown meta config key {key!r}")
        cur = getattr(self, key)
        if key == "raft_peers":
            if isinstance(value, str):
                value = dict(kv.split("=", 1)
                             for kv in value.split(",") if kv)
            elif not isinstance(value, dict):
                raise BadArguments("raft_peers must be a map or id=addr,...")
        elif isinstance(cur, bool):
            value = str(value).strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int) and not isinstance(cur, bool):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        elif value is not None:
            value = str(value)
        setattr(self, key, value)

    def _apply_file(self, path: str) -> None:
        import tomllib
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for k, v in data.items():
            if isinstance(v, dict) and k != "raft_peers":
                # allow [raft] / [meta] style sections, flattened
                for kk, vv in v.items():
                    self._apply(kk, vv)
            else:
                self._apply(k, v)

    def _apply_env(self, env: Dict[str, str]) -> None:
        for k, v in env.items():
            if k.startswith(ENV_PREFIX) and k != ENV_PREFIX + "CONFIG_FILE":
                self._apply(k[len(ENV_PREFIX):], v)

    def _apply_argv(self, argv: List[str]) -> None:
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
            self._apply(name, value)
            i += 1

    def to_dict(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in fields(self)}
