"""metactl: export / import / inspect the meta KV store.

Reference analog: databend-metactl (src/meta/binaries, src/meta/control) —
the operational tool for dumping and restoring the meta service's state.
Export format: one JSON line per key — {"key", "seq", "value"} — so dumps
diff cleanly and stream through standard tooling.

    python -m databend_tpu.tools.metactl export --meta-path meta.db > dump.jsonl
    python -m databend_tpu.tools.metactl import --meta-path new.db < dump.jsonl
    python -m databend_tpu.tools.metactl status --meta-path meta.db
"""

from __future__ import annotations

import json
import sys
from typing import IO, Optional

from ..meta.kv import MetaStore


def export_meta(meta: MetaStore, out: IO[str], prefix: str = "") -> int:
    n = 0
    for key, value, seq in meta.list_prefix(prefix):
        out.write(json.dumps({"key": key, "seq": seq, "value": value}) + "\n")
        n += 1
    return n


def import_meta(meta: MetaStore, inp: IO[str],
                overwrite: bool = True) -> int:
    n = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if not overwrite:
            _, seq = meta.get(rec["key"])
            if seq:
                continue
        meta.upsert(rec["key"], rec["value"])
        n += 1
    return n


def status(meta: MetaStore) -> dict:
    keys = meta.list_prefix("")
    by_ns: dict = {}
    for k, _, _ in keys:
        ns = k.split("/", 1)[0]
        by_ns[ns] = by_ns.get(ns, 0) + 1
    return {"keys": len(keys), "namespaces": by_ns}


def main(argv: Optional[list] = None) -> int:  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(prog="metactl",
                                description="meta KV export/import/status")
    p.add_argument("command", choices=["export", "import", "status"])
    p.add_argument("--meta-path", default=None)
    p.add_argument("--meta-endpoint", default=None,
                   help="remote meta service (http://host:port)")
    p.add_argument("--prefix", default="")
    a = p.parse_args(argv)
    if not a.meta_path and not a.meta_endpoint:
        p.error("one of --meta-path / --meta-endpoint is required")
    if a.meta_endpoint:
        from ..meta.kv import RemoteMetaStore
        meta = RemoteMetaStore(a.meta_endpoint)
    else:
        meta = MetaStore(a.meta_path)
    try:
        if a.command == "export":
            export_meta(meta, sys.stdout, a.prefix)
        elif a.command == "import":
            n = import_meta(meta, sys.stdin)
            print(f"imported {n} keys", file=sys.stderr)
        else:
            print(json.dumps(status(meta), indent=2))
    finally:
        meta.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
