"""Cluster backup / restore.

Reference analog: src/bendsave (backup.rs / restore.rs — streams the meta
state + object-storage data into a save location and back). Here a backup
is a tar.gz of the data root (meta KV + table dirs) plus a manifest with
versions and per-file checksums; restore verifies the manifest before
unpacking.

CLI:
    python -m databend_tpu.tools.bendsave backup  --data-root D --to F.tgz
    python -m databend_tpu.tools.bendsave restore --from F.tgz --data-root D
"""

from __future__ import annotations

import hashlib
import json
import os
import tarfile
import tempfile
import time
from typing import Dict

from ..errors import BadArguments
from ..version import __version__

MANIFEST = "BENDSAVE_MANIFEST.json"


def _walk_files(root: str):
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            yield os.path.relpath(p, root), p


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def backup(data_root: str, dest: str) -> Dict:
    if not os.path.isdir(data_root):
        raise BadArguments(f"data root {data_root!r} does not exist")
    files = {}
    for rel, p in _walk_files(data_root):
        files[rel] = {"sha256": _sha256(p), "size": os.path.getsize(p)}
    manifest = {
        "version": __version__,
        "created_at": time.time(),
        "file_count": len(files),
        "files": files,
    }
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    with tarfile.open(dest, "w:gz") as tar:
        for rel, p in _walk_files(data_root):
            tar.add(p, arcname=os.path.join("data", rel))
        mf = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
        json.dump(manifest, mf)
        mf.close()
        tar.add(mf.name, arcname=MANIFEST)
        os.unlink(mf.name)
    return manifest


def restore(src: str, data_root: str, overwrite: bool = False) -> Dict:
    if not os.path.exists(src):
        raise BadArguments(f"backup {src!r} does not exist")
    if os.path.isdir(data_root) and os.listdir(data_root) and not overwrite:
        raise BadArguments(
            f"data root {data_root!r} is not empty (pass overwrite)")
    with tarfile.open(src, "r:gz") as tar:
        mf = tar.extractfile(MANIFEST)
        if mf is None:
            raise BadArguments("missing manifest: not a bendsave backup")
        manifest = json.load(mf)
        with tempfile.TemporaryDirectory() as tmp:
            tar.extractall(tmp, filter="data")
            staged = os.path.join(tmp, "data")
            # verify checksums BEFORE touching the destination
            for rel, info in manifest["files"].items():
                p = os.path.join(staged, rel)
                if not os.path.exists(p):
                    raise BadArguments(f"backup corrupt: missing {rel}")
                if _sha256(p) != info["sha256"]:
                    raise BadArguments(f"backup corrupt: checksum mismatch {rel}")
            os.makedirs(data_root, exist_ok=True)
            for rel, _ in manifest["files"].items():
                dst = os.path.join(data_root, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                os.replace(os.path.join(staged, rel), dst)
    return manifest


def main(argv=None):  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(prog="bendsave")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("backup")
    b.add_argument("--data-root", required=True)
    b.add_argument("--to", required=True)
    r = sub.add_parser("restore")
    r.add_argument("--from", dest="src", required=True)
    r.add_argument("--data-root", required=True)
    r.add_argument("--overwrite", action="store_true")
    a = p.parse_args(argv)
    if a.cmd == "backup":
        m = backup(a.data_root, a.to)
        print(json.dumps({"files": m["file_count"], "to": a.to}))
    else:
        m = restore(a.src, a.data_root, a.overwrite)
        print(json.dumps({"files": m["file_count"], "restored_to": a.data_root}))


if __name__ == "__main__":  # pragma: no cover
    main()
