"""Named stages: managed file locations for COPY / LIST / SELECT-from-stage.

Reference: src/query/storages/stage (stage table + COPY paths),
src/meta/app/src/principal/user_stage.rs (StageInfo/StageType),
interpreter_{stage_create,stage_drop,stage_remove,presign}.rs.

TPU-first notes: stages are pure control-plane — metadata in the meta KV,
bytes behind the scheme-routed ``DataOperator`` (fs/memory/s3). Internal
stages live under ``{data_root}/stages/<name>``; external stages point at a
user URL. Loading a stage file materializes it to a local scratch file so
the (host-side) format decoders stream it; decoded blocks then enter the
normal device ingest path.
"""

from __future__ import annotations

import fnmatch
import os
import posixpath
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import BadArguments, SemanticError, UnknownStage
from .operator import OPERATOR

_META_PREFIX = "stages/"


@dataclass
class StageInfo:
    name: str
    stage_type: str  # "Internal" | "External" | "User"
    url: str  # absolute location (fs path or scheme://...)
    file_format: Dict[str, str] = field(default_factory=dict)
    comment: str = ""
    created_ts: float = 0.0
    number_of_files: int = -1  # filled on demand
    connection: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "stage_type": self.stage_type,
                "url": self.url, "file_format": dict(self.file_format),
                "comment": self.comment, "created_ts": self.created_ts,
                "connection": dict(self.connection)}

    @staticmethod
    def from_dict(d: dict) -> "StageInfo":
        return StageInfo(d["name"], d["stage_type"], d["url"],
                         dict(d.get("file_format") or {}),
                         d.get("comment", ""), d.get("created_ts", 0.0),
                         connection=dict(d.get("connection") or {}))


def _safe_rel(rel: str) -> str:
    """Confine a stage-relative path to the stage root.

    The reference roots its stage operator at the stage prefix, so
    ``@stage/../x`` can never escape; mirror that by normalising and
    rejecting any path that resolves above the root (or is absolute).
    """
    rel = rel.strip()
    if not rel:
        return ""
    if rel.startswith(("/", "\\")) or "\x00" in rel:
        raise BadArguments(f"invalid stage path: {rel!r}")
    norm = posixpath.normpath(rel.replace("\\", "/"))
    if norm in (".", ""):
        return ""
    if norm == ".." or norm.startswith("../"):
        raise BadArguments(f"stage path escapes the stage root: {rel!r}")
    return norm


def _join(url: str, rel: str) -> str:
    rel = _safe_rel(rel.lstrip("/"))
    if not rel:
        return url
    return url.rstrip("/") + "/" + rel


class StageManager:
    """CRUD + file operations for named stages (meta-KV backed)."""

    def __init__(self, meta, data_root: str):
        self.meta = meta
        self.data_root = data_root

    # ------------------------------------------------------------- metadata
    def create(self, name: str, url: Optional[str] = None,
               file_format: Optional[Dict[str, str]] = None,
               comment: str = "", if_not_exists: bool = False,
               or_replace: bool = False,
               connection: Optional[Dict[str, str]] = None) -> StageInfo:
        key = _META_PREFIX + name
        existing, _seq = self.meta.get(key)
        if existing is not None and not or_replace:
            if if_not_exists:
                return StageInfo.from_dict(existing)
            raise BadArguments(f"stage {name!r} already exists")
        if url is None:
            stage_type = "Internal"
            url = os.path.join(self.data_root, "stages", name)
        else:
            stage_type = "External"
        info = StageInfo(name, stage_type, url, dict(file_format or {}),
                         comment, time.time(),
                         connection=dict(connection or {}))
        self.meta.upsert(key, info.to_dict())
        return info

    def drop(self, name: str, if_exists: bool = False) -> None:
        key = _META_PREFIX + name
        got, _seq = self.meta.get(key)
        if got is None:
            if if_exists:
                return
            raise UnknownStage(f"unknown stage {name!r}")
        info = StageInfo.from_dict(got)
        # internal stages own their files; external URLs are left untouched
        if info.stage_type == "Internal":
            for key_ in self._list_keys(info, ""):
                OPERATOR.delete(key_)
        self.meta.delete(key)

    def get(self, name: str) -> StageInfo:
        got, _seq = self.meta.get(_META_PREFIX + name)
        if got is None:
            raise UnknownStage(f"unknown stage {name!r}")
        return StageInfo.from_dict(got)

    def list(self) -> List[StageInfo]:
        return sorted((StageInfo.from_dict(v) for _, v, _
                       in self.meta.list_prefix(_META_PREFIX)),
                      key=lambda s: s.name)

    # ------------------------------------------------------------ reference
    def resolve(self, ref: str) -> Tuple[StageInfo, str]:
        """``@name[/rel/path]`` -> (StageInfo, rel_path).

        ``@~`` is the per-user stage (reference StageType::User), backed by
        an auto-created internal location.
        """
        if not ref.startswith("@"):
            raise SemanticError(f"not a stage reference: {ref!r}")
        body = ref[1:]
        name, _, rel = body.partition("/")
        if name == "~":
            key = _META_PREFIX + "~user~"
            got, _seq = self.meta.get(key)
            if got is None:
                info = StageInfo("~user~", "User",
                                 os.path.join(self.data_root, "stages", "~user~"),
                                 {}, "", time.time())
                self.meta.upsert(key, info.to_dict())
            else:
                info = StageInfo.from_dict(got)
            return info, _safe_rel(rel)
        return self.get(name), _safe_rel(rel)

    # ------------------------------------------------------------ file ops
    def _op(self, info: StageInfo):
        """The stage's data-plane operator: connection-scoped credentials
        when the stage carries CONNECTION params (inline or by
        connection_name), the ambient chain otherwise (reference:
        per-stage storage params, src/meta/app-storage)."""
        params = dict(info.connection)
        cname = params.pop("connection_name", None)
        if cname:
            got, _seq = self.meta.get(f"connections/{cname.lower()}")
            if got is None:
                raise BadArguments(f"unknown connection {cname!r}")
            merged = dict(got.get("params") or {})
            merged.update(params)
            params = merged
        return OPERATOR.scoped(params)

    def _list_keys(self, info: StageInfo, rel: str) -> List[str]:
        prefix = _join(info.url, rel)
        if OPERATOR.is_object_store(info.url):
            return sorted(self._op(info).list(prefix))
        # fs: prefix may be a directory, a file, or a glob-ish path head
        if os.path.isdir(prefix):
            out = []
            for root, _dirs, names in os.walk(prefix):
                out.extend(os.path.join(root, n) for n in names)
            return sorted(out)
        if os.path.isfile(prefix):
            return [prefix]
        return []

    def list_files(self, ref: str, pattern: Optional[str] = None
                   ) -> List[Tuple[str, int]]:
        """LIST @stage — [(relative name, size)]."""
        info, rel = self.resolve(ref)
        base = info.url.rstrip("/") + "/"
        out = []
        for key in self._list_keys(info, rel):
            name = key[len(base):] if key.startswith(base) else posixpath.basename(key)
            if pattern and not fnmatch.fnmatch(name, pattern):
                continue
            out.append((name, self._op(info).size(key)))
        return out

    def remove(self, ref: str, pattern: Optional[str] = None) -> int:
        info, rel = self.resolve(ref)
        base = info.url.rstrip("/") + "/"
        n = 0
        for key in self._list_keys(info, rel):
            name = key[len(base):] if key.startswith(base) else posixpath.basename(key)
            if pattern and not fnmatch.fnmatch(name, pattern):
                continue
            self._op(info).delete(key)
            n += 1
        return n

    def put_bytes(self, ref: str, rel_name: str, data: bytes) -> str:
        """Upload helper (the PUT side of presigned flows and tests)."""
        info, rel = self.resolve(ref)
        key = _join(info.url, posixpath.join(rel, rel_name) if rel else rel_name)
        if not OPERATOR.is_object_store(key):
            os.makedirs(os.path.dirname(key), exist_ok=True)
        self._op(info).write_bytes(key, data)
        return key

    def presign(self, ref: str, method: str = "DOWNLOAD",
                expire_secs: int = 3600) -> dict:
        """PRESIGN [DOWNLOAD|UPLOAD] @stage/file — reference presign.rs.

        S3 backends produce a real presigned URL when botocore is present;
        fs/memory return a file:// URL (the local-dev behavior).
        """
        info, rel = self.resolve(ref)
        if not rel:
            raise BadArguments("PRESIGN requires a file path: @stage/file")
        key = _join(info.url, rel)
        headers: Dict[str, str] = {}
        if OPERATOR.is_object_store(key) and key.startswith("s3://"):
            try:
                backend = self._op(info).backend_for(key)
                bucket, obj = backend._split(key)
                op = ("get_object" if method.upper() == "DOWNLOAD"
                      else "put_object")
                url = backend._s3.generate_presigned_url(
                    op, Params={"Bucket": bucket, "Key": obj},
                    ExpiresIn=expire_secs)
            except Exception:
                url = key
        else:
            url = "file://" + key
        return {"method": "GET" if method.upper() == "DOWNLOAD" else "PUT",
                "headers": headers, "url": url}

    def materialize(self, info: StageInfo, key: str, scratch_dir: str) -> str:
        """Make a stage object readable as a local file for the decoders."""
        if not OPERATOR.is_object_store(key):
            return key
        os.makedirs(scratch_dir, exist_ok=True)
        fd, local = tempfile.mkstemp(dir=scratch_dir,
                                     suffix="_" + posixpath.basename(key))
        with os.fdopen(fd, "wb") as f:
            f.write(self._op(info).read_bytes(key))
        return local

    def scan_block(self, ref: str, options: Dict[str, str],
                   scratch_dir: str):
        """SELECT-from-stage: read every matching file into one DataBlock.

        Reference: stage table (src/query/storages/stage/src/stage_table.rs)
        — schema inferred per format, files concatenated in name order.
        """
        from ..expression import DataBlock
        from ..formats import FileFormatOptions, detect_format, infer_schema, read_file
        info, _rel = self.resolve(ref)
        pattern = options.get("pattern")
        files = self.source_files(ref, pattern)
        fmt_opts = dict(info.file_format)
        for k, v in options.items():
            if k == "file_format":
                fmt_opts["type"] = v
            elif k != "pattern":
                fmt_opts[k] = v
        locals_ = [self.materialize(info, key, scratch_dir)
                   for _name, key in files]
        opts = (FileFormatOptions.from_dict(fmt_opts) if fmt_opts
                else FileFormatOptions(type=detect_format(locals_[0])))
        schema = infer_schema(locals_[0], opts)
        blocks = [read_file(p, schema, opts) for p in locals_]
        return DataBlock.concat(blocks), schema.fields

    def source_files(self, ref: str, pattern: Optional[str] = None,
                     files: Optional[List[str]] = None
                     ) -> List[Tuple[str, str]]:
        """COPY-source resolution: [(stage-relative name, storage key)]."""
        info, rel = self.resolve(ref)
        base = info.url.rstrip("/") + "/"
        if files:
            out = []
            for f in files:
                key = _join(info.url, posixpath.join(rel, f) if rel else f)
                if not OPERATOR.exists(key):
                    raise BadArguments(f"stage file not found: @{info.name}/{f}")
                out.append((f, key))
            return out
        out = []
        for key in self._list_keys(info, rel):
            name = key[len(base):] if key.startswith(base) else posixpath.basename(key)
            if pattern and not fnmatch.fnmatch(name, pattern):
                continue
            out.append((name, key))
        if not out:
            raise BadArguments(f"COPY source matches no files: {ref!r}")
        return out
