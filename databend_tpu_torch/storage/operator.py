"""DataOperator: scheme-dispatched object storage (the opendal analog).

The reference is object-storage-native: every fuse read/write goes through
an opendal ``DataOperator`` configured for S3/GCS/Azure/HDFS/fs/memory
(reference: src/common/storage, init at
src/query/service/src/binaries .. entry.rs:176 ``DataOperator::init``).
Here the same role is played by a path-scheme router:

* plain paths           -> local filesystem
* ``memory://ns/...``   -> process-wide in-memory object store
* ``s3://bucket/key``   -> boto3 when available, otherwise the in-memory
                           S3 double (same semantics: flat keyspace, no
                           directories, last-write-wins puts)

All fuse/bendsave IO funnels through the module-level ``OPERATOR`` facade,
with a retry layer for transient errors (reference: opendal RetryLayer).
``os.path.join`` keeps scheme prefixes intact on posix, so callers build
paths exactly as they would for the local fs.
"""

from __future__ import annotations

import io
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

RETRIES = 3
RETRY_BASE_DELAY_S = 0.05


class Backend:
    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        """Keys under prefix (recursive), absolute paths."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:  # flat stores: no-op
        pass


class FsBackend(Backend):
    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def list(self, prefix: str) -> List[str]:
        out = []
        if os.path.isdir(prefix):
            for root, _dirs, files in os.walk(prefix):
                for fn in files:
                    out.append(os.path.join(root, fn))
        return sorted(out)

    def delete(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)


class MemoryBackend(Backend):
    """Process-wide flat object store — the S3 test double.

    S3 semantics: a flat keyspace (no directories to create), whole-object
    puts with last-write-wins, list-by-prefix.
    """

    _stores: Dict[str, Dict[str, bytes]] = {}
    _lock = threading.Lock()

    def __init__(self, scheme: str):
        self.scheme = scheme

    def _store(self) -> Dict[str, bytes]:
        with MemoryBackend._lock:
            return MemoryBackend._stores.setdefault(self.scheme, {})

    def read_bytes(self, path: str) -> bytes:
        store = self._store()
        data = store.get(path)
        if data is None:
            raise FileNotFoundError(path)
        return data

    def write_bytes(self, path: str, data: bytes) -> None:
        self._store()[path] = bytes(data)

    def exists(self, path: str) -> bool:
        store = self._store()
        if path in store:
            return True
        # directory-like existence: any key under it
        p = path.rstrip("/") + "/"
        return any(k.startswith(p) for k in store)

    def list(self, prefix: str) -> List[str]:
        p = prefix.rstrip("/") + "/"
        store = self._store()
        return sorted(k for k in store if k.startswith(p) or k == prefix)

    def delete(self, path: str) -> None:
        self._store().pop(path, None)

    def size(self, path: str) -> int:
        return len(self.read_bytes(path))

    @classmethod
    def wipe(cls):  # test helper
        with cls._lock:
            cls._stores.clear()


class S3Backend(Backend):
    """Real S3 via boto3 (when installed). Paths are s3://bucket/key.

    ``params`` carries connection-scoped credentials (reference:
    src/meta/app-storage StorageS3Config — access_key_id,
    secret_access_key, session_token, endpoint_url, region); absent
    keys fall back to the ambient boto3 chain."""

    def __init__(self, params: Optional[Dict[str, str]] = None):
        import boto3  # gated: raise cleanly when unavailable
        kw = {}
        p = params or {}
        if p.get("access_key_id"):
            kw["aws_access_key_id"] = p["access_key_id"]
        if p.get("secret_access_key"):
            kw["aws_secret_access_key"] = p["secret_access_key"]
        if p.get("session_token"):
            kw["aws_session_token"] = p["session_token"]
        if p.get("endpoint_url"):
            kw["endpoint_url"] = p["endpoint_url"]
        if p.get("region"):
            kw["region_name"] = p["region"]
        self._s3 = boto3.client("s3", **kw)

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        rest = path[len("s3://"):]
        bucket, _, key = rest.partition("/")
        return bucket, key

    def read_bytes(self, path: str) -> bytes:
        b, k = self._split(path)
        return self._s3.get_object(Bucket=b, Key=k)["Body"].read()

    def write_bytes(self, path: str, data: bytes) -> None:
        b, k = self._split(path)
        self._s3.put_object(Bucket=b, Key=k, Body=data)

    def exists(self, path: str) -> bool:
        b, k = self._split(path)
        try:
            self._s3.head_object(Bucket=b, Key=k)
            return True
        except Exception:
            return bool(self.list(path))

    def list(self, prefix: str) -> List[str]:
        b, k = self._split(prefix.rstrip("/") + "/")
        out = []
        token = None
        while True:
            kw = {"Bucket": b, "Prefix": k}
            if token:
                kw["ContinuationToken"] = token
            resp = self._s3.list_objects_v2(**kw)
            out.extend(f"s3://{b}/{o['Key']}" for o in resp.get("Contents", []))
            token = resp.get("NextContinuationToken")
            if not token:
                break
        return sorted(out)

    def delete(self, path: str) -> None:
        b, k = self._split(path)
        self._s3.delete_object(Bucket=b, Key=k)

    def size(self, path: str) -> int:
        b, k = self._split(path)
        return int(self._s3.head_object(Bucket=b, Key=k)["ContentLength"])


class DataOperator:
    """Scheme router + retry layer. One process-wide instance (OPERATOR)."""

    def __init__(self):
        self._fs = FsBackend()
        self._backends: Dict[str, Backend] = {}

    def backend_for(self, path: str) -> Backend:
        if path.startswith("memory://"):
            return self._cached("memory")
        if path.startswith("s3://"):
            return self._cached("s3")
        return self._fs

    def scoped(self, params: Optional[Dict[str, str]]) -> "DataOperator":
        """An operator view whose s3 backend authenticates with the given
        connection parameters instead of the ambient chain (reference:
        per-stage/连接 storage params, src/meta/app-storage). Falls back
        to this operator when no credential keys are present. Scoped
        backends are cached per credential set."""
        keys = ("access_key_id", "secret_access_key", "session_token",
                "endpoint_url", "region")
        p = {k: v for k, v in (params or {}).items() if k in keys and v}
        if not p:
            return self
        cache_key = "s3:" + "\x1f".join(f"{k}={p[k]}" for k in sorted(p))
        b = self._backends.get(cache_key)
        if b is None:
            try:
                b = S3Backend(p)
            except Exception:
                # no boto3: the in-memory double, namespaced per cred set
                # so scoped writes stay isolated in tests
                b = MemoryBackend(cache_key)
            self._backends[cache_key] = b
        view = DataOperator.__new__(DataOperator)
        view._fs = self._fs
        view._backends = dict(self._backends)
        view._backends["s3"] = b
        return view

    def _cached(self, scheme: str) -> Backend:
        b = self._backends.get(scheme)
        if b is None:
            if scheme == "s3":
                try:
                    b = S3Backend()
                except Exception:
                    # no boto3 / no credentials: in-process S3 double
                    b = MemoryBackend("s3")
            else:
                b = MemoryBackend(scheme)
            self._backends[scheme] = b
        return b

    # --------------------------------------------------------------- retries
    def _with_retry(self, fn, *args):
        last = None
        for attempt in range(RETRIES):
            try:
                return fn(*args)
            except FileNotFoundError:
                raise  # not transient
            except OSError as e:
                last = e
                time.sleep(RETRY_BASE_DELAY_S * (2 ** attempt))
        raise last

    # ------------------------------------------------------------------- api
    def read_bytes(self, path: str) -> bytes:
        return self._with_retry(self.backend_for(path).read_bytes, path)

    def open_read(self, path: str) -> io.BytesIO:
        return io.BytesIO(self.read_bytes(path))

    def write_bytes(self, path: str, data: bytes) -> None:
        self._with_retry(self.backend_for(path).write_bytes, path, data)

    def exists(self, path: str) -> bool:
        return self.backend_for(path).exists(path)

    def list(self, prefix: str) -> List[str]:
        return self.backend_for(prefix).list(prefix)

    def delete(self, path: str) -> None:
        self.backend_for(path).delete(path)

    def size(self, path: str) -> int:
        return self.backend_for(path).size(path)

    def makedirs(self, path: str) -> None:
        self.backend_for(path).makedirs(path)

    @staticmethod
    def is_object_store(path: str) -> bool:
        return path.startswith(("memory://", "s3://"))


OPERATOR = DataOperator()
