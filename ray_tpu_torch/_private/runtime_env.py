"""runtime_env materialization: working_dir packaging + per-node extraction.

Counterpart of the reference's runtime_env packaging + agent
(reference: python/ray/_private/runtime_env/packaging.py — zip working_dir
into the GCS KV keyed by content hash; runtime_env/agent/runtime_env_agent.py
— per-node download/extract before worker start). Here the driver uploads,
and the raylet extracts into <session_dir>/runtime_envs/<hash>/ the first
time a lease needs it; workers chdir there via RTPU_TORCH_WORKING_DIR.
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import Optional

KV_NAMESPACE = "runtime_env"
URI_PREFIX = "kv:"
WORKING_DIR_ENV = "RTPU_TORCH_WORKING_DIR"

_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}
_MAX_WORKING_DIR_BYTES = 512 * 1024 * 1024


def package_working_dir(path: str, arc_prefix: str = "") -> bytes:
    """Deterministically zip a local directory (stable hash for same
    content). arc_prefix nests entries under a directory inside the
    archive — py_modules use the module dir's basename so the EXTRACTED
    root is a sys.path entry from which `import <basename>` works
    (reference py_modules contract)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env working_dir {path!r} is not a directory")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for fname in sorted(files):
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, path)
                if arc_prefix:
                    rel = os.path.join(arc_prefix, rel)
                try:
                    total += os.path.getsize(full)
                except OSError:
                    continue
                if total > _MAX_WORKING_DIR_BYTES:
                    raise ValueError(
                        f"working_dir {path!r} exceeds "
                        f"{_MAX_WORKING_DIR_BYTES} bytes"
                    )
                # Fixed date_time so identical content hashes identically.
                info = zipfile.ZipInfo(rel, date_time=(2000, 1, 1, 0, 0, 0))
                info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
                with open(full, "rb") as f:
                    zf.writestr(info, f.read())
    return buf.getvalue()


def upload_working_dir(gcs, path: str, arc_prefix: str = "") -> str:
    """Zip + upload to the GCS KV; returns the kv:<hash> URI."""
    blob = package_working_dir(path, arc_prefix)
    digest = hashlib.sha1(blob).hexdigest()
    key = digest.encode()
    if not gcs.kv_exists(KV_NAMESPACE, key):
        gcs.kv_put(KV_NAMESPACE, key, blob, overwrite=False)
    return URI_PREFIX + digest


def materialized_path(uri: str, base_dir: str) -> str:
    """Where an uploaded working_dir lives once extracted on this node."""
    assert uri.startswith(URI_PREFIX), uri
    return os.path.join(base_dir, "runtime_envs", uri[len(URI_PREFIX):])


def extract_working_dir(uri: str, blob: Optional[bytes], base_dir: str) -> str:
    """Extract an uploaded working_dir under base_dir; idempotent per hash.

    Returns the extracted directory path. ``blob`` may be None if the
    directory already exists (caller can skip the KV fetch). Concurrent
    extractions are safe: each works in a unique tmp dir and the first
    rename wins.
    """
    import uuid

    target = materialized_path(uri, base_dir)
    if os.path.isdir(target):
        return target
    if blob is None:
        raise FileNotFoundError(f"working_dir {uri} not materialized")
    tmp = target + f".tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            for info in zf.infolist():
                extracted = zf.extract(info, tmp)
                # extractall/extract ignore permissions; restore the modes
                # packaged in external_attr (executables must stay runnable).
                mode = (info.external_attr >> 16) & 0xFFFF
                if mode:
                    os.chmod(extracted, mode & 0o7777)
        os.rename(tmp, target)
    except OSError:
        # Lost a concurrent-extract race: the winner's tree is equivalent.
        if not os.path.isdir(target):
            raise
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return target


def dir_signature(path: str) -> str:
    """Cheap content signature (names+sizes+mtimes) for upload caching."""
    h = hashlib.sha1()
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for fname in sorted(files):
            full = os.path.join(root, fname)
            try:
                st = os.stat(full)
            except OSError:
                continue
            h.update(
                f"{os.path.relpath(full, path)}:{st.st_size}:{st.st_mtime_ns}".encode()
            )
    return h.hexdigest()


def is_uploaded(working_dir: Optional[str]) -> bool:
    return bool(working_dir) and working_dir.startswith(URI_PREFIX)
