"""Checkpoint storage abstraction: URI-addressed persistence so Train/Tune
work on clusters WITHOUT a shared filesystem
(reference: python/ray/train/_internal/storage.py:352 StorageContext — the
reference uses pyarrow.fs URIs; we keep that for real remote schemes and add
a cluster-backed mock scheme for chip-free tests).

Schemes:
  /plain/path, file:///path  → LocalStorage (copytree; same-FS clusters)
  mock://bucket/prefix       → MockRemoteStorage: contents live in a detached
                               named actor, reachable from every node of the
                               cluster — simulates S3/GCS in tests and proves
                               the no-shared-FS path end to end
  s3://, gs://, hdfs://, ... → ArrowStorage via pyarrow.fs.FileSystem.from_uri

Workers upload checkpoints from their own node (`upload_dir`); the driver
only ever handles URIs, never worker-local paths.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional
from urllib.parse import urlparse

MOCK_STORAGE_ACTOR = "_rtpu_mock_storage"


def is_remote_uri(path: Optional[str]) -> bool:
    if not path:
        return False
    scheme = urlparse(path).scheme
    return scheme not in ("", "file")


def get_storage(uri: str) -> "Storage":
    scheme = urlparse(uri).scheme
    if scheme in ("", "file"):
        return LocalStorage(urlparse(uri).path if scheme else uri)
    if scheme == "mock":
        return MockRemoteStorage(uri)
    return ArrowStorage(uri)


class Storage:
    """upload/download directories addressed by a path relative to the root
    URI. `uri_of(rel)` returns the absolute URI of a relative path."""

    def uri_of(self, rel: str) -> str:
        raise NotImplementedError

    def upload_dir(self, local_dir: str, rel: str) -> str:
        raise NotImplementedError

    def download_dir(self, rel: str, local_dir: str) -> str:
        raise NotImplementedError

    def delete_dir(self, rel: str):
        raise NotImplementedError

    def list_dirs(self, rel: str = "") -> List[str]:
        raise NotImplementedError


class LocalStorage(Storage):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def uri_of(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def upload_dir(self, local_dir: str, rel: str) -> str:
        dest = self.uri_of(rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copytree(local_dir, dest, dirs_exist_ok=True)
        return dest

    def download_dir(self, rel: str, local_dir: str) -> str:
        src = rel if os.path.isabs(rel) else self.uri_of(rel)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)
        return local_dir

    def delete_dir(self, rel: str):
        shutil.rmtree(self.uri_of(rel), ignore_errors=True)

    def list_dirs(self, rel: str = "") -> List[str]:
        path = self.uri_of(rel) if rel else self.root
        if not os.path.isdir(path):
            return []
        return sorted(
            d for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d))
        )


class _MockStorageActor:
    """Detached actor holding {path: bytes} — the 'remote bucket'."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}

    def put_files(self, files: Dict[str, bytes]):
        self._files.update(files)
        return True

    def get_files(self, prefix: str) -> Dict[str, bytes]:
        prefix = prefix.rstrip("/") + "/"
        return {k: v for k, v in self._files.items() if k.startswith(prefix)}

    def delete_prefix(self, prefix: str):
        prefix = prefix.rstrip("/") + "/"
        for k in [k for k in self._files if k.startswith(prefix)]:
            del self._files[k]
        return True

    def list_dirs(self, prefix: str) -> List[str]:
        prefix = prefix.rstrip("/")
        pre = prefix + "/" if prefix else ""
        out = set()
        for k in self._files:
            if k.startswith(pre):
                rest = k[len(pre):]
                if "/" in rest:
                    out.add(rest.split("/", 1)[0])
        return sorted(out)


class MockRemoteStorage(Storage):
    """mock://bucket/prefix — files live in a detached named actor, so any
    node of the cluster can up/download without a shared filesystem."""

    def __init__(self, uri: str):
        p = urlparse(uri)
        self.uri_root = uri.rstrip("/")
        self.prefix = (p.netloc + p.path).rstrip("/")

    def _actor(self):
        import ray_tpu_torch

        try:
            return ray_tpu_torch.get_actor(MOCK_STORAGE_ACTOR)
        except Exception:
            try:
                return (
                    ray_tpu_torch.remote(_MockStorageActor)
                    .options(name=MOCK_STORAGE_ACTOR, lifetime="detached",
                             num_cpus=0)
                    .remote()
                )
            except Exception:
                return ray_tpu_torch.get_actor(MOCK_STORAGE_ACTOR)

    def uri_of(self, rel: str) -> str:
        return f"{self.uri_root}/{rel}" if rel else self.uri_root

    def _key(self, rel: str) -> str:
        return f"{self.prefix}/{rel}" if rel else self.prefix

    def upload_dir(self, local_dir: str, rel: str) -> str:
        import ray_tpu_torch

        files = {}
        base = self._key(rel)
        for dirpath, _, names in os.walk(local_dir):
            for n in names:
                fp = os.path.join(dirpath, n)
                rp = os.path.relpath(fp, local_dir)
                with open(fp, "rb") as f:
                    files[f"{base}/{rp}"] = f.read()
        ray_tpu_torch.get(self._actor().put_files.remote(files), timeout=120)
        return self.uri_of(rel)

    def download_dir(self, rel: str, local_dir: str) -> str:
        import ray_tpu_torch

        base = self._key(rel)
        files = ray_tpu_torch.get(self._actor().get_files.remote(base), timeout=120)
        if not files:
            raise FileNotFoundError(f"{self.uri_of(rel)} is empty/missing")
        for key, data in files.items():
            rp = key[len(base) + 1:]
            dest = os.path.join(local_dir, rp)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                f.write(data)
        return local_dir

    def delete_dir(self, rel: str):
        import ray_tpu_torch

        ray_tpu_torch.get(self._actor().delete_prefix.remote(self._key(rel)),
                    timeout=60)

    def list_dirs(self, rel: str = "") -> List[str]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor().list_dirs.remote(self._key(rel)),
                           timeout=60)


class ArrowStorage(Storage):
    """Real remote filesystems through pyarrow.fs (s3://, gs://, hdfs://)."""

    def __init__(self, uri: str):
        import pyarrow.fs as pafs

        self.uri_root = uri.rstrip("/")
        self.fs, self.root_path = pafs.FileSystem.from_uri(self.uri_root)

    def uri_of(self, rel: str) -> str:
        return f"{self.uri_root}/{rel}" if rel else self.uri_root

    def _key(self, rel: str) -> str:
        return f"{self.root_path}/{rel}" if rel else self.root_path

    def upload_dir(self, local_dir: str, rel: str) -> str:
        import pyarrow.fs as pafs

        pafs.copy_files(local_dir, self._key(rel),
                        destination_filesystem=self.fs)
        return self.uri_of(rel)

    def download_dir(self, rel: str, local_dir: str) -> str:
        import pyarrow.fs as pafs

        src = rel if "://" in rel else self._key(rel)
        pafs.copy_files(src, local_dir, source_filesystem=self.fs)
        return local_dir

    def delete_dir(self, rel: str):
        self.fs.delete_dir_contents(self._key(rel), missing_dir_ok=True)

    def list_dirs(self, rel: str = "") -> List[str]:
        import pyarrow.fs as pafs

        sel = pafs.FileSelector(self._key(rel), allow_not_found=True)
        return sorted(
            os.path.basename(f.path) for f in self.fs.get_file_info(sel)
            if f.type == pafs.FileType.Directory
        )
