"""Checkpoint: a directory of files addressed by local path OR storage URI
(reference: python/ray/train/_checkpoint.py:56 — a dir + pyarrow-fs URI).
Local paths cover single-node and shared-FS clusters (a directory of
``torch.save`` files); URIs (mock://, s3://, ...) go through ``_storage`` so
driver and workers never assume a shared filesystem."""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Optional


class Checkpoint:
    def __init__(self, path: str):
        from ray_tpu_torch.train._storage import is_remote_uri

        self._remote = is_remote_uri(path)
        self.path = path if self._remote else os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        return cls(uri)

    @property
    def uri(self) -> Optional[str]:
        return self.path if self._remote else None

    def as_directory(self):
        """Context manager yielding a local directory with the contents.
        Remote checkpoints download to a temp dir cleaned up on exit."""
        if not self._remote:
            return contextlib.nullcontext(self.path)

        @contextlib.contextmanager
        def _dl():
            tmp = tempfile.mkdtemp(prefix="rtpu_ckpt_")
            try:
                yield self.to_directory(tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)

        return _dl()

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        if self._remote:
            from ray_tpu_torch.train._storage import get_storage

            return get_storage(self.path).download_dir("", dest)
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))
