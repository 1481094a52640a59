"""ctypes binding for the native shared-memory object store
(ray_tpu_torch/_native/plasma_store.cc).

The store client in the reference talks to a store server over a unix socket
with fd passing (reference: src/ray/object_manager/plasma/client.cc); here every
client attaches the named shm segment directly and the C library synchronizes
through a robust in-segment mutex, so get() of a sealed object is a hash probe
plus an mmap'd memoryview — no syscalls on the hot path after attach.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

PS_OK = 0
PS_NOT_FOUND = 1
PS_EXISTS = 2
PS_OOM = 3
PS_NOT_SEALED = 4
PS_PINNED = 5
PS_ERROR = 6

_ID_SIZE = 20

_build_lock = threading.Lock()
_lib = None


def _src_path():
    # the C++ source ships inside the package so installed copies
    # (pip install, wheels) can build without the repo checkout
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "plasma_store.cc"
    )


def _lib_path():
    """Per-(version, source-hash) .so in the package's ``_build/``, where
    the port's CUDA kernels go too (``RTPU_TORCH_CACHE_DIR`` overrides it,
    for a read-only install): a content-keyed name makes the existence
    check the freshness check, and the library never mixes with the JAX
    package's (reference: python/setup.py ships prebuilt binaries; here the
    toolchain is on the box, so a first-use build is simpler)."""
    import hashlib

    from ray_tpu_torch import __version__ as version

    with open(_src_path(), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    cache = os.environ.get("RTPU_TORCH_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
    )
    return os.path.join(cache, f"libplasma-{version}-{digest}.so")


def build_native(force: bool = False) -> str:
    """Compile libplasma.so if not cached for this (version, source);
    returns its path."""
    with _build_lock:
        lib = _lib_path()
        if not force and os.path.exists(lib):
            return lib
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = lib + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
            "-o", tmp, _src_path(), "-lpthread", "-lrt",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib)
        return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    lib = ctypes.CDLL(path)
    lib.ps_open.restype = ctypes.c_void_p
    lib.ps_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.ps_close.argtypes = [ctypes.c_void_p]
    lib.ps_unlink.argtypes = [ctypes.c_char_p]
    lib.ps_base.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ps_base.argtypes = [ctypes.c_void_p]
    lib.ps_capacity.restype = ctypes.c_uint64
    lib.ps_capacity.argtypes = [ctypes.c_void_p]
    lib.ps_arena_offset.restype = ctypes.c_uint64
    lib.ps_arena_offset.argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ps_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, u64p]
    lib.ps_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p, u64p]
    lib.ps_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p]
    lib.ps_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p, u64p, u64p]
    lib.ps_list.restype = ctypes.c_uint64
    lib.ps_list.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.ps_test_lock.argtypes = [ctypes.c_void_p]
    lib.ps_recovered_count.restype = ctypes.c_uint64
    lib.ps_recovered_count.argtypes = [ctypes.c_void_p]
    lib.ps_poisoned.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class PlasmaOOM(Exception):
    pass


class PlasmaClient:
    """Handle to one node-local store segment.

    The raylet creates the segment (create=True); workers attach.
    """

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        self._libref = _load()
        self.name = name
        self._handle = self._libref.ps_open(name.encode(), capacity, 1 if create else 0)
        if not self._handle:
            raise RuntimeError(f"failed to open plasma store {name}")
        # Build a zero-copy view over the whole arena via /dev/shm mmap.
        shm_path = f"/dev/shm{name}" if name.startswith("/") else f"/dev/shm/{name}"
        self._f = open(shm_path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), 0)
        self._arena_off = self._libref.ps_arena_offset(self._handle)
        self._view = memoryview(self._mm)

    @staticmethod
    def _id_bytes(object_id) -> bytes:
        if isinstance(object_id, ObjectID):
            return object_id.binary()
        return bytes(object_id)

    def create(self, object_id, size: int) -> memoryview:
        off = ctypes.c_uint64()
        rc = self._libref.ps_create(
            self._handle, self._id_bytes(object_id), size, ctypes.byref(off)
        )
        if rc == PS_EXISTS:
            raise FileExistsError(f"object {object_id} already exists")
        if rc == PS_OOM:
            raise PlasmaOOM(f"object store out of memory creating {size} bytes")
        if rc != PS_OK:
            raise RuntimeError(f"plasma create failed rc={rc}")
        start = self._arena_off + off.value
        return self._view[start : start + size]

    def seal(self, object_id):
        rc = self._libref.ps_seal(self._handle, self._id_bytes(object_id))
        if rc != PS_OK:
            raise RuntimeError(f"plasma seal failed rc={rc}")
        # Drop the creator pin taken at create().
        self._libref.ps_release(self._handle, self._id_bytes(object_id))

    def put_blob(self, object_id, data) -> bool:
        """Create+copy+seal in one step — the single copy of the store's
        zero-copy discipline (callers hand raw views, never pre-materialized
        bytes; the hot path streams via serialization.write_blob instead).
        Returns False if it already existed."""
        data = memoryview(data)
        nbytes = data.nbytes
        try:
            dest = self.create(object_id, nbytes)
        except FileExistsError:
            return False
        if nbytes:  # cast("B") rejects empty multi-dim views
            dest[:] = data.cast("B")
        dest.release()
        self.seal(object_id)
        return True

    def get(self, object_id) -> Optional[memoryview]:
        """Zero-copy view of a sealed object; pins it until release()."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._libref.ps_get(
            self._handle, self._id_bytes(object_id), ctypes.byref(off), ctypes.byref(size)
        )
        if rc in (PS_NOT_FOUND, PS_NOT_SEALED):
            return None
        if rc != PS_OK:
            raise RuntimeError(f"plasma get failed rc={rc}")
        start = self._arena_off + off.value
        return self._view[start : start + size.value]

    def contains(self, object_id) -> bool:
        return bool(self._libref.ps_contains(self._handle, self._id_bytes(object_id)))

    def release(self, object_id):
        # A zero-copy value may outlive close() (a driver's shutdown): the
        # mapping stays, and its pin went with the client, so there is
        # nothing to release (ps_release on the closed handle would crash).
        if self._handle:
            self._libref.ps_release(self._handle, self._id_bytes(object_id))

    def delete(self, object_id) -> bool:
        rc = self._libref.ps_delete(self._handle, self._id_bytes(object_id))
        return rc == PS_OK

    def abort(self, object_id):
        self._libref.ps_abort(self._handle, self._id_bytes(object_id))

    def evict(self, num_bytes: int) -> int:
        freed = ctypes.c_uint64()
        self._libref.ps_evict(self._handle, num_bytes, ctypes.byref(freed))
        return freed.value

    def list_object_ids(self, max_objects: int = 65536):
        buf = (ctypes.c_uint8 * (max_objects * _ID_SIZE))()
        n = self._libref.ps_list(self._handle, buf, max_objects)
        raw = bytes(buf)
        return [ObjectID(raw[i * _ID_SIZE : (i + 1) * _ID_SIZE]) for i in range(n)]

    def stats(self):
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        num = ctypes.c_uint64()
        ev_b = ctypes.c_uint64()
        ev_c = ctypes.c_uint64()
        self._libref.ps_stats(
            self._handle, ctypes.byref(used), ctypes.byref(cap), ctypes.byref(num),
            ctypes.byref(ev_b), ctypes.byref(ev_c),
        )
        return {
            "used_bytes": used.value,
            "capacity_bytes": cap.value,
            "num_objects": num.value,
            "evicted_bytes": ev_b.value,
            "evicted_count": ev_c.value,
        }

    def recovered_count(self) -> int:
        """Owner-death free-list rebuilds performed on this store."""
        return self._libref.ps_recovered_count(self._handle)

    def poisoned(self) -> bool:
        """True if unrecoverable corruption was detected; all ops fail."""
        return bool(self._libref.ps_poisoned(self._handle))

    def _test_lock_and_abandon(self):
        """Test-only: take the store mutex and never release it. The calling
        process is expected to exit, triggering EOWNERDEAD recovery in the
        next locker."""
        self._libref.ps_test_lock(self._handle)

    def close(self, unmap: bool = False):
        """Detach from the store.

        By default the mapping is left in place until process exit: zero-copy
        values deserialized from the store may still alias it, and unmapping
        under them would turn later reads into segfaults. Pass unmap=True only
        when no views can be outstanding (e.g. the raylet destroying the store).
        """
        if self._handle:
            try:
                self._f.close()
            except Exception:
                pass
            if unmap:
                try:
                    self._view.release()
                    self._mm.close()
                except Exception:
                    pass
                self._libref.ps_close(self._handle)
            self._handle = None

    @staticmethod
    def unlink(name: str):
        _load().ps_unlink(name.encode())
