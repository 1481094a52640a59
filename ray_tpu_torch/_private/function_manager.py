"""Export/import of remote functions and actor classes through the GCS KV.

Same shape as the reference's function table
(reference: python/ray/_private/function_manager.py): the driver exports
cloudpickled callables under a content-hash key; executing workers fetch once
and cache. Export happens lazily on first `.remote()` call.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Any, Dict

import cloudpickle

FN_NS = "fn"


class FunctionManager:
    def __init__(self, kv_put, kv_get):
        # kv_put(ns, key, value, overwrite) / kv_get(ns, key) are sync callables
        # wired to the GCS client by the worker.
        self._kv_put = kv_put
        self._kv_get = kv_get
        self._exported: set = set()
        self._cache: Dict[bytes, Any] = {}
        self._by_obj: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def export(self, obj: Any) -> bytes:
        """Pickle obj, store under its hash, return the key.

        Memoized per object (weak-keyed, so a driver minting fresh closures
        per submission doesn't leak memory): re-pickling the same function
        for every .remote() costs ~0.2 ms/call."""
        try:
            memo = self._by_obj.get(obj)
        except TypeError:
            memo = None  # unhashable / not weakrefable
        if memo is not None:
            return memo
        data = cloudpickle.dumps(obj)
        key = hashlib.sha1(data).digest()
        with self._lock:
            exported = key in self._exported
        if not exported:
            self._kv_put(FN_NS, key, data, False)
            with self._lock:
                self._exported.add(key)
                self._cache[key] = obj
        try:
            self._by_obj[obj] = key
        except TypeError:
            pass
        return key

    def seed(self, key: bytes, data: bytes):
        """Pre-populate the cache from a blob fetched by someone else (the
        raylet ships the actor class in the spawn message so freshly-forked
        actor workers skip the per-process KV round-trip)."""
        with self._lock:
            if key in self._cache:
                return
        obj = cloudpickle.loads(data)
        with self._lock:
            self._cache[key] = obj

    def fetch_cached(self, key: bytes) -> Any:
        """Non-blocking cache probe; None on miss (callers then fetch() off
        the io loop — the KV round-trip blocks)."""
        with self._lock:
            return self._cache.get(key)

    def fetch(self, key: bytes) -> Any:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        data = self._kv_get(FN_NS, key)
        if data is None:
            raise RuntimeError(f"function {key.hex()} not found in GCS function table")
        obj = cloudpickle.loads(data)
        with self._lock:
            self._cache[key] = obj
        return obj
