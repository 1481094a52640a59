"""In-process memory store for inline objects owned by this worker.

Counterpart of the reference's CoreWorkerMemoryStore
(reference: src/ray/core_worker/store_provider/memory_store/memory_store.h):
small task returns and pending-object placeholders live here; `get` waiters
block on per-object asyncio events on the worker's IO loop.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import ObjectID


class _Pending:
    """Placeholder for an expected value. The event is lazy (most objects
    are put before anyone waits) and batch waiters let a 1000-ref get()
    block on ONE event instead of 1000 (each wait_for costs a Task + timer
    on the loop)."""

    __slots__ = ("event", "waiters")

    def __init__(self):
        self.event = None
        self.waiters = None

    def resolve(self):
        if self.event is not None:
            self.event.set()
        if self.waiters:
            for w in self.waiters:
                w.remaining -= 1
                if w.remaining <= 0:
                    w.event.set()
            self.waiters = None


class _BatchWaiter:
    __slots__ = ("remaining", "event")

    def __init__(self):
        self.remaining = 0
        self.event = asyncio.Event()


class InPlasma:
    """Placeholder value: the object's data lives in plasma, not in memory."""

    __slots__ = ("size", "locations")

    def __init__(self, size: int, locations=None):
        self.size = size
        # set of node_id bytes where a copy exists (owner-maintained directory)
        self.locations = set(locations or [])


class MemoryStore:
    """Must only be touched from the IO loop thread."""

    def __init__(self):
        self._store: Dict[ObjectID, Any] = {}
        self._pending: Dict[ObjectID, _Pending] = {}
        # io-loop callback fired when an object becomes available — the
        # core worker's dependency-gated task dispatch hangs off it
        # (reference: task_dependency_manager notifying the scheduler)
        self.on_ready = None

    def put_pending(self, object_id: ObjectID):
        if object_id not in self._store and object_id not in self._pending:
            self._pending[object_id] = _Pending()

    def put(self, object_id: ObjectID, value: Any):
        self._store[object_id] = value
        p = self._pending.pop(object_id, None)
        if p is not None:
            p.resolve()
        if self.on_ready is not None:
            self.on_ready(object_id)

    def contains(self, object_id: ObjectID) -> bool:
        return object_id in self._store

    def get_if_exists(self, object_id: ObjectID):
        return self._store.get(object_id)

    def is_pending(self, object_id: ObjectID) -> bool:
        return object_id in self._pending

    async def wait_ready(self, object_id: ObjectID, timeout: Optional[float] = None):
        """Wait until a value (or plasma placeholder) is set. Returns True if ready."""
        if object_id in self._store:
            return True
        p = self._pending.get(object_id)
        if p is None:
            # Not pending and not present: either never created here or already freed.
            return object_id in self._store
        if p.event is None:
            p.event = asyncio.Event()
        if timeout is None:
            await p.event.wait()
            return True
        try:
            await asyncio.wait_for(p.event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def wait_ready_many(self, object_ids, timeout: Optional[float] = None) -> bool:
        """Wait until ALL given objects resolve (value, placeholder, or
        free). One event for the whole batch. False on timeout."""
        w = _BatchWaiter()
        registered = []
        for oid in object_ids:
            if oid in self._store:
                continue
            p = self._pending.get(oid)
            if p is None:
                continue
            if p.waiters is None:
                p.waiters = []
            p.waiters.append(w)
            registered.append(p)
            w.remaining += 1
        if w.remaining <= 0:
            return True
        if timeout is None:
            await w.event.wait()
            return True
        try:
            await asyncio.wait_for(w.event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            # Deregister, or a get()-with-timeout polling loop accumulates
            # a stale waiter per call on every still-pending object.
            for p in registered:
                if p.waiters is not None:
                    try:
                        p.waiters.remove(w)
                    except ValueError:
                        pass
            return False

    def free(self, object_id: ObjectID):
        self._store.pop(object_id, None)
        p = self._pending.pop(object_id, None)
        if p is not None:
            p.resolve()

    def fail_pending(self, object_id: ObjectID, error: Exception):
        """Resolve a pending object to an error value (task failure, etc.)."""
        self.put(object_id, error)

    def size(self) -> int:
        return len(self._store)
