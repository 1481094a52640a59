"""ObjectRef — the user-facing future/handle for a value in the object store.

Semantics follow the reference's ownership model
(reference: src/ray/core_worker/reference_count.h:61): the worker that created
the ref (by ``put`` or by submitting the task that returns it) *owns* it — the
owner address travels with the ref so any borrower can reach the owner for
value/location queries and reference accounting.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

# Set by the worker module once a worker is connected; used for local refcounts
# and for `ref.get()` style conveniences.
_worker_hooks = None


def set_worker_hooks(hooks):
    global _worker_hooks
    _worker_hooks = hooks


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_skip_refcount", "__weakref__")

    def __init__(
        self,
        object_id: ObjectID,
        owner_addr: Optional[Tuple[str, int]] = None,
        skip_refcount: bool = False,
    ):
        self._id = object_id
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._skip_refcount = skip_refcount
        if not skip_refcount and _worker_hooks is not None:
            _worker_hooks.add_local_ref(self)

    def object_id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    @property
    def owner_address(self):
        return self._owner_addr

    def task_id(self):
        return self._id.task_id()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        if not self._skip_refcount and _worker_hooks is not None:
            try:
                _worker_hooks.remove_local_ref(self)
            except Exception:
                pass

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        if _worker_hooks is None:
            raise RuntimeError("ray_tpu_torch not initialized")
        return _worker_hooks.as_future(self)

    def __reduce__(self):
        # Plain pickling (outside the runtime serializer) preserves identity but
        # does not register borrows; the runtime serializer intercepts before this.
        return (ObjectRef, (self._id, self._owner_addr))

    def __await__(self):
        if _worker_hooks is None:
            raise RuntimeError("ray_tpu_torch not initialized")
        return _worker_hooks.await_ref(self).__await__()
