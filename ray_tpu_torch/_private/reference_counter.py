"""Distributed reference counting, owner side and borrower side.

Follows the reference's ownership protocol in spirit
(reference: src/ray/core_worker/reference_count.h:61) with a simplified
borrowing rule: every process that materializes an ObjectRef it does not own
registers itself with the owner (AddBorrowerRef) and deregisters when its last
local reference drops (RemoveBorrowerRef). The owner frees the object when

    local_ref_count == 0  and  submitted_task_count == 0  and  no borrowers.

This is chattier than the reference's batched borrower-merging protocol but
has the same lifetime semantics; the hot path (refs that never leave the
owner) involves no RPCs at all.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.ids import ObjectID


@dataclass
class OwnedRef:
    local_refs: int = 0
    # Refs held by tasks we submitted that haven't finished yet.
    submitted_task_refs: int = 0
    # (host, port) of borrower worker rpc servers.
    borrowers: Set[Tuple[str, int]] = field(default_factory=set)
    # Lineage: spec of the task that can recreate this object (for reconstruction).
    lineage_task_id: Optional[bytes] = None
    freed: bool = False
    # --- ownership-ledger metadata (memory observability plane) ----------
    # Populated at add_owned / note_size time and ONLY read back by the
    # pull-only GetMemoryReport path — nothing on the hot path consults it.
    size: int = 0
    created: float = 0.0
    callsite: str = ""
    task_id: Optional[bytes] = None  # task whose return this is (if any)
    plasma: bool = False  # primary copy lives in the shared object store


class ReferenceCounter:
    """Thread-safe: touched from user threads (__del__) and the IO loop."""

    def __init__(self, on_zero: Callable[[ObjectID], None]):
        self._lock = threading.RLock()
        self._owned: Dict[ObjectID, OwnedRef] = {}
        # Objects this process borrows: id -> (owner_addr, local_count)
        self._borrowed: Dict[ObjectID, list] = {}
        self._on_zero = on_zero
        # Called with (object_id, owner_addr, delta) when a borrowed ref's local
        # count transitions 0->1 (+1) or 1->0 (-1); wired to RPC by the worker.
        self.on_borrow_change: Optional[Callable] = None

    # ---- owner side -------------------------------------------------------

    def add_owned(self, object_id: ObjectID, lineage_task_id=None, *,
                  size: int = 0, callsite: str = "", task_id=None):
        with self._lock:
            ref = self._owned.setdefault(object_id, OwnedRef())
            ref.lineage_task_id = lineage_task_id
            ref.created = time.time()
            if size:
                ref.size = size
            if callsite:
                ref.callsite = callsite
            if task_id is not None:
                ref.task_id = task_id

    def owns(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._owned

    def add_local_ref(self, object_id: ObjectID):
        with self._lock:
            ref = self._owned.get(object_id)
            if ref is not None:
                ref.local_refs += 1

    def remove_local_ref(self, object_id: ObjectID):
        self._change_owned(object_id, d_local=-1)

    def add_submitted_task_ref(self, object_id: ObjectID):
        with self._lock:
            ref = self._owned.get(object_id)
            if ref is not None:
                ref.submitted_task_refs += 1

    def remove_submitted_task_ref(self, object_id: ObjectID):
        self._change_owned(object_id, d_task=-1)

    def add_borrower(self, object_id: ObjectID, borrower: Tuple[str, int]):
        with self._lock:
            ref = self._owned.get(object_id)
            if ref is not None:
                ref.borrowers.add(tuple(borrower))

    def remove_borrower(self, object_id: ObjectID, borrower: Tuple[str, int]):
        with self._lock:
            ref = self._owned.get(object_id)
            if ref is None:
                return
            ref.borrowers.discard(tuple(borrower))
            self._maybe_free_locked(object_id, ref)

    def _change_owned(self, object_id: ObjectID, d_local=0, d_task=0):
        with self._lock:
            ref = self._owned.get(object_id)
            if ref is None:
                return
            ref.local_refs += d_local
            ref.submitted_task_refs += d_task
            self._maybe_free_locked(object_id, ref)

    def _maybe_free_locked(self, object_id: ObjectID, ref: OwnedRef):
        if (
            ref.local_refs <= 0
            and ref.submitted_task_refs <= 0
            and not ref.borrowers
            and not ref.freed
        ):
            ref.freed = True
            del self._owned[object_id]
            self._on_zero(object_id)

    def num_owned(self) -> int:
        with self._lock:
            return len(self._owned)

    def get_lineage(self, object_id: ObjectID):
        with self._lock:
            ref = self._owned.get(object_id)
            return ref.lineage_task_id if ref else None

    # ---- borrower side ----------------------------------------------------

    def add_borrowed_ref(self, object_id: ObjectID, owner_addr) -> bool:
        """Returns True if this is the first local ref (caller must notify owner)."""
        with self._lock:
            entry = self._borrowed.get(object_id)
            if entry is None:
                self._borrowed[object_id] = [tuple(owner_addr) if owner_addr else None, 1]
                return owner_addr is not None
            entry[1] += 1
            return False

    def remove_borrowed_ref(self, object_id: ObjectID) -> Optional[Tuple[str, int]]:
        """Returns owner_addr if this was the last local ref (caller notifies owner)."""
        with self._lock:
            entry = self._borrowed.get(object_id)
            if entry is None:
                return None
            entry[1] -= 1
            if entry[1] <= 0:
                del self._borrowed[object_id]
                return entry[0]
            return None

    def stats(self):
        with self._lock:
            return {"owned": len(self._owned), "borrowed": len(self._borrowed)}

    # ---- ownership ledger (pull-only; memory observability plane) ---------

    def note_size(self, object_id: ObjectID, size: int, plasma: bool = False):
        """Record an owned ref's byte size once it becomes known (reply
        landing, plasma registration). No-op for refs we no longer own."""
        with self._lock:
            ref = self._owned.get(object_id)
            if ref is not None:
                ref.size = size
                if plasma:
                    ref.plasma = True

    def owns_many(self, ids) -> List[bool]:
        """Batch ownership probe for the leak detector's CheckRefs RPC."""
        with self._lock:
            return [oid in self._owned for oid in ids]

    def ledger(self, limit: int = 0) -> List[dict]:
        """Snapshot of every owned ref's metadata, largest first.

        This IS the per-worker object ownership ledger: per ref — size,
        owning task, creation callsite, pin/plasma state, age, refcounts.
        Built entirely on demand (the hot path only ever wrote the cheap
        fields); ``limit`` > 0 keeps the top holders by size.
        """
        now = time.time()
        with self._lock:
            rows = [
                {
                    "object_id": oid.binary(),
                    "size": ref.size,
                    "age_s": round(now - ref.created, 3) if ref.created else 0.0,
                    "callsite": ref.callsite,
                    "task_id": ref.task_id or b"",
                    "plasma": ref.plasma,
                    "local_refs": ref.local_refs,
                    "submitted_task_refs": ref.submitted_task_refs,
                    "borrowers": len(ref.borrowers),
                }
                for oid, ref in self._owned.items()
            ]
        rows.sort(key=lambda r: -r["size"])
        if limit and len(rows) > limit:
            del rows[limit:]
        return rows

    def owned_bytes(self) -> Tuple[int, int]:
        """(total owned bytes, of which plasma-resident) — cheap totals for
        snapshots and rollups."""
        with self._lock:
            total = plasma = 0
            for ref in self._owned.values():
                total += ref.size
                if ref.plasma:
                    plasma += ref.size
            return total, plasma
