"""Pluggable streaming-executor backpressure policies.

Reference: data/_internal/execution/backpressure_policy/ — the streaming
executor consults a policy chain before launching more block tasks, so
memory pressure (not just a fixed window) can throttle ingest. The
default chain caps per-operator concurrency at the operator's
max_in_flight; ObjectStoreMemoryBackpressurePolicy additionally holds
launches while the local plasma store is nearly full (letting the
consumer + spiller drain it). Policies are process-wide via DataContext:

    from ray_tpu_torch.data.backpressure import (
        DataContext, ObjectStoreMemoryBackpressurePolicy)

    DataContext.get_current().backpressure_policies.append(
        ObjectStoreMemoryBackpressurePolicy(0.7))

A copy of ``ray_tpu/data/backpressure.py``; the memory policy reads this
package's plasma store (``ray_tpu_torch._private.worker``).
"""

from __future__ import annotations

from typing import List, Optional


class BackpressurePolicy:
    """Decides whether an operator may launch one more block task.
    Called with the operator and its current in-flight count; returning
    False holds the launch until an outstanding block completes (the
    executor always retains progress: an empty window may always
    launch)."""

    def can_add_input(self, op, in_flight: int) -> bool:
        raise NotImplementedError


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    """The default: per-operator in-flight window (the operator's
    max_in_flight, or a global cap if given)."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = cap

    def can_add_input(self, op, in_flight: int) -> bool:
        cap = self.cap or getattr(op, "max_in_flight", 4)
        return in_flight < cap


class ObjectStoreMemoryBackpressurePolicy(BackpressurePolicy):
    """Hold launches while local plasma usage exceeds a fraction of
    capacity — intermediate blocks otherwise race the spiller and evict
    hot objects (reference: backpressure based on object-store memory)."""

    def __init__(self, fraction: float = 0.8):
        self.fraction = fraction

    def can_add_input(self, op, in_flight: int) -> bool:
        # Only "no store to read" (no runtime in this process, or a worker
        # not attached to plasma) lets a launch through unread; a failing
        # read raises instead of quietly turning the policy off.
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None or w.plasma is None:
            return True
        stats = w.plasma.stats()
        cap = stats.get("capacity_bytes") or 0
        if not cap:
            return True
        return stats["used_bytes"] < self.fraction * cap


class DataContext:
    """Process-wide execution options (reference: data/context.py
    DataContext.get_current())."""

    _current: Optional["DataContext"] = None

    def __init__(self):
        self.backpressure_policies: List[BackpressurePolicy] = [
            ConcurrencyCapBackpressurePolicy()
        ]

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = DataContext()
        return cls._current
