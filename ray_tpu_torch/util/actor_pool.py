"""ActorPool: round-robin work distribution over a fixed set of actors
(reference: python/ray/util/actor_pool.py)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable, value):
        """fn(actor, value) -> ObjectRef; runs on the next idle actor."""
        if not self._idle:
            raise RuntimeError("no idle actors; call get_next first")
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = (self._next_task_index, actor)
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout=None) -> Any:
        """Next result in submission order, of those not yet taken."""
        import ray_tpu_torch

        # get_next_unordered may have taken results at or after the index
        while (self._next_return_index < self._next_task_index
               and self._next_return_index not in self._index_to_future):
            self._next_return_index += 1
        if self._next_return_index not in self._index_to_future:
            raise RuntimeError("no pending result at this index")
        ref = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(ref)
        self._idle.append(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def get_next_unordered(self, timeout=None) -> Any:
        """Next result in completion order."""
        import ray_tpu_torch

        if not self._future_to_actor:
            raise RuntimeError("no pending results")
        ready, _ = ray_tpu_torch.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        idx, actor = self._future_to_actor.pop(ref)
        self._index_to_future.pop(idx, None)
        self._idle.append(actor)
        return ray_tpu_torch.get(ref)

    def map(self, fn: Callable, values: Iterable):
        for v in values:
            if not self._idle:
                yield self.get_next()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable):
        for v in values:
            if not self._idle:
                yield self.get_next_unordered()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor):
        self._idle.append(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
