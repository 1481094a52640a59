"""Distributed FIFO queue backed by an actor (reference:
python/ray/util/queue.py)."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = asyncio.Queue(maxsize)

    async def put(self, item, timeout=None):
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
        except asyncio.TimeoutError:
            raise Full from None

    async def get(self, timeout=None):
        try:
            return await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            raise Empty from None

    def put_nowait(self, item):
        if self._q.full():
            raise Full
        self._q.put_nowait(item)

    def get_nowait(self):
        if self._q.empty():
            raise Empty
        return self._q.get_nowait()

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = actor_options or {}
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        if block:
            ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        else:
            ray_tpu_torch.get(self.actor.put_nowait.remote(item))

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if block:
            return ray_tpu_torch.get(self.actor.get.remote(timeout))
        return ray_tpu_torch.get(self.actor.get_nowait.remote())

    def put_nowait(self, item):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_async(self, item):
        return self.actor.put.remote(item, None)

    def get_async(self):
        return self.actor.get.remote(None)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)
