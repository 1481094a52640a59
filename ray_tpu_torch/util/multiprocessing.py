"""multiprocessing.Pool shim over actors
(reference: python/ray/util/multiprocessing/pool.py — drop-in Pool whose
workers are cluster actors, so `Pool(8).map(f, xs)` scales past one host).

Supported surface: map/map_async/starmap/starmap_async/apply/apply_async/
imap/imap_unordered, context manager, close/terminate/join.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    """multiprocessing.pool.AsyncResult lookalike over object refs."""

    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        values = ray_tpu_torch.get(self._refs, timeout=timeout)
        return values[0] if self._single else values

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class _PoolWorker:
    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn, chunk):
        return [fn(*args) for args in chunk]


class Pool:
    def __init__(self, processes: Optional[int] = None, *,
                 ray_actor_options: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        if processes is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            processes = max(1, int(total))
        opts = dict(ray_actor_options or {})
        opts.setdefault("num_cpus", 1)
        cls = ray_tpu_torch.remote(_PoolWorker)
        self._actors = [cls.options(**opts).remote()
                        for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False
        self._inflight: List[Any] = []

    # ------------------------------------------------------------- plumbing

    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _next(self):
        return self._actors[next(self._rr)]

    @staticmethod
    def _star(iterable) -> List[tuple]:
        return [args if isinstance(args, tuple) else (args,)
                for args in iterable]

    def _submit_chunks(self, func: Callable, items: List[tuple],
                       chunksize: Optional[int]) -> List[Any]:
        if chunksize is None:
            chunksize = max(1, len(items) // (len(self._actors) * 4) or 1)
        refs = []
        for i in range(0, len(items), chunksize):
            chunk = items[i:i + chunksize]
            refs.append(self._next().run_batch.remote(func, chunk))
        self._inflight.extend(refs)
        return refs

    # --------------------------------------------------------------- public

    def apply(self, func: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        self._check()
        ref = self._next().run.remote(func, tuple(args), kwds or {})
        self._inflight.append(ref)
        return AsyncResult([ref], single=True)

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap(func, [(x,) for x in iterable], chunksize)

    def map_async(self, func: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        return self.starmap_async(func, [(x,) for x in iterable], chunksize)

    def starmap(self, func: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        self._check()
        items = self._star(iterable)
        refs = self._submit_chunks(func, items, chunksize)
        out: List[Any] = []
        for chunk in ray_tpu_torch.get(refs):
            out.extend(chunk)
        return out

    def starmap_async(self, func: Callable, iterable: Iterable,
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check()
        items = self._star(iterable)
        refs = self._submit_chunks(func, items, chunksize)

        class _Flat(AsyncResult):
            def get(self, timeout: Optional[float] = None):
                out: List[Any] = []
                for chunk in ray_tpu_torch.get(self._refs, timeout=timeout):
                    out.extend(chunk)
                return out

        return _Flat(refs, single=False)

    def _lazy_chunks(self, func: Callable, iterable: Iterable,
                     chunksize: int, window: int):
        """Generator of chunk refs, submitting at most `window` ahead of
        consumption — imap over an infinite/huge iterable streams instead
        of materializing (multiprocessing.Pool.imap laziness)."""
        it = iter(iterable)
        inflight: List[Any] = []
        while True:
            while len(inflight) < window:
                chunk = [(x,) for x in itertools.islice(it, chunksize)]
                if not chunk:
                    break
                ref = self._next().run_batch.remote(func, chunk)
                self._inflight.append(ref)
                inflight.append(ref)
            if not inflight:
                return
            yield inflight.pop(0)

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: int = 1):
        """Ordered lazy iteration: a bounded window of chunks is in flight
        while earlier results stream out."""
        self._check()
        window = max(2, len(self._actors) * 2)
        for ref in self._lazy_chunks(func, iterable, chunksize, window):
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check()
        window = max(2, len(self._actors) * 2)
        pending: List[Any] = []
        gen = self._lazy_chunks(func, iterable, chunksize, window)
        exhausted = False
        while True:
            while not exhausted and len(pending) < window:
                try:
                    pending.append(next(gen))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    # ------------------------------------------------------------ lifecycle

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self):
        """Barrier: wait for all submitted work to finish
        (multiprocessing.Pool.join semantics; requires close() first)."""
        if not self._closed:
            raise ValueError("Pool is still running")
        if self._inflight:
            try:
                ray_tpu_torch.wait(self._inflight,
                             num_returns=len(self._inflight))
            except Exception:
                pass
            self._inflight = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
