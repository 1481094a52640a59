"""Gloo ranks for the port's multi-rank tests, spawned once per test module.

``Ranks(body, world, workdir, args)`` starts ``world`` processes (the
``spawn`` method: each starts from a fresh import, and never imports JAX
unless the body does). Each rank sets one torch thread, joins a gloo
process group through ``file://<workdir>/rendezvous`` (no TCP port to
collide across test workers) with a 60 s collective timeout, and runs
``body(rank, world, *args)``, a generator of ``(key, value)`` results
that go back to the test process as they come. ``Ranks.get(key, rank)``
waits for one of them under the pool's deadline; a rank that raised, died
or outlived the deadline fails the test with every rank's traceback
(``faulthandler`` dumps the stacks of a hung rank to its log before the
deadline), and the remaining ranks are killed. The body is a module-level
function of the test file, so the child can import it by name.
"""

from __future__ import annotations

import faulthandler
import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta

ERROR = "__error__"


def _rank_main(body, rank, world, workdir, args, results, dump_at):
    with open(os.path.join(workdir, f"rank{rank}.log"), "w") as log:
        # dump the stacks and exit shortly before the pool's deadline
        faulthandler.dump_traceback_later(max(dump_at - time.time(), 0.1), exit=True,
                                          file=log)
        try:
            import torch
            import torch.distributed as dist

            torch.set_num_threads(1)
            dist.init_process_group(
                "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                world_size=world, timeout=timedelta(seconds=60))
            for key, value in body(rank, world, *args):
                results.put((rank, key, value))
            dist.destroy_process_group()
        except BaseException:
            results.put((rank, ERROR, traceback.format_exc()))
            raise
        finally:
            faulthandler.cancel_dump_traceback_later()


class Ranks:
    def __init__(self, body, world: int, workdir, args=(), deadline_s: float = 120.0):
        self.workdir = str(workdir)
        self.world = world
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._got = {}
        self._errors = []
        self._deadline = time.monotonic() + deadline_s
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(body, r, world, self.workdir, args, self._results,
                              time.time() + 0.85 * deadline_s))
            for r in range(world)]
        for p in self._procs:
            p.start()

    def _read(self, timeout: float) -> bool:
        try:
            rank, key, value = self._results.get(timeout=timeout)
        except queue.Empty:
            return False
        if key == ERROR:
            self._errors.append(f"rank {rank}:\n{value}")
        else:
            self._got[(rank, key)] = value
        return True

    def get(self, key, rank: int = 0):
        """Rank ``rank``'s result ``key``, waiting for it under the deadline."""
        while (rank, key) not in self._got:
            if self._errors:
                self._fail(f"a rank raised before giving {key!r}")
            left = self._deadline - time.monotonic()
            if left <= 0:
                self._fail(f"no result {key!r} from rank {rank} within the deadline")
            if not self._read(min(left, 0.5)):
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode not in (None, 0)]
                if dead and not self._read(1.0):
                    self._fail(f"ranks {dead} died before giving {key!r}")
        return self._got[(rank, key)]

    def _fail(self, why: str):
        self.close(drain=False)
        logs = []
        for r in range(self.world):
            path = os.path.join(self.workdir, f"rank{r}.log")
            if os.path.exists(path) and os.path.getsize(path):
                with open(path) as f:
                    logs.append(f"rank {r} stacks:\n{f.read()}")
        raise AssertionError("\n".join([why] + self._errors + logs))

    def close(self, drain: bool = True) -> None:
        """Collect what the ranks still send and let them exit (with
        ``drain``, under the deadline), then kill whatever still runs."""
        while drain and time.monotonic() < self._deadline and not self._errors and any(
                p.is_alive() for p in self._procs):
            self._read(0.2)
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=5)
