"""Object spilling + OOM monitor of the port's raylet.

A copy of ``tests/test_spilling.py`` against ``ray_tpu_torch``.

Reference contracts: pinned primary copies spill to disk under store
pressure and restore on access (src/ray/raylet/local_object_manager.h:41);
the raylet kills workers when node memory crosses a threshold and the task
fails with OutOfMemoryError when retries are exhausted
(src/ray/common/memory_monitor.h:52, worker_killing_policy*.h).
"""

import numpy as np
import pytest

from _torch_runtime import shutdown_only  # noqa: F401  (a fixture)


def test_put_2x_capacity_spills_and_restores(shutdown_only):
    """A workload 2x plasma capacity completes via spill-to-disk."""
    import ray_tpu_torch

    capacity = 64 * 1024 * 1024
    ray_tpu_torch.init(num_cpus=2, object_store_memory=capacity)

    rng = np.random.default_rng(0)
    n, size = 16, 8 * 1024 * 1024  # 128 MiB of primaries in a 64 MiB store
    arrays = [rng.integers(0, 255, size=size, dtype=np.uint8) for _ in range(n)]
    refs = [ray_tpu_torch.put(a) for a in arrays]

    # Every object must come back intact, in arbitrary access order.
    order = rng.permutation(n)
    for i in order:
        out = ray_tpu_torch.get(refs[i], timeout=120)
        assert np.array_equal(out, arrays[i]), f"object {i} corrupted"


def test_task_returns_spill(shutdown_only):
    """Large task returns exceed capacity and still all materialize."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)

    @ray_tpu_torch.remote
    def make(i):
        r = np.random.default_rng(i)
        return r.integers(0, 255, size=8 * 1024 * 1024, dtype=np.uint8)

    refs = [make.remote(i) for i in range(16)]
    # Fetch one at a time: results are zero-copy views over plasma, so
    # holding all 2x-capacity results at once cannot fit by construction
    # (same store-capacity contract as the reference).
    for i, ref in enumerate(refs):
        out = ray_tpu_torch.get(ref, timeout=170)
        expect = np.random.default_rng(i).integers(
            0, 255, size=8 * 1024 * 1024, dtype=np.uint8
        )
        assert np.array_equal(out, expect)
        del out


def test_oom_monitor_kills_worker(shutdown_only, monkeypatch):
    """threshold=0 makes every leased worker an OOM victim: the task dies
    with OutOfMemoryError naming the memory monitor, instead of hanging."""
    import ray_tpu_torch
    from ray_tpu_torch.exceptions import OutOfMemoryError, WorkerCrashedError

    monkeypatch.setenv("RTPU_TORCH_memory_usage_threshold", "0.0")
    monkeypatch.setenv("RTPU_TORCH_memory_monitor_refresh_ms", "100")
    ray_tpu_torch.init(num_cpus=2)

    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        import time

        time.sleep(30)
        return 1

    with pytest.raises((OutOfMemoryError, WorkerCrashedError)) as exc_info:
        ray_tpu_torch.get(hog.remote(), timeout=60)
    # The death reason should be attributed to the memory monitor.
    assert "memory monitor" in str(exc_info.value)


def test_oom_victim_policy():
    """Task workers die before actor workers; newest first within a class."""
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.raylet.main import NodeManager

    class H:
        def __init__(self, wid, token, alive=True, leased=True, pid=1):
            self.worker_id = wid
            self.startup_token = token
            self.alive = alive
            self.leased = leased
            self.pid = pid

    nm = object.__new__(NodeManager)  # policy only; no cluster needed
    nm._actor_workers = {b"actor1": b"aid"}

    class Pool:
        workers = {
            b"task_old": H(b"task_old", 1),
            b"task_new": H(b"task_new", 5),
            b"actor1": H(b"actor1", 9),
            b"idle": H(b"idle", 7, leased=False),
        }

    nm.worker_pool = Pool()
    victim = nm._pick_oom_victim()
    assert victim.worker_id == b"task_new"  # newest task worker
    Pool.workers.pop(b"task_new")
    Pool.workers.pop(b"task_old")
    assert nm._pick_oom_victim().worker_id == b"actor1"  # actors last
    Pool.workers.pop(b"actor1")
    assert nm._pick_oom_victim() is None  # idle workers are not victims
