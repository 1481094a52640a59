"""Core API tests of the port's runtime: tasks, objects, errors.

A copy of tests/test_basic.py run against ``ray_tpu_torch`` (fixtures from
tests/_torch_runtime.py); torch tensors through the object store are in
tests/test_torch_runtime_tensors.py.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401
from ray_tpu_torch.exceptions import GetTimeoutError, TaskError


@ray_tpu_torch.remote
def echo(x):
    return x


@ray_tpu_torch.remote
def add(a, b):
    return a + b


def test_simple_task(ray_start_regular):
    assert ray_tpu_torch.get(add.remote(1, 2)) == 3


def test_many_parallel_tasks(ray_start_regular):
    refs = [add.remote(i, i) for i in range(50)]
    assert ray_tpu_torch.get(refs) == [2 * i for i in range(50)]


def test_put_get_roundtrip(ray_start_regular):
    for value in [1, "hello", {"a": [1, 2, 3]}, None, (1, 2), b"bytes"]:
        assert ray_tpu_torch.get(ray_tpu_torch.put(value)) == value


def test_put_get_numpy_zero_copy(ray_start_regular):
    arr = np.arange(500_000, dtype=np.float64)
    got = ray_tpu_torch.get(ray_tpu_torch.put(arr))
    assert np.array_equal(got, arr)


def test_large_task_return_via_plasma(ray_start_regular):
    @ray_tpu_torch.remote
    def big():
        return np.ones((1000, 1000), dtype=np.float32)

    arr = ray_tpu_torch.get(big.remote())
    assert float(arr.sum()) == 1_000_000.0


def test_large_task_arg(ray_start_regular):
    arr = np.ones(300_000, dtype=np.float64)

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    assert ray_tpu_torch.get(total.remote(arr)) == 300_000.0


def test_object_ref_as_arg(ray_start_regular):
    ref = ray_tpu_torch.put(21)
    assert ray_tpu_torch.get(add.remote(ref, 21)) == 42


def test_nested_object_ref_in_arg(ray_start_regular):
    ref = ray_tpu_torch.put(5)

    @ray_tpu_torch.remote
    def unwrap(d):
        return ray_tpu_torch.get(d["ref"]) + 1

    assert ray_tpu_torch.get(unwrap.remote({"ref": ref})) == 6


def test_chained_dependencies(ray_start_regular):
    x = add.remote(1, 1)
    y = add.remote(x, 1)
    z = add.remote(y, 1)
    assert ray_tpu_torch.get(z) == 4


def test_task_exception(ray_start_regular):
    @ray_tpu_torch.remote
    def fail():
        raise ValueError("expected failure")

    with pytest.raises(TaskError, match="expected failure"):
        ray_tpu_torch.get(fail.remote())


def test_exception_propagates_through_dependency(ray_start_regular):
    @ray_tpu_torch.remote
    def fail():
        raise ValueError("root cause")

    # Downstream tasks receiving a failed ref also fail at get().
    downstream = add.remote(fail.remote(), 1)
    with pytest.raises(TaskError):
        ray_tpu_torch.get(downstream)


def test_multiple_returns(ray_start_regular):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_get_timeout(ray_start_regular):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.5)


def test_wait(ray_start_regular):
    @ray_tpu_torch.remote
    def sleepy(t):
        time.sleep(t)
        return t

    refs = [sleepy.remote(0.01), sleepy.remote(5)]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=1, timeout=10)
    assert len(ready) == 1 and len(pending) == 1
    assert ray_tpu_torch.get(ready[0]) == 0.01


def test_nested_task_submission(ray_start_regular):
    @ray_tpu_torch.remote
    def outer(n):
        return sum(ray_tpu_torch.get([add.remote(i, 1) for i in range(n)]))

    assert ray_tpu_torch.get(outer.remote(4)) == 10


def test_options_override(ray_start_regular):
    assert ray_tpu_torch.get(add.options(name="custom").remote(2, 2)) == 4


def test_num_cpus_resource(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=2)
    def heavy():
        return "done"

    assert ray_tpu_torch.get(heavy.remote()) == "done"


def test_kwargs(ray_start_regular):
    @ray_tpu_torch.remote
    def kw(a, b=10, *, c=100):
        return a + b + c

    assert ray_tpu_torch.get(kw.remote(1, c=2)) == 13


def test_cluster_resources(ray_start_regular):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 4.0


def test_remote_call_direct_raises(ray_start_regular):
    with pytest.raises(TypeError):
        add(1, 2)


def test_deep_queue_batched_tasks(ray_start_regular):
    """A deep queue of tiny tasks triggers PushTasks batching; results must
    stay exact and per-ref ordered."""
    refs = [add.remote(i, 1) for i in range(400)]
    assert ray_tpu_torch.get(refs) == [i + 1 for i in range(400)]


def test_coordinating_tasks_in_deep_queue(shutdown_only):
    """Tasks that synchronize with each other must not deadlock when deep-
    queue batching packs them onto shared leases: batched tasks execute
    concurrently, as if each had its own lease."""
    import time as _time

    ray_tpu_torch.init(num_cpus=8)

    @ray_tpu_torch.remote
    class Signal:
        def __init__(self):
            self.sent = False

        def send(self):
            self.sent = True

        def ready(self):
            return self.sent

    sig = Signal.remote()

    # One function for every role so all tasks share a scheduling key and
    # are eligible for the same PushTasks batches.
    @ray_tpu_torch.remote
    def step(role, s):
        import ray_tpu_torch as rt

        if role == "wait":
            deadline = _time.time() + 60
            while not rt.get(s.ready.remote()):
                if _time.time() > deadline:
                    return False
                _time.sleep(0.01)
            return True
        if role == "send":
            rt.get(s.send.remote())
        return True

    refs = [step.remote("noop", sig) for _ in range(40)]
    refs += [step.remote("wait", sig) for _ in range(3)]
    refs += [step.remote("noop", sig) for _ in range(40)]
    refs += [step.remote("send", sig)]
    refs += [step.remote("noop", sig) for _ in range(40)]
    out = ray_tpu_torch.get(refs, timeout=120)
    assert all(out), out



def test_zero_copy_value_outlives_shutdown(tmp_path):
    """A value read zero-copy from the store and freed after ``shutdown()``
    (here by the cyclic GC) must not crash the process: its pin went with
    the store's client (fault 8; the JAX runtime segfaults here, rc -11)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "zero_copy.py"
    script.write_text(
        "import gc\n"
        "import numpy as np\n"
        "import ray_tpu_torch as rt\n"
        "rt.init(num_cpus=1)\n"
        "value = rt.get(rt.put(np.arange(1 << 20)))\n"
        "cycle = [value]\n"
        "cycle.append(cycle)\n"
        "rt.shutdown()\n"
        "del value, cycle\n"
        "gc.collect()\n"
        "print('survived')\n")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
           "RTPU_TORCH_dashboard_agent": "0"}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert (res.returncode, res.stdout.strip()) == (0, "survived"), res.stderr[-2000:]
