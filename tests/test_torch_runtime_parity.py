"""One program under ``ray_tpu``, then under ``ray_tpu_torch``, in one test.

The program: a fan-out of tasks; nested refs (refs inside an actor call's
return, owned by the actor, and inside a task's argument); ``wait`` with
``num_returns`` and with a timeout; an actor's ordered method calls;
``kill`` and then the actor's death; a task's error; ``max_retries`` over a
worker that dies. Its results, and
the names of the exceptions it met (with their base classes), must be
equal. The runtimes run one after the other, never at once, each started
with its own test flags and shut down before the next.
"""

import os
import time

import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env


def _program(rt, tmp_dir):
    out = {}

    @rt.remote
    def square(x):
        return x * x

    out["fan_out"] = rt.get([square.remote(i) for i in range(24)])

    @rt.remote
    class Owner:
        def make_refs(self, n):
            self.refs = [rt.put(i * 10) for i in range(n)]
            return self.refs

    owner = Owner.remote()
    out["nested_return"] = rt.get(rt.get(owner.make_refs.remote(4)))

    @rt.remote
    def total(d):
        return sum(rt.get(d["refs"])) + rt.get(d["ref"])

    out["nested_arg"] = rt.get(total.remote(
        {"refs": [rt.put(i) for i in range(5)], "ref": square.remote(3)}))

    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    refs = [sleepy.remote(0.0), sleepy.remote(0.05), sleepy.remote(60)]
    ready, pending = rt.wait(refs, num_returns=2, timeout=30)
    out["wait"] = (sorted(rt.get(ready)), len(pending))
    ready, pending = rt.wait(refs[2:], num_returns=1, timeout=0.2)
    out["wait_timeout"] = (len(ready), len(pending))
    ready, pending = rt.wait(refs[:2], num_returns=2, timeout=0)
    out["wait_done"] = (len(ready), len(pending))

    @rt.remote
    class Log:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def items_(self):
            return self.items

    log = Log.remote()
    out["ordered"] = rt.get([log.add.remote(i) for i in range(16)])
    out["ordered_items"] = rt.get(log.items_.remote())
    rt.kill(log)
    err = None
    for _ in range(50):
        try:
            rt.get(log.add.remote(0), timeout=5)
        except Exception as e:  # the death surfaces at a later call
            err = e
            break
        time.sleep(0.1)
    out["killed"] = _names(err)

    @rt.remote
    def fail():
        raise KeyError("missing")

    try:
        rt.get(fail.remote())
    except Exception as e:
        out["task_error"] = (_names(e), type(e.cause).__name__, e.cause.args)

    marker = os.path.join(tmp_dir, f"{rt.__name__}.died")

    @rt.remote(max_retries=2)
    def die_once(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "retried"

    out["retry"] = rt.get(die_once.remote(marker), timeout=60)

    @rt.remote(max_retries=0)
    def die_always():
        os._exit(1)

    try:
        rt.get(die_always.remote(), timeout=60)
    except Exception as e:
        out["no_retry"] = _names(e)
    return out


def _names(e):
    """The exception's class and base-class names, package-free."""
    return [c.__name__ for c in type(e).__mro__]


@pytest.fixture
def jax_results(tmp_path):
    """The program under the JAX runtime, which is shut down before the
    port's starts (tests/conftest.py sets the JAX runtime's test flags)."""
    ray_tpu.init(num_cpus=4)
    try:
        return _program(ray_tpu, str(tmp_path))
    finally:
        ray_tpu.shutdown()


def test_one_program_equal_results_and_exception_types(jax_results, monkeypatch,
                                                       tmp_path):
    assert not ray_tpu.is_initialized()
    port_env(monkeypatch)
    ray_tpu_torch.init(num_cpus=4)
    try:
        got = _program(ray_tpu_torch, str(tmp_path))
    finally:
        ray_tpu_torch.shutdown()
    assert got == jax_results
    assert got["fan_out"] == [i * i for i in range(24)]
    assert got["killed"][0] == "ActorDiedError"
    assert got["task_error"][0][0] == "TaskError"
    assert got["retry"] == "retried"
    assert got["no_retry"][0] == "WorkerCrashedError"
