"""The rest of the port's ``util``: Pool, inspect_serializability, ActorPool,
Queue and OpenLoopLoadGen, and the package's lazy attributes.

Copies of ``tests/test_util_pool.py``'s four ``Pool`` tests and of
``tests/test_check_serialize.py``'s three against ``ray_tpu_torch``;
``ActorPool`` (``map``, ``map_unordered``, ``get_next``, ``has_free``,
``push``, ``pop_idle``) and ``Queue`` (blocking and ``nowait``, ``Full`` /
``Empty``, timeouts) as programs run under ``ray_tpu`` and then under
``ray_tpu_torch``, one runtime at a time, with equal results (the JAX
package has no test of either); ``OpenLoopLoadGen``'s schedules bitwise
the JAX package's, and a short run against a local function.
"""

import importlib
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch.util.check_serialize import inspect_serializability
from ray_tpu_torch.util.loadgen import OpenLoopLoadGen
from ray_tpu_torch.util.multiprocessing import Pool

REPO = Path(__file__).resolve().parent.parent


def _names(e):
    return [c.__name__ for c in type(e).__mro__]


def p_actor_pool(rt):
    ActorPool = rt.util.ActorPool

    @rt.remote
    class Doubler:
        def double(self, v):
            return 2 * v

        def slow(self, v):
            time.sleep(0.02 * v)
            return v

    double = lambda a, v: a.double.remote(v)  # noqa: E731
    pool = ActorPool([Doubler.remote() for _ in range(3)])
    out = {"map": list(pool.map(double, range(10))),
           "has_free_idle": pool.has_free()}
    for v in (5, 6, 7):
        pool.submit(double, v)
    out["has_free_busy"] = pool.has_free()
    try:
        pool.submit(double, 8)
    except Exception as e:  # noqa: BLE001 — the class is the result
        out["submit_busy"] = _names(e)
    out["get_next"] = [pool.get_next(timeout=30) for _ in range(3)]
    out["has_next"] = pool.has_next()
    idle = pool.pop_idle()
    out["pop_idle"] = idle is not None and pool.has_free()
    pool.push(idle)
    out["pushed_back"] = list(pool.map(double, [100, 200, 300, 400]))
    out["map_unordered"] = sorted(pool.map_unordered(double, range(10)))
    # completion order: the shortest sleep lands first
    out["unordered_first"] = next(pool.map_unordered(
        lambda a, v: a.slow.remote(v), [15, 1, 10]))
    while pool.has_next():     # drain what the generator left running
        pool.get_next_unordered()
    out["has_free_drained"] = pool.has_free()
    drained = ActorPool([])
    out["empty_pop"] = drained.pop_idle()
    try:
        drained.get_next_unordered()
    except Exception as e:  # noqa: BLE001
        out["empty_get"] = _names(e)
    return out


def p_queue(rt):
    qmod = importlib.import_module(f"{rt.__name__}.util.queue")
    q = qmod.Queue(maxsize=2)
    out = {"empty0": q.empty(), "qsize0": q.qsize()}
    q.put(1)
    q.put_nowait(2)
    out["full"] = (q.full(), q.qsize())
    for name, call in (("put_nowait_full", lambda: q.put_nowait(3)),
                       ("put_timeout_full", lambda: q.put(3, timeout=0.2))):
        try:
            call()
        except Exception as e:  # noqa: BLE001
            out[name] = (_names(e), isinstance(e, qmod.Full)
                         or isinstance(getattr(e, "cause", None), qmod.Full))
    out["gets"] = [q.get(), q.get_nowait()]
    for name, call in (("get_nowait_empty", q.get_nowait),
                       ("get_timeout_empty", lambda: q.get(timeout=0.2))):
        try:
            call()
        except Exception as e:  # noqa: BLE001
            out[name] = (_names(e), isinstance(e, qmod.Empty)
                         or isinstance(getattr(e, "cause", None), qmod.Empty))

    @rt.remote
    def producer(queue, items):
        time.sleep(0.3)
        for x in items:
            queue.put(x)
        return len(items)

    done = producer.remote(q, ["a", "b", "c"])
    out["blocking"] = [q.get(timeout=30) for _ in range(3)]  # waits on the task
    out["produced"] = rt.get(done)
    ref = q.get_async()
    rt.get(q.put_async({"k": [1, 2]}))
    out["async"] = rt.get(ref, timeout=30)
    out["end"] = (q.empty(), q.qsize())
    q.shutdown()
    return out


PROGRAMS = {"actor_pool": p_actor_pool, "queue": p_queue}


def _run(rt):
    out = {}
    rt.init(num_cpus=6)
    try:
        for name, prog in PROGRAMS.items():
            try:
                out[name] = prog(rt)
            except Exception:  # noqa: BLE001 — the test that reads it fails
                out[name] = traceback.format_exc()
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module", autouse=True)
def by_value():
    """This module travels to the workers by value: no port worker imports
    it, nor the JAX package with it."""
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def parity():
    jax = _run(ray_tpu)
    assert not ray_tpu.is_initialized()
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        port = _run(ray_tpu_torch)
    return jax, port


def test_actor_pool_program_equal(parity):
    jax, port = parity
    got = port["actor_pool"]
    assert got == jax["actor_pool"], (got, jax["actor_pool"])
    assert got["map"] == [2 * v for v in range(10)]
    assert got["map_unordered"] == sorted(2 * v for v in range(10))
    assert got["unordered_first"] == 1
    assert got["get_next"] == [10, 12, 14]
    assert got["pushed_back"] == [200, 400, 600, 800]
    assert (got["has_free_idle"], got["has_free_busy"], got["has_next"],
            got["pop_idle"], got["has_free_drained"]) == (True, False, False, True, True)


def test_actor_pool_ordered_after_unordered(pool_cluster):
    """``get_next`` after ``get_next_unordered`` returns the next result not
    yet taken, as the reference's ActorPool does (it moves the ordered
    index past what the unordered call took); the JAX package's raises
    there."""
    from ray_tpu_torch.util.actor_pool import ActorPool

    @ray_tpu_torch.remote
    class Doubler:
        def double(self, v):
            return 2 * v

    pool = ActorPool([Doubler.remote() for _ in range(2)])
    double = lambda a, v: a.double.remote(v)  # noqa: E731
    pool.submit(double, 1)
    pool.submit(double, 2)
    first = pool.get_next_unordered(timeout=30)
    pool.submit(double, 3)
    rest = [pool.get_next(timeout=30) for _ in range(2)]
    assert sorted([first] + rest) == [2, 4, 6] and rest[-1] == 6
    assert not pool.has_next() and pool.has_free()


def test_queue_program_equal(parity):
    jax, port = parity
    got = port["queue"]
    assert got == jax["queue"], (got, jax["queue"])
    assert got["full"] == (True, 2) and got["gets"] == [1, 2]
    assert got["blocking"] == ["a", "b", "c"] and got["async"] == {"k": [1, 2]}
    for name in ("put_nowait_full", "put_timeout_full", "get_nowait_empty",
                 "get_timeout_empty"):
        assert got[name][1], (name, got[name])
    assert got["end"] == (True, 0)


# ----------------------------------------------------------------- loadgen


@pytest.mark.parametrize("arrival,rate,duration,seed", [
    ("uniform", 50.0, 2.0, 0), ("uniform", 7.5, 3.3, 0),
    ("poisson", 50.0, 2.0, 0), ("poisson", 200.0, 1.5, 11),
])
def test_loadgen_schedule_bitwise_the_jax_packages(arrival, rate, duration, seed):
    from ray_tpu.util.loadgen import OpenLoopLoadGen as Reference

    got = OpenLoopLoadGen._schedule(rate, duration, arrival, seed)
    assert got == Reference._schedule(rate, duration, arrival, seed)
    assert got and all(0 <= t < duration for t in got)


def test_loadgen_short_run_against_a_local_function():
    seen = []

    def fn(i):
        seen.append(threading.get_ident())
        if i % 10 == 9:
            raise KeyError(i)
        time.sleep(0.005)
        return i * i

    gen = OpenLoopLoadGen(fn, rate_hz=200, duration_s=0.25, arrival="poisson",
                          seed=3)
    report = gen.run(join_timeout_s=30)
    n = len(OpenLoopLoadGen._schedule(200, 0.25, "poisson", 3))
    assert report["offered"] == n == len(gen.records) and report["shed"] == 0
    assert report["failed"] == n // 10 and report["errors"] == {"KeyError": n // 10}
    assert report["completed"] == n - n // 10
    assert 0 < report["p50_s"] <= report["p99_s"] <= report["max_s"] < 5
    assert sorted(r["result"] for r in gen.records if r["ok"]) == sorted(
        i * i for i in range(n) if i % 10 != 9)
    assert len(set(seen)) > 1      # open loop: requests overlap on threads
    with pytest.raises(ValueError):
        OpenLoopLoadGen(fn, rate_hz=0, duration_s=1)


# ---------------------------------------------- tests/test_util_pool.py's four


@pytest.fixture(scope="module")
def pool_cluster(parity):
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=8)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_map_starmap(pool_cluster):
    with Pool(4) as p:
        assert p.map(_sq, range(20)) == [x * x for x in range(20)]
        assert p.starmap(_add, [(1, 2), (3, 4), (5, 6)]) == [3, 7, 11]


def test_apply_and_async(pool_cluster):
    with Pool(2) as p:
        assert p.apply(_add, (2, 3)) == 5
        r = p.apply_async(_sq, (9,))
        assert r.get(timeout=30) == 81
        m = p.map_async(_sq, [1, 2, 3])
        assert m.get(timeout=30) == [1, 4, 9]
        assert m.ready() and m.successful()


def test_imap_ordered_and_unordered(pool_cluster):
    with Pool(4) as p:
        assert list(p.imap(_sq, range(10), chunksize=3)) == [
            x * x for x in range(10)
        ]
        assert sorted(p.imap_unordered(_sq, range(10), chunksize=2)) == [
            x * x for x in range(10)
        ]


def test_closed_pool_rejects(pool_cluster):
    p = Pool(2)
    p.close()
    with pytest.raises(ValueError):
        p.map(_sq, [1])
    p.terminate()
    p.join()


# ----------------------------------------- tests/test_check_serialize.py's three


def test_serializable_object():
    ok, failures = inspect_serializability({"a": [1, 2], "b": "x"})
    assert ok and not failures


def test_finds_bad_closure():
    lock = threading.Lock()

    def f():
        return lock

    ok, failures = inspect_serializability(f, print_failures=False)
    assert not ok
    assert any(fail.name == "lock" for fail in failures)


def test_finds_bad_attribute():
    class Holder:
        def __init__(self):
            self.fine = 1
            self.bad = threading.Lock()

    ok, failures = inspect_serializability(Holder(), print_failures=False)
    assert not ok
    assert any(fail.name == "bad" and fail.parent == "Holder"
               for fail in failures)


# ------------------------------------------------------ the lazy attributes


def test_tune_and_cluster_utils_resolve_without_torch():
    """``ray_tpu_torch.tune`` and ``ray_tpu_torch.cluster_utils`` resolve
    lazily, as ``ray_tpu``'s do, in a fresh interpreter that loads no
    torch."""
    code = (
        "import sys\n"
        "import ray_tpu_torch\n"
        "assert ray_tpu_torch.tune.Tuner and ray_tpu_torch.cluster_utils.Cluster\n"
        "assert ray_tpu_torch.util.ActorPool and ray_tpu_torch.util.state.list_nodes\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'ray_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
