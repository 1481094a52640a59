"""The port's state API (``ray_tpu_torch.util.state``) on two nodes.

One program on a two-node ``Cluster`` (a task, an actor on the second
node, a put object in plasma) reads ``list_nodes``, ``list_actors``,
``list_tasks``, ``summarize_tasks``, ``list_objects``, ``list_workers``,
``memory_report`` and ``memory_rollup``: each row's key set and each count
must equal the same program's under ``ray_tpu``. The runtimes run one
after the other, never at once.
"""

import importlib
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env

DEADLINE_S = 30


def _keys(rows):
    """The distinct key sets of ``rows``, sorted."""
    return sorted({tuple(sorted(r)) for r in rows})


def _until(read, ok):
    """``read()`` once ``ok`` holds of it, or at the deadline."""
    deadline = time.time() + DEADLINE_S
    got = read()
    while not ok(got) and time.time() < deadline:
        time.sleep(0.2)
        got = read()
    return got


def _program(rt):
    cu = importlib.import_module(f"{rt.__name__}.cluster_utils")
    state = importlib.import_module(f"{rt.__name__}.util.state")
    cluster = cu.Cluster(initialize_head=True,
                         head_node_args={"resources": {"CPU": 2}})
    try:
        second = cluster.add_node(resources={"CPU": 2, "n1": 1})
        cluster.wait_for_nodes()
        rt.init(address=cluster.address)

        @rt.remote
        def square(x):
            return x * x

        @rt.remote(resources={"n1": 1})
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        assert rt.get(square.remote(3)) == 9
        counter = Counter.options(name="counter").remote()
        assert rt.get([counter.incr.remote() for _ in range(3)]) == [1, 2, 3]
        blob = np.arange(1 << 18, dtype=np.float64)            # 2 MiB: plasma
        ref = rt.put(blob)
        oid = ref.object_id().hex()
        out = {}

        nodes = state.list_nodes()
        second_id = second.node_id.hex()
        out["nodes"] = (_keys(nodes), len(nodes), sorted(n["state"] for n in nodes),
                        sorted(n["is_head_node"] for n in nodes))
        actors = _until(state.list_actors,
                        lambda a: any(r["state"] == "ALIVE" for r in a))
        out["actors"] = (_keys(actors), len(actors),
                         [(a["name"], a["state"], a["class_name"],
                           a["node_id"] == second_id) for a in actors])

        def mine(rows):
            return sorted((t["name"], t["state"]) for t in rows
                          if t["name"].split(".")[-1] in ("square", "incr"))

        tasks = _until(state.list_tasks,
                       lambda t: len([r for r in mine(t) if r[1] == "FINISHED"]) >= 4)
        out["tasks"] = (_keys(tasks), mine(tasks))
        summary = state.summarize_tasks()
        out["summary"] = (sorted(summary), {
            name: by for name, by in summary["summary"].items()
            if name.split(".")[-1] in ("square", "incr")})
        objects = _until(state.list_objects,
                         lambda o: any(r["object_id"] == oid for r in o))
        out["objects"] = (_keys(objects), [
            (o["node_id"] == second_id, o["size_bytes"] >= blob.nbytes, o["pinned"],
             o["spilled"]) for o in objects if o["object_id"] == oid])
        workers = state.list_workers()
        out["workers"] = (_keys(workers), len(
            [w for w in workers if w["is_alive"] and w["actor_id"]]))
        report = state.memory_report()
        out["report"] = (sorted(report), len(report["nodes"]),
                         _keys(report["nodes"]), len(report["drivers"]),
                         sorted({k for n in report["nodes"]
                                 for o in n["objects"] for k in o}),
                         [sum(o["object_id"] == oid for o in n["objects"])
                          for n in sorted(report["nodes"],
                                          key=lambda n: n["node_id"] == second_id)])
        out["rollup"] = {
            by: (len(rows), _keys(rows.values()))
            for by, rows in ((by, state.memory_rollup(report, by))
                             for by in ("job", "actor", "node"))}
        job = rt.get_runtime_context().get_job_id()
        job_row = state.memory_rollup(report, "job").get(job, {})
        out["rollup_job"] = (job_row.get("objects", 0) >= 1,
                             job_row.get("plasma_bytes", 0) >= blob.nbytes)
        rt.kill(counter)
        return out
    finally:
        rt.shutdown()
        cluster.shutdown()


@pytest.fixture(scope="module")
def results():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        ref = _program(ray_tpu)
        assert not ray_tpu.is_initialized()
        with pytest.MonkeyPatch.context() as mp:
            port_env(mp)
            got = _program(ray_tpu_torch)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    return ref, got


@pytest.mark.parametrize("part", ["nodes", "actors", "tasks", "summary", "objects",
                                  "workers", "report", "rollup", "rollup_job"])
def test_state_equal_under_both_packages(results, part):
    ref, got = results
    assert got[part] == ref[part]


def test_state_reads_the_two_nodes(results):
    _, got = results
    assert got["nodes"][1:] == (2, ["ALIVE", "ALIVE"], [False, True])
    assert [(name, alive, on_second) for name, alive, _, on_second in got["actors"][2]] \
        == [("counter", "ALIVE", True)]
    assert got["tasks"][1] == [("Counter.incr", "FINISHED")] * 3 + [
        ("_program.<locals>.square", "FINISHED")]
    assert got["summary"][1] == {"Counter.incr": {"FINISHED": 3},
                                 "_program.<locals>.square": {"FINISHED": 1}}
    assert got["objects"][1] == [(False, True, True, False)]
    assert got["workers"][1] == 1
    assert got["report"][1] == 2 and got["rollup_job"] == (True, True)
