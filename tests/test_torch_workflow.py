"""The port's durable workflows (``ray_tpu_torch.workflow``) against the JAX
package's.

The nine tests of ``tests/test_workflow.py`` on the port's runtime (one
module session, as the JAX file's), and one program under both packages
(``ray_tpu`` first, shut down, then the port): a workflow with an input, a
multi-output node and a continuation, run, failed on one step and resumed,
writes the same step ids (file names under ``steps/``), the same meta keys
and statuses, and returns the same value; the step that had finished is
not run again on resume under either. Tolerance: none, every comparison is
exact.
"""

import json
import os
import sys

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch import workflow
from ray_tpu_torch.dag.node import InputNode, MultiOutputNode


def p_workflow(rt, storage):
    """Run a workflow under ``rt`` in ``storage``: its first run fails on
    one step, ``resume`` finishes it. Returns the value, the step files,
    the meta keys and statuses, and how often each step body ran."""
    import importlib

    wf = importlib.import_module(f"{rt.__name__}.workflow")
    node = importlib.import_module(f"{rt.__name__}.dag.node")
    wf.init(storage=str(storage))
    flag, log = storage / "fail.flag", storage / "runs.txt"
    flag.write_text("1")

    @rt.remote
    def add(a, b):
        with open(log, "a") as f:
            f.write("a")
        return a + b

    @rt.remote
    def mul(a, b):
        with open(log, "a") as f:
            f.write("m")
        return a * b

    @rt.remote
    def flaky(x):
        if os.path.exists(flag):
            raise RuntimeError("injected failure")
        return x + 1

    @rt.remote
    def fib(n):
        if n <= 1:
            return n
        return add.bind(fib.bind(n - 1), fib.bind(n - 2))

    with node.InputNode() as inp:
        dag = node.MultiOutputNode([flaky.bind(add.bind(inp[0], mul.bind(2, 3))),
                                    fib.bind(5), inp[1]])
    out = {}
    try:
        wf.run(dag, workflow_id="parity", input_value=(10, "x"))
    except Exception as e:  # noqa: BLE001 — the injected failure
        out["first"] = type(e).__name__
    out["status_failed"] = wf.get_status("parity")
    runs_before = log.read_text()
    flag.unlink()
    out["value"] = wf.resume("parity")
    out["reran"] = log.read_text()[len(runs_before):]
    out["status"] = wf.get_status("parity")
    wdir = storage / "parity"
    out["steps"] = sorted(os.listdir(wdir / "steps"))
    out["files"] = sorted(os.listdir(wdir))
    out["meta_keys"] = sorted(json.loads((wdir / "meta.json").read_text()))
    out["output"] = wf.get_output("parity")
    out["listed"] = [(w["workflow_id"], w["status"]) for w in wf.list_all()]
    return out


@pytest.fixture(scope="module")
def by_value():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def jax_run(by_value, tmp_path_factory):
    ray_tpu.init(num_cpus=4)
    try:
        return p_workflow(ray_tpu, tmp_path_factory.mktemp("jax_wf"))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def wf_cluster(jax_run):
    assert not ray_tpu.is_initialized()
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=4)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()


@pytest.fixture()
def wf_storage(tmp_path):
    workflow.init(storage=str(tmp_path))
    yield str(tmp_path)


def test_same_workflow_same_storage_under_both_packages(jax_run, wf_cluster, tmp_path):
    port = p_workflow(ray_tpu_torch, tmp_path)
    assert port == jax_run
    assert port["value"] == [17, 5, "x"]
    assert (port["status_failed"], port["status"]) == (workflow.FAILED, workflow.SUCCESSFUL)
    # resume ran fib(5)'s seven continuation adds (the failure came first),
    # and not the checkpointed add and mul of the failed branch
    assert port["reran"] == "a" * 7
    assert "r.0.0_add.pkl" in port["steps"] and "__output__.pkl" in port["steps"]
    assert port["meta_keys"] == ["end_time", "start_time", "status"]


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def mul(a, b):
    return a * b


def test_basic_dag(wf_cluster, wf_storage):
    dag = add.bind(1, mul.bind(2, 3))
    assert workflow.run(dag, workflow_id="w1") == 7
    assert workflow.get_status("w1") == workflow.SUCCESSFUL
    assert workflow.get_output("w1") == 7


def test_input_node(wf_cluster, wf_storage):
    with InputNode() as inp:
        dag = add.bind(inp, 10)
    assert workflow.run(dag, workflow_id="w2", input_value=5) == 15


def test_multi_output(wf_cluster, wf_storage):
    dag = MultiOutputNode([add.bind(1, 1), mul.bind(3, 3)])
    assert workflow.run(dag, workflow_id="w3") == [2, 9]


def test_checkpoints_skip_on_resume(wf_cluster, wf_storage, tmp_path):
    marker = tmp_path / "count.txt"

    @ray_tpu_torch.remote
    def effect(x):
        with open(marker, "a") as f:
            f.write("x")
        return x * 2

    dag = add.bind(effect.bind(5), 1)
    assert workflow.run(dag, workflow_id="w4") == 11
    assert marker.read_text() == "x"
    # resume: the effect step is checkpointed, so it must NOT run again
    assert workflow.resume("w4") == 11
    assert marker.read_text() == "x"


def test_resume_after_failure(wf_cluster, wf_storage, tmp_path):
    flag = tmp_path / "fail.flag"
    flag.write_text("1")

    @ray_tpu_torch.remote
    def stage1():
        return 41

    @ray_tpu_torch.remote
    def flaky(x):
        if os.path.exists(flag):
            raise RuntimeError("injected failure")
        return x + 1

    dag = flaky.bind(stage1.bind())
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w5")
    assert workflow.get_status("w5") == workflow.FAILED
    flag.unlink()
    # stage1's checkpoint survives; only flaky reruns
    assert workflow.resume("w5") == 42
    assert workflow.get_status("w5") == workflow.SUCCESSFUL


def test_continuation(wf_cluster, wf_storage):
    @ray_tpu_torch.remote
    def fib(n):
        if n <= 1:
            return n
        return add.bind(fib.bind(n - 1), fib.bind(n - 2))

    assert workflow.run(fib.bind(7), workflow_id="w6") == 13


def test_list_and_delete(wf_cluster, wf_storage):
    workflow.run(add.bind(1, 2), workflow_id="wa")
    workflow.run(add.bind(3, 4), workflow_id="wb")
    ids = {w["workflow_id"] for w in workflow.list_all()}
    assert {"wa", "wb"} <= ids
    ok = {w["workflow_id"]
          for w in workflow.list_all(status_filter=workflow.SUCCESSFUL)}
    assert {"wa", "wb"} <= ok
    workflow.delete("wa")
    ids = {w["workflow_id"] for w in workflow.list_all()}
    assert "wa" not in ids


def test_virtual_actor_durable_state(wf_cluster, wf_storage):
    """Virtual actors: state commits per call and survives 'cluster
    loss' — resurrection from storage alone (reference: workflow virtual
    actors)."""

    @workflow.virtual_actor
    class Counter:
        def __init__(self, start=0):
            self.count = start
            self.log = []

        def add(self, n):
            self.count += n
            self.log.append(n)
            return self.count

        @workflow.virtual_actor.readonly
        def peek(self):
            return self.count

    c = Counter.get_or_create("vc-1", 10)
    assert c.add.run(5) == 15
    assert c.add.run(2) == 17
    assert c.peek.run() == 17

    # readonly did not commit a new snapshot
    # resurrect from storage in a fresh handle (as a new driver would)
    c2 = workflow.get_actor("vc-1")
    assert c2.peek.run() == 17
    assert c2.add.run(3) == 20

    # get_or_create on an existing id resumes, never resets
    c3 = Counter.get_or_create("vc-1", 999)
    assert c3.peek.run() == 20

    actors = workflow.list_actors()
    assert any(a["actor_id"] == "vc-1" for a in actors)


def test_virtual_actor_write_ordering(wf_cluster, wf_storage):
    @workflow.virtual_actor
    class Appender:
        def __init__(self):
            self.items = []

        def push(self, x):
            self.items.append(x)
            return list(self.items)

    a = Appender.get_or_create("vc-order")
    refs = [a.push.run_async(i) for i in range(8)]
    outs = ray_tpu_torch.get(refs, timeout=120)
    assert outs[-1] == list(range(8))
