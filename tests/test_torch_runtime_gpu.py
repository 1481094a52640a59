"""GPU assignment in the port's runtime, and which processes load torch.

Ported from tests/test_chip_assignment.py (TPU chips through
``TPU_VISIBLE_CHIPS``) to GPUs through ``CUDA_VISIBLE_DEVICES``, on a
cluster started with ``init(num_cpus=4, num_gpus=4)`` (no card is needed:
leases hand out indices, and the workers here never touch CUDA):
two concurrent ``num_gpus=2`` actors get disjoint pairs covering all four;
ids return to the pool when a lease ends; a fractional lease leaves the
variable unset; ``get_accelerator_ids()`` gives ``{"GPU": [...]}``; a
raylet that sees ``CUDA_VISIBLE_DEVICES="2,3,5,7"`` hands out those cards;
``num_tpus`` is refused with a message naming ``num_gpus``.

Process hygiene: after a task and an actor have imported torch, the GCS,
the raylet, the fork server and a worker that never imported torch still
have no torch mapped (read from ``/proc/<pid>/maps``) across watchdog
ticks, and importing their modules, the fork server's preimports and the
serve package (its controller, proxy, handle and ingress modules, and
``serve.llm``'s entry points) in a fresh interpreter leaves torch out of
``sys.modules``.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import psutil
import pytest

import ray_tpu_torch
from _torch_runtime import port_env

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def gpu_cluster(monkeypatch):
    port_env(monkeypatch)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_concurrent_actors_get_disjoint_gpus(gpu_cluster):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 4.0

    @ray_tpu_torch.remote(num_gpus=2)
    class Holder:
        def gpus(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES", "")

    a = Holder.remote()
    b = Holder.remote()
    ga = ray_tpu_torch.get(a.gpus.remote(), timeout=60)
    gb = ray_tpu_torch.get(b.gpus.remote(), timeout=60)
    assert ga and gb
    sa, sb = set(ga.split(",")), set(gb.split(","))
    assert len(sa) == 2 and len(sb) == 2
    assert not (sa & sb), f"GPU overlap: {ga} vs {gb}"
    assert sa | sb == {"0", "1", "2", "3"}
    ray_tpu_torch.kill(a)
    ray_tpu_torch.kill(b)


def test_gpus_recycle_after_release(gpu_cluster):
    @ray_tpu_torch.remote(num_gpus=4)
    def all_gpus():
        return os.environ.get("CUDA_VISIBLE_DEVICES", "")

    first = ray_tpu_torch.get(all_gpus.remote(), timeout=60)
    assert set(first.split(",")) == {"0", "1", "2", "3"}
    # lease released after the task; the full pool must be reusable
    second = ray_tpu_torch.get(all_gpus.remote(), timeout=60)
    assert set(second.split(",")) == {"0", "1", "2", "3"}


def test_fractional_gpu_shares_pool(gpu_cluster):
    @ray_tpu_torch.remote(num_gpus=0.5)
    def frac():
        return os.environ.get("CUDA_VISIBLE_DEVICES", "unset")

    # fractional demand gets no exclusive assignment (shares the node view)
    assert ray_tpu_torch.get(frac.remote(), timeout=60) == "unset"


def test_runtime_context_accelerator_ids(gpu_cluster):
    @ray_tpu_torch.remote(num_gpus=1)
    def ids():
        return (ray_tpu_torch.get_runtime_context().get_accelerator_ids(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    out, visible = ray_tpu_torch.get(ids.remote(), timeout=60)
    assert out == {"GPU": [visible]} and visible in ("0", "1", "2", "3")


def test_num_tpus_is_refused_naming_num_gpus(gpu_cluster):
    @ray_tpu_torch.remote(num_tpus=1)
    def f():
        return 1

    @ray_tpu_torch.remote(num_tpus=1)
    class A:
        pass

    with pytest.raises(ValueError, match="use num_gpus"):
        f.remote()
    with pytest.raises(ValueError, match="use num_gpus"):
        A.remote()


def test_leases_map_through_the_raylet_view(monkeypatch):
    """The node detects four cards from its own CUDA_VISIBLE_DEVICES and
    hands out those cards, not indices 0-3."""
    port_env(monkeypatch)
    monkeypatch.delenv("RTPU_TORCH_num_gpus", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3,5,7")
    ray_tpu_torch.init(num_cpus=4)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 4.0

        @ray_tpu_torch.remote(num_gpus=1)
        def one():
            return os.environ["CUDA_VISIBLE_DEVICES"]

        @ray_tpu_torch.remote(num_gpus=4)
        def four():
            return os.environ["CUDA_VISIBLE_DEVICES"]

        assert ray_tpu_torch.get(one.remote(), timeout=60) in ("2", "3", "5", "7")
        assert set(ray_tpu_torch.get(four.remote(), timeout=60).split(",")) == {
            "2", "3", "5", "7"}
    finally:
        ray_tpu_torch.shutdown()


# ----------------------------------------------------------- process hygiene


def _maps_torch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_control_plane_processes_never_load_torch(monkeypatch):
    """Nor does a worker that never imported it, across watchdog ticks
    (the watchdog looks for a train recorder without importing one)."""
    port_env(monkeypatch)
    monkeypatch.setenv("RTPU_TORCH_watchdog_interval_s", "0.2")
    ray_tpu_torch.init(num_cpus=4, num_gpus=4)
    try:
        _check_torch_free_processes()
    finally:
        ray_tpu_torch.shutdown()


def _check_torch_free_processes():
    @ray_tpu_torch.remote(num_cpus=0)
    class Plain:
        def pid(self):
            return os.getpid()

    @ray_tpu_torch.remote(num_gpus=1)
    def task_with_torch():
        import torch

        return int(torch.ones(2).sum()), os.getpid()

    @ray_tpu_torch.remote(num_gpus=1)
    class ActorWithTorch:
        def pid(self):
            import torch  # noqa: F401

            return os.getpid()

    plain = Plain.remote()
    plain_pid = ray_tpu_torch.get(plain.pid.remote(), timeout=60)
    value, task_pid = ray_tpu_torch.get(task_with_torch.remote(), timeout=60)
    actor = ActorWithTorch.remote()
    actor_pid = ray_tpu_torch.get(actor.pid.remote(), timeout=60)
    assert value == 2 and _maps_torch(task_pid) and _maps_torch(actor_pid)
    roles = {}
    for proc in psutil.Process().children(recursive=True):
        cmd = " ".join(proc.cmdline())
        for role in ("gcs.server", "raylet.main", "workers.fork_server"):
            # workers are forks of the fork server and keep its command
            # line: the server is the one whose parent is the raylet
            if f"ray_tpu_torch._private.{role}" in cmd and (
                    role != "workers.fork_server"
                    or "raylet.main" in " ".join(proc.parent().cmdline())):
                roles[role] = proc.pid
    assert set(roles) == {"gcs.server", "raylet.main", "workers.fork_server"}
    workers = {p.pid for p in psutil.Process(roles["workers.fork_server"]).children()}
    assert {task_pid, actor_pid, plain_pid} <= workers
    time.sleep(1.0)                                   # five watchdog ticks
    roles["plain worker"] = plain_pid
    assert {role: _maps_torch(pid) for role, pid in roles.items()} == {
        role: False for role in roles}


def test_control_plane_imports_leave_torch_out_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init, ray_tpu_torch.remote  # the API, lazily\n"
        "import ray_tpu_torch._private.gcs.server\n"
        "import ray_tpu_torch._private.raylet.main\n"
        "import ray_tpu_torch.dashboard.agent\n"
        "from ray_tpu_torch._private.workers import fork_server\n"
        "fork_server._preimport()\n"
        "from ray_tpu_torch import serve\n"
        "from ray_tpu_torch.serve import _controller, _handle, _proxy, _replica, llm, rpc_ingress\n"
        "llm.deploy, llm.stream, llm.generate  # the deployment's entry points\n"
        "ray_tpu_torch.tune, ray_tpu_torch.cluster_utils  # lazy attributes\n"
        "from ray_tpu_torch.util import (actor_pool, broadcast, check_serialize, client,\n"
        "                                collective, loadgen, multiprocessing, queue, state)\n"
        "from ray_tpu_torch.util.client import server\n"
        "from ray_tpu_torch import dag, experimental, workflow  # the graph half of 11c\n"
        "from ray_tpu_torch.dag import compiled, node\n"
        "from ray_tpu_torch.experimental import channel\n"
        "from ray_tpu_torch.workflow import virtual_actor\n"
        "ray_tpu_torch.remote(lambda: 1).bind(), ray_tpu_torch.dag.InputNode()  # nodes\n"
        "from ray_tpu_torch import scripts, _version  # the operator plane (11d)\n"
        "from ray_tpu_torch.dashboard import grafana, head\n"
        "from ray_tpu_torch.job_submission import _manager\n"
        "from ray_tpu_torch.autoscaler import (autoscaler, gcp_tpu, launcher,\n"
        "                                      node_provider, scheduler)\n"
        "from ray_tpu_torch._private import microbench, perf_gate\n"
        "from ray_tpu_torch._private.lint import blocking, contracts, core, shard_safety\n"
        "ray_tpu_torch.autoscaler, ray_tpu_torch.job_submission  # lazy attributes\n"
        "grafana.generate_dashboard(), head.DashboardHead('127.0.0.1:1')._perf_api({})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
