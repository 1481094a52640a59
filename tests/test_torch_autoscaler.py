"""The port's autoscaler: demand scheduler + fake-provider e2e, a copy of
``tests/test_autoscaler.py`` over ``ray_tpu_torch`` (one cluster for the
module), with GPU node types, plus the demand scheduler held against the JAX
package's on the same seeded demands.

Reference contracts: v2 ResourceDemandScheduler picks node types for
unplaceable demand (autoscaler/v2/scheduler.py:624), the autoscaler reads
cluster load from the GCS (gcs_autoscaler_state_manager.h:30), and the fake
multi-node provider enables cloud-free e2e
(autoscaler/_private/fake_multi_node/node_provider.py). A GPU node type is
launched for pending ``num_gpus`` demand, and removed once idle.
"""

import subprocess
import sys
import time
import uuid

import numpy as np
import pytest

from _torch_runtime import port_env

GPU8 = {"CPU": 8.0, "GPU": 8.0, "GPU-H100-8-head": 1.0}


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch
    from ray_tpu_torch import api

    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        try:
            yield api._local_node.gcs_address, api._local_node.session_dir
        finally:
            ray_tpu_torch.shutdown()


def test_scheduler_picks_node_type_for_head_demand():
    from ray_tpu_torch.autoscaler.scheduler import ResourceDemandScheduler

    sched = ResourceDemandScheduler(
        {
            "cpu-small": {"resources": {"CPU": 4.0}, "max_workers": 10},
            "gpu-8": {"resources": dict(GPU8), "max_workers": 4},
        }
    )
    # Host-head demand can only fit the GPU type.
    to_launch, infeasible = sched.schedule(
        [{"GPU-H100-8-head": 1.0, "GPU": 8.0}], [], {}
    )
    assert to_launch == {"gpu-8": 1} and not infeasible

    # A CPU demand prefers the smallest satisfying type.
    to_launch, _ = sched.schedule([{"CPU": 2.0}], [], {})
    assert to_launch == {"cpu-small": 1}

    # Demand that fits existing capacity launches nothing.
    to_launch, _ = sched.schedule([{"CPU": 2.0}], [{"CPU": 4.0}], {})
    assert to_launch == {}

    # Two host demands -> two nodes; max_workers caps the third.
    to_launch, infeasible = sched.schedule(
        [{"GPU-H100-8-head": 1.0}] * 3, [], {"gpu-8": 2}
    )
    assert to_launch == {"gpu-8": 2}
    assert len(infeasible) == 1

    # Bin-packing: 4 x CPU:2 demands pack into one cpu-small plus one more.
    to_launch, _ = sched.schedule([{"CPU": 2.0}] * 4, [], {})
    assert to_launch == {"cpu-small": 2}


def test_scheduler_min_workers():
    from ray_tpu_torch.autoscaler.scheduler import ResourceDemandScheduler

    sched = ResourceDemandScheduler(
        {"gpu-8": {"resources": dict(GPU8), "min_workers": 2, "max_workers": 4}}
    )
    assert sched.min_workers_to_launch({}) == {"gpu-8": 2}
    assert sched.min_workers_to_launch({"gpu-8": 3}) == {}


def _random_case(rng):
    keys = ["CPU", "GPU", "memory", "custom"]
    types = {}
    for i in range(int(rng.integers(1, 4))):
        res = {k: float(rng.integers(1, 9)) for k in keys
               if rng.random() < 0.7 or k == "CPU"}
        types[f"t{i}"] = {"resources": res,
                          "min_workers": int(rng.integers(0, 2)),
                          "max_workers": int(rng.integers(1, 4))}
    demands = [{k: float(rng.choice([0.5, 1, 2, 4])) for k in keys
                if rng.random() < 0.5} or {"CPU": 1.0}
               for _ in range(int(rng.integers(0, 12)))]
    caps = [{k: float(rng.integers(0, 5)) for k in keys if rng.random() < 0.6}
            for _ in range(int(rng.integers(0, 3)))]
    counts = {t: int(rng.integers(0, 3)) for t in types if rng.random() < 0.5}
    return types, demands, caps, counts


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_matches_the_jax_package(seed):
    """Same node types, demands, free capacity and node counts give the
    same launches, infeasible demands and min-worker deficits."""
    from ray_tpu.autoscaler.scheduler import ResourceDemandScheduler as Jax
    from ray_tpu_torch.autoscaler.scheduler import ResourceDemandScheduler

    rng = np.random.default_rng(seed)
    for _ in range(25):
        types, demands, caps, counts = _random_case(rng)
        ours = ResourceDemandScheduler(types)
        ref = Jax(types)
        assert ours.schedule(demands, caps, counts) == ref.schedule(
            demands, caps, counts)
        assert ours.min_workers_to_launch(counts) == ref.min_workers_to_launch(
            counts)


@pytest.mark.timeout(120)
def test_autoscaler_update_with_recording_provider(cluster):
    """Pending actor demand visible in GCS load triggers a launch decision."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
    from ray_tpu_torch.autoscaler.node_provider import RecordingNodeProvider

    gcs_address, _ = cluster

    @ray_tpu_torch.remote(resources={"SLICE": 1.0})
    class OnSlice:
        def where(self):
            return "slice"

    actor = OnSlice.remote()  # unplaceable until such a node exists
    try:
        provider = RecordingNodeProvider()
        scaler = Autoscaler(
            gcs_address=gcs_address,
            provider=provider,
            node_types={
                "fake-slice": NodeTypeConfig(
                    resources={"CPU": 4.0, "SLICE": 1.0}, max_workers=2
                )
            },
        )
        deadline = time.time() + 30
        while time.time() < deadline and not provider.launches:
            scaler.update()
            time.sleep(0.5)
        assert provider.launches == ["fake-slice"]
        # The demand is now covered by the pending node; no duplicate launch.
        scaler.update()
        assert provider.launches == ["fake-slice"]
    finally:
        ray_tpu_torch.kill(actor)


@pytest.mark.timeout(170)
def test_autoscaler_e2e_fake_provider_gpu_node(cluster):
    """num_gpus demand -> the fake provider launches a REAL raylet with one
    GPU -> the pending actor schedules onto it and answers with its card;
    once the actor is gone the idle node is removed."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import (Autoscaler, FakeMultiNodeProvider,
                                          NodeTypeConfig)

    gcs_address, session_dir = cluster
    node_types = {
        "gpu-node": NodeTypeConfig(resources={"CPU": 2.0, "GPU": 1.0},
                                   max_workers=1)
    }
    provider = FakeMultiNodeProvider(
        gcs_address,
        {k: v.to_dict() for k, v in node_types.items()},
        session_dir=session_dir,
    )
    scaler = Autoscaler(gcs_address, provider, node_types,
                        update_interval_s=0.5, idle_timeout_s=1.0)
    scaler.start()
    try:

        @ray_tpu_torch.remote(num_gpus=1)
        class OnCard:
            def card(self):
                import os

                return os.environ.get("CUDA_VISIBLE_DEVICES")

        w = OnCard.remote()
        # The actor is unplaceable on the head (GPU 0); the autoscaler must
        # notice and launch the GPU node, then the GCS schedules onto it.
        assert ray_tpu_torch.get(w.card.remote(), timeout=90) == "0"
        assert len(provider.non_terminated_nodes()) == 1
        assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0
        ray_tpu_torch.kill(w)
        deadline = time.time() + 60
        while provider.non_terminated_nodes() and time.time() < deadline:
            time.sleep(0.5)
        assert provider.non_terminated_nodes() == {}
    finally:
        scaler.stop()
        provider.shutdown()


@pytest.mark.timeout(170)
def test_command_node_provider_launches_real_node(cluster, tmp_path,
                                                 monkeypatch):
    """CommandNodeProvider runs user shell commands to provision nodes:
    the 'up' command here is the port's operator CLI, and the launched node
    joins the cluster (reference: the local/on-prem provider story)."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler.node_provider import CommandNodeProvider

    gcs, _ = cluster
    # the CLI records its node in a state file of this test's own
    monkeypatch.setenv("RTPU_TORCH_STATE_FILE", str(tmp_path / "state.json"))
    token = f"prov_{uuid.uuid4().hex[:8]}"
    up = (
        f"{sys.executable} -m ray_tpu_torch.scripts start "
        "--address $gcs_address "
        f"--resources '{{\"CPU\": 1, \"GPU\": 0, \"{token}\": 1}}'"
    )
    provider = CommandNodeProvider(gcs, {"worker": {"up": up}})
    try:
        (pid,) = provider.create_node("worker")
        assert provider.non_terminated_nodes() == {pid: "worker"}

        deadline = time.time() + 60
        while True:
            tokens = ray_tpu_torch.cluster_resources().get(token)
            if tokens:
                break
            assert time.time() < deadline, ray_tpu_torch.nodes()
            time.sleep(0.5)

        @ray_tpu_torch.remote(resources={token: 1})
        def where():
            return ray_tpu_torch.get_runtime_context().get_node_id()

        assert ray_tpu_torch.get(where.remote(), timeout=60)
        provider.terminate_node(pid)  # no down command: bookkeeping only
        assert provider.non_terminated_nodes() == {}
    finally:
        # reap the CLI-launched raylet (no down command in this test): the
        # unique resource token appears only in THIS node's argv
        subprocess.run(["pkill", "-f", token], capture_output=True)


def test_command_node_provider_command_contract(tmp_path):
    """Placeholders format into commands; failures surface loudly; down
    runs on terminate."""
    from ray_tpu_torch.autoscaler.node_provider import CommandNodeProvider

    up_marker = tmp_path / "up.log"
    down_marker = tmp_path / "down.log"
    provider = CommandNodeProvider("1.2.3.4:5", {
        "t": {
            "up": f"echo $provider_node_id $gcs_address >> {up_marker}",
            "down": f"echo $provider_node_id >> {down_marker}",
        },
        "bad": {"up": "exit 3"},
    })
    (pid,) = provider.create_node("t")
    assert up_marker.read_text().strip() == f"{pid} 1.2.3.4:5"
    provider.terminate_node(pid)
    assert down_marker.read_text().strip() == pid
    assert provider.non_terminated_nodes() == {}

    with pytest.raises(RuntimeError, match="provider command failed"):
        provider.create_node("bad")
