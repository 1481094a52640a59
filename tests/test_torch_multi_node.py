"""Several nodes on one machine: the port's ``cluster_utils.Cluster``.

A copy of ``tests/test_multi_node.py`` (modeled on reference
python/ray/tests/test_multi_node.py) against ``ray_tpu_torch``, on one
module cluster of three raylets, plus GPU placement: with
``RTPU_TORCH_num_gpus=1`` every raylet would claim one card, so each node
names its count, and only the node given ``{"GPU": 1}`` takes a
``num_gpus=1`` task; and a removed node's raylet unlinks its plasma
segment.
"""

import os
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)


@ray_tpu_torch.remote
def node_of():
    return ray_tpu_torch.get_runtime_context().get_node_id()


@pytest.fixture(scope="module")
def three_node_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        mp.setenv("RTPU_TORCH_num_gpus", "1")   # one card per raylet, faked
        cluster = Cluster(
            initialize_head=True,
            head_node_args={"resources": {"CPU": 2, "GPU": 0}},
        )
        try:
            cluster.add_node(resources={"CPU": 2, "special": 1, "GPU": 1})
            cluster.add_node(resources={"CPU": 2, "GPU": 0})
            cluster.wait_for_nodes()
            ray_tpu_torch.init(address=cluster.address)
            time.sleep(1.0)
            yield cluster
        finally:
            cluster.shutdown()


def test_cluster_visible(three_node_cluster):
    assert len([n for n in ray_tpu_torch.nodes() if n["Alive"]]) == 3
    assert ray_tpu_torch.cluster_resources()["CPU"] == 6.0


def test_custom_resource_routing(three_node_cluster):
    @ray_tpu_torch.remote(resources={"special": 1})
    def special():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    nid = ray_tpu_torch.get(special.remote())
    info = next(n for n in ray_tpu_torch.nodes() if n["NodeID"] == nid)
    assert info["Resources"].get("special") == 1.0


def test_tasks_spread_across_nodes(three_node_cluster):
    @ray_tpu_torch.remote
    def spot(t):
        time.sleep(t)
        return ray_tpu_torch.get_runtime_context().get_node_id()

    t0 = time.time()
    nodes_used = ray_tpu_torch.get([spot.remote(2) for _ in range(6)])
    assert len(set(nodes_used)) >= 2
    assert time.time() - t0 < 8


def test_cross_node_object_transfer(three_node_cluster):
    @ray_tpu_torch.remote(resources={"special": 0.5})
    def produce():
        return np.ones((1200, 1200), dtype=np.float32)

    @ray_tpu_torch.remote
    def consume(a):
        return float(a.sum())

    ref = produce.remote()
    assert ray_tpu_torch.get(consume.remote(ref)) == 1200 * 1200
    # driver-side pull of the same remote object
    assert ray_tpu_torch.get(ref).shape == (1200, 1200)


def test_node_affinity(three_node_cluster):
    target = [n for n in ray_tpu_torch.nodes() if not n["IsHead"]][0]["NodeID"]
    nid = ray_tpu_torch.get(
        node_of.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(target)
        ).remote()
    )
    assert nid == target


def test_strict_spread_pg(three_node_cluster):
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(30)
    nodes = ray_tpu_torch.get(
        [
            node_of.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(pg, i)
            ).remote()
            for i in range(3)
        ]
    )
    assert len(set(nodes)) == 3
    remove_placement_group(pg)


def test_strict_pack_pg(three_node_cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    assert pg.wait(30)
    nodes = ray_tpu_torch.get(
        [
            node_of.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(pg, i)
            ).remote()
            for i in range(2)
        ]
    )
    assert len(set(nodes)) == 1
    remove_placement_group(pg)


def test_pg_infeasible_stays_pending(three_node_cluster):
    pg = placement_group([{"CPU": 100}], strategy="PACK")
    assert not pg.wait(1.5)


def test_actor_on_remote_node(three_node_cluster):
    @ray_tpu_torch.remote(resources={"special": 1})
    class Pinned:
        def where(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    p = Pinned.remote()
    nid = ray_tpu_torch.get(p.where.remote())
    info = next(n for n in ray_tpu_torch.nodes() if n["NodeID"] == nid)
    assert info["Resources"].get("special") == 1.0


def test_gpu_only_on_the_node_that_names_it(three_node_cluster):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    gpu_node = three_node_cluster.nodes[1].node_id.hex()
    by_node = {n["NodeID"]: n["Resources"].get("GPU", 0) for n in ray_tpu_torch.nodes()}
    assert by_node == {n.node_id.hex(): (1.0 if n.node_id.hex() == gpu_node else 0)
                       for n in three_node_cluster.nodes}

    @ray_tpu_torch.remote(num_gpus=1)
    def on_card():
        return (ray_tpu_torch.get_runtime_context().get_node_id(),
                os.environ.get("CUDA_VISIBLE_DEVICES"), "torch" in sys.modules)

    assert ray_tpu_torch.get(on_card.remote(), timeout=60) == (gpu_node, "0", False)


def test_removed_node_unlinks_its_store(three_node_cluster):
    """A node's shutdown (SIGTERM to its raylet) unlinks the raylet's plasma
    segment: it would otherwise stay in /dev/shm with the objects it held."""
    node = three_node_cluster.add_node(resources={"CPU": 1, "GPU": 0})
    three_node_cluster.wait_for_nodes()
    segment = f"/dev/shm/rtpu_torch_plasma_{node.node_id.hex()[:12]}"
    assert os.path.exists(segment)
    three_node_cluster.remove_node(node)
    assert not os.path.exists(segment)


def test_killed_node_unlinks_its_store_at_shutdown(three_node_cluster):
    """A raylet killed outright cannot unlink its plasma segment; the
    node's shutdown does it."""
    node = three_node_cluster.add_node(resources={"CPU": 1, "GPU": 0})
    three_node_cluster.wait_for_nodes()
    segment = f"/dev/shm/rtpu_torch_plasma_{node.node_id.hex()[:12]}"
    assert os.path.exists(segment)
    node.kill_raylet()
    for proc in node.processes.values():
        proc.wait(timeout=10)
    assert os.path.exists(segment)
    three_node_cluster.remove_node(node)
    assert not os.path.exists(segment)


def test_node_death_detected(three_node_cluster):
    cluster = three_node_cluster
    victim = cluster.nodes[-1]
    victim_id = victim.node_id.hex()
    victim.kill_raylet()
    deadline = time.time() + 30
    while time.time() < deadline:
        info = {n["NodeID"]: n["Alive"] for n in ray_tpu_torch.nodes()}
        if info.get(victim_id) is False:
            break
        time.sleep(0.5)
    else:
        pytest.fail("node death not detected")
