"""Placement groups of the port's runtime (``ray_tpu_torch.util.placement_group``).

A copy of ``tests/test_fast.py::test_placement_group`` against
``ray_tpu_torch``, plus what one node can show of the rest: PACK, SPREAD
and STRICT_PACK placing both bundles, STRICT_SPREAD and an oversized
bundle staying pending, ``placement_group_table`` and
``get_placement_group``, removal giving the bundles back, a removed
group's submit raising instead of hanging, a group handed to a task, and
the trainer's case: ``{"GPU": 1, "CPU": 1}`` bundles whose actors each
lease a card of their own. One module cluster, ``init(num_cpus=4,
num_gpus=2)`` (the GPUs are the raylet's bookkeeping: no card is needed).
"""

import time

import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=4, num_gpus=2)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()


def _in_bundle(pg, i):
    return PlacementGroupSchedulingStrategy(pg, i)


@ray_tpu_torch.remote(num_cpus=0.5)
def where():
    return ray_tpu_torch.get_runtime_context().get_node_id()


def _free_cpus_reach(ok, timeout=30.0):
    """Wait until the free CPU count satisfies ``ok`` (the raylet reports
    reservations and returns to the GCS with a lag of about a second)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if ok(ray_tpu_torch.available_resources().get("CPU", 0)):
            return True
        time.sleep(0.1)
    return False


def _cpus_back(n):
    """Wait until ``n`` CPUs are free again (a previous test's bundles and
    leases come back asynchronously)."""
    return _free_cpus_reach(lambda free: free >= n)


@pytest.mark.timeout(60)
def test_placement_group(cluster):
    pg = placement_group([{"CPU": 0.5}, {"CPU": 0.5}], strategy="PACK")
    pg.ready()
    n = ray_tpu_torch.get(where.options(scheduling_strategy=_in_bundle(pg, 0)).remote())
    assert isinstance(n, str) and len(n) > 0
    remove_placement_group(pg)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("strategy", ["PACK", "SPREAD", "STRICT_PACK"])
def test_strategy_places_both_bundles_on_the_one_node(cluster, strategy):
    assert _cpus_back(4)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy=strategy)
    assert pg.wait(30)
    nodes = ray_tpu_torch.get([
        where.options(scheduling_strategy=_in_bundle(pg, i)).remote() for i in range(2)])
    rec = placement_group_table()[pg.id.hex()]
    assert rec["strategy"] == strategy and rec["state"] == "CREATED"
    assert rec["bundles"] == {0: {"CPU": 1}, 1: {"CPU": 1}}
    assert set(rec["bundles_to_node_id"].values()) == set(nodes) == {
        ray_tpu_torch.get_runtime_context().get_node_id()}
    remove_placement_group(pg)


@pytest.mark.timeout(60)
def test_unplaceable_groups_stay_pending(cluster):
    assert _cpus_back(4)
    spread = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    big = placement_group([{"CPU": 100}], strategy="PACK")
    assert not spread.wait(1.5) and not big.wait(0.5)
    table = placement_group_table()
    assert table[spread.id.hex()]["state"] != "CREATED"
    assert table[big.id.hex()]["bundles_to_node_id"] == {0: None}
    remove_placement_group(spread)
    remove_placement_group(big)


@pytest.mark.timeout(60)
def test_named_group_table_and_removal(cluster):
    assert _cpus_back(4)
    pg = placement_group([{"CPU": 2}], strategy="STRICT_PACK", name="gang")
    pg.ready(timeout=30)
    assert pg.bundle_count == 1 and pg.bundle_specs == [{"CPU": 2}]
    assert get_placement_group("gang").id == pg.id
    assert placement_group_table()[pg.id.hex()]["name"] == "gang"
    assert _free_cpus_reach(lambda free: free <= 2), "the bundle holds no CPUs"
    remove_placement_group(pg)
    assert placement_group_table()[pg.id.hex()]["state"] == "REMOVED"
    with pytest.raises(ValueError, match="no placement group named 'gang'"):
        get_placement_group("gang")
    assert _cpus_back(4), "a removed group kept its CPUs"


@pytest.mark.timeout(90)
def test_removed_group_submit_raises(cluster):
    assert _cpus_back(4)
    pg = placement_group([{"CPU": 1}])
    pg.ready(timeout=30)
    remove_placement_group(pg)
    start = time.time()
    with pytest.raises(Exception, match="placement group"):
        ray_tpu_torch.get(where.options(scheduling_strategy=_in_bundle(pg, 0)).remote(),
                          timeout=60)
    assert time.time() - start < 60


@pytest.mark.timeout(60)
def test_group_travels_to_a_task(cluster):
    assert _cpus_back(4)
    pg = placement_group([{"CPU": 1}])
    pg.ready(timeout=30)

    @ray_tpu_torch.remote(num_cpus=0)
    def submit_inside(group):
        assert isinstance(group, PlacementGroup) and group.bundle_count == 1
        return ray_tpu_torch.get(
            where.options(scheduling_strategy=_in_bundle(group, 0)).remote())

    assert ray_tpu_torch.get(submit_inside.remote(pg), timeout=60)
    remove_placement_group(pg)


def test_bad_groups_are_refused(cluster):
    with pytest.raises(ValueError, match="strategy must be one of"):
        placement_group([{"CPU": 1}], strategy="TIGHT")
    with pytest.raises(ValueError, match="non-empty"):
        placement_group([])
    with pytest.raises(ValueError, match="invalid bundle"):
        placement_group([{"CPU": -1}])


@pytest.mark.timeout(90)
def test_gpu_bundles_give_each_actor_its_own_card(cluster):
    """A train worker group's reservation: one ``{"GPU": 1, "CPU": 1}``
    bundle per worker; each bundle's actor sees a card of its own, and no
    card is left for a third GPU actor outside the group."""
    assert _cpus_back(4)

    @ray_tpu_torch.remote(num_gpus=1, num_cpus=1)
    class Card:
        def visible(self):
            import os

            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    ray_tpu_torch.get_runtime_context().get_accelerator_ids()["GPU"])

    pg = placement_group([{"GPU": 1, "CPU": 1}] * 2)
    pg.ready(timeout=30)
    actors = [Card.options(scheduling_strategy=_in_bundle(pg, i)).remote() for i in range(2)]
    seen = ray_tpu_torch.get([a.visible.remote() for a in actors], timeout=60)
    assert sorted(v for v, _ in seen) == ["0", "1"]
    assert all([v] == ids for v, ids in seen)
    outside = Card.remote()
    ready, _ = ray_tpu_torch.wait([outside.visible.remote()], timeout=1.5)
    assert not ready, "a GPU actor outside the group found a free card"
    for a in actors + [outside]:
        ray_tpu_torch.kill(a)
    remove_placement_group(pg)
