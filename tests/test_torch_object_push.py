"""Object push and broadcast fan-out on the port's ``Cluster``.

A copy of ``tests/test_object_push.py`` (reference: object_manager.cc:339
Push, push_manager.h, release/benchmarks object_store broadcast) against
``ray_tpu_torch``, on one module cluster of four raylets: each test puts
an object of its own.
"""

import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.broadcast import broadcast_object


@pytest.fixture(scope="module")
def three_nodes():
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        cluster = Cluster(
            initialize_head=True, head_node_args={"resources": {"CPU": 2}}
        )
        try:
            for i in range(3):
                cluster.add_node(resources={"CPU": 1, f"n{i}": 1})
            cluster.wait_for_nodes()
            ray_tpu_torch.init(address=cluster.address)
            yield cluster
            ray_tpu_torch.shutdown()
        finally:
            cluster.shutdown()


def test_broadcast_tree_fanout(three_nodes):
    """Broadcast uses >=2 distinct sources (tree fan-out), not N pushes
    from the primary, and every node ends up holding a copy."""
    data = np.arange(2_000_000, dtype=np.float64)  # 16 MB -> plasma
    ref = ray_tpu_torch.put(data)

    stats = broadcast_object(ref)
    assert len(stats["nodes"]) == 4  # head + 3 workers
    sources = {s for s, _ in stats["transfers"]}
    assert len(stats["transfers"]) == 3  # N-1 transfers total
    assert len(sources) >= 2, (
        f"broadcast used a single source: {stats['transfers']}"
    )
    assert stats["rounds"] <= 2  # ceil(log2(4))

    # every node can now read the value locally (no further transfer):
    # schedule a reader on each worker node via its private resource
    for i in range(3):
        @ray_tpu_torch.remote(resources={f"n{i}": 1})
        def readback(v):
            import numpy as _np

            return float(_np.asarray(v).sum())

        # the ref arg resolves node-locally (a copy is already there)
        assert ray_tpu_torch.get(readback.remote(ref)) == float(data.sum())


def test_hot_object_pull_spreads_sources(three_nodes):
    """Concurrent pullers of a hot object spread over registered holders
    (shuffled source selection) instead of all hitting the primary."""
    data = np.ones(1_000_000, dtype=np.float64)  # 8 MB
    ref = ray_tpu_torch.put(data)

    # seed one extra copy via push, then let the remaining nodes pull
    stats = broadcast_object(ref)
    assert len(stats["nodes"]) == 4

    @ray_tpu_torch.remote
    def reader(v):
        return float(v.sum())

    out = ray_tpu_torch.get([reader.remote(ref) for _ in range(6)])
    assert out == [float(data.sum())] * 6


def test_push_object_rpc_direct(three_nodes):
    """A single PushObject RPC moves a spilled-or-resident object to an
    explicit target node."""
    from ray_tpu_torch._private.worker import get_global_worker

    data = np.full(500_000, 7.0)
    ref = ray_tpu_torch.put(data)
    worker = get_global_worker()
    oid = ref.object_id()

    nodes = worker.gcs.get_all_node_info()
    me = worker.node_id.binary()
    target = next(n for n in nodes if n["node_id"] != me)
    holder = next(n for n in nodes if n["node_id"] == me)

    async def push():
        client = await worker.pool.get(
            holder["ip"], holder["raylet_port"]
        )
        return await client.call(
            "PushObject",
            {"object_id": oid.binary(), "target": target["node_id"],
             "owner_addr": list(worker.address)},
            timeout=60,
        )

    r = worker.io.run(push())
    assert r.get("ok"), r
    # AddObjectLocation arrives as a fire-and-forget notify: poll briefly
    import time

    deadline = time.time() + 10
    while True:
        entry = worker.memory_store.get_if_exists(oid)
        locs = set(entry.locations) | worker._object_locations.get(
            oid.binary(), set()
        )
        if target["node_id"] in locs:
            break
        assert time.time() < deadline, f"location never registered: {locs}"
        time.sleep(0.1)
