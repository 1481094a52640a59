"""The port's DAGs (``ray_tpu_torch.dag``): ``.bind()``, eager
``execute()`` and compiled graphs over the port's channels.

The ten tests of ``tests/test_dag.py`` on the port, on one module cluster
of two nodes (the JAX file starts a runtime per test): the eight on the
head node, the two cross-node ones with their stages placed by custom
resources on either node (a same-node edge on shared memory, the edge
between nodes on a socket). The second node has no CPU, so that every
actor that does not ask for its resources stays on the head; its stages
ask for ``num_cpus=0`` beside them. Then one program run under both packages
(``ray_tpu`` first, shut down, then the port): a three-stage pipeline,
fan-out / fan-in and numpy payloads from a seed give equal outputs. Port
only: a CPU torch tensor (fp32 and bf16) through a compiled DAG comes back
bitwise, and its input channel leaves the store at teardown. Queue C
fault 12: a stage output over the channel buffer raises ``ChannelFull``
at the driver's ``get()`` and the DAG goes on, where the JAX package's
exec loop dies and ``get()`` waits out its timeout. Tolerance: none,
every comparison is exact (the pipelining and speed bounds are
test_dag.py's).
"""

import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch.dag.node import InputNode, MultiOutputNode


@ray_tpu_torch.remote
class Doubler:
    def apply(self, x):
        return x * 2


@ray_tpu_torch.remote
class Adder:
    def __init__(self, k=1):
        self.k = k

    def apply(self, x):
        return x + self.k

    def add_pair(self, a, b):
        return a + b

    def boom(self, x):
        raise ValueError("boom")


def kill(*handles):
    for h in handles:
        ray_tpu_torch.kill(h)


# ------------------------------------------- one program under both packages


def p_graphs(rt, seed: int = 0):
    """A three-stage pipeline, fan-out / fan-in and numpy payloads under the
    runtime package ``rt``; then a stage whose output is over a 64 KiB
    channel: what its ``get(timeout=1.5)`` raises, and the next execute."""
    import importlib

    node = importlib.import_module(f"{rt.__name__}.dag.node")

    class Add:
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x + self.k

        def pair(self, a, b):
            return a + b

        def big(self, n):
            return np.zeros(n, np.uint8)

    class Mul:
        def apply(self, x):
            return x * 2

    A, M = rt.remote(Add), rt.remote(Mul)
    out = {}
    a, b, c = A.remote(1), M.remote(), A.remote(100)
    with node.InputNode() as inp:
        z = c.apply.bind(b.apply.bind(a.apply.bind(inp)))
    dag = z.experimental_compile()
    try:
        out["pipeline"] = [dag.execute(i).get() for i in range(10)]
    finally:
        dag.teardown()
    d, e = A.remote(2), A.remote(0)
    with node.InputNode() as inp:
        s = e.pair.bind(a.apply.bind(inp), d.apply.bind(inp))
    dag = s.experimental_compile()
    try:
        out["fan_in"] = [dag.execute(i).get() for i in range(10)]
    finally:
        dag.teardown()
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=n).astype(np.float32) for n in (1, 1000, 100_000)]
    with node.InputNode() as inp:
        y = c.apply.bind(b.apply.bind(inp))
    dag = y.experimental_compile()
    try:
        got = [dag.execute(x).get() for x in arrays]
        out["numpy"] = [(g.dtype.str, g.shape, g.tobytes()) for g in got]
    finally:
        dag.teardown()
    with node.InputNode() as inp:
        w = a.big.bind(inp)
    dag = w.experimental_compile(buffer_size_bytes=1 << 16)
    try:
        try:
            dag.execute(1 << 17).get(timeout=1.5)
            out["oversized"] = None
        except Exception as err:  # noqa: BLE001 — which error is the result
            out["oversized"] = type(err).__name__
        try:
            out["after_oversized"] = int(dag.execute(16).get(timeout=1.5).size)
        except Exception as err:  # noqa: BLE001
            out["after_oversized"] = type(err).__name__
    finally:
        dag.teardown()
    for h in (a, b, c, d, e):
        rt.kill(h)
    return out


@pytest.fixture(scope="module")
def by_value():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def jax_run(by_value):
    ray_tpu.init(num_cpus=6)
    try:
        return p_graphs(ray_tpu)
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster(jax_run):
    """Two nodes; the port's runtime starts after the JAX run ended."""
    from ray_tpu_torch.cluster_utils import Cluster

    assert not ray_tpu.is_initialized()
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        cluster = Cluster(initialize_head=True,
                          head_node_args={"resources": {"CPU": 8, "stage1": 1, "GPU": 0}})
        try:
            cluster.add_node(resources={"CPU": 0, "stage2": 2, "far": 1, "GPU": 0})
            cluster.wait_for_nodes()
            ray_tpu_torch.init(address=cluster.address)
            yield cluster
        finally:
            ray_tpu_torch.shutdown()
            cluster.shutdown()


def test_same_program_same_outputs_under_both_packages(jax_run, cluster):
    port = p_graphs(ray_tpu_torch)
    for key in ("pipeline", "fan_in", "numpy"):
        assert port[key] == jax_run[key], key
    assert port["pipeline"] == [(i + 1) * 2 + 100 for i in range(10)]
    assert port["fan_in"] == [(i + 1) + (i + 2) for i in range(10)]
    # Queue C fault 12: the JAX package's exec loop dies on the oversized
    # output (get() times out, and so does every later execute); the
    # port's sends ChannelFull downstream and lives on
    assert (jax_run["oversized"], jax_run["after_oversized"]) == ("TimeoutError",) * 2
    assert (port["oversized"], port["after_oversized"]) == ("ChannelFull", 16)


# ------------------------------------------------ tests/test_dag.py, ported


def test_eager_dag_execute(cluster):
    a = Adder.remote(10)
    with InputNode() as inp:
        out = a.apply.bind(inp)
    ref = out.execute(5)
    assert ray_tpu_torch.get(ref) == 15
    kill(a)


def test_compiled_three_stage_pipeline(cluster):
    a = Adder.remote(1)
    b = Doubler.remote()
    c = Adder.remote(100)
    with InputNode() as inp:
        x = a.apply.bind(inp)
        y = b.apply.bind(x)
        z = c.apply.bind(y)
    dag = z.experimental_compile()
    try:
        for i in range(50):
            assert dag.execute(i).get() == (i + 1) * 2 + 100
    finally:
        dag.teardown()
        kill(a, b, c)


def test_compiled_dag_pipelining_overlap(cluster):
    """Stages overlap: 3 stages x 50ms, 6 items. Serial would be 900ms;
    pipelined is ~(3 + 5) * 50ms = 400ms. Assert well under serial."""

    @ray_tpu_torch.remote
    class Slow:
        def apply(self, x):
            time.sleep(0.05)
            return x + 1

    s1, s2, s3 = Slow.remote(), Slow.remote(), Slow.remote()
    with InputNode() as inp:
        out = s3.apply.bind(s2.apply.bind(s1.apply.bind(inp)))
    dag = out.experimental_compile()
    try:
        dag.execute(0).get()  # warm
        t0 = time.perf_counter()
        refs = [dag.execute(i) for i in range(6)]
        outs = [r.get() for r in refs]
        dt = time.perf_counter() - t0
        assert outs == [i + 3 for i in range(6)]
        assert dt < 0.75, f"no pipelining: {dt:.2f}s"
    finally:
        dag.teardown()
        kill(s1, s2, s3)


def test_compiled_dag_fan_out_fan_in(cluster):
    a = Adder.remote(1)
    b = Adder.remote(2)
    c = Adder.remote(0)
    with InputNode() as inp:
        x = a.apply.bind(inp)
        y = b.apply.bind(inp)
        z = c.add_pair.bind(x, y)
    dag = z.experimental_compile()
    try:
        for i in range(10):
            assert dag.execute(i).get() == (i + 1) + (i + 2)
    finally:
        dag.teardown()
        kill(a, b, c)


def test_compiled_dag_multi_output(cluster):
    a = Adder.remote(1)
    b = Doubler.remote()
    with InputNode() as inp:
        x = a.apply.bind(inp)
        y = b.apply.bind(inp)
    dag = MultiOutputNode([x, y]).experimental_compile()
    try:
        assert dag.execute(5).get() == [6, 10]
    finally:
        dag.teardown()
        kill(a, b)


def test_compiled_dag_numpy_payloads(cluster):
    b = Doubler.remote()
    with InputNode() as inp:
        out = b.apply.bind(inp)
    dag = b and out.experimental_compile()
    try:
        arr = np.arange(100_000, dtype=np.float32)
        got = dag.execute(arr).get()
        np.testing.assert_array_equal(got, arr * 2)
    finally:
        dag.teardown()
        kill(b)


def test_compiled_dag_error_propagation(cluster):
    a = Adder.remote(1)
    b = Adder.remote(1)
    with InputNode() as inp:
        out = b.apply.bind(a.boom.bind(inp))
    dag = out.experimental_compile()
    try:
        with pytest.raises(ValueError, match="boom"):
            dag.execute(1).get()
        # the DAG stays usable after an application error
        with pytest.raises(ValueError, match="boom"):
            dag.execute(2).get()
    finally:
        dag.teardown()
        kill(a, b)


def test_compiled_dag_faster_than_uncompiled(cluster):
    """The headline property: per-step overhead beats .remote() chains."""
    a = Adder.remote(1)
    b = Doubler.remote()
    with InputNode() as inp:
        out = b.apply.bind(a.apply.bind(inp))

    # uncompiled: 2 actor submissions + gets per step
    n = 200
    ray_tpu_torch.get(b.apply.remote(ray_tpu_torch.get(a.apply.remote(0))))
    t0 = time.perf_counter()
    for i in range(n):
        ray_tpu_torch.get(b.apply.remote(ray_tpu_torch.get(a.apply.remote(i))))
    t_uncompiled = time.perf_counter() - t0

    dag = out.experimental_compile()
    try:
        dag.execute(0).get()
        t0 = time.perf_counter()
        for i in range(n):
            assert dag.execute(i).get() == (i + 1) * 2
        t_compiled = time.perf_counter() - t0
    finally:
        dag.teardown()
        kill(a, b)
    speedup = t_uncompiled / t_compiled
    print(f"\ncompiled {n / t_compiled:,.0f} steps/s vs "
          f"uncompiled {n / t_uncompiled:,.0f} steps/s ({speedup:.1f}x)")
    assert speedup > 2.0, f"compiled DAG only {speedup:.2f}x faster"


def node_of(h):
    return ray_tpu_torch.get(h.__ray_call__.remote(
        lambda self: __import__("ray_tpu_torch").get_runtime_context().get_node_id()))


def test_compiled_dag_cross_node_pipeline(cluster):
    """Stages on different nodes connected by socket channels, same-node
    edges on shared memory (reference: compiled_dag_node.py:391 + the NCCL
    channel's role, torch_tensor_nccl_channel.py:191)."""
    a = Adder.options(resources={"stage1": 1}).remote(1)  # head node
    b = Doubler.options(num_cpus=0, resources={"stage2": 1}).remote()  # second node
    c = Adder.options(num_cpus=0, resources={"stage2": 1}).remote(100)  # second node
    try:
        assert node_of(a) != node_of(b)
        assert node_of(b) == node_of(c)

        with InputNode() as inp:
            x = a.apply.bind(inp)     # driver -> head actor (shm)
            y = b.apply.bind(x)       # head -> node2 (socket)
            z = c.apply.bind(y)       # node2 -> node2 (shm on node2)
        dag = z.experimental_compile()
        try:
            for i in range(30):
                assert dag.execute(i).get() == (i + 1) * 2 + 100
            # numpy payload across the socket edge
            with InputNode() as inp2:
                w = b.apply.bind(inp2)
            dag2 = w.experimental_compile()
            try:
                arr = np.arange(1000, dtype=np.float32)
                out = dag2.execute(arr).get()
                assert np.allclose(out, arr * 2)
            finally:
                dag2.teardown()
        finally:
            dag.teardown()
    finally:
        kill(a, b, c)


def test_compiled_dag_cross_node_error_propagation(cluster):
    a = Adder.options(num_cpus=0, resources={"far": 1}).remote(1)
    with InputNode() as inp:
        out = a.boom.bind(inp)
    dag = out.experimental_compile()
    try:
        with pytest.raises(ValueError, match="boom"):
            dag.execute(1).get()
        # channel stays usable for the next tick after an error
        with pytest.raises(ValueError, match="boom"):
            dag.execute(2).get()
    finally:
        dag.teardown()
        kill(a)


# ---------------------------------------------------------------- port only


def test_cpu_tensors_through_a_compiled_dag(cluster):
    """fp32 and bf16 CPU tensors through two stages come back bitwise as
    CPU tensors; the driver's input channel leaves the store at teardown."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.worker import get_global_worker

    a, b = Adder.remote(1), Doubler.remote()
    with InputNode() as inp:
        out = b.apply.bind(a.apply.bind(inp))
    dag = out.experimental_compile(buffer_size_bytes=8 << 20)
    oid = dag._input_channel.descriptor()["oid"]
    try:
        g = torch.Generator().manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(4, 512, 768, generator=g).to(dtype)
            got = dag.execute(x).get()
            want = (x + 1) * 2
            assert got.device.type == "cpu" and got.dtype == dtype
            assert torch.equal(got, want)
        # in flight: several executes before the first get
        xs = [torch.full((3,), float(i)) for i in range(4)]
        refs = [dag.execute(x) for x in xs]
        assert [r.get().tolist() for r in refs] == [((x + 1) * 2).tolist() for x in xs]
        assert get_global_worker().plasma.contains(ObjectID(oid))
    finally:
        dag.teardown()
        kill(a, b)
    assert not get_global_worker().plasma.contains(ObjectID(oid))
