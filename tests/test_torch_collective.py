"""The host plane's collectives of the port (``ray_tpu_torch.util.collective``).

The nine tests of ``tests/test_collective.py`` against ``ray_tpu_torch``,
and one program under each package: four ranks, float32 inputs from
``np.random.default_rng(seed)``; sum, product, min and max allreduce,
allgather, broadcast, reducescatter and send/recv. The port's results are
bitwise the JAX package's for numpy float32, for CPU torch float32
tensors against the same numpy arrays, and for CPU torch bf16 tensors
against ``ml_dtypes.bfloat16`` arrays with the same bits; each tensor is
updated in place (allreduce, broadcast) and every tensor result stays on
its device. A rank that reduces only numpy never loads torch. The
runtimes run one after the other (the program under ``ray_tpu``, then
under ``ray_tpu_torch``), before the module's port cluster starts.
"""

import importlib
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch.util import collective as col

WORLD = 4
SEED = 7
N = 1001            # not a multiple of WORLD: the ring's chunks are uneven
OPS = ("sum", "product", "min", "max")


@ray_tpu_torch.remote
class Worker:
    def init(self, world, rank, group="default"):
        col.init_collective_group(world, rank, group_name=group)
        return rank

    def allreduce(self, x, group="default", op=col.ReduceOp.SUM):
        return col.allreduce(np.asarray(x, dtype=np.float32), group, op=op)

    def allgather(self, x, group="default"):
        return col.allgather(np.asarray(x, dtype=np.float32), group)

    def broadcast(self, x, src, group="default"):
        return col.broadcast(np.asarray(x, dtype=np.float32), src, group)

    def reducescatter(self, x, group="default"):
        return col.reducescatter(np.asarray(x, dtype=np.float32), group)

    def allreduce_read_only(self, x, group="default"):
        a = np.array(x, dtype=np.float32)
        a.flags.writeable = False      # as a zero-copy object-store view
        out = col.allreduce(a, group)
        return out, a

    def rank_info(self, group="default"):
        return (col.get_rank(group), col.get_collective_group_size(group))

    def p2p(self, peer, group="default"):
        r = col.get_rank(group)
        if r == 0:
            col.send(np.arange(5, dtype=np.int64) * 7, peer, group)
            return None
        return col.recv(0, group)

    def barrier(self, group="default"):
        col.barrier(group)
        return True

    def destroy(self, group="default"):
        col.destroy_collective_group(group)
        return True


# ------------------------------------------------------------ the program


def _bits(x) -> bytes:
    """The raw bytes of an array or a tensor."""
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x).reshape(-1).view(np.uint8).tobytes()
    torch = sys.modules["torch"]
    return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _inputs(rank: int):
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(N).astype(np.float32) for _ in range(WORLD)][rank]


def _make(kind: str, a: np.ndarray):
    """``a`` as the kind of argument: a numpy float32 array (np32), an
    ml_dtypes bf16 array (np_bf16, JAX package only), a CPU torch float32 or
    bf16 tensor (t32, t_bf16, the port only)."""
    if kind == "np32":
        return a.copy()
    if kind == "np_bf16":
        import ml_dtypes

        return a.astype(ml_dtypes.bfloat16)
    import torch

    t = torch.from_numpy(a.copy())
    return t if kind == "t32" else t.to(torch.bfloat16)


def _rank_ops(col, rank: int, kind: str, group: str):
    """Every collective once, in the same order on every rank: the bytes of
    each result, and for tensors whether each stayed in place on the CPU."""
    x = _inputs(rank)
    out, kept = {}, []
    for op in OPS:
        arg = _make(kind, x)
        got = col.allreduce(arg, group, op=op)
        out[f"allreduce_{op}"] = _bits(got)
        if kind.startswith("t"):
            kept.append(got is arg and got.device.type == "cpu")
    gathered = col.allgather(_make(kind, x), group)
    out["allgather"] = [_bits(g) for g in gathered]
    arg = _make(kind, x if rank == 2 else np.zeros(N, np.float32))
    got = col.broadcast(arg, 2, group)
    out["broadcast"] = _bits(got)
    shard = col.reducescatter(_make(kind, x), group)
    out["reducescatter"] = _bits(shard)
    if kind.startswith("t"):
        kept += [got is arg, _bits(arg) == out["broadcast"]]
        kept += [t.device.type == "cpu" and t.dtype == arg.dtype for t in gathered + [shard]]
    if rank % 2 == 0:
        col.send(_make(kind, x[:17]), rank + 1, group)
    else:
        out["recv"] = _bits(col.recv(rank - 1, group))
    return out, kept


def _program(rt, kinds):
    collective = importlib.import_module(f"{rt.__name__}.util.collective")

    @rt.remote
    class Rank:
        def __init__(self, rank):
            self.rank = rank
            collective.init_collective_group(WORLD, rank, group_name="parity")

        def run(self, kind):
            out, kept = _rank_ops(collective, self.rank, kind, "parity")
            return out, kept, "torch" in sys.modules

    ranks = [Rank.remote(r) for r in range(WORLD)]
    return {kind: rt.get([r.run.remote(kind) for r in ranks], timeout=120)
            for kind in kinds}


@pytest.fixture(scope="module", autouse=True)
def by_value():
    """This module travels to the workers by value: no port worker imports
    it, nor the JAX package with it."""
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def parity():
    """The program under ``ray_tpu``, then under ``ray_tpu_torch``."""
    ray_tpu.init(num_cpus=WORLD)
    try:
        ref = _program(ray_tpu, ("np32", "np_bf16"))
    finally:
        ray_tpu.shutdown()
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=WORLD)
        try:
            got = _program(ray_tpu_torch, ("np32", "t32", "t_bf16"))
        finally:
            ray_tpu_torch.shutdown()
    return ref, got


def _results(runs):
    return [out for out, _, _ in runs]


def test_numpy_float32_bitwise_the_jax_packages(parity):
    ref, got = parity
    assert _results(got["np32"]) == _results(ref["np32"])
    # the sum is the ring's: within rounding of numpy's own sum
    xs = [_inputs(r) for r in range(WORLD)]
    total = np.frombuffer(_results(got["np32"])[0]["allreduce_sum"], np.float32)
    np.testing.assert_allclose(total, np.sum(xs, axis=0), rtol=1e-5, atol=1e-6)


def test_torch_float32_tensors_bitwise_in_place(parity):
    ref, got = parity
    assert _results(got["t32"]) == _results(ref["np32"])
    assert all(all(kept) and kept for _, kept, _ in got["t32"])


def test_torch_bf16_tensors_bitwise_ml_dtypes(parity):
    ref, got = parity
    assert _results(got["t_bf16"]) == _results(ref["np_bf16"])
    assert all(all(kept) and kept for _, kept, _ in got["t_bf16"])


def test_numpy_ranks_never_load_torch(parity):
    _, got = parity
    assert [loaded for _, _, loaded in got["np32"]] == [False] * WORLD
    assert [loaded for _, _, loaded in got["t32"]] == [True] * WORLD


# ------------------------------------------- tests/test_collective.py's nine


@pytest.fixture(scope="module")
def world4(parity):
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=6)
        try:
            workers = [Worker.remote() for _ in range(4)]
            ray_tpu_torch.get([w.init.remote(4, i) for i, w in enumerate(workers)])
            yield workers
        finally:
            ray_tpu_torch.shutdown()


def test_rank_info(world4):
    infos = ray_tpu_torch.get([w.rank_info.remote() for w in world4])
    assert infos == [(0, 4), (1, 4), (2, 4), (3, 4)]


def test_allreduce_sum(world4):
    data = [np.full(10, i + 1, np.float32) for i in range(4)]
    out = ray_tpu_torch.get(
        [w.allreduce.remote(d) for w, d in zip(world4, data)]
    )
    for o in out:
        np.testing.assert_array_equal(o, np.full(10, 10.0, np.float32))


def test_allreduce_max(world4):
    data = [np.arange(8, dtype=np.float32) * (i + 1) for i in range(4)]
    out = ray_tpu_torch.get(
        [w.allreduce.remote(d, "default", col.ReduceOp.MAX)
         for w, d in zip(world4, data)]
    )
    for o in out:
        np.testing.assert_array_equal(o, np.arange(8, dtype=np.float32) * 4)


def test_allreduce_of_a_read_only_array_leaves_it(world4):
    """A read-only array (a zero-copy view of the object store) is reduced
    in a copy, as in the JAX package; the array itself is left as it was."""
    data = [np.full(6, i + 1, np.float32) for i in range(4)]
    out = ray_tpu_torch.get(
        [w.allreduce_read_only.remote(d) for w, d in zip(world4, data)])
    for (reduced, left), d in zip(out, data):
        np.testing.assert_array_equal(reduced, np.full(6, 10.0, np.float32))
        np.testing.assert_array_equal(left, d)


def test_allgather(world4):
    out = ray_tpu_torch.get(
        [w.allgather.remote(np.full(3, i, np.float32))
         for i, w in enumerate(world4)]
    )
    for gathered in out:
        assert len(gathered) == 4
        for i, g in enumerate(gathered):
            np.testing.assert_array_equal(g, np.full(3, i, np.float32))


def test_broadcast(world4):
    payload = np.arange(6, dtype=np.float32)
    out = ray_tpu_torch.get(
        [w.broadcast.remote(payload if i == 1 else np.zeros(6), 1)
         for i, w in enumerate(world4)]
    )
    for o in out:
        np.testing.assert_array_equal(o, payload)


def test_reducescatter(world4):
    data = np.arange(8, dtype=np.float32)
    out = ray_tpu_torch.get([w.reducescatter.remote(data) for w in world4])
    full = data * 4
    got = np.concatenate([out[(r + 1) % 4] for r in range(4)])
    # every element of the reduced vector appears exactly once across ranks
    np.testing.assert_array_equal(np.sort(got), np.sort(full))


def test_send_recv(world4):
    res = ray_tpu_torch.get([world4[0].p2p.remote(1), world4[1].p2p.remote(1)])
    np.testing.assert_array_equal(res[1], np.arange(5, dtype=np.int64) * 7)


def test_barrier(world4):
    assert all(ray_tpu_torch.get([w.barrier.remote() for w in world4]))


def test_create_collective_group_declarative(world4):
    workers = [Worker.remote() for _ in range(2)]
    col.create_collective_group(workers, 2, [0, 1], group_name="g2")
    out = ray_tpu_torch.get(
        [w.allreduce.remote(np.ones(4), "g2") for w in workers]
    )
    for o in out:
        np.testing.assert_array_equal(o, np.full(4, 2.0, np.float32))
    ray_tpu_torch.get([w.destroy.remote("g2") for w in workers])
