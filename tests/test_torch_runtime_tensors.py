"""Torch tensors through the port's object store, on a cluster of its
runtime: CPU tensors in fp32, bf16 and int64, contiguous or not, through
``put`` / ``get`` and through task arguments and returns, each bitwise
equal, small ones inline and large ones by way of plasma, out of band; the
tensor ``get`` returns owns its memory.
"""

import pytest
import torch

import ray_tpu_torch
from _torch_runtime import port_env


def _tensor(kind, numel):
    """A seeded CPU tensor of ``numel`` elements: fp32, bf16 or int64,
    contiguous or a non-contiguous view (a transpose)."""
    gen = torch.Generator().manual_seed(numel)
    dtype, layout = kind.split("-")
    if dtype == "int64":
        t = torch.randint(-2**62, 2**62, (numel // 64, 64), generator=gen)
    else:
        t = torch.randn(numel // 64, 64, generator=gen).to(getattr(torch, dtype))
    return t.t() if layout == "strided" else t


def _bitwise_equal(a, b):
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.dtype == b.dtype and a.shape == b.shape and b.device.type == "cpu"
            and torch.equal(a.contiguous().view(width[a.element_size()]),
                            b.contiguous().view(width[b.element_size()])))


@pytest.fixture(scope="module")
def tensor_cluster():
    """One cluster for the tensor tests: its workers import torch once
    (the fork server never does) and serve every case."""
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=4)
        yield
        ray_tpu_torch.shutdown()


_KINDS = ["float32-contiguous", "bfloat16-contiguous", "int64-contiguous",
          "float32-strided", "bfloat16-strided", "int64-strided"]


@pytest.mark.parametrize("kind", _KINDS)
def test_tensor_put_get_and_task_roundtrip_bitwise(tensor_cluster, kind):
    """Small (inline, in the owner's memory store) and large (plasma)
    tensors, through put/get, as a task argument and as a task return."""
    @ray_tpu_torch.remote
    def echo_t(t):
        assert isinstance(t, torch.Tensor)
        return t

    @ray_tpu_torch.remote
    def make(kind, numel):
        return _tensor(kind, numel)

    for numel in (64 * 16, 64 * 8192):       # 4-8 KiB inline; 2-4 MiB plasma
        t = _tensor(kind, numel)
        assert _bitwise_equal(t, ray_tpu_torch.get(ray_tpu_torch.put(t)))
        assert _bitwise_equal(t, ray_tpu_torch.get(echo_t.remote(t)))
        assert _bitwise_equal(t, ray_tpu_torch.get(make.remote(kind, numel)))


def test_large_tensor_rides_plasma_out_of_band(tensor_cluster):
    """A large tensor's bytes go to plasma as one out-of-band buffer (not
    torch's in-band storage pickling), and the tensor that comes back owns
    writable memory of its own."""
    from ray_tpu_torch._private import serialization, worker as worker_mod

    t = _tensor("bfloat16-contiguous", 64 * 8192)
    p, bufs, _ = serialization.serialize(t)
    assert len(bufs) == 1 and memoryview(bufs[0]).nbytes == t.numel() * 2
    assert len(p) < 1024
    ref = ray_tpu_torch.put(t)
    w = worker_mod.global_worker
    assert w.plasma.contains(ref.object_id())
    got = ray_tpu_torch.get(ref)
    got.add_(1)                                     # writable, and a copy
    assert _bitwise_equal(t, ray_tpu_torch.get(ref))
