"""ray_tpu_torch.parallel.mesh and _collectives against ray_tpu.parallel.mesh.

Eight gloo ranks (spawned once for the module, ``_torch_ranks``) build the
port's meshes: ``make_mesh``'s size rules, error messages and rank layout
are held against the JAX ``make_mesh`` on the 8 virtual CPU devices (rank r
is device r), ``filter_spec_for_mesh`` and ``batch_sharding`` against the
JAX functions on every mesh of the JAX package's train-step tests, and
``local_slice_info`` against the JAX keys. The collectives' forward and
backward are checked on the ranks. In this process: every parameter's spec
in the port's rules is the JAX spec of its flax path (transposed for a
dense kernel), ``flax_path`` inverts the flax-to-port naming, and a rank
that hangs fails its test within the pool's deadline with its stack.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import Ranks
from ray_tpu_torch.models import _flax
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import gpt2_moe as tgmoe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel.mesh import P, filter_spec_for_mesh

AXIS_DICTS = [{"dp": 8}, {"dp": -1}, {"dp": 2, "fsdp": -1, "tp": 2}, {"sp": 4, "dp": 2},
              {"tp": 2, "dp": 2, "sp": 2}, {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1},
              {"dp": 2, "tp": 2}, {"dp": 16}]
MESHES = [{"dp": 8}, {"fsdp": 8}, {"dp": 2, "fsdp": 4}, {"tp": 8}, {"dp": 2, "tp": 4},
          {"sp": 8}, {"dp": 2, "sp": 4}, {"dp": 2, "fsdp": 2, "tp": 2},
          {"dp": 2, "sp": 2, "tp": 2}, {"tp": 4, "dp": 2}, {"sp": 4, "dp": 2},
          {"fsdp": 4, "tp": 2}]
SPECS = sorted({tuple(spec) for _, spec in tgpt2.GPT2_SHARDING_PATTERNS
                + tllama.LLAMA_SHARDING_PATTERNS}, key=repr) + [
    (("dp", "fsdp"), "sp"), (("dp", "tp"), None, "fsdp"), ("ep", "tp")]
BATCH = (8, 64)


def _mesh_body(rank, world):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import _collectives as col
    from ray_tpu_torch.parallel.mesh import (
        axis_group,
        batch_sharding,
        local_slice_info,
        make_mesh,
    )

    made = {}
    for i, axes in enumerate(AXIS_DICTS):
        try:
            mesh = make_mesh(axes, device="cpu")
            made[i] = ("ok", mesh.mesh_dim_names, tuple(mesh.mesh.shape),
                       mesh.mesh.tolist())
        except ValueError as exc:
            made[i] = ("error", str(exc))
    yield "make_mesh", made

    for axes in MESHES:
        mesh = make_mesh(axes, device="cpu")
        yield repr(axes), {
            "filtered": [tuple(filter_spec_for_mesh(P(*s), mesh)) for s in SPECS],
            "batch": batch_sharding(mesh, BATCH)}
    yield "info", local_slice_info()

    # ppermute on a ring of 8 (shift 1 and 3) and its gradient; the tp pair
    # on a tp axis of 4
    ring = make_mesh({"sp": 8}, device="cpu")
    out = {}
    for shift in (1, 3):
        x = torch.tensor([float(rank)], requires_grad=True)
        y = col.ppermute(x, axis_group(ring, "sp"), shift)
        (y * (rank + 1)).sum().backward()
        out[shift] = (y.item(), x.grad.item())
    mesh = make_mesh({"dp": 2, "tp": 4}, device="cpu")
    tp = col.TPGroup(mesh.get_group("tp"), 4, mesh.get_local_rank("tp"))
    x = torch.tensor([float(rank)], requires_grad=True)
    (col.copy_to_tp(x, tp) * (rank + 1)).sum().backward()
    copy_grad = x.grad.item()
    x = torch.tensor([float(rank)], requires_grad=True)
    y = col.reduce_from_tp(x, tp)
    (y * (rank + 1)).sum().backward()
    mean = col.all_reduce_mean(torch.tensor([float(rank)])).item()
    yield "collectives", {"ppermute": out, "copy_grad": copy_grad,
                          "reduce": (y.item(), x.grad.item()), "mean": mean,
                          "world": dist.get_world_size()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(_mesh_body, 8, tmp_path_factory.mktemp("mesh_ranks"))
    yield pool
    pool.close()


def _jax_mesh(axes):
    from ray_tpu.parallel.mesh import make_mesh

    return make_mesh(axes)


def test_make_mesh_rules_and_messages_match_jax(ranks):
    made = ranks.get("make_mesh")
    for i, axes in enumerate(AXIS_DICTS):
        try:
            mesh = _jax_mesh(axes)
        except ValueError as exc:
            assert made[i] == ("error", str(exc)), axes
            continue
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        assert made[i] == ("ok", tuple(mesh.axis_names), ids.shape, ids.tolist()), axes


@pytest.mark.parametrize("axes", MESHES, ids=[repr(m) for m in MESHES])
def test_filter_spec_and_batch_sharding_match_jax(ranks, axes):
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.parallel.mesh import batch_sharding as jbatch
    from ray_tpu.parallel.mesh import filter_spec_for_mesh as jfilter

    mesh = _jax_mesh(axes)
    want = [tuple(jfilter(JP(*s), mesh)) for s in SPECS]
    index_of = jbatch(mesh).devices_indices_map(BATCH)
    for rank in range(8):
        got = ranks.get(repr(axes), rank)
        assert got["filtered"] == want
        device = next(d for d in index_of if d.id == rank)
        rows, cols = (s.indices(n) for s, n in zip(index_of[device], BATCH))
        assert (got["batch"][0].indices(8), got["batch"][1].indices(64)) == (rows, cols)


def test_local_slice_info_has_the_jax_keys(ranks):
    from ray_tpu.parallel.mesh import local_slice_info as jinfo

    for rank in range(8):
        info = ranks.get("info", rank)
        assert set(info) == set(jinfo())
        assert (info["process_index"], info["process_count"], info["num_devices"]) \
            == (rank, 8, 8)


def test_collectives_forward_and_backward(ranks):
    for rank in range(8):
        got = ranks.get("collectives", rank)
        for shift, (y, grad) in got["ppermute"].items():
            # y comes from rank - shift; x's gradient is the weight of the
            # rank it went to, rank + shift
            assert y == (rank - shift) % 8 and grad == (rank + shift) % 8 + 1
        tp_ranks = range(rank // 4 * 4, rank // 4 * 4 + 4)
        assert got["copy_grad"] == sum(r + 1 for r in tp_ranks)
        assert got["reduce"] == (sum(tp_ranks), rank + 1)
        assert got["mean"] == 3.5 and got["world"] == 8


def _families():
    """(port module, port rules, the JAX parameter tree's shapes, JAX rules)
    of each family."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2_moe as jgmoe
    from ray_tpu.models import llama as jllama
    from ray_tpu.models.gpt2 import GPT2_SHARDING_RULES, GPT2Config, init_params

    return [
        (tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu"), tgpt2.GPT2_SHARDING_RULES,
         jax.eval_shape(lambda: init_params(GPT2Config.tiny(dtype=jnp.float32))),
         GPT2_SHARDING_RULES),
        (tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu"),
         tllama.LLAMA_SHARDING_RULES,
         jax.eval_shape(lambda: jllama.init_params(jllama.LlamaConfig.tiny(
             dtype=jnp.float32))),
         jllama.LLAMA_SHARDING_RULES),
        (tgmoe.GPT2MoE(tgmoe.GPT2MoEConfig.tiny_moe(), device="cpu"), None,
         jax.eval_shape(lambda: jgmoe.init_params(jgmoe.GPT2MoEConfig.tiny_moe(
             dtype=jnp.float32))), None),
    ]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def test_every_parameter_has_the_jax_spec_transposed_and_its_flax_path():
    for model, rules, jparams, jrules in _families():
        flat = _flat(jparams)
        names = {_flax._torch_name(path): path for path in flat}
        assert set(names) == {n for n, _ in model.named_parameters()}
        specs = rules.tree_specs(model) if rules is not None else {}
        for name, p in model.named_parameters():
            path = names[name]
            assert _flax.flax_path(model, name) == path
            if rules is None:
                continue
            want = _padded(jrules.spec_for(path), p.ndim)
            if path.endswith("kernel"):
                want = want[::-1]
            assert _padded(specs[name], p.ndim) == want, name


def _hang_body(rank, world):
    import time

    yield "started", rank
    if rank == 1:
        time.sleep(600)
    torch.distributed.barrier()
    yield "never", rank


def test_a_hung_rank_fails_within_the_deadline(tmp_path):
    import time

    t0 = time.monotonic()
    pool = Ranks(_hang_body, 2, tmp_path, deadline_s=15.0)
    assert pool.get("started", 1) == 1
    with pytest.raises(AssertionError, match="rank 1 stacks") as info:
        pool.get("never", 0)
    assert time.monotonic() - t0 < 20.0
    assert "_hang_body" in str(info.value)
