"""Device meshes and sharding rules: the port of ``ray_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over the slice's devices and
lets XLA place every array from its ``PartitionSpec``. The port runs one
process per device, as PyTorch does: a mesh is a ``DeviceMesh`` from
``init_device_mesh`` over the ranks of the default process group, one rank
per card (or, for the tests, per CPU process over gloo), and each rank
holds its own shard of every tensor. The axis conventions are the JAX
package's:

  dp    data parallel (batch rows)
  fsdp  parameter and optimizer sharding (ZeRO-3), also carries batch rows
  tp    Megatron tensor parallel over heads and hidden widths
  sp    sequence parallel (ring attention rides this axis)
  ep    expert parallel (MoE) and pp pipeline stages: not ported yet

A spec is the port's own :class:`PartitionSpec`, a tuple of axis names per
tensor dimension; the port never imports ``jax.sharding``. The sharding
rules are written in the port's parameter names and layouts (an
``nn.Linear`` weight is (out, in), the transpose of a flax kernel).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch._private.device import resolve_device

DATA_AXES = ("dp", "fsdp")


class PartitionSpec(tuple):
    """Axis names per tensor dimension: ``None`` (not sharded), a name, or a
    tuple of names (sharded over their product; a tuple of one name is that
    name). Trailing dimensions left out are not sharded, as in
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def make_mesh(axes: Dict[str, int], *, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` with the given axis sizes over every rank of the
    default process group (``-1`` once means "the rest"). Dict order is
    layout order: the last axis varies fastest over the ranks.

    With no process group yet, this process starts one of its own (world
    size 1: NCCL on the card, gloo with ``device="cpu"``), so that
    ``make_mesh({"dp": 1})`` works in one process as a one-chip mesh does in
    JAX. On the card each rank takes the card ``rank % device_count``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("only one axis may be -1")
    if unknown:
        known = math.prod(v for v in sizes.values() if v != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"mesh axes {sizes} need {total} devices, have {n}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def single_axis_mesh(name: str = "dp", device=None) -> DeviceMesh:
    """Every rank on one axis."""
    return make_mesh({name: -1}, device=device)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis ``name``; 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on axis ``name``; 0 where the mesh has none."""
    return mesh.get_local_rank(name) if name in (mesh.mesh_dim_names or ()) else 0


def axis_group(mesh: DeviceMesh, name: str):
    """The process group of this rank's axis ``name``; None where the axis
    is absent or of size 1 (a collective over it would be the identity)."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


class ShardingRules:
    """Map parameter-name regexes to specs; the first match wins. Names are
    the port's dotted ``named_parameters`` names, e.g.
    ``h.3.attn.c_attn.weight``."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]],
                 default: PartitionSpec = P()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]
        self._default = default

    def spec_for(self, path: str) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(path):
                return spec
        return self._default

    def tree_specs(self, model: torch.nn.Module) -> Dict[str, PartitionSpec]:
        """``{name: spec}`` for every parameter of ``model``."""
        return {name: self.spec_for(name) for name, _ in model.named_parameters()}


def filter_spec_for_mesh(spec: PartitionSpec, mesh: DeviceMesh) -> PartitionSpec:
    """Drop axis names the mesh does not have or has at size 1 (one rule
    set serves every mesh shape: tp rules are no-ops on a dp mesh)."""
    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if axis_size(mesh, e) > 1)
            return kept if kept else None
        return entry if axis_size(mesh, entry) > 1 else None

    return P(*(keep(e) for e in spec))


def spec_dim(spec: PartitionSpec, axis: str) -> Optional[int]:
    """The tensor dimension that ``spec`` shards over ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, (tuple, list)) and axis in entry):
            return dim
    return None


def _block(mesh: DeviceMesh, axes: Sequence[str], n: int) -> slice:
    """This rank's contiguous block of a length-``n`` dimension sharded over
    ``axes`` together (the first axis major), as a slice."""
    parts, index = 1, 0
    for a in axes:
        index = index * axis_size(mesh, a) + axis_index(mesh, a)
        parts *= axis_size(mesh, a)
    if n % parts:
        raise ValueError(f"a dimension of {n} does not split over {parts} "
                         f"ranks of {tuple(axes)}")
    step = n // parts
    return slice(index * step, (index + 1) * step)


def batch_sharding(mesh: DeviceMesh, shape: Sequence[int], *,
                   data_axes: Sequence[str] = DATA_AXES,
                   seq_axis: str = "sp") -> Tuple[slice, slice]:
    """The (rows, columns) of a global (B, T) batch that this rank holds:
    rows by its (dp, fsdp) coordinate, columns by its sp coordinate; the
    batch is replicated over every other axis (tp)."""
    return (_block(mesh, data_axes, shape[0]), _block(mesh, (seq_axis,), shape[1]))


def replicated(mesh: DeviceMesh) -> PartitionSpec:
    """The spec of a tensor every rank holds whole."""
    del mesh
    return P()


def local_slice_info() -> dict:
    """Where this process runs: its rank, the world size, the device."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    cuda = torch.cuda.is_available()
    return {
        "num_devices": world,
        "num_local_devices": 1,
        "process_index": rank,
        "process_count": world,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
    }


def data_parallel_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 2-D (replicate, fsdp) mesh that FSDP2 reduces gradients over, for
    this rank's tp coordinate. The JAX loss is the mean over the global
    batch, so every gradient is averaged over dp, fsdp and sp, while
    parameters are sharded over fsdp only: replicate is every axis but tp
    and fsdp. Built with the public ``DeviceMesh`` constructor over the
    same ranks regrouped as (tp, replicate, fsdp), then sliced, so every
    rank creates the same process groups in the same order."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    for a in ("tp", "fsdp"):
        if a not in names:
            ranks, names = ranks.unsqueeze(-1), names + [a]
    rest = [i for i, a in enumerate(names) if a not in ("tp", "fsdp")]
    order = [names.index("tp")] + rest + [names.index("fsdp")]
    tp, fsdp = ranks.size(names.index("tp")), ranks.size(names.index("fsdp"))
    grid = ranks.permute(order).reshape(tp, -1, fsdp)
    full = DeviceMesh(mesh.device_type, grid,
                      mesh_dim_names=("tp", "replicate", "fsdp"))
    return full["replicate", "fsdp"]
