"""What every model family of the port shares with its flax original: the
parameter tree's naming, flax's default initialisers, and carrying the JAX
package's parameters and Adam state across.

Module names follow the flax tree: ``h_{i}/attn/c_attn/kernel`` is
``h.{i}.attn.c_attn.weight``. A flax dense ``kernel`` is (in, out) and is
transposed into ``nn.Linear.weight``; ``scale``, ``embedding`` and the
RMSNorm ``weight`` map by name; a raw array parameter (the MoE experts'
``wi``/``wo``) keeps its name and layout.

On a mesh each rank's module holds its tp shard of a parameter
(:func:`tp_layout`: the rows of one dimension it holds, which for GPT-2's
fused ``c_attn`` are this rank's heads of each of q, k and v, not one
block), and FSDP2 holds its fsdp shard of that as a DTensor. Loading
slices the whole tensor both ways on each rank, with no communication;
:func:`full_state` gathers it back.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's lecun_normal: truncated normal on [-2, 2] std units, rescaled so
    # the result has variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def flax_init_(model: nn.Module, embed_std: float,
               generator: Optional[torch.Generator]) -> nn.Module:
    """Fill ``model`` (on the CPU) with flax's default initialisers: embedding
    tables normal with std ``embed_std``; dense kernels lecun-normal over
    their input width; a 3-D expert stack (E, in, out) lecun-normal over
    E * in, as flax counts the leading axis into the fan-in; biases 0; norm
    scales 1. Values are drawn in fp32 from ``generator`` (default: seed 0),
    so one seed gives the same weights on every device; the numbers differ
    from JAX's, whose generator differs."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32)
            if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.Embedding):
                w.normal_(0.0, embed_std, generator=gen)
            elif name.endswith("bias"):
                w.zero_()
            elif w.dim() == 1:
                w.fill_(1.0)  # LayerNorm / RMSNorm scale
            elif w.dim() == 2:
                _lecun_normal_(w, w.shape[1], gen)
            else:
                _lecun_normal_(w, w.shape[0] * w.shape[1], gen)
            p.copy_(w)
    return model


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def _torch_name(flax_path: str) -> str:
    parts = flax_path.split("/")
    if parts[0].startswith("h_"):
        parts = ["h", parts[0][2:]] + parts[1:]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    parts[-1] = leaf.get(parts[-1], parts[-1])
    return ".".join(parts)


def _holder(model: nn.Module, name: str):
    """(the module holding parameter ``name``, its path, the leaf name)."""
    module_name, _, leaf = name.rpartition(".")
    return model.get_submodule(module_name), module_name, leaf


def flax_path(model: nn.Module, name: str) -> str:
    """The flax path of parameter ``name`` (the inverse of ``_torch_name``):
    ``h.3.attn.c_attn.weight`` is ``h_3/attn/c_attn/kernel``."""
    module, module_name, leaf = _holder(model, name)
    if leaf == "weight":
        for cls, flax_leaf in ((nn.Embedding, "embedding"), (nn.Linear, "kernel"),
                               (nn.LayerNorm, "scale")):
            if isinstance(module, cls):
                leaf = flax_leaf
    parts = module_name.split(".") if module_name else []
    if parts and parts[0] == "h":
        parts = [f"h_{parts[1]}"] + parts[2:]
    return "/".join(parts + [leaf])


def tp_layout(model: nn.Module, name: str):
    """The ``TPLayout`` of parameter ``name``, from the layer that holds it;
    None where every tp rank holds it whole (norms, ``wpe``, the bias of a
    row-parallel layer, every parameter without tp)."""
    module, _, leaf = _holder(model, name)
    layout = getattr(module, "tp_layout", None)
    if layout is None or (leaf == "bias" and layout.dim != 0):
        return None
    return layout


def full_shape(model: nn.Module, name: str, p: torch.Tensor):
    """The whole shape of parameter ``name`` of which ``p`` is a tp shard."""
    shape = list(p.shape)
    layout = tp_layout(model, name)
    if layout is not None:
        shape[layout.dim] = layout.full
    return tuple(shape)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP2 DTensor; any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_like(model: nn.Module, name: str, full: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
    """The whole tensor ``full`` of parameter ``name`` held as ``like`` (the
    parameter or a moment of it) is held on this rank: its tp rows, on
    ``like``'s device, and for an FSDP2 DTensor its fsdp shard (a DTensor
    with ``like``'s placement). No communication."""
    layout = tp_layout(model, name)
    if layout is not None:
        full = full.index_select(layout.dim, layout.index)
    full = full.to(like.device)
    if isinstance(like, DTensor):
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full


def gather_full(model: nn.Module, name: str, t: torch.Tensor, tp) -> torch.Tensor:
    """The whole fp32 tensor of parameter ``name`` from every rank's shard
    ``t`` (the parameter or a moment of it), on every rank, on the CPU:
    FSDP2's all-gather over fsdp, then a sum over tp of each owner's rows
    written into zeros. A collective: every rank calls it."""
    t = t.full_tensor() if isinstance(t, DTensor) else t
    t = t.detach().float()
    layout = tp_layout(model, name)
    if layout is None:
        return t.cpu()
    shape = list(t.shape)
    shape[layout.dim] = layout.full
    full = t.new_zeros(shape)
    if layout.owner:
        full.index_copy_(layout.dim, layout.index.to(t.device), t)
    dist.all_reduce(full, group=tp.group)
    return full.cpu()


def flax_tensors(model: nn.Module, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax tree ``tree`` (nested dicts of arrays, laid out like the
    parameters) as fp32 CPU tensors keyed by ``model``'s parameter names,
    dense kernels transposed; on a mesh, the whole tensors. Unknown or
    missing keys, and shapes that do not match, raise ``ValueError``."""
    flat = _flatten(tree)
    targets = {name: full_shape(model, name, p) for name, p in model.named_parameters()}
    by_name = {_torch_name(path): path for path in flat}
    unknown = sorted(by_name[n] for n in set(by_name) - set(targets))
    missing = sorted(set(targets) - set(by_name))
    if unknown or missing:
        raise ValueError(f"flax params do not fit the module: unknown "
                         f"{unknown}, missing {missing}")
    out = {}
    for name, path in by_name.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if path.endswith("kernel"):
            arr = arr.T
        if tuple(arr.shape) != targets[name]:
            raise ValueError(f"{path}: shape {arr.shape} does not fit "
                             f"{name} {targets[name]}")
        out[name] = torch.tensor(arr)
    return out


def load_full(model: nn.Module, values: Dict[str, torch.Tensor]) -> nn.Module:
    """Fill ``model`` from whole fp32 tensors keyed by parameter name, each
    rank of a mesh model taking its own shard."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            local_tensor(p).copy_(local_tensor(shard_like(model, name, values[name], p)))
    return model


def load_flax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Fill ``model`` from the JAX package's parameter tree, given as nested
    dicts of numpy arrays; a mesh model (a ``TrainStep``'s ``new_model()``)
    takes this rank's shard of each. Unknown or missing keys, and shapes
    that do not match, raise ``ValueError``."""
    return load_full(model, flax_tensors(model, params))


def _adam_state(opt_state):
    """The optax ``ScaleByAdamState`` (count, mu, nu) inside a chain's
    nested state tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def load_flax_state(ts, state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX ``TrainStep`` state (``params``, the optax chain's state with
    Adam's ``count``/``mu``/``nu``, and ``step``, as numpy leaves, e.g.
    ``jax.tree.map(np.asarray, state)``) as the state of the port's
    :class:`~ray_tpu_torch.parallel.train_step.TrainStep` ``ts``, on its
    device, for whichever family ``ts`` trains. Training continues from it
    where the JAX run stopped. On a mesh ``TrainStep`` each rank keeps its
    own shard of every parameter and of ``mu`` and ``nu``."""
    model = load_flax_params(ts.new_model(), state["params"])
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    params = dict(model.named_parameters())
    moments = {key: {name: shard_like(model, name, t, params[name]) for name, t in
                     flax_tensors(model, getattr(adam, key)).items()}
               for key in ("mu", "nu")}
    return {"params": model,
            "opt_state": {"count": int(np.asarray(adam.count)), **moments},
            "step": int(np.asarray(state["step"]))}


def full_state(ts, state: Dict[str, Any]) -> Dict[str, Any]:
    """A mesh ``TrainStep`` state gathered whole, as the JAX state's global
    arrays are: ``{"params", "mu", "nu"}`` each ``{flax path: fp32 CPU
    tensor}`` in flax's layout (kernels (in, out)), with ``count`` and
    ``step``. A collective: every rank calls it, and every rank gets it."""
    model = state["params"]
    opt = state["opt_state"]
    out = {"params": {}, "mu": {}, "nu": {},
           "count": opt["count"], "step": state["step"]}
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        for key, t in (("params", p), ("mu", opt["mu"][name]), ("nu", opt["nu"][name])):
            full = gather_full(model, name, t, ts.tp)
            out[key][path] = full.T if path.endswith("kernel") else full
    return out
