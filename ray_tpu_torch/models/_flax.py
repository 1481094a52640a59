"""What every model family of the port shares with its flax original: the
parameter tree's naming, flax's default initialisers, and carrying the JAX
package's parameters and Adam state across.

Module names follow the flax tree: ``h_{i}/attn/c_attn/kernel`` is
``h.{i}.attn.c_attn.weight``. A flax dense ``kernel`` is (in, out) and is
transposed into ``nn.Linear.weight``; ``scale``, ``embedding`` and the
RMSNorm ``weight`` map by name; a raw array parameter (the MoE experts'
``wi``/``wo``) keeps its name and layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


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


def flax_tensors(model: nn.Module, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax tree ``tree`` (nested dicts of arrays, laid out like the
    parameters) as fp32 CPU tensors keyed by ``model``'s parameter names,
    dense kernels transposed. Unknown or missing keys, and shapes that do
    not match, raise ``ValueError``."""
    flat = _flatten(tree)
    targets = dict(model.named_parameters())
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
        if tuple(arr.shape) != tuple(targets[name].shape):
            raise ValueError(f"{path}: shape {arr.shape} does not fit "
                             f"{name} {tuple(targets[name].shape)}")
        out[name] = torch.tensor(arr)
    return out


def load_flax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Fill ``model`` from the JAX package's parameter tree, given as nested
    dicts of numpy arrays. Unknown or missing keys, and shapes that do not
    match, raise ``ValueError``."""
    values = flax_tensors(model, params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(values[name])
    return model


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
    where the JAX run stopped."""
    model = load_flax_params(ts.new_model(), state["params"])
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    moments = {key: {name: t.to(ts.device) for name, t in
                     flax_tensors(model, getattr(adam, key)).items()}
               for key in ("mu", "nu")}
    return {"params": model,
            "opt_state": {"count": int(np.asarray(adam.count)), **moments},
            "step": int(np.asarray(state["step"]))}
