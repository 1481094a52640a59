"""GPT-2 as a PyTorch module, the port of ``ray_tpu/models/gpt2.py``.

Submodule names follow the flax parameter tree (``wte``, ``wpe``,
``h.{i}.ln_1``, ``h.{i}.attn.c_attn``, ``h.{i}.attn.c_proj``, ``h.{i}.ln_2``,
``h.{i}.mlp.c_fc``, ``h.{i}.mlp.c_proj``, ``ln_f``) so that
:func:`load_flax_params` can carry the JAX package's weights across, and the
arithmetic follows flax's: LayerNorm with eps 1e-6 (flax's value, not
torch's 1e-5), tanh-gelu, learned positions, and a weight-tied head computed
in fp32. Attention goes through ``ops.attention.causal_attention``, which
is the hand-written flash kernel on a CUDA tensor.

Parameters live in ``config.dtype`` on the model's device; the dense
layers, embeddings and norms compute in that type, the head in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import causal_attention

LAYERNORM_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def gpt2_124m(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=512, block_size=128, n_layer=2, n_head=4, n_embd=128)
        base.update(kw)
        return cls(**base)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.n_head = cfg.n_head
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, **factory)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, **factory)

    def qkv(self, x):
        """(..., C) -> q, k, v each (..., n_head, head_dim)."""
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        shape = x.shape[:-1] + (self.n_head, x.shape[-1] // self.n_head)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def forward(self, x):
        B, T, C = x.shape
        y = causal_attention(*self.qkv(x))
        return self.c_proj(y.reshape(B, T, C))


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **factory)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **factory)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=LAYERNORM_EPS, **factory)
        self.attn = CausalSelfAttention(cfg, **factory)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=LAYERNORM_EPS, **factory)
        self.mlp = MLP(cfg, **factory)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT2(nn.Module):
    """GPT-2 on ``device`` (default CUDA). Its weights start at torch's
    default initialisation; :func:`init_params` gives flax's instead and
    :func:`load_flax_params` loads the JAX package's."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        factory = dict(device=resolve_device(device), dtype=config.dtype)
        self.wte = nn.Embedding(config.vocab_size, config.n_embd, **factory)
        self.wpe = nn.Embedding(config.block_size, config.n_embd, **factory)
        self.h = nn.ModuleList(Block(config, **factory)
                               for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(config.n_embd, eps=LAYERNORM_EPS, **factory)

    def head(self, x):
        """Final norm + weight-tied head in fp32: (..., C) -> (..., vocab)."""
        return self.ln_f(x).float() @ self.wte.weight.float().T

    def forward(self, idx):
        B, T = idx.shape
        pos = torch.arange(T, device=idx.device)
        x = self.wte(idx) + self.wpe(pos)[None]
        for block in self.h:
            x = block(x)
        return self.head(x)


def forward(config: GPT2Config, model: GPT2, idx):
    """Logits (B, T, vocab) fp32 for token ids ``idx`` (B, T)."""
    del config  # kept for the JAX package's signature; the module has it
    return model(idx)


def loss_fn(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def num_params(model: GPT2) -> int:
    return sum(p.numel() for p in model.parameters())


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    # flax Dense default: truncated normal on [-2, 2] std units, rescaled so
    # the result has variance 1/fan_in (fan_in is nn.Linear's in_features)
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_params(config: GPT2Config, generator: Optional[torch.Generator] = None,
                device=None) -> GPT2:
    """A :class:`GPT2` with flax's default initialisers: dense kernels
    lecun-normal, biases 0, LayerNorm scale 1 and bias 0, embeddings normal
    with variance 1/n_embd. The values are drawn in fp32 on the CPU from
    ``generator`` (default: seed 0), so one seed gives the same weights on
    every device; the numbers differ from JAX's, whose generator differs."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = GPT2(config, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32)
            if isinstance(_owner(model, name), nn.Embedding):
                w.normal_(0.0, 1.0 / math.sqrt(config.n_embd), generator=gen)
            elif name.endswith("weight") and w.dim() == 2:
                _lecun_normal_(w, gen)
            elif name.endswith("weight"):
                w.fill_(1.0)  # LayerNorm scale
            else:
                w.zero_()
            p.copy_(w)
    return model.to(dev)


def _owner(model: nn.Module, param_name: str) -> nn.Module:
    return model.get_submodule(param_name.rsplit(".", 1)[0])


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


def load_flax_params(model: GPT2, params: Dict[str, Any]) -> GPT2:
    """Fill ``model`` from the JAX package's parameter tree, given as nested
    dicts of numpy arrays (``h_{i}/attn/c_attn/kernel`` ...). Dense kernels
    are (in, out) and are transposed into ``nn.Linear.weight``; LayerNorm
    ``scale``/``bias`` and embedding tables map by name. Unknown or missing
    keys, and shapes that do not match, raise ``ValueError``."""
    flat = _flatten(params)
    targets = dict(model.named_parameters())
    by_name = {_torch_name(path): path for path in flat}
    unknown = sorted(by_name[n] for n in set(by_name) - set(targets))
    missing = sorted(set(targets) - set(by_name))
    if unknown or missing:
        raise ValueError(f"flax params do not fit the module: unknown "
                         f"{unknown}, missing {missing}")
    with torch.no_grad():
        for name, path in by_name.items():
            arr = np.asarray(flat[path], dtype=np.float32)
            if path.endswith("kernel"):
                arr = arr.T
            p = targets[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {arr.shape} does not fit "
                                 f"{name} {tuple(p.shape)}")
            p.copy_(torch.tensor(arr))
    return model
