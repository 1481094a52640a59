"""GPT-2 as a PyTorch module, the port of ``ray_tpu/models/gpt2.py``.

Submodule names follow the flax parameter tree (``wte``, ``wpe``,
``h.{i}.ln_1``, ``h.{i}.attn.c_attn``, ``h.{i}.attn.c_proj``, ``h.{i}.ln_2``,
``h.{i}.mlp.c_fc``, ``h.{i}.mlp.c_proj``, ``ln_f``) so that
:func:`load_flax_params` can carry the JAX package's weights across, and the
arithmetic follows flax's: LayerNorm with eps 1e-6 (flax's value, not
torch's 1e-5), tanh-gelu, learned positions, and a weight-tied head.
Attention goes through ``ops.attention.causal_attention``, which is the
hand-written flash kernel on a CUDA tensor and is differentiable.

Precision follows flax's rule: parameters are always fp32 (the optimizer's
master weights) and ``config.dtype`` is the compute type only. Each
submodule casts at its own call, as flax's ``promote_dtype`` does: a dense
layer casts its input, weight and bias to ``dtype``; LayerNorm takes its
statistics in fp32 with fp32 scale and bias, then casts to ``dtype``;
embedding rows are cast to ``dtype``; the tied head (``Embed.attend``)
computes in ``dtype``. So a bf16 config gives bf16 logits, as JAX's does,
and its gradients land on fp32 parameters.

Each block is checkpointed while grad is enabled (``config.remat``), the
counterpart of ``nn.remat(Block)``: its activations are recomputed in the
backward pass, so the attention forward kernel runs twice per block per
training step. Serving under ``torch.inference_mode`` never checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import _flax
from ray_tpu_torch.models._flax import flax_init_
from ray_tpu_torch.models._flax import flax_tensors as _flax_tensors  # noqa: F401
from ray_tpu_torch.ops.attention import causal_attention

LAYERNORM_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dtype: torch.dtype = torch.bfloat16   # compute type; params stay fp32
    remat: bool = True                     # checkpoint each block under grad

    @classmethod
    def gpt2_124m(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=512, block_size=128, n_layer=2, n_head=4, n_embd=128)
        base.update(kw)
        return cls(**base)


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``
    (flax ``Dense``: input, kernel and bias promoted to ``dtype``)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device=None,
                 bias: bool = True):
        super().__init__(n_in, n_out, bias=bias, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: fp32 statistics, fp32 scale and bias, the result
    cast to ``dtype``."""

    def __init__(self, n: int, dtype: torch.dtype, device=None):
        super().__init__(n, eps=LAYERNORM_EPS, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Embedding(nn.Embedding):
    """flax ``Embed``: an fp32 table whose rows are cast to ``dtype``;
    :meth:`attend` is the tied head, computed in ``dtype``."""

    def __init__(self, n: int, dim: int, dtype: torch.dtype, device=None):
        super().__init__(n, dim, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, idx):
        return super().forward(idx).to(self.compute_dtype)

    def attend(self, x):
        dt = self.compute_dtype
        return x.to(dt) @ self.weight.to(dt).T


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.n_head = cfg.n_head
        self.c_attn = Dense(cfg.n_embd, 3 * cfg.n_embd, cfg.dtype, device)
        self.c_proj = Dense(cfg.n_embd, cfg.n_embd, cfg.dtype, device)

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
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.c_fc = Dense(cfg.n_embd, 4 * cfg.n_embd, cfg.dtype, device)
        self.c_proj = Dense(4 * cfg.n_embd, cfg.n_embd, cfg.dtype, device)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

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
        dev = resolve_device(device)
        dt = config.dtype
        self.wte = Embedding(config.vocab_size, config.n_embd, dt, dev)
        self.wpe = Embedding(config.block_size, config.n_embd, dt, dev)
        self.h = nn.ModuleList(self._block(i, dev) for i in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd, dt, dev)

    def _block(self, i: int, device) -> nn.Module:
        """Block ``i`` (the hook ``GPT2MoE`` overrides for its MoE blocks)."""
        return Block(self.config, device)

    def head(self, x):
        """Final norm + weight-tied head in ``dtype``: (..., C) -> (..., vocab)."""
        return self.wte.attend(self.ln_f(x))

    def forward(self, idx):
        B, T = idx.shape
        pos = torch.arange(T, device=idx.device)
        x = self.wte(idx) + self.wpe(pos)[None]
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.h:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.head(x)


def forward(config: GPT2Config, model: GPT2, idx):
    """Logits (B, T, vocab) in ``config.dtype`` for token ids ``idx`` (B, T)."""
    del config  # kept for the JAX package's signature; the module has it
    return model(idx)


def loss_fn(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def init_params(config: GPT2Config, generator: Optional[torch.Generator] = None,
                device=None) -> GPT2:
    """A :class:`GPT2` with flax's default initialisers: dense kernels
    lecun-normal, biases 0, LayerNorm scale 1 and bias 0, embeddings normal
    with variance 1/n_embd. The values are drawn in fp32 on the CPU from
    ``generator`` (default: seed 0), so one seed gives the same weights on
    every device; the numbers differ from JAX's, whose generator differs."""
    dev = resolve_device(device)
    model = GPT2(config, device="cpu")
    flax_init_(model, 1.0 / math.sqrt(config.n_embd), generator)
    return model.to(dev)


def load_flax_params(model: GPT2, params: Dict[str, Any]) -> GPT2:
    """Fill ``model`` from the JAX package's parameter tree, given as nested
    dicts of numpy arrays (``h_{i}/attn/c_attn/kernel`` ...). Dense kernels
    are (in, out) and are transposed into ``nn.Linear.weight``; LayerNorm
    ``scale``/``bias`` and embedding tables map by name. Unknown or missing
    keys, and shapes that do not match, raise ``ValueError``."""
    return _flax.load_flax_params(model, params)


load_flax_state = _flax.load_flax_state
