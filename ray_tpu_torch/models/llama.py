"""The Llama family as a PyTorch module, the port of ``ray_tpu/models/llama.py``.

RMSNorm, rotary position embeddings (rotate-half, fp32 math, shifted by
``pos_offset``), grouped-query attention, a SwiGLU MLP, an untied head, no
biases anywhere. Submodule names follow the flax parameter tree
(``tok_emb``, ``h.{i}.attn_norm``, ``h.{i}.attn.wq``/``wk``/``wv``/``wo``,
``h.{i}.mlp_norm``, ``h.{i}.mlp.gate``/``up``/``down``, ``final_norm``,
``lm_head``), so :func:`load_flax_params` carries the JAX package's weights
across.

Precision follows flax's, as in ``models/gpt2.py``: fp32 parameters, each
dense layer computing in ``config.dtype``; RMSNorm takes its statistic in
fp32, casts the normalised input back to the input's type and only then
multiplies by the weight in that type; the head runs in fp32 on an fp32
copy of the final norm's output, even under a bf16 config.

GQA: k and v are repeated from ``n_kv_head`` to ``n_head`` heads before
attention, head h reading kv head h // (n_head / n_kv_head), as the JAX
package's broadcast-reshape does. So the attention kernels (forward, dq and
dk/dv on the card) see k and v shaped like q, the contract they share with
the Pallas kernels.

Each block is checkpointed while grad is enabled (``config.remat``), the
counterpart of ``nn.remat(LlamaBlock)``. The tensor-parallel layout
(``LLAMA_SHARDING_PATTERNS``) waits for the port's mesh (ROADMAP Queue A
item 8).
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
from ray_tpu_torch.models.gpt2 import Dense, Embedding, loss_fn, num_params  # noqa: F401
from ray_tpu_torch.ops.attention import attention_for


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    block_size: int = 2048
    n_layer: int = 8
    n_head: int = 8
    n_kv_head: int = 4
    n_embd: int = 512
    intermediate: Optional[int] = None  # default: the 8/3 SwiGLU rule, rounded
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # compute type; params stay fp32
    use_flash_attention: bool = True       # else the einsum path
    remat: bool = True                     # checkpoint each block under grad

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def mlp_dim(self) -> int:
        if self.intermediate is not None:
            return self.intermediate
        # 2/3 * 4 * n_embd rounded up to a multiple of 128
        raw = int(8 * self.n_embd / 3)
        return (raw + 127) // 128 * 128

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=512, block_size=128, n_layer=2, n_head=4,
                    n_kv_head=2, n_embd=128)
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_160m(cls, **kw):
        base = dict(vocab_size=32000, block_size=1024, n_layer=12, n_head=12,
                    n_kv_head=4, n_embd=768)
        base.update(kw)
        return cls(**base)


def rms_norm(x, weight, eps: float):
    """The statistic in fp32, the normalised input cast back to ``x``'s type,
    then the multiply by ``weight`` (already in that type)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


class RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, device=device, dtype=torch.float32))

    def forward(self, x):
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


def rope_angles(head_dim: int, theta: float, positions):
    """Integer positions of any shape -> fp32 angles ``positions.shape +
    (head_dim // 2,)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    return positions.float()[..., None] * inv


def apply_rope(x, angles):
    """Rotate-half RoPE in fp32: ``x`` (..., T, H, D) with ``angles``
    (..., T, D/2) (leading axes broadcast), the result in ``x``'s type."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    cos = torch.cos(angles).unsqueeze(-2)
    sin = torch.sin(angles).unsqueeze(-2)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x, rep: int):
    """GQA: (..., n_kv_head, D) -> (..., n_kv_head * rep, D), head h reading
    kv head h // rep (the JAX package's broadcast-reshape, not a tiling)."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=-2)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attention = attention_for(cfg)
        hd, dt = cfg.head_dim, cfg.dtype
        self.wq = Dense(cfg.n_embd, cfg.n_head * hd, dt, device, bias=False)
        self.wk = Dense(cfg.n_embd, cfg.n_kv_head * hd, dt, device, bias=False)
        self.wv = Dense(cfg.n_embd, cfg.n_kv_head * hd, dt, device, bias=False)
        self.wo = Dense(cfg.n_head * hd, cfg.n_embd, dt, device, bias=False)

    def qkv(self, x, positions):
        """(..., C) -> q (..., n_head, D) and k, v (..., n_kv_head, D), q and
        k rotated to integer ``positions``, which broadcast against x's
        leading axes: (T,) for a (B, T, C) forward, one per row while
        serving."""
        cfg = self.cfg
        hd = cfg.head_dim
        ang = rope_angles(hd, cfg.rope_theta, positions)
        q = apply_rope(self.wq(x).unflatten(-1, (cfg.n_head, hd)), ang)
        k = apply_rope(self.wk(x).unflatten(-1, (cfg.n_kv_head, hd)), ang)
        v = self.wv(x).unflatten(-1, (cfg.n_kv_head, hd))
        return q, k, v

    def forward(self, x, pos_offset: int = 0):
        cfg = self.cfg
        B, T, C = x.shape
        q, k, v = self.qkv(x, torch.arange(T, device=x.device) + pos_offset)
        rep = cfg.n_head // cfg.n_kv_head
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
        y = self.attention(q, k, v)
        return self.wo(y.reshape(B, T, C))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        dt = cfg.dtype
        self.gate = Dense(cfg.n_embd, cfg.mlp_dim, dt, device, bias=False)
        self.up = Dense(cfg.n_embd, cfg.mlp_dim, dt, device, bias=False)
        self.down = Dense(cfg.mlp_dim, cfg.n_embd, dt, device, bias=False)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.n_embd, cfg.rms_eps, device)
        self.attn = LlamaAttention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.n_embd, cfg.rms_eps, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, pos_offset: int = 0):
        x = x + self.attn(self.attn_norm(x), pos_offset)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Llama on ``device`` (default CUDA). Its weights start at torch's
    default initialisation; :func:`init_params` gives flax's instead and
    :func:`load_flax_params` loads the JAX package's."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.tok_emb = Embedding(config.vocab_size, config.n_embd, config.dtype, dev)
        self.h = nn.ModuleList(LlamaBlock(config, dev) for _ in range(config.n_layer))
        self.final_norm = RMSNorm(config.n_embd, config.rms_eps, dev)
        self.lm_head = Dense(config.n_embd, config.vocab_size, torch.float32, dev,
                             bias=False)

    def head(self, x):
        """Final norm + untied head in fp32: (..., C) -> (..., vocab) fp32."""
        return self.lm_head(self.final_norm(x).float())

    def forward(self, idx, pos_offset: int = 0):
        x = self.tok_emb(idx)
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.h:
            x = (checkpoint(block, x, pos_offset, use_reentrant=False) if remat
                 else block(x, pos_offset))
        return self.head(x)


def forward(config: LlamaConfig, model: Llama, idx, pos_offset: int = 0):
    """Logits (B, T, vocab) fp32 for token ids ``idx`` (B, T) at positions
    ``pos_offset`` ... ``pos_offset + T``."""
    del config  # kept for the JAX package's signature; the module has it
    return model(idx, pos_offset)


def init_params(config: LlamaConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Llama:
    """A :class:`Llama` with flax's default initialisers (dense kernels
    lecun-normal, norm weights 1, the embedding normal with variance
    1/n_embd), drawn in fp32 on the CPU from ``generator`` (default: seed
    0)."""
    dev = resolve_device(device)
    model = Llama(config, device="cpu")
    _flax.flax_init_(model, 1.0 / math.sqrt(config.n_embd), generator)
    return model.to(dev)


def load_flax_params(model: Llama, params: Dict[str, Any]) -> Llama:
    """Fill ``model`` from the JAX package's parameter tree (nested dicts of
    numpy arrays: ``h_{i}/attn/wq/kernel``, ``h_{i}/attn_norm/weight`` ...).
    Unknown or missing keys, and shapes that do not match, raise
    ``ValueError``."""
    return _flax.load_flax_params(model, params)


load_flax_state = _flax.load_flax_state
