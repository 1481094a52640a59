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
counterpart of ``nn.remat(LlamaBlock)``.

On a mesh the module is built with a tp group and holds this rank's shard,
Megatron's layout of ``LLAMA_SHARDING_PATTERNS``: column-parallel
``wq``/``wk``/``wv``/``gate``/``up`` and the vocab-parallel ``lm_head``,
row-parallel ``wo``/``down``, a vocab-parallel ``tok_emb``, RMSNorm weights
replicated. A rank holds whole query heads, and the KV heads they read:
where tp exceeds ``n_kv_head`` (a multiple of it), tp / n_kv_head ranks
hold the same KV head (``tp_copies``), and the step sums its gradients
over them. Where tp is a multiple of ``n_head``, GPT-2's ``head_split``
applies: tp / n_head ranks compute the same query head, and each feeds its
own C / tp of the head's output to ``wo``'s plain row split.
``repeat_kv`` then repeats only the local heads. RoPE takes global
positions through ``pos_offset``.
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
from ray_tpu_torch.models.gpt2 import (  # noqa: F401
    Dense,
    Embedding,
    head_split,
    loss_fn,
    num_params,
    vocab_parallel_loss,
)
from ray_tpu_torch.ops.attention import attention_for
from ray_tpu_torch.parallel._collectives import TPGroup, copy_to_tp, split_range
from ray_tpu_torch.parallel.mesh import P, ShardingRules


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
    # Override the attention primitive, e.g. ring attention bound to the sp
    # ranks. Signature (q, k, v) -> out, all (B, T, H, D) with H the heads
    # this rank holds.
    attn_fn: Any = None

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


def local_kv_heads(n_head: int, n_kv_head: int, tp: Optional[TPGroup]):
    """([first, stop) of the KV heads a tp rank holds, how many tp ranks
    hold each of them): a contiguous part where tp divides ``n_kv_head``;
    where tp is a multiple of it, the one KV head the rank's query heads
    (:func:`head_split`) read, held by tp / n_kv_head ranks."""
    if tp is None or n_kv_head % tp.size == 0:
        return split_range(n_kv_head, 1 if tp is None else tp.size,
                           0 if tp is None else tp.rank), 1
    if tp.size % n_kv_head:
        raise ValueError(f"{n_kv_head} KV heads do not split over tp = {tp.size}, "
                         f"nor does tp = {tp.size} repeat them evenly")
    copies = tp.size // n_kv_head
    first = head_split(n_head, tp)[0] // (n_head // n_kv_head)
    return (first, first + 1), copies


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.attention = attention_for(cfg)
        hd, dt, C = cfg.head_dim, cfg.dtype, cfg.n_embd
        first, stop, q_copies = head_split(cfg.n_head, tp)
        (kv_first, kv_stop), copies = local_kv_heads(cfg.n_head, cfg.n_kv_head, tp)
        self.n_head, self.n_kv_head = stop - first, kv_stop - kv_first
        q_rows = torch.arange(first * hd, stop * hd)
        kv_rows = torch.arange(kv_first * hd, kv_stop * hd)
        self.wq = Dense(C, cfg.n_head * hd, dt, device, bias=False, tp=tp, tp_dim=0,
                        tp_index=q_rows, tp_copies=q_copies)
        self.wk = Dense(C, cfg.n_kv_head * hd, dt, device, bias=False, tp=tp, tp_dim=0,
                        tp_index=kv_rows, tp_copies=copies)
        self.wv = Dense(C, cfg.n_kv_head * hd, dt, device, bias=False, tp=tp, tp_dim=0,
                        tp_index=kv_rows, tp_copies=copies)
        # a query head that several ranks compute: each takes its own
        # contiguous part of the head's output, as wo's plain row split has it
        self.out_cols = None
        if q_copies > 1:
            width = cfg.n_head * hd // tp.size
            start = (tp.rank % q_copies) * width
            self.out_cols = (start, start + width)
            q_rows = torch.arange(tp.rank * width, (tp.rank + 1) * width)
        self.wo = Dense(cfg.n_head * hd, C, dt, device, bias=False, tp=tp, tp_dim=1,
                        tp_index=q_rows)

    def qkv(self, x, positions):
        """(..., C) -> q (..., n_head, D) and k, v (..., n_kv_head, D), q and
        k rotated to integer ``positions``, which broadcast against x's
        leading axes: (T,) for a (B, T, C) forward, one per row while
        serving."""
        hd = self.cfg.head_dim
        ang = rope_angles(hd, self.cfg.rope_theta, positions)
        x = copy_to_tp(x, self.tp)
        q = apply_rope(self.wq(x).unflatten(-1, (self.n_head, hd)), ang)
        k = apply_rope(self.wk(x).unflatten(-1, (self.n_kv_head, hd)), ang)
        v = self.wv(x).unflatten(-1, (self.n_kv_head, hd))
        return q, k, v

    def forward(self, x, pos_offset: int = 0):
        B, T, _ = x.shape
        q, k, v = self.qkv(x, torch.arange(T, device=x.device) + pos_offset)
        rep = self.n_head // self.n_kv_head
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
        y = self.attention(q, k, v).reshape(B, T, self.n_head * self.cfg.head_dim)
        if self.out_cols is not None:
            y = y[..., self.out_cols[0]:self.out_cols[1]]
        return self.wo(y)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        dt = cfg.dtype
        self.tp = tp
        self.gate = Dense(cfg.n_embd, cfg.mlp_dim, dt, device, bias=False, tp=tp, tp_dim=0)
        self.up = Dense(cfg.n_embd, cfg.mlp_dim, dt, device, bias=False, tp=tp, tp_dim=0)
        self.down = Dense(cfg.mlp_dim, cfg.n_embd, dt, device, bias=False, tp=tp, tp_dim=1)

    def forward(self, x):
        x = copy_to_tp(x, self.tp)
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.n_embd, cfg.rms_eps, device)
        self.attn = LlamaAttention(cfg, device, tp)
        self.mlp_norm = RMSNorm(cfg.n_embd, cfg.rms_eps, device)
        self.mlp = LlamaMLP(cfg, device, tp)

    def forward(self, x, pos_offset: int = 0):
        x = x + self.attn(self.attn_norm(x), pos_offset)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Llama on ``device`` (default CUDA); with ``tp``, this tp rank's shard
    of it. Its weights start at torch's default initialisation;
    :func:`init_params` gives flax's instead and :func:`load_flax_params`
    loads the JAX package's."""

    def __init__(self, config: LlamaConfig, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        self.config = config
        self.tp = tp
        dev = resolve_device(device)
        self.tok_emb = Embedding(config.vocab_size, config.n_embd, config.dtype, dev,
                                 tp=tp)
        self.h = nn.ModuleList(LlamaBlock(config, dev, tp) for _ in range(config.n_layer))
        self.final_norm = RMSNorm(config.n_embd, config.rms_eps, dev)
        self.lm_head = Dense(config.n_embd, config.vocab_size, torch.float32, dev,
                             bias=False, tp=tp, tp_dim=0)

    @property
    def vocab_start(self) -> int:
        """The first vocabulary id of this rank's logits."""
        return self.tok_emb.vocab_start

    def head(self, x):
        """Final norm + untied head in fp32: (..., C) -> (..., vocab) fp32
        (this rank's vocabulary slice under tp)."""
        return self.lm_head(copy_to_tp(self.final_norm(x).float(), self.tp))

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


# Megatron-style TP layout + fsdp on the complementary dim: the JAX
# package's LLAMA_SHARDING_PATTERNS in the port's names and (out, in)
# layouts.
LLAMA_SHARDING_PATTERNS = [
    (r"tok_emb\.weight", P("tp", "fsdp")),
    (r"attn\.w[qkv]\.weight", P("tp", "fsdp")),   # column parallel
    (r"attn\.wo\.weight", P("fsdp", "tp")),       # row parallel
    (r"mlp\.(gate|up)\.weight", P("tp", "fsdp")),
    (r"mlp\.down\.weight", P("fsdp", "tp")),
    (r"lm_head\.weight", P("tp", "fsdp")),
    (r"norm", P()),
]
LLAMA_SHARDING_RULES = ShardingRules(LLAMA_SHARDING_PATTERNS, default=P())
