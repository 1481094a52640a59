"""GPT-2 with Mixture-of-Experts FFN blocks, the port of
``ray_tpu/models/gpt2_moe.py``.

Every ``moe_every``-th block (block i with i % moe_every == moe_every - 1)
swaps its dense MLP for the top-k routed :class:`~ray_tpu_torch.ops.moe.MoE`;
everything else is the port's GPT-2 (fp32 parameters, compute in
``config.dtype``, attention through the flash kernels on the card, the
weight-tied head in ``dtype``). ``GPT2MoEConfig()`` is GPT-2-124M's widths
with 8 experts, top-2, capacity factor 1.25 and an MoE block every 2nd
layer.

The MoE blocks' aux losses are summed and returned beside the logits
(:func:`forward_with_aux`), where flax collects them from the
``losses`` collection. Blocks are checkpointed under ``config.remat`` as in
the port's GPT-2 (the flax model does not remat its MoE blocks; the
recompute gives the same numbers and keeps a training step's memory at
GPT-2's).

On a mesh (``parallel/train_step.py``) the module is built with this
rank's tp, ep and sp groups: GPT-2's Megatron layout for the attention,
the dense blocks, the embedding and the head, and each MoE layer's experts
split over ep and their hidden width over tp (``ops/moe.py``), routing over
the global sequence under sp. ``GPT2_MOE_SHARDING_RULES`` are the MoE
patterns, then GPT-2's, the MoE ones first as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import _flax
from ray_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2,
    GPT2_SHARDING_PATTERNS,
    Block,
    CausalSelfAttention,
    GPT2Config,
    LayerNorm,
    loss_fn,
    vocab_parallel_loss,
)
from ray_tpu_torch.ops.moe import MOE_SHARDING_PATTERNS, MoE, MoEConfig
from ray_tpu_torch.parallel._collectives import TPGroup
from ray_tpu_torch.parallel.mesh import P, ShardingRules


@dataclasses.dataclass(frozen=True)
class GPT2MoEConfig(GPT2Config):
    moe: MoEConfig = MoEConfig()
    moe_every: int = 2  # every Nth block is an MoE block (1 = all)

    @classmethod
    def tiny_moe(cls, **kw):
        base = dict(
            vocab_size=512, block_size=128, n_layer=2, n_head=4, n_embd=128,
            moe=MoEConfig(num_experts=4, top_k=2),
            moe_every=1,
        )
        base.update(kw)
        return cls(**base)

    def is_moe(self, i: int) -> bool:
        return i % self.moe_every == self.moe_every - 1


class MoEBlock(nn.Module):
    def __init__(self, cfg: GPT2MoEConfig, device=None, tp: Optional[TPGroup] = None,
                 ep: Optional[TPGroup] = None, sp: Optional[TPGroup] = None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device, tp)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.moe = MoE(cfg.n_embd, 4 * cfg.n_embd, cfg.moe, cfg.dtype, device,
                       tp=tp, ep=ep, sp=sp)

    def forward(self, x):
        """x -> (x, this block's aux loss)."""
        x = x + self.attn(self.ln_1(x))
        y, aux = self.moe(self.ln_2(x))
        return x + y, aux


class DenseBlock(Block):
    """GPT-2's block, giving no aux loss."""


class GPT2MoE(GPT2):
    """GPT-2-MoE on ``device`` (default CUDA); with ``tp``, ``ep`` and
    ``sp``, this rank's shard of it. ``forward`` gives the logits (this tp
    rank's vocabulary slice) and the summed aux loss."""

    config: GPT2MoEConfig

    def __init__(self, config: GPT2MoEConfig, device=None, tp: Optional[TPGroup] = None,
                 ep: Optional[TPGroup] = None, sp: Optional[TPGroup] = None):
        self.ep, self.sp = ep, sp   # read by _block while GPT2 builds the blocks
        super().__init__(config, device, tp)

    def _block(self, i: int, device) -> nn.Module:
        cfg = self.config
        if cfg.is_moe(i):
            return MoEBlock(cfg, device, self.tp, self.ep, self.sp)
        return DenseBlock(cfg, device, self.tp)

    def forward(self, idx, pos_offset: int = 0):
        B, T = idx.shape
        pos = torch.arange(T, device=idx.device) + pos_offset
        x = self.wte(idx) + self.wpe(pos)[None]
        remat = self.config.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=idx.device)
        for block in self.h:
            out = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if isinstance(block, MoEBlock):
                x, a = out
                aux = aux + a
            else:
                x = out
        return self.head(x), aux


def init_params(config: GPT2MoEConfig, generator: Optional[torch.Generator] = None,
                device=None) -> GPT2MoE:
    """A :class:`GPT2MoE` with flax's default initialisers (as
    ``gpt2.init_params``; the experts' (E, in, out) stacks lecun-normal over
    E * in, as flax counts them), drawn in fp32 on the CPU from
    ``generator`` (default: seed 0)."""
    dev = resolve_device(device)
    model = GPT2MoE(config, device="cpu")
    _flax.flax_init_(model, 1.0 / math.sqrt(config.n_embd), generator)
    return model.to(dev)


def forward_with_aux(config: GPT2MoEConfig, model: GPT2MoE, idx):
    """(logits (B, T, vocab) in ``config.dtype``, the summed MoE aux loss)."""
    del config  # kept for the JAX package's signature; the module has it
    return model(idx)


def moe_loss_fn(config: GPT2MoEConfig, model: GPT2MoE, idx, targets):
    logits, aux = forward_with_aux(config, model, idx)
    return loss_fn(logits, targets) + aux


def load_flax_params(model: GPT2MoE, params: Dict[str, Any]) -> GPT2MoE:
    """Fill ``model`` from the JAX package's parameter tree (GPT-2's names,
    plus ``h_{i}/moe/router/{kernel,bias}`` and the expert stacks
    ``h_{i}/moe/wi`` (E, C, F) and ``h_{i}/moe/wo`` (E, F, C), kept as they
    are). Unknown or missing keys, and shapes that do not match, raise
    ``ValueError``."""
    return _flax.load_flax_params(model, params)


load_flax_state = _flax.load_flax_state


# MoE rules first: they are more specific than the dense fallbacks.
GPT2_MOE_SHARDING_RULES = ShardingRules(
    MOE_SHARDING_PATTERNS + GPT2_SHARDING_PATTERNS, default=P())
