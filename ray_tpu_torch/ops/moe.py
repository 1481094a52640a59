"""Mixture-of-Experts FFN, the port of ``ray_tpu/ops/moe.py``.

Top-k routing with a static per-expert capacity and dispatch/combine as
einsums (the Mesh-TensorFlow formulation the JAX package uses), so every
shape is static. The JAX package computes all of it outside any Pallas
kernel, and so does the port: the einsums go to ``torch.einsum``. The
expert-parallel layout (``MOE_SHARDING_PATTERNS``, the experts' leading dim
over an ``ep`` axis) waits for the port's mesh (ROADMAP Queue A item 8).

Where flax's ``MoE`` hands its aux loss to the caller through
``self.sow("losses", ...)``, :class:`MoE` returns it beside its output.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.gpt2 import Dense


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(top_k * tokens * capacity_factor / E)
    capacity_factor: float = 1.25
    # Switch-style load-balance auxiliary loss weight
    aux_loss_weight: float = 0.01


def top_k_routing(probs: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (B, S, E) -> (dispatch (B, S, E, C) 0/1, combine (B, S, E, C)).

    The k choices come in ``jax.lax.top_k``'s order (descending, the lower
    expert first on a tie). All first choices are admitted before any
    second choice, earlier positions win, and a token past its expert's
    capacity is dropped (combine weight 0: it passes through the residual
    only). The kept gates are renormalised to sum to 1 per token."""
    B, S, E = probs.shape
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[..., :k], order.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    dispatch = torch.zeros((B, S, E, capacity), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    slots = torch.arange(capacity, device=probs.device)
    # tokens already admitted per (batch, expert)
    used = torch.zeros((B, E), dtype=torch.long, device=probs.device)
    for i in range(k):
        mask_i = F.one_hot(gate_idx[..., i], E)                   # (B, S, E)
        # position of each token within its expert's buffer
        pos_i = mask_i.cumsum(dim=1) - 1 + used[:, None, :]
        keep = mask_i * (pos_i < capacity)
        used = used + keep.sum(dim=1)
        # one-hot of pos_i; a position outside [0, capacity) is all zeros
        pos_oh = (pos_i[..., None] == slots).to(probs.dtype)       # (B, S, E, C)
        sel = keep.to(probs.dtype)[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + sel * gate_vals[..., i, None, None]
    return dispatch, combine


def load_balance_loss(probs: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """Switch aux loss: E * sum_e (token fraction_e * mean prob_e)."""
    E = probs.shape[-1]
    tokens_per_expert = dispatch.sum(dim=(1, 3))                    # (B, E)
    total = tokens_per_expert.sum(dim=-1, keepdim=True).clamp_min(1.0)
    fraction = tokens_per_expert / total
    mean_prob = probs.mean(dim=1)                                   # (B, E)
    return E * (fraction * mean_prob).sum(dim=-1).mean()


class MoE(nn.Module):
    """Drop-in FFN replacement: x (B, S, C) -> (out (B, S, C), aux loss),
    the aux loss already multiplied by ``aux_loss_weight``.

    The router runs in fp32 (a tiny product with a big numerical lever);
    the experts (tanh-GELU, ``wi`` (E, C, F), ``wo`` (E, F, C), fp32
    parameters) and both einsums compute in ``dtype``."""

    def __init__(self, d_model: int, d_ff: int, moe: MoEConfig,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.moe = moe
        self.compute_dtype = dtype
        E = moe.num_experts
        self.router = Dense(d_model, E, torch.float32, device)
        self.wi = nn.Parameter(torch.empty(E, d_model, d_ff, device=device))
        self.wo = nn.Parameter(torch.empty(E, d_ff, d_model, device=device))
        nn.init.normal_(self.wi, std=(E * d_model) ** -0.5)
        nn.init.normal_(self.wo, std=(E * d_ff) ** -0.5)

    def capacity(self, tokens: int) -> int:
        k, cf, E = self.moe.top_k, self.moe.capacity_factor, self.moe.num_experts
        return max(1, int(-(-k * tokens * cf // E)))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, C = x.shape
        probs = torch.softmax(self.router(x.float()), dim=-1)
        dispatch, combine = top_k_routing(probs, self.moe.top_k, self.capacity(S))
        aux = load_balance_loss(probs, dispatch) * self.moe.aux_loss_weight
        dt = self.compute_dtype
        dispatch, combine, xd = dispatch.to(dt), combine.to(dt), x.to(dt)
        expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, xd)   # scatter
        h = torch.einsum("ebcm,emf->ebcf", expert_in, self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ebcf,efm->ebcm", h, self.wo.to(dt))
        y = torch.einsum("bsec,ebcm->bsm", combine, out)            # gather
        return y.to(x.dtype), aux
