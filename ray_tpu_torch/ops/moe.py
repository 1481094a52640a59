"""Mixture-of-Experts FFN, the port of ``ray_tpu/ops/moe.py``.

Top-k routing with a static per-expert capacity and dispatch/combine as
einsums (the Mesh-TensorFlow formulation the JAX package uses), so every
shape is static. The JAX package computes all of it outside any Pallas
kernel, and so does the port: the einsums go to ``torch.einsum``.

Where flax's ``MoE`` hands its aux loss to the caller through
``self.sow("losses", ...)``, :class:`MoE` returns it beside its output.

On a mesh (``MOE_SHARDING_PATTERNS``: the experts' leading dim over ep,
their hidden width over tp, the router replicated) the layer holds this
rank's E / ep experts and F / tp hidden columns. JAX's batch spec names
dp, fsdp and sp only, so the tokens are replicated over ep and XLA's
expert contraction needs no token exchange: each ep rank runs its own
experts on the same tokens and the combine's sum over E is a sum over the
ep ranks. The port does just that. Routing (router, softmax, top-k, the
aux loss) and dispatch and combine over all E run whole on every rank,
which uses its own experts' slots; ``x`` and ``combine`` enter through
``copy_to`` over ep and tp (so the router's and x's gradients are whole on
each rank) and the output leaves through ``reduce_from`` over both. Under
sp each rank holds a chunk of the sequence; routing takes its capacity
from the global length and numbers each expert's tokens over the global
sequence (one all-gather of the chunks' per-expert counts), a slot that
another chunk's token fills is all zeros here (``gelu(0 · wi) · wo = 0``,
so no expert input is exchanged), and the aux loss's token fractions and
mean probabilities are sums over sp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.gpt2 import Dense
from ray_tpu_torch.parallel._collectives import (
    TPGroup,
    copy_to,
    reduce_from,
    split_range,
    tp_layout,
)
from ray_tpu_torch.parallel.mesh import P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(top_k * tokens * capacity_factor / E)
    capacity_factor: float = 1.25
    # Switch-style load-balance auxiliary loss weight
    aux_loss_weight: float = 0.01


def _chunk_counts(counts: torch.Tensor, sp: Optional[TPGroup]):
    """(the counts of the sp ranks before this one, the counts of every
    rank) of per-rank ``counts``; (0, counts) without sp."""
    if sp is None:
        return torch.zeros_like(counts), counts
    every = [torch.empty_like(counts) for _ in range(sp.size)]
    dist.all_gather(every, counts.contiguous(), group=sp.group)
    every = torch.stack(every)
    return every[:sp.rank].sum(dim=0), every.sum(dim=0)


def top_k_routing(probs: torch.Tensor, k: int, capacity: int,
                  sp: Optional[TPGroup] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (B, S, E) -> (dispatch (B, S, E, C) 0/1, combine (B, S, E, C)).

    The k choices come in ``jax.lax.top_k``'s order (descending, the lower
    expert first on a tie). All first choices are admitted before any
    second choice, earlier positions win, and a token past its expert's
    capacity is dropped (combine weight 0: it passes through the residual
    only). The kept gates are renormalised to sum to 1 per token.

    With ``sp``, ``probs`` is this rank's chunk of the sequence and the
    numbering runs over the global sequence: a chunk's tokens come after
    every earlier chunk's tokens of the same choice, and the tokens each
    choice admits are counted over every chunk."""
    B, S, E = probs.shape
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[..., :k], order.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    dispatch = torch.zeros((B, S, E, capacity), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    slots = torch.arange(capacity, device=probs.device)
    masks = F.one_hot(gate_idx, E).movedim(2, 0)                    # (k, B, S, E)
    before, total = _chunk_counts(masks.sum(dim=2), sp)             # (k, B, E) each
    # tokens already admitted per (batch, expert)
    used = torch.zeros((B, E), dtype=torch.long, device=probs.device)
    for i in range(k):
        mask_i = masks[i]                                           # (B, S, E)
        # position of each token within its expert's buffer
        pos_i = mask_i.cumsum(dim=1) - 1 + (used + before[i])[:, None, :]
        keep = mask_i * (pos_i < capacity)
        # choice i's tokens of expert e hold positions used, used + 1, ...
        used = used + torch.minimum(capacity - used, total[i])
        # one-hot of pos_i; a position outside [0, capacity) is all zeros
        pos_oh = (pos_i[..., None] == slots).to(probs.dtype)       # (B, S, E, C)
        sel = keep.to(probs.dtype)[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + sel * gate_vals[..., i, None, None]
    return dispatch, combine


def load_balance_loss(probs: torch.Tensor, dispatch: torch.Tensor,
                      sp: Optional[TPGroup] = None) -> torch.Tensor:
    """Switch aux loss: E * sum_e (token fraction_e * mean prob_e). With
    ``sp``, over the global sequence of which ``probs`` and ``dispatch``
    are this rank's chunk: the same value on every sp rank, whose gradient
    reaches this rank's tokens only."""
    E = probs.shape[-1]
    tokens_per_expert = dispatch.sum(dim=(1, 3))                    # (B, E)
    if sp is None:
        mean_prob = probs.mean(dim=1)                               # (B, E)
    else:
        dist.all_reduce(tokens_per_expert, group=sp.group)
        mean_prob = reduce_from(probs.sum(dim=1), sp) / (probs.shape[1] * sp.size)
    total = tokens_per_expert.sum(dim=-1, keepdim=True).clamp_min(1.0)
    fraction = tokens_per_expert / total
    return E * (fraction * mean_prob).sum(dim=-1).mean()


class MoE(nn.Module):
    """Drop-in FFN replacement: x (B, S, C) -> (out (B, S, C), aux loss),
    the aux loss already multiplied by ``aux_loss_weight``.

    The router runs in fp32 (a tiny product with a big numerical lever);
    the experts (tanh-GELU, ``wi`` (E, C, F), ``wo`` (E, F, C), fp32
    parameters) and both einsums compute in ``dtype``.

    With ``ep`` and ``tp`` (:class:`TPGroup`s), this rank's experts
    ``[ep_rank · E/ep, (ep_rank + 1) · E/ep)`` and hidden columns (its
    contiguous F / tp), recorded in ``tp_layouts`` and ``ep_layouts`` by
    parameter name; with ``sp``, routing over the global sequence."""

    def __init__(self, d_model: int, d_ff: int, moe: MoEConfig,
                 dtype: torch.dtype = torch.bfloat16, device=None, *,
                 tp: Optional[TPGroup] = None, ep: Optional[TPGroup] = None,
                 sp: Optional[TPGroup] = None):
        super().__init__()
        self.moe = moe
        self.compute_dtype = dtype
        self.tp, self.ep, self.sp = tp, ep, sp
        E = moe.num_experts
        if ep is not None and E % ep.size:
            raise ValueError(f"ep = {ep.size} does not divide num_experts = {E}")
        self.experts = (0, E) if ep is None else split_range(E, ep.size, ep.rank)
        self.tp_layouts = {"wi": tp_layout(tp, 2, d_ff), "wo": tp_layout(tp, 1, d_ff)}
        self.ep_layouts = {n: tp_layout(ep, 0, E) for n in ("wi", "wo")}
        n_local = self.experts[1] - self.experts[0]
        f_local = d_ff if tp is None else len(self.tp_layouts["wi"].index)
        self.router = Dense(d_model, E, torch.float32, device)
        self.wi = nn.Parameter(torch.empty(n_local, d_model, f_local, device=device))
        self.wo = nn.Parameter(torch.empty(n_local, f_local, d_model, device=device))
        nn.init.normal_(self.wi, std=(E * d_model) ** -0.5)
        nn.init.normal_(self.wo, std=(E * d_ff) ** -0.5)

    def capacity(self, tokens: int) -> int:
        k, cf, E = self.moe.top_k, self.moe.capacity_factor, self.moe.num_experts
        return max(1, int(-(-k * tokens * cf // E)))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, C = x.shape
        sp = self.sp
        seq = S if sp is None else S * sp.size
        probs = torch.softmax(self.router(x.float()), dim=-1)
        dispatch, combine = top_k_routing(probs, self.moe.top_k, self.capacity(seq), sp)
        aux = load_balance_loss(probs, dispatch, sp) * self.moe.aux_loss_weight
        dt = self.compute_dtype
        dispatch, combine, xd = dispatch.to(dt), combine.to(dt), x.to(dt)
        sharded = self.tp is not None or self.ep is not None
        if sharded:   # this rank's experts; gradients summed over ep and tp
            first, stop = self.experts
            xd = copy_to(copy_to(xd, self.tp), self.ep)
            combine = copy_to(copy_to(combine, self.tp), self.ep)[:, :, first:stop]
            dispatch = dispatch[:, :, first:stop]
        expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, xd)   # scatter
        h = torch.einsum("ebcm,emf->ebcf", expert_in, self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ebcf,efm->ebcm", h, self.wo.to(dt))
        y = torch.einsum("bsec,ebcm->bsm", combine, out)            # gather
        if sharded:   # partial over this rank's experts and hidden columns
            y = reduce_from(reduce_from(y, self.ep), self.tp)
        return y.to(x.dtype), aux


# The JAX package's MOE_SHARDING_PATTERNS in the port's names: the expert
# stacks keep flax's (E, C, F) / (E, F, C) layouts, so their specs are
# JAX's own; the router's (E, C) weight is replicated, as its kernel is.
MOE_SHARDING_PATTERNS = [
    (r"moe\.router\.weight", P()),
    (r"moe\.router\.bias", P()),
    (r"moe\.wi", P("ep", "fsdp", "tp")),
    (r"moe\.wo", P("ep", "tp", "fsdp")),
]
