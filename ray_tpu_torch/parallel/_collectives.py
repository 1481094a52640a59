"""Collectives with gradients: what XLA inserts for the JAX package's meshes,
written out for the port's eager ranks.

  ppermute(x, group, shift)   ``jax.lax.ppermute`` on a ring: rank r sends
                              to r + shift and receives from r - shift; the
                              backward sends the gradient the other way
  copy_to_tp(x, tp)           Megatron's "f": identity forward, all-reduce
                              of the gradient over tp (where a replicated
                              activation enters a column-parallel layer)
  reduce_from_tp(x, tp)       Megatron's "g": all-reduce forward, identity
                              backward (the partial sums of a row-parallel
                              layer, of a vocab-parallel lookup or softmax)
  all_reduce_mean(x, group)   a metric's mean over a group, no gradient

Each takes ``None`` for a group of one rank and is then the identity, so a
model built without tensor parallelism runs exactly the one-device code.
A tensor-parallel layer keeps a :class:`TPLayout` of the rows it holds,
which loading, gathering and the gradient norm read.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """This rank's tensor-parallel group: its process group, size and rank."""

    group: object
    size: int
    rank: int


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of part ``index`` of ``n`` items split into ``parts``
    contiguous parts, the first ``n % parts`` one longer (numpy's
    ``array_split``): 50257 rows over 2 ranks are 25129 and 25128."""
    q, rem = divmod(n, parts)
    start = index * q + min(index, rem)
    return start, start + q + (index < rem)


class TPLayout(NamedTuple):
    """How a tp rank holds a weight: rows ``index`` of dimension ``dim``
    (of ``full`` rows); ``copies`` ranks hold the same rows, of which this
    one is the first (``owner``) or not."""

    dim: int
    index: torch.Tensor
    full: int
    copies: int
    owner: bool


def tp_layout(tp: Optional[TPGroup], dim: int, full: int, index=None,
              copies: int = 1) -> Optional[TPLayout]:
    """A tp rank's rows ``index`` (default: its contiguous
    :func:`split_range` part) of dimension ``dim``; None without tp."""
    if tp is None:
        return None
    if index is None:
        index = torch.arange(*split_range(full, tp.size, tp.rank))
    return TPLayout(dim, torch.as_tensor(index, dtype=torch.long), full, copies,
                    tp.rank % copies == 0)


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                       dist.P2POp(dist.irecv, out, src, group)]):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _send_recv(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` of rank r - shift (ranks of ``group``, mod its size); the
    gradient flows back to the sender. ``group=None`` is a ring of one."""
    return x if group is None else _PPermute.apply(x, group, shift)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """Identity; the gradient is summed over the tp ranks."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The sum over the tp ranks; the gradient passes unchanged."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (default: every rank), detached."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)
