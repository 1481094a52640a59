"""Ring attention: causal attention with the sequence sharded over the sp
ranks, the port of ``ray_tpu/ops/ring_attention.py``.

Each sp rank holds a contiguous chunk (B, T/n, H, D) of q, k and v. Its q
chunk stays put while the k/v chunks go round the ring (``ppermute``: rank
r sends to r + 1), n - 1 hops; after each hop the rank attends its q chunk
to the k/v chunk it holds. The per-chunk results merge with the streaming
softmax in log space (a running log-sum-exp, the same clips at -80 / 80 as
the JAX package), so the result is the softmax over the whole sequence.
Causality comes from global positions (chunk offset = owner rank x chunk
length): a chunk wholly in a query's future gives -inf lse and drops out of
the merge.

The chunk attention is a plain einsum in fp32, as in JAX (where it is no
Pallas kernel either). Autograd runs through the ring: each ``ppermute``'s
backward sends the gradient back the way its chunk came, so the gradients
of k and v flow round the ring in reverse to the rank that owns them.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.parallel import _collectives
from ray_tpu_torch.parallel.mesh import DATA_AXES, _block, axis_group

NEG_INF = -1e30


def _chunk_attn(q, k, v, q_offset: int, k_offset: int, scale: float):
    """Attention of a q chunk (B, Tq, H, D) over one k/v chunk (B, Tk, H, D)
    with global causal masking. Returns (o, lse, m): o (B, Tq, H, D) fp32,
    normalised within the chunk and scaled by exp(-m); lse and m (B, Tq, H),
    the chunk's log-sum-exp and its row maxima (floored at -1e29, so a
    fully masked row gives p = 0 and lse = NEG_INF, never exp(0) = 1)."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    k_pos = k_offset + torch.arange(Tk, device=q.device)[None, :]
    causal = q_pos >= k_pos
    s = torch.where(causal, s, NEG_INF)
    safe_m = torch.clamp(s.amax(dim=-1), min=-1e29)            # (B, H, Tq)
    p = torch.where(causal, torch.exp(s - safe_m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p.to(q.dtype).float(), v.float())
    lse = torch.where(l > 0, safe_m + torch.log(torch.clamp(l, min=1e-30)), NEG_INF)
    return o, lse.transpose(1, 2), safe_m.transpose(1, 2)


def ring_causal_attention(q, k, v, group=None):
    """Causal attention over the ring of ``group`` (None: one rank, plain
    causal attention). q/k/v: this rank's chunks (B, Tl, H, D) of the
    sequence, rank i holding positions i * Tl ... (i + 1) * Tl. Returns
    (B, Tl, H, D) in q's type."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    idx = 0 if group is None else torch.distributed.get_rank(group)
    B, Tl, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    acc = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((B, Tl, H), NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        owner = (idx - s) % n            # whose chunk this rank holds now
        o, lse, m = _chunk_attn(q, k_cur, v_cur, idx * Tl, owner * Tl, scale)
        new_lse = torch.logaddexp(lse_acc, lse)
        w_old = torch.exp(torch.clamp(lse_acc - new_lse, -80, 0))
        w_new = torch.exp(torch.clamp(lse - new_lse, -80, 0))
        o_norm = o * torch.exp(torch.clamp(m - lse, -80, 80))[..., None]
        acc = acc * w_old[..., None] + o_norm * w_new[..., None]
        lse_acc = new_lse
        if s < n - 1:
            k_cur = _collectives.ppermute(k_cur, group, 1)
            v_cur = _collectives.ppermute(v_cur, group, 1)
    return acc.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                           batch_axes=DATA_AXES):
    """Global tensors (B, T, H, D), the same on every rank, in; this rank's
    chunk of the output out: rows by its coordinate on ``batch_axes``,
    positions by its ``axis_name`` coordinate, every head (the counterpart
    of the JAX wrapper's shard_map)."""
    rows = _block(mesh, batch_axes, q.shape[0])
    cols = _block(mesh, (axis_name,), q.shape[1])
    local = [x[rows, cols] for x in (q, k, v)]
    return ring_causal_attention(*local, group=axis_group(mesh, axis_name))
