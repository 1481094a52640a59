"""Causal attention: hand-written Hopper flash-attention kernels, forward
and backward, with their plain PyTorch versions beside them.

The public surface of ``ray_tpu/ops/attention.py``, with the same layouts:

  flash_causal_attention(q, k, v)      (B, H, T, D) -> (B, H, T, D),
                                       differentiable
  flash_causal_attention_fwd(q, k, v)  (B, H, T, D) -> (o, lse (B, H, T))
  flash_causal_attention_bwd(q, k, v, o, lse, do) -> (dq, dk, dv)
  plain_causal_attention(q, k, v)      the counterpart of
                                       ``xla_causal_attention``
  causal_attention(q, k, v)            (B, T, H, D) -> (B, T, H, D),
                                       differentiable

Dispatch is by the tensor's device, with no fallback: a CUDA tensor always
launches the kernels (``csrc/flash_attn_fwd.cu`` forward,
``csrc/flash_attn_bwd.cu`` dq and dk/dv; the wrappers raise on a dtype,
head dim, layout or alignment the kernels do not take), a CPU tensor always
takes the plain versions. The JAX package's rule (kernel only on a TPU, only
for T >= 256 with T % 128 == 0) was a TPU tiling constraint; the CUDA
kernels mask their own ragged edges and take every T >= 1.

Inside the C entry points the kernel is chosen by the dtype, one kernel per
dtype: bfloat16 runs the forward, dq and dk/dv on the tensor cores (wgmma
on TMA-fed tiles); float32, which the tensor cores take only as TF32
(turned off by the port's fp32 policy), runs on the CUDA cores in fp32.
TMA needs 16-byte-aligned tensors, so every kernel input must start on a
16-byte boundary (a freshly allocated tensor does).

The gradient is :class:`FlashCausalAttention`, the counterpart of the JAX
package's ``custom_vjp`` around ``_flash``: the forward saves q, k, v, o
and lse; the backward computes delta = rowsum(o * do) in fp32 and calls the
dq and dk/dv kernels (their plain versions on the CPU). Without grad (as
under ``torch.inference_mode`` while serving) nothing is saved.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

NEG_INF = -1e30

# Launches of each kernel (plain integers; CPU calls never touch them).
# chip_smoke.py resets them to show the main path used the kernels.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def plain_causal_attention_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: q/k/v (B, H, T, D) ->
    ``o`` (B, H, T, D) in q's type and ``lse`` (B, H, T) fp32, every step
    in fp32 (q scaled before the product, as the kernel does)."""
    d, t = q.shape[-1], q.shape[-2]
    qf = q.float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bhtd,bhsd->bhts", qf, k.float())
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p, v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def plain_causal_attention(q, k, v) -> torch.Tensor:
    """Plain einsum-softmax causal attention, (B, H, T, D): the counterpart
    of ``xla_causal_attention`` (scores and softmax in fp32, probabilities
    cast to q's type before the second product)."""
    d, t = q.shape[-1], q.shape[-2]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", p, v)


def plain_causal_attention_bwd(q, k, v, o, lse, do
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, the counterpart of
    ``_flash_bwd``: from q/k/v/o/do (B, H, T, D) and the forward's ``lse``
    (B, H, T) fp32, recompute p = exp(q k^T / sqrt(d) - lse) under the
    causal mask and return (dq, dk, dv) in q's type, every step in fp32:
    delta = rowsum(o * do), ds = p * (do v^T - delta), dq = ds k / sqrt(d),
    dk = ds^T (q / sqrt(d)), dv = p^T do."""
    d, t = q.shape[-1], q.shape[-2]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    qf = qf * scale
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


@functools.cache
def _kernel():
    from ray_tpu_torch.ops import _cuda

    lib = _cuda.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.flash_attn_fwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.cache
def _bwd_kernels():
    from ray_tpu_torch.ops import _cuda

    lib = _cuda.load("flash_attn_bwd")
    dq = lib.flash_attn_bwd_dq
    dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dq.restype = ctypes.c_int
    dkv = lib.flash_attn_bwd_dkv
    dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dkv.restype = ctypes.c_int
    err = lib.flash_attn_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return dq, dkv, err


def _check_kernel_inputs(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"q/k/v must be (B, H, T, D), got {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_attn_fwd takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attn_fwd takes head dim {_KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attn_fwd needs contiguous q, k and v")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_aligned(name, x)
    b, h, t, _ = q.shape
    if t < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f"flash_attn_fwd takes T >= 1 and 1 <= B*H <= 65535, "
                         f"got {tuple(q.shape)}")


def _check_aligned(name, x) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"the attention kernels need {name} to start on a "
                         f"16-byte boundary (TMA), got address {x.data_ptr():#x}")


def _check_rows(name, x, q) -> None:
    if (x.shape != q.shape[:-1] or x.dtype != torch.float32
            or x.device != q.device or not x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 {tuple(q.shape[:-1])} "
                         f"on {q.device}, got {tuple(x.shape)} {x.dtype} {x.device}")


def _check_bwd_inputs(q, k, v, do, lse, delta, o=None) -> None:
    _check_kernel_inputs(q, k, v)
    for name, x in (("o", o), ("do", do)):
        if x is None:
            continue
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attn_bwd needs a contiguous {name}")
        _check_aligned(name, x)
    _check_rows("lse", lse, q)
    if delta is not None:
        _check_rows("delta", delta, q)


def _kernel_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    global FLASH_FWD_LAUNCHES
    _check_kernel_inputs(q, k, v)
    b, h, t, d = q.shape
    fn, err = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b * h, t, d, _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_fwd launch failed: {err(rc).decode()} (cudaError {rc})")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta):
    b, h, t, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    return ptrs, (b * h, t, d, _KERNEL_DTYPES[q.dtype])


def launch_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq from the dq kernel alone (CUDA tensors; ``delta`` = rowsum(o * do)
    (B, H, T) fp32)."""
    global FLASH_BWD_DQ_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, delta)
    fn, _, err = _bwd_kernels()
    ptrs, shape = _bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, dq.data_ptr(), *shape, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    FLASH_BWD_DQ_LAUNCHES += 1
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dk/dv kernel alone (CUDA tensors, as for
    :func:`launch_bwd_dq`)."""
    global FLASH_BWD_DKV_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, delta)
    _, fn, err = _bwd_kernels()
    ptrs, shape = _bwd_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *shape, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    FLASH_BWD_DKV_LAUNCHES += 1
    return dk, dv


def _kernel_bwd(q, k, v, o, lse, do):
    _check_bwd_inputs(q, k, v, do, lse, None, o=o)
    # delta = rowsum(o * do) in fp32, outside the kernels as on the TPU
    delta = (o.float() * do.float()).sum(dim=-1)
    dq = launch_bwd_dq(q, k, v, do, lse, delta)
    return (dq, *launch_bwd_dkv(q, k, v, do, lse, delta))


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def flash_causal_attention_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, T, D) -> (o (B, H, T, D), lse (B, H, T) fp32).

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; any other device raises."""
    if q.device.type == "cuda":
        return _kernel_fwd(q, k, v)
    if q.device.type == "cpu":
        return plain_causal_attention_fwd(q, k, v)
    raise ValueError(f"no causal attention for device {q.device}")


def flash_causal_attention_bwd(q, k, v, o, lse, do
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of causal attention, in q's type, from the
    forward's inputs, its output ``o`` and ``lse`` (B, H, T) fp32 and the
    output's gradient ``do``. CUDA tensors go through the dq and dk/dv
    kernels, CPU tensors through the plain version; any other device
    raises."""
    if q.device.type == "cuda":
        return _kernel_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return plain_causal_attention_bwd(q, k, v, o, lse, do)
    raise ValueError(f"no causal attention for device {q.device}")


class FlashCausalAttention(torch.autograd.Function):
    """Causal attention with the flash kernels' gradient: the forward saves
    q, k, v, o and lse, the backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_causal_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_causal_attention_bwd(q, k, v, o, lse, do.contiguous())


def flash_causal_attention(q, k, v) -> torch.Tensor:
    """q/k/v (B, H, T, D) -> (B, H, T, D); fused causal attention,
    differentiable when grad is enabled and an input requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashCausalAttention.apply(q, k, v)
    return flash_causal_attention_fwd(q, k, v)[0]


def causal_attention(q, k, v) -> torch.Tensor:
    """Layout-adapting entry: q/k/v (B, T, H, D) -> (B, T, H, D)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return flash_causal_attention(qt, kt, vt).transpose(1, 2)
