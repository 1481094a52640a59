"""Causal attention: a hand-written Hopper flash-attention forward kernel,
with its plain PyTorch version beside it.

The public surface of ``ray_tpu/ops/attention.py``, with the same layouts:

  flash_causal_attention(q, k, v)      (B, H, T, D) -> (B, H, T, D)
  flash_causal_attention_fwd(q, k, v)  (B, H, T, D) -> (o, lse (B, H, T))
  plain_causal_attention(q, k, v)      the counterpart of
                                       ``xla_causal_attention``
  causal_attention(q, k, v)            (B, T, H, D) -> (B, T, H, D)

Dispatch is by the tensor's device, with no fallback: a CUDA tensor always
launches ``csrc/flash_attn_fwd.cu`` (and the wrapper raises on a dtype,
head dim or layout the kernel does not take), a CPU tensor always takes the
plain version. The JAX package's rule (kernel only on a TPU, only for
T >= 256 with T % 128 == 0) was a TPU tiling constraint; the CUDA kernel
masks its own ragged edge and takes every T >= 1.

There is no autograd here yet: serving runs under ``torch.inference_mode``.
The backward kernels and the ``torch.autograd.Function`` come with the
training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

NEG_INF = -1e30

# Launches of the flash forward kernel (plain integer; CPU calls never
# touch it). chip_smoke.py resets it to show the main path used the kernel.
FLASH_FWD_LAUNCHES = 0

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


# --------------------------------------------------------------------------
# the kernel
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
    b, h, t, _ = q.shape
    if t < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f"flash_attn_fwd takes T >= 1 and 1 <= B*H <= 65535, "
                         f"got {tuple(q.shape)}")


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


def flash_causal_attention(q, k, v) -> torch.Tensor:
    """q/k/v (B, H, T, D) -> (B, H, T, D); fused causal attention."""
    return flash_causal_attention_fwd(q, k, v)[0]


def causal_attention(q, k, v) -> torch.Tensor:
    """Layout-adapting entry: q/k/v (B, T, H, D) -> (B, T, H, D)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return flash_causal_attention(qt, kt, vt).transpose(1, 2)
