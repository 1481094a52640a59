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

Dispatch is decided by the device alone: a CUDA tensor goes to the kernels
(``csrc/flash_attn_fwd.cu`` forward, ``csrc/flash_attn_bwd.cu`` dq and
dk/dv), a CPU tensor to their plain versions, any other device raises.
There is no silent fallback: on the card, what the kernels cannot take
raises. The kernels are built for head dims of 32, 64 and 128; every
other head dim up to 128 is computed at the next of those
(:func:`kernel_head_dim`, :func:`padded_fwd`, :func:`padded_bwd`): q, k and
v are zero-padded along D, q is scaled by sqrt(d_pad / d) so that the
kernel's 1 / sqrt(d_pad) gives the model's 1 / sqrt(d), the outputs are
sliced back to D and dq is scaled by the same factor. So gpt2-tiny (head
dim 16) and ``GPT2Config(n_head=16)`` (head dim 48) run on the kernels, as
the JAX package's kernel takes them. A head dim above 128, a type other
than fp32 or bf16, or a layout or alignment the kernels do not take raises
on the card. The JAX package's other limits (a TPU only, T >= 256 with
T % 128 == 0) were TPU tiling constraints; the CUDA kernels mask their own
ragged edges and take every T >= 1. The grid's second axis holds at most
65535 (b, h) slices, so the host wrappers launch a larger B * H in
contiguous chunks of at most 65532 slices of the (B * H, T, D) view, one
launch (and one count) each.

A model picks its attention through :func:`attention_for`: the kernels
(:func:`causal_attention`) with ``use_flash_attention`` on, the flax
models' einsum path (:func:`einsum_causal_attention`) with it off. Each
call of the einsum path on the card adds one to ``PLAIN_ATTENTION_CALLS``,
so a run can show that its path never left the kernels.

Inside the C entry points the kernel is chosen by the dtype, one kernel per
dtype: bfloat16 runs the forward, dq and dk/dv on the tensor cores (wgmma
on TMA-fed tiles); float32, which the tensor cores take only as TF32
(turned off by the port's fp32 policy), runs on the CUDA cores in fp32.
TMA and cp.async need 16-byte-aligned tensors, so every kernel input must
start on a 16-byte boundary (a freshly allocated tensor does).

The forward's tile plan is chosen here, from the launch, and passed to the
C entry point: :func:`fwd_block_m` gives the query rows per thread block
(the bf16 design's fixed 128; for fp32 64, 32 or 16, the largest whose
grid holds enough waves of blocks, so that one request's prompt still
spreads over every SM), and :func:`fwd_tiles` lists the blocks in launch
order, as the kernel maps them (heaviest q tiles of every slice first).

The gradient is :class:`FlashCausalAttention`, the counterpart of the JAX
package's ``custom_vjp`` around ``_flash``: the forward saves q, k, v, o
and lse; the backward computes delta = rowsum(o * do) in fp32 and calls the
dq and dk/dv kernels (their plain versions on the CPU). Without grad (as
under ``torch.inference_mode`` while serving) nothing is saved.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Tuple

import torch

NEG_INF = -1e30

# Launches of each kernel (plain integers; CPU calls never touch them), and
# calls on the card of the einsum path (a config's use_flash_attention off).
# chip_smoke.py resets them to show the main path used the kernels.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0
PLAIN_ATTENTION_CALLS = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)
# (b, h) slices per launch: at most 65535 (a grid axis), and a multiple of 4
# so that every chunk's fp32 lse and delta rows, like its q/k/v/do tiles,
# start on a 16-byte boundary
_CHUNK_BH = 65532
# query rows per block of the forward: the bf16 design's two warpgroups of
# 64; the fp32 design's tiles, largest first, each with the blocks per SM
# its grid must hold to be chosen. Measured on the H100 (PERF.md §6):
# a 64-row block walks the longest K/V range, so its heaviest tiles end the
# launch alone unless two waves of blocks stand behind them; 32 rows win
# from one wave up (one request's prompt of 512-1024 tokens, 12 heads); 16
# rows spread a short prompt over every SM.
BF16_BLOCK_M = 128
FP32_TILES = ((64, 2), (32, 1), (16, 0))
FP32_BLOCK_MS = tuple(rows for rows, _ in FP32_TILES)
H100_SMS = 132


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels compute a head dim ``d`` at: ``d`` where
    they are built for it (32, 64, 128), else the next of those above it;
    raises above 128."""
    for size in _KERNEL_HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"the attention kernels take head dims up to "
                     f"{_KERNEL_HEAD_DIMS[-1]}, got {d}")


def fwd_block_m(bh: int, t: int, dtype, sms: int = H100_SMS) -> int:
    """Query rows per thread block of the forward kernel for ``bh`` (b, h)
    slices of ``t`` rows on a card of ``sms`` SMs: 128 for bfloat16; for
    float32 the first tile of :data:`FP32_TILES` whose grid, bh x
    ceil(t / rows) blocks, holds its waves of ``sms`` blocks. Larger tiles
    read each K/V tile for more rows; smaller ones spread one request's
    prompt (B = 1) over every SM and shorten the heaviest tile's walk."""
    if dtype == torch.bfloat16:
        return BF16_BLOCK_M
    return next(rows for rows, waves in FP32_TILES
                if bh * -(-t // rows) >= waves * sms)


def fwd_tiles(bh: int, t: int, block_m: int) -> torch.Tensor:
    """The forward kernel's blocks in launch order, as it maps them: a
    (blocks, 4) int64 tensor of (slice, first row, row past the last, key
    past the last) per block. The grid is (bh, ceil(t / block_m)), blockIdx.x
    the slice and blockIdx.y the rank of the q tile counted from the last
    one, and blocks launch with x fastest: every slice's heaviest tile, then
    every slice's next. A block sees keys [0, min(t, q0 + block_m)), every
    key of its causal rows, none split off to another block."""
    n_tiles = -(-t // block_m)
    rank, slice_ = torch.meshgrid(torch.arange(n_tiles), torch.arange(bh),
                                  indexing="ij")
    q0 = (n_tiles - 1 - rank.reshape(-1)) * block_m
    stop = torch.clamp(q0 + block_m, max=t)
    return torch.stack([slice_.reshape(-1), q0, stop, stop], dim=1)


def _pad_head(x, size: int, factor: float = 1.0):
    """``x`` (..., D) times ``factor`` (in fp32, then back to x's type),
    zero-padded along D to ``size``: a fresh contiguous tensor."""
    if factor != 1.0:
        x = (x.float() * factor).to(x.dtype)
    return torch.nn.functional.pad(x, (0, size - x.shape[-1]))


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
    # q, k, v, o, lse; bh, t, d, dtype, block_m; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    if t < 1 or b * h < 1:
        raise ValueError(f"flash_attn_fwd takes T >= 1 and B*H >= 1, "
                         f"got {tuple(q.shape)}")


def _check_aligned(name, x) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"the attention kernels need {name} to start on a "
                         f"16-byte boundary (TMA, cp.async), got address "
                         f"{x.data_ptr():#x}")


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


def _chunks(bh: int):
    """(start, count) of each launch over ``bh`` (b, h) slices."""
    return [(i, min(_CHUNK_BH, bh - i)) for i in range(0, bh, _CHUNK_BH)]


def _slices(x, start: int, count: int):
    """Rows [start, start + count) of ``x`` viewed as (B * H, ...): a
    contiguous view."""
    return x.reshape((-1,) + tuple(x.shape[2:]))[start:start + count]


def _kernel_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    global FLASH_FWD_LAUNCHES
    _check_kernel_inputs(q, k, v)
    b, h, t, _ = q.shape
    fn, err = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    sms = _sm_count(q.device)
    FLASH_FWD_LAUNCHES += _launch(
        "flash_attn_fwd", fn, err, [q, k, v], [o, lse],
        lambda n: (fwd_block_m(n, t, q.dtype, sms),))
    return o, lse


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@contextlib.contextmanager
def _on_card(q):
    """q's card as the current device; yields its current stream's handle."""
    with torch.cuda.device(q.device):
        yield torch.cuda.current_stream(q.device).cuda_stream


def _launch(name, fn, err, inputs, outputs, extra=lambda n: ()) -> int:
    """Launch a kernel over every chunk of (b, h) slices, its arguments the
    chunks' pointers, then (b*h, t, d, dtype), then ``extra(b*h)``, then the
    stream; returns the number of launches."""
    q = inputs[0]
    b, h, t, d = q.shape
    with _on_card(q) as stream:
        chunks = _chunks(b * h)
        for start, n in chunks:
            # one chunk is the whole of each tensor: no views to make, which
            # cost the host more than a short kernel takes
            parts = (inputs + outputs if len(chunks) == 1
                     else [_slices(x, start, n) for x in inputs + outputs])
            for x in parts:
                _check_aligned("a chunk", x)
            ptrs = [x.data_ptr() for x in parts]
            rc = fn(*ptrs, n, t, d, _KERNEL_DTYPES[q.dtype], *extra(n), stream)
            if rc != 0:
                raise RuntimeError(f"{name} launch failed: "
                                   f"{err(rc).decode()} (cudaError {rc})")
    return len(chunks)


def launch_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq from the dq kernel alone (CUDA tensors; ``delta`` = rowsum(o * do)
    (B, H, T) fp32)."""
    global FLASH_BWD_DQ_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, delta)
    fn, _, err = _bwd_kernels()
    dq = torch.empty_like(q)
    FLASH_BWD_DQ_LAUNCHES += _launch(
        "flash_attn_bwd_dq", fn, err, [q, k, v, do, lse, delta], [dq])
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dk/dv kernel alone (CUDA tensors, as for
    :func:`launch_bwd_dq`)."""
    global FLASH_BWD_DKV_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, delta)
    _, fn, err = _bwd_kernels()
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    FLASH_BWD_DKV_LAUNCHES += _launch(
        "flash_attn_bwd_dkv", fn, err, [q, k, v, do, lse, delta], [dk, dv])
    return dk, dv


def _kernel_bwd(q, k, v, o, lse, do):
    _check_bwd_inputs(q, k, v, do, lse, None, o=o)
    # delta = rowsum(o * do) in fp32, outside the kernels as on the TPU
    delta = (o.float() * do.float()).sum(dim=-1)
    dq = launch_bwd_dq(q, k, v, do, lse, delta)
    return (dq, *launch_bwd_dkv(q, k, v, do, lse, delta))


def padded_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel at the kernels' head dim: q/k/v (B, H, T, D)
    zero-padded along D to :func:`kernel_head_dim`, q scaled by
    c = sqrt(d_pad / d), o sliced back to D. The scores, and so lse, are
    the model's: (c q) k^T / sqrt(d_pad) = q k^T / sqrt(d)."""
    d = q.shape[-1]
    size = kernel_head_dim(d)
    if size == d:
        return _kernel_fwd(q, k, v)
    c = math.sqrt(size / d)
    o, lse = _kernel_fwd(_pad_head(q, size, c), _pad_head(k, size),
                         _pad_head(v, size))
    return o[..., :d].contiguous(), lse


def padded_bwd(q, k, v, o, lse, do
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq and dk/dv kernels at the kernels' head dim, padded as in
    :func:`padded_fwd`, o and do too (so delta = rowsum(o * do) is
    unchanged); dq, dk and dv are sliced back to D and dq is scaled by c,
    the chain rule through q's scaling. dk needs no factor: the kernel
    multiplies dS by the scaled q over sqrt(d_pad), which is q / sqrt(d)."""
    d = q.shape[-1]
    size = kernel_head_dim(d)
    if size == d:
        return _kernel_bwd(q, k, v, o, lse, do)
    c = math.sqrt(size / d)
    dq, dk, dv = _kernel_bwd(_pad_head(q, size, c), _pad_head(k, size),
                             _pad_head(v, size), _pad_head(o, size), lse,
                             _pad_head(do, size))
    return ((dq[..., :d].float() * c).to(q.dtype), dk[..., :d].contiguous(),
            dv[..., :d].contiguous())


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def _device_of(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no causal attention for device {q.device}")
    return q.device.type


def flash_causal_attention_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, T, D) -> (o (B, H, T, D), lse (B, H, T) fp32).

    A CUDA tensor goes through the kernel, at :func:`kernel_head_dim` (the
    wrapper raises on what the kernel cannot take); a CPU tensor through
    the plain version; any other device raises."""
    if _device_of(q) == "cuda":
        return padded_fwd(q, k, v)
    return plain_causal_attention_fwd(q, k, v)


def flash_causal_attention_bwd(q, k, v, o, lse, do
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of causal attention, in q's type, from the
    forward's inputs, its output ``o`` and ``lse`` (B, H, T) fp32 and the
    output's gradient ``do``. Dispatched as :func:`flash_causal_attention_fwd`:
    the dq and dk/dv kernels on a CUDA tensor, the plain version on a CPU
    tensor; any other device raises."""
    if _device_of(q) == "cuda":
        return padded_bwd(q, k, v, o, lse, do)
    return plain_causal_attention_bwd(q, k, v, o, lse, do)


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
    """Layout-adapting entry: q/k/v (B, T, H, D) -> (B, T, H, D) through
    :func:`flash_causal_attention`."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return flash_causal_attention(qt, kt, vt).transpose(1, 2)


def einsum_causal_attention(q, k, v) -> torch.Tensor:
    """:func:`plain_causal_attention` in the (B, T, H, D) layout: the flax
    models' einsum path when ``use_flash_attention`` is off (fp32 scores, a
    causal mask of -1e30, the softmax cast to q's type), differentiable
    through autograd. Each call on the card counts in
    ``PLAIN_ATTENTION_CALLS``."""
    global PLAIN_ATTENTION_CALLS
    if _device_of(q) == "cuda":
        PLAIN_ATTENTION_CALLS += 1
    return plain_causal_attention(*(x.transpose(1, 2) for x in (q, k, v))
                                  ).transpose(1, 2)


def attention_for(cfg):
    """A model's attention, (B, T, H, D) -> (B, T, H, D): the config's
    ``attn_fn`` where it is set (ring attention on a mesh with sp > 1),
    else by ``use_flash_attention``: :func:`causal_attention` (the kernels)
    on, :func:`einsum_causal_attention` off."""
    if getattr(cfg, "attn_fn", None) is not None:
        return cfg.attn_fn
    return causal_attention if cfg.use_flash_attention else einsum_causal_attention
