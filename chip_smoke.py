#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card and check
every kernel of its main paths.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports nothing of
JAX or of the JAX package. Phases, in order; any failure raises and the
script exits non-zero:

  1. device  the card's name and power limit (nvidia-smi)
  2. build   compile ray_tpu_torch/csrc with nvcc, one process per source,
             all at once (timed); show ptxas's register / spill report and
             fail if a tensor-core (sm90) instance spills
  3. kernel  flash_attn_fwd against its plain PyTorch version on the card,
             o and lse, fp32 and bf16, head dims 32, 64 and 128, ragged and
             aligned lengths, bitwise repeatable, with a digest of each
             case's outputs (to compare commits bitwise); times of the
             kernel, the plain version and SDPA (yardstick only) at the serving and
             training shapes, beside the least time the card could take,
             with the kernel's achieved TFLOP/s, its share of that bound
             and its ratio to SDPA
  4. bwd     flash_attn_bwd's dq and dk/dv kernels against their plain
             version on the card (and, in fp32, against autograd of the
             plain attention), fp32 and bf16, head dims 32, 64 and 128,
             ragged and aligned lengths, bitwise repeatable, with a digest
             of each gradient; times at the training shapes beside the bound, the plain backward and
             SDPA's backward (yardstick only), with achieved TFLOP/s,
             share of the bound and ratio to SDPA's backward
  5. model   GPT-2-124M forward at (4, 512) on the card against the same
             weights' forward on the CPU plain path
  6. serve   the serving path: LLMEngine over build_adapter("gpt2") at
             full width answers 8 requests (one prefix-cache hit); the
             forward kernel's launch counter, the cache's integrity, and a
             teacher-forced check of every greedy token against the CPU
             plain forward
  7. train   the training path: TrainStep on GPT-2-124M at full width, bf16
             compute over fp32 master weights, B = 16, T = 1024: a warm-up
             step, then timed steps on a repeated batch with a falling
             loss and exactly 24 forward, 12 dq and 12 dk/dv launches per
             step; step time, tokens/s, MFU and peak memory from the
             port's recorder; the attention kernels' share of one step
             (torch.profiler); then one fp32 step at full width on (2, 128)
             on the card and on the CPU plain path from the same weights
  8. llama   Llama-160M at full width (12 layers, 12 heads, 4 KV heads
             repeated to 12 before the kernels, width 768, vocab 32000):
             the fp32 forward at (4, 512) against the CPU, serving as in
             phase 6 (build_adapter("llama-160m")), training as in phase 7
             (bf16, B = 16, T = 1024, with the exact 6N MFU beside the
             recorder's), and one fp32 step on (2, 128) against the CPU
  9. spec    speculative decoding: the Llama-160M target answers phase 6's
             prompts without a draft and with two (a same-seed llama-160m,
             acceptance near 1; llama-tiny at vocabulary 32000, near 0),
             k = 4; every stream equals the plain one, or leaves it only
             at a near tie of the CPU plain forward (within GREEDY_TOL);
             acceptance, rounds and tokens/s beside the plain run
 10. moe     GPT2MoEConfig() (GPT-2-124M widths, 8 experts, top-2, an MoE
             block every 2nd layer) trains at B = 8, T = 1024 (a warm-up
             and three timed steps, 24 / 12 / 12 launches each, loss with
             the aux loss falling); one fp32 step on (2, 128) against the
             CPU after its dispatch masks are compared (a routing flip from
             a near tie shows as such); gpt2-moe-tiny serves 4 requests
             (dropless routing) against the CPU

Then one JSON line of kernels (launches per path: GPT-2 train and serve,
Llama train and serve, spec, MoE train) and, last, ``{"ok": true,
"device": ...}``.
Without CUDA it exits 2 before printing any result.
"""

from __future__ import annotations

import copy
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"   # the card; every phase runs on it

FP32_TOL = 2e-5   # kernel vs plain, both fp32 with TF32 off: summation order
BF16_TOL = 2e-2   # bf16 kernel output vs the plain version in fp32 on the
#                   same bf16 inputs: one bf16 rounding of o (|o| < ~3)
# Backward errors are normalised: max |err| / max(max |ref|, 1). dk and dv
# sum over up to T query rows, so their size grows with T; the floor of 1
# keeps a gradient that is exactly 0 (dq and dk at T = 1, where do.v equals
# delta) from dividing rounding noise by rounding noise.
BWD_FP32_TOL = 1e-5  # fp32, TF32 off: summation order over up to T terms
BWD_BF16_TOL = 1e-2  # bf16 output vs the plain version in fp32 on the same
#                      bf16 inputs: one bf16 rounding (2^-9 relative) each
LOGIT_TOL = 1e-3  # GPT-2 logits, card vs CPU, fp32 through 12 layers
GREEDY_TOL = 1e-3  # a card-chosen greedy token vs the CPU's max logit
# fp32 train step, card vs CPU from the same weights: loss and grad_norm to
# 1e-4 relative and every gradient to 1e-4 of its tensor's norm (12 fp32
# layers forward and backward, summation orders differ); parameters after
# the step to 2 * lr (Adam's first step moves each weight by about lr
# whatever its gradient's size, so a near-0 gradient whose sign differs
# moves a weight by up to 2 * lr) plus 1e-6 of rounding.
TRAIN_REL_TOL = 1e-4

# correctness cases (every one in fp32 and bf16): GPT-2's head dim at
# ragged and aligned lengths, and the kernels' other head dims, 32 and 128
KERNEL_SHAPES = ([(1, 12, t, 64) for t in (1, 7, 100, 512, 1024)] + [(2, 4, 128, 32)]
                 + [(1, 4, t, d) for d in (32, 128) for t in (1, 7, 100, 512)])
TRAIN_SHAPE = (16, 12, 1024, 64)   # GPT-2-124M attention at B = 16, T = 1024
# (shape, dtype) pairs timed: the serving widths (fp32 and bf16 prompts) and
# the training shapes (bf16, as the bf16 train step gives them)
TIMED_FWD = [((1, 12, t, 64), dt) for t in (512, 1024)
             for dt in (torch.float32, torch.bfloat16)] + [(TRAIN_SHAPE, torch.bfloat16)]
TIMED_BWD = [((1, 12, 1024, 64), torch.bfloat16), (TRAIN_SHAPE, torch.bfloat16)]
HEADLINE = (TRAIN_SHAPE, torch.bfloat16)  # the training path's shape and type

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s for
# the inputs' type (fp32 outside the tensor cores; bf16 dense tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# which design runs each kernel, by dtype (csrc/: the entry points choose)
TENSOR_CORES = "sm90 wgmma+TMA, bf16"
CUDA_CORES = "CUDA cores, fp32"
DESIGN = {"flash_attn_fwd": {"bfloat16": TENSOR_CORES, "float32": CUDA_CORES},
          "flash_attn_bwd_dq": {"bfloat16": TENSOR_CORES, "float32": CUDA_CORES},
          "flash_attn_bwd_dkv": {"bfloat16": TENSOR_CORES, "float32": CUDA_CORES}}

SERVE_WIDTH = (12, 12, 768, 50257, 1024)  # layers, heads, width, vocab, context
FORWARD_SHAPE = (4, 512)      # the fp32 forward checked against the CPU
TRAIN_BATCH = (16, 1024)      # bench.py's GPT-2-124M batch
TRAIN_STEPS = 5               # timed steps after one warm-up step
PARITY_BATCH = (2, 128)       # the fp32 card-vs-CPU step
SERVE_PROMPT_LENS = (16, 41, 97, 150, 233, 318, 480, 600)
SERVE_MAX_TOKENS = 32
SHARED_PREFIX = 64
# layers, heads, KV heads, width, SwiGLU width, vocab, context
LLAMA_WIDTH = (12, 12, 4, 768, 2048, 32000, 1024)
SPEC_K = 4                    # draft tokens per speculative round
# layers, heads, width, vocab, experts, top-k, an MoE block every n-th
MOE_WIDTH = (12, 12, 768, 50257, 8, 2, 2)
MOE_TRAIN_BATCH = (8, 1024)
MOE_TRAIN_STEPS = 3           # timed steps after one warm-up step


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Time of one call on the card: CUDA events around a window of `iters`
    back-to-back calls, divided by `iters`; the median of three windows.
    A window keeps the card's queue full, so the host's time to launch a
    call is hidden wherever it is shorter than the call itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes. The
    kernel phases make their inputs on the CPU from fixed seeds, so two
    commits whose digests agree gave bitwise the same outputs."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def norm_err(got, ref) -> float:
    """max |got - ref| / max(max |ref|, 1), in fp32."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def attention_flops(shape, per_pair: int) -> int:
    """FLOP of `per_pair` * d per visible (query, key) pair, causal."""
    b, h, t, d = shape
    return per_pair * d * b * h * t * (t + 1) // 2


def rates(ms: float, shape, per_pair: int, bound_ms: float, library_ms: float):
    """Achieved TFLOP/s, share of the bound and ratio to the library call."""
    return {"tflops": attention_flops(shape, per_pair) / (ms * 1e-3) / 1e12,
            "bound_share": bound_ms / ms, "vs_library": ms / library_ms}


def attention_bound(shape, dtype):
    """Least time (ms) for causal attention on these inputs: each of q, k,
    v read once and o, lse written once over HBM bandwidth, against the
    causal products (2 * d multiply-adds per visible (query, key) pair) over
    the peak rate of the inputs' type. Returns (ms, "bytes"|"operations")."""
    b, h, t, d = shape
    bh = b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * t * d * esize + bh * t * 4
    flops = attention_flops(shape, 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound(shape, dtype, kernel: str):
    """Least time (ms) for one backward kernel on these inputs. Bytes: q, k,
    v and do read once, lse and delta (fp32) read once, and the kernel's
    outputs written once (dq for "dq"; dk and dv for "dkv"), over HBM
    bandwidth. Operations: per visible (query, key) pair the dq kernel does
    3 products of 2 * d FLOP (q.k, do.v, ds*k), 6 * d, and the dk/dv kernel
    4, 8 * d (q.k, do.v, p*do, ds*q), over the peak rate of the inputs'
    type. Returns (ms, "bytes"|"operations")."""
    b, h, t, d = shape
    bh = b * h
    esize = torch.finfo(dtype).bits // 8
    outputs = 1 if kernel == "dq" else 2
    nbytes = (4 + outputs) * bh * t * d * esize + 2 * bh * t * 4
    flops = attention_flops(shape, 6 if kernel == "dq" else 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------- phases


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = out.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> float:
    from ray_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    libs = _cuda.build()
    dt = time.perf_counter() - t0
    log(f"[build] {sorted(libs)} in {dt:.1f} s")
    # ptxas reports each instance as "Compiling entry function '<mangled>'"
    # followed by its spill and register lines: the fp32 CUDA-core kernels
    # are templates on <float, d>, the bf16 tensor-core ones on <d>
    entry = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)IfLi(\d+)E")
    entry90 = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_sm90_kernel)ILi(\d+)E")
    spills = []
    for name in sorted(libs):
        label = name
        for line in _cuda.build_log(name).splitlines():
            found, found90 = entry.search(line), entry90.search(line)
            if found:
                label = "{}<float, {}>".format(*found.groups())
            elif found90:
                label = "{}<bf16, {}>".format(*found90.groups())
            elif "registers" in line or "spill" in line:
                log(f"[build] {label}: {line.split(':', 1)[-1].strip()}")
                if "_sm90_" in label and re.search(r"[1-9]\d* bytes spill", line):
                    spills.append(f"{label}: {line.strip()}")
    # the tensor-core designs are sized to keep their accumulators in
    # registers: a spill is a fault of the build, not a slow path
    if spills:
        raise AssertionError(f"tensor-core kernels spill: {spills}")
    return dt


def phase_kernel(card: str):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator().manual_seed(0)
    cases = []
    checked = [(shape, dt) for shape in KERNEL_SHAPES
               for dt in (torch.float32, torch.bfloat16)] + [HEADLINE]
    for shape, dtype in checked:
        q, k, v = (torch.randn(shape, generator=gen).to(DEVICE, dtype)
                   for _ in range(3))
        o, lse = attention.flash_causal_attention_fwd(q, k, v)
        o2, lse2 = attention.flash_causal_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        repeatable = torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = attention.plain_causal_attention_fwd(
            q.float(), k.float(), v.float())
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"non-finite kernel output at {shape} {dtype}")
        err_o = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        case = {"shape": list(shape), "dtype": dtype_name(dtype),
                "design": DESIGN["flash_attn_fwd"][dtype_name(dtype)],
                "err_o": err_o, "err_lse": err_lse, "tol": tol,
                "repeatable": repeatable, "digest": digest(o, lse)}
        if (shape, dtype) in TIMED_FWD:
            bound_ms, bound_by = attention_bound(shape, dtype)
            case.update(
                ms=cuda_ms(lambda: attention.flash_causal_attention_fwd(q, k, v)),
                plain_ms=cuda_ms(lambda: attention.plain_causal_attention_fwd(q, k, v)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)),
                bound_ms=bound_ms, bound_by=bound_by)
            case.update(rates(case["ms"], shape, 4, bound_ms, case["library_ms"]))
        log(f"[kernel] {json.dumps(case)}")
        if err_o > tol or err_lse > tol or not repeatable:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                 f"version or is not repeatable: {case}")
        cases.append(case)
        del q, k, v, o, lse, o2, lse2, o_ref, lse_ref
    for c in cases:
        if "ms" in c:
            log(f"[kernel] flash_attn_fwd {c['shape']} {c['dtype']} ({c['design']}): "
                f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, SDPA "
                f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']}); {c['tflops']:.1f} TFLOP/s, "
                f"{c['bound_share']:.3f} of the bound, {c['vs_library']:.2f}x SDPA "
                f"on {card}")
    return cases


def phase_bwd(card: str):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator().manual_seed(1)
    cases = []
    checked = [(shape, dt) for shape in KERNEL_SHAPES
               for dt in (torch.float32, torch.bfloat16)] + [HEADLINE]
    for shape, dtype in checked:
        q, k, v, do = (torch.randn(shape, generator=gen).to(DEVICE, dtype)
                       for _ in range(4))
        o, lse = attention.flash_causal_attention_fwd(q, k, v)
        grads = attention.flash_causal_attention_bwd(q, k, v, o, lse, do)
        # the remat recompute must give what the first forward gave, and two
        # backward runs the same gradients: both bitwise (no atomics)
        o2, lse2 = attention.flash_causal_attention_fwd(q, k, v)
        again = attention.flash_causal_attention_bwd(q, k, v, o2, lse2, do)
        torch.cuda.synchronize()
        repeatable = all(torch.equal(a, b) for a, b in
                         zip((o, lse) + grads, (o2, lse2) + again))
        ref = attention.plain_causal_attention_bwd(
            q.float(), k.float(), v.float(), o.float(), lse, do.float())
        names = ("dq", "dk", "dv")
        case = {"shape": list(shape), "dtype": dtype_name(dtype),
                "design": {n: DESIGN[n][dtype_name(dtype)] for n in
                           ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")},
                "repeatable": repeatable,
                "digest": {n: digest(g) for n, g in zip(names, grads)},
                "err": {n: norm_err(g, r) for n, g, r in zip(names, grads, ref)},
                "abs_err": {n: (g.float() - r).abs().max().item()
                            for n, g, r in zip(names, grads, ref)},
                "tol": BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL}
        if dtype == torch.float32:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(attention.plain_causal_attention(*leaves),
                                       leaves, do)
            case["err_vs_autograd"] = {n: norm_err(g, a) for n, g, a in
                                       zip(names, grads, auto)}
        if (shape, dtype) in TIMED_BWD:
            delta = (o.float() * do.float()).sum(dim=-1)
            qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            for kernel, fn in (("dq", attention.launch_bwd_dq),
                               ("dkv", attention.launch_bwd_dkv)):
                bound_ms, bound_by = attention_bwd_bound(shape, dtype, kernel)
                case[kernel] = {
                    "ms": cuda_ms(lambda: fn(q, k, v, do, lse, delta)),
                    "bound_ms": bound_ms, "bound_by": bound_by}
            case.update(
                bwd_ms=cuda_ms(lambda: attention.flash_causal_attention_bwd(
                    q, k, v, o, lse, do)),
                plain_ms=cuda_ms(lambda: attention.plain_causal_attention_bwd(
                    q, k, v, o, lse, do)),
                library_ms=cuda_ms(lambda: torch.autograd.grad(
                    sdpa_out, (qs, ks, vs), do, retain_graph=True)))
            for kernel, per_pair in (("dq", 6), ("dkv", 8)):
                case[kernel].update(rates(case[kernel]["ms"], shape, per_pair,
                                          case[kernel]["bound_ms"], case["library_ms"]))
            del delta, qs, ks, vs, sdpa_out
        log(f"[bwd] {json.dumps(case)}")
        finite = all(torch.isfinite(g).all() for g in grads)
        errs = list(case["err"].values()) + list(case.get("err_vs_autograd", {}).values())
        if not finite or not repeatable or max(errs) > case["tol"]:
            raise AssertionError(f"flash_attn_bwd disagrees with its plain "
                                 f"version or is not repeatable: {case}")
        cases.append(case)
        del q, k, v, do, o, lse, o2, lse2, grads, again, ref
    for c in cases:
        if "dq" in c:
            for kernel, name in (("dq", "flash_attn_bwd_dq"), ("dkv", "flash_attn_bwd_dkv")):
                r = c[kernel]
                log(f"[bwd] {name} {c['shape']} {c['dtype']} ({c['design'][name]}): "
                    f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}); "
                    f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the bound, "
                    f"{r['vs_library']:.2f}x SDPA's whole backward on {card}")
            log(f"[bwd] {c['shape']} {c['dtype']}: whole backward {c['bwd_ms']:.4f} ms, "
                f"plain {c['plain_ms']:.4f}, SDPA backward {c['library_ms']:.4f} "
                f"on {card}")
    torch.cuda.empty_cache()
    return cases


def check_forward(card: str, tag: str, name: str, model, vocab: int) -> None:
    """``model``'s fp32 forward at FORWARD_SHAPE on the card against a CPU
    copy of the same weights (the plain path): logits within LOGIT_TOL and
    one forward kernel launch per layer."""
    from ray_tpu_torch.ops import attention

    idx = torch.randint(0, vocab, FORWARD_SHAPE,
                        generator=torch.Generator().manual_seed(1))
    cpu_model = copy.deepcopy(model).to("cpu")
    idx_card = idx.to(DEVICE)
    attention.FLASH_FWD_LAUNCHES = 0
    with torch.inference_mode():
        logits = model(idx_card)
        torch.cuda.synchronize()
        launches = attention.FLASH_FWD_LAUNCHES
        ms = cuda_ms(lambda: model(idx_card), iters=5, warmup=1)
        ref = cpu_model(idx)
    n_layer = model.config.n_layer
    if launches != n_layer:
        raise AssertionError(f"forward launched the kernel {launches} times, "
                             f"expected {n_layer}")
    got = logits.cpu()
    err = (got - ref).abs().max().item()
    if got.shape != FORWARD_SHAPE + (vocab,) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits {tuple(got.shape)}")
    log(f"[{tag}] {name} fp32 forward {FORWARD_SHAPE}: {ms:.2f} ms on {card}; "
        f"kernel launches {launches}; max |logit - cpu| {err:.3g}")
    if err > LOGIT_TOL:
        raise AssertionError(f"card logits differ from the CPU plain path by {err}")


def phase_model(card: str) -> None:
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_params

    cfg = GPT2Config.gpt2_124m(dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0), device=DEVICE)
    check_forward(card, "model", "gpt2-124m", model, cfg.vocab_size)
    del model
    torch.cuda.empty_cache()


def serve_prompts(vocab: int):
    """The serve phases' 8 prompts (16-600 tokens); requests 3 and 4 share
    their first SHARED_PREFIX tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    prompts = [rng.integers(0, vocab, n).tolist() for n in SERVE_PROMPT_LENS]
    prompts[3] = shared + prompts[3][SHARED_PREFIX:]
    prompts[4] = shared + prompts[4][SHARED_PREFIX:]
    return prompts


def drive_engine(engine, prompts, max_tokens: int):
    """Submit every prompt but the fifth, step once (request 3's blocks are
    then indexed), submit the fifth (a prefix-cache hit on request 3's
    first 64 tokens), drain. Returns ({request: tokens}, wall seconds),
    after checking every request ran to its length and the cache is whole
    and empty."""
    from ray_tpu_torch.serve.llm import SamplingParams

    sp = SamplingParams(max_tokens=max_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = {i: engine.submit(p, sp) for i, p in enumerate(prompts) if i != 4}
    engine.step()
    if len(prompts) > 4:
        rids[4] = engine.submit(prompts[4], sp)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outputs = {}
    for i, rid in sorted(rids.items()):
        toks, done, reason = engine.pull(rid)
        if not done or reason != "length" or len(toks) != max_tokens:
            raise AssertionError(f"request {i}: done={done} reason={reason} "
                                 f"tokens={len(toks)}")
        outputs[i] = toks
    for cache in (engine.cache, engine.draft_cache):
        if cache is None:
            continue
        problems = cache.check_integrity()
        if problems:
            raise AssertionError(f"KV cache integrity: {problems}")
        cache.assert_no_leaks()
        if cache.num_used_blocks != 0:
            raise AssertionError("KV blocks still held after drain")
    return outputs, wall


def greedy_gaps(cpu_model, prompts, outputs):
    """Teacher-forced on the CPU plain forward: per request, how far each
    generated token's logit lies below the position's max logit."""
    gaps = {}
    with torch.inference_mode():
        for i, toks in outputs.items():
            ctx = torch.tensor([prompts[i] + toks])
            logits = cpu_model(ctx)[0, len(prompts[i]) - 1:-1].float()
            chosen = logits[torch.arange(len(toks)), torch.tensor(toks)]
            gaps[i] = (logits.max(dim=-1).values - chosen).tolist()
    return gaps


def serve_run(card: str, tag: str, adapter):
    """The serving path on ``adapter`` at full width: 8 requests, one
    prefix-cache hit, SERVE_MAX_TOKENS greedy tokens each; the forward
    kernel's launches, the cache's integrity, and every greedy token
    teacher-forced against the CPU plain forward. Returns (launches,
    prompts, outputs, cpu_model)."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = adapter.cfg
    engine = LLMEngine(adapter)
    prompts = serve_prompts(cfg.vocab_size)

    prefills = []   # (tokens, start, ms) per adapter prefill call
    inner = adapter.prefill_ctx

    def timed_prefill(tokens, start, k_ctx, v_ctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(tokens, start, k_ctx, v_ctx)
        torch.cuda.synchronize()
        prefills.append((len(tokens), start, (time.perf_counter() - t0) * 1e3))
        return out

    adapter.prefill_ctx = timed_prefill
    attention.FLASH_FWD_LAUNCHES = 0
    outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
    launches = attention.FLASH_FWD_LAUNCHES
    del adapter.prefill_ctx

    cold = [p for p in prefills if p[1] == 0]
    hits = [p for p in prefills if p[1] > 0]
    if len(hits) != 1 or hits[0][1] != SHARED_PREFIX:
        raise AssertionError(f"expected one {SHARED_PREFIX}-token prefix hit, "
                             f"got prefills {prefills}")
    if launches < cfg.n_layer * len(cold):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(cold)} cold prefills x {cfg.n_layer} layers")

    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    log(f"[{tag}] {len(prompts)} requests x {SERVE_MAX_TOKENS} tokens in "
        f"{wall:.3f} s: {n_tokens / wall:.1f} tokens/s on {card} "
        f"(fp32, LLMEngine defaults, prefill timings synchronised)")
    for n, start, ms in prefills:
        log(f"[{tag}] prefill {n} tokens at start {start}: {ms:.2f} ms on {card}")
    log(f"[{tag}] flash_attn_fwd launches {launches} for {len(cold)} cold "
        f"prefills x {cfg.n_layer} layers; stats {engine.stats()}")

    # teacher-forced: every greedy token is the CPU plain forward's argmax
    # to within GREEDY_TOL of the max logit at its position
    cpu_model = copy.deepcopy(adapter.model).to("cpu")
    gaps = greedy_gaps(cpu_model, prompts, outputs)
    worst = max(max(g) for g in gaps.values())
    log(f"[{tag}] teacher-forced: worst greedy gap {worst:.3g} (limit {GREEDY_TOL})")
    if worst > GREEDY_TOL:
        raise AssertionError(f"a greedy token is {worst} below the CPU max logit")
    return launches, prompts, outputs, cpu_model


def phase_serve(card: str) -> int:
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    adapter = build_adapter("gpt2", seed=0, device=DEVICE)
    cfg = adapter.cfg
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or adapter.dtype != torch.float32:
        raise AssertionError(f"not GPT-2-124M at full width in fp32: {cfg}")
    launches = serve_run(card, "serve", adapter)[0]
    del adapter
    torch.cuda.empty_cache()
    return launches


def device_kernel_times(prof):
    """{kernel name: total device microseconds} from a torch.profiler run."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def train_run(card: str, tag: str, name: str, cfg, batch_shape, steps: int,
              profiled: bool):
    """``TrainStep(cfg)`` on the card, bf16 compute over fp32 master weights:
    one warm-up step, then ``steps`` timed steps on a repeated batch with a
    falling loss and exactly 2L forward, L dq and L dk/dv launches per step
    (forward + remat), then (if ``profiled``) one step under torch.profiler
    with its largest kernels. Returns the run's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel.train_step import TrainStep

    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    if any(p.dtype != torch.float32 for p in state["params"].parameters()):
        raise AssertionError("master weights are not fp32")
    n_params = sum(p.numel() for p in state["params"].parameters())
    # an MoE token runs top_k of num_experts experts: the active count keeps
    # that share of the expert stacks (wi, wo)
    experts = sum(p.numel() for n, p in state["params"].named_parameters()
                  if n.endswith((".moe.wi", ".moe.wo")))
    moe = getattr(cfg, "moe", None)
    n_active = n_params - experts + (experts * moe.top_k // moe.num_experts
                                     if moe else 0)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, cfg.vocab_size, batch_shape)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    state, m = ts.step(state, batch)     # warm-up, booked as the compile step
    warm_s = time.perf_counter() - t0
    losses, norms, step_ms, counts = [m["loss"].item()], [m["grad_norm"].item()], [], []
    for _ in range(steps):
        attention.FLASH_FWD_LAUNCHES = 0
        attention.FLASH_BWD_DQ_LAUNCHES = 0
        attention.FLASH_BWD_DKV_LAUNCHES = 0
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)   # ends in a synchronise (telemetry)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append((attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DQ_LAUNCHES,
                       attention.FLASH_BWD_DKV_LAUNCHES))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    summary = ts.telemetry.summary()
    tokens_per_s = summary["tokens_per_s"]
    # the exact 6N count (every parameter, the untied head included) beside
    # the recorder's estimate 12 L d^2 + V d
    exact_mfu = 6 * n_active * tokens_per_s / PEAK_FLOPS[torch.bfloat16]
    log(f"[{tag}] {name} {dtype_name(cfg.dtype)} compute / fp32 params, batch {batch_shape}: "
        f"warm-up {warm_s:.2f} s, then steps {[round(x, 2) for x in step_ms]} ms "
        f"on {card}")
    log(f"[{tag}] loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, launches per step (fwd, dq, dkv) {counts}")
    log(f"[{tag}] recorder: {json.dumps(summary)}; at the median step "
        f"{batch_shape[0] * batch_shape[1] / (statistics.median(step_ms) / 1e3):.0f} "
        f"tokens/s")
    log(f"[{tag}] {n_params} parameters, {n_active} active per token; MFU "
        f"{summary.get('mfu')} by the recorder's 12 L d^2 + V d count, "
        f"{exact_mfu:.6f} by the exact 6N count of active parameters "
        f"({6 * n_active:.4g} FLOP per token) over 989 TFLOP/s")
    want = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
    if any(c != want for c in counts):
        raise AssertionError(f"launches per step {counts}, expected {want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    out = {"step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "losses": losses, "grad_norms": norms, "n_params": n_params,
           "n_active_params": n_active,
           "exact_mfu": exact_mfu,
           "median_tokens_per_s": batch_shape[0] * batch_shape[1]
                                  / (statistics.median(step_ms) / 1e3),
           "launches": [sum(c[i] for c in counts) for i in range(3)],
           "launches_per_step": list(want), "summary": summary}

    if profiled:   # where one step's device time goes
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = ts.step(state, batch)
            prof_ms = (time.perf_counter() - t0) * 1e3
        kernel_us = device_kernel_times(prof)
        busy_ms = sum(kernel_us.values()) / 1e3
        attn_ms = sum(us for name, us in kernel_us.items() if "flash_" in name) / 1e3
        top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:16]
        log(f"[{tag}] profiled step: wall {prof_ms:.2f} ms, kernels {busy_ms:.2f} ms "
            f"({len(kernel_us)} distinct), hand-written attention kernels "
            f"{attn_ms:.2f} ms = {attn_ms / max(busy_ms, 1e-9):.3f} of kernel time")
        for name, us in top:
            log(f"[{tag}]   {us / 1e3:9.3f} ms  {name[:110]}")
        out.update(profiled_step_ms=prof_ms, attention_ms_profiled=attn_ms,
                   kernel_ms_profiled=busy_ms)
        del prof
    del ts, state, batch, m
    torch.cuda.empty_cache()
    return out


def phase_train(card: str):
    from ray_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.gpt2_124m()   # JAX's default: bf16 compute, remat
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or cfg.dtype != torch.bfloat16 or not cfg.remat:
        raise AssertionError(f"not GPT-2-124M at full width in bf16: {cfg}")
    train = train_run(card, "train", "gpt2-124m", cfg, TRAIN_BATCH, TRAIN_STEPS,
                      profiled=True)
    train["parity"] = train_parity(card, "train", GPT2Config.gpt2_124m(dtype=torch.float32))
    return train


def train_parity(card: str, tag: str, cfg):
    """One fp32 step at full width on the card and on the CPU plain path
    from the same weights (drawn on the CPU from one seed)."""
    from ray_tpu_torch.parallel.train_step import TrainStep

    card_ts = TrainStep(cfg, device=DEVICE, telemetry=False)
    host_ts = TrainStep(cfg, device="cpu", telemetry=False)
    card_state = card_ts.init(torch.Generator().manual_seed(1))
    host_state = host_ts.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    idx = rng.integers(0, cfg.vocab_size, PARITY_BATCH)
    raw = {"idx": idx, "targets": np.roll(idx, -1, axis=1)}
    cb, hb = card_ts.shard_batch(raw), host_ts.shard_batch(raw)

    loss_c, grads_c = card_ts.loss_and_grads(card_state, cb)
    loss_h, grads_h = host_ts.loss_and_grads(host_state, hb)
    grad_err = max(((grads_c[n].cpu() - g).norm() / g.norm()).item()
                   for n, g in grads_h.items() if g.norm() > 0)
    card_state, mc = card_ts.step(card_state, cb)
    host_state, mh = host_ts.step(host_state, hb)
    rel = lambda a, b: abs(a - b) / abs(b)
    out = {"loss_card": loss_c.item(), "loss_cpu": loss_h.item(),
           "loss_rel_err": rel(loss_c.item(), loss_h.item()),
           "grad_norm_rel_err": rel(mc["grad_norm"].item(), mh["grad_norm"].item()),
           "step_loss_rel_err": rel(mc["loss"].item(), mh["loss"].item()),
           "grad_rel_err": grad_err,
           "param_abs_err": max((p.detach().cpu() - q.detach()).abs().max().item()
                                for p, q in zip(card_state["params"].parameters(),
                                                host_state["params"].parameters()))}
    log(f"[{tag}] fp32 step {PARITY_BATCH}, card vs CPU plain path: {json.dumps(out)}")
    param_tol = 2 * card_ts.learning_rate + 1e-6
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"], out["step_loss_rel_err"],
            out["grad_rel_err"]) > TRAIN_REL_TOL or out["param_abs_err"] > param_tol):
        raise AssertionError(f"card train step differs from the CPU plain path: {out}")
    del card_ts, card_state, host_ts, host_state
    torch.cuda.empty_cache()
    return out


def phase_llama(card: str):
    """Llama-160M at full width (GQA: k/v repeated from 4 to 12 heads
    before the kernels): forward against the CPU, serving, training, and
    one fp32 step against the CPU."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    cfg = LlamaConfig.llama_160m(dtype=torch.float32)
    width = (cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.n_embd, cfg.mlp_dim,
             cfg.vocab_size, cfg.block_size)
    if width != LLAMA_WIDTH:
        raise AssertionError(f"not Llama-160M at full width: {width}")
    model = init_params(cfg, torch.Generator().manual_seed(0), device=DEVICE)
    check_forward(card, "llama", "llama-160m", model, cfg.vocab_size)
    del model

    adapter = build_adapter("llama-160m", seed=0, device=DEVICE)
    if adapter.dtype != torch.float32 or adapter.cfg != cfg:
        raise AssertionError(f"not Llama-160M in fp32: {adapter.cfg}")
    serve_launches, prompts, outputs, cpu_model = serve_run(card, "llama", adapter)
    del adapter
    torch.cuda.empty_cache()

    train = train_run(card, "llama", "llama-160m", LlamaConfig.llama_160m(),
                      TRAIN_BATCH, TRAIN_STEPS, profiled=True)
    train["parity"] = train_parity(card, "llama", cfg)
    return {"serve_launches": serve_launches, "train": train, "prompts": prompts,
            "outputs": outputs, "cpu_model": cpu_model}


def phase_spec(card: str, prompts, serve_outputs, cpu_model):
    """Speculative decoding on the card: the Llama-160M target answers the
    serve phases' prompts without a draft and with each of two drafts (the
    target's own weights from its seed; llama-tiny at vocabulary 32000).
    Every speculative stream must equal the plain one; where one differs,
    its first differing token and every token after must lie within
    GREEDY_TOL of the CPU plain forward's max logit (a near tie)."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    target = build_adapter("llama-160m", seed=0, device=DEVICE)
    drafts = {"same-seed llama-160m": build_adapter("llama-160m", seed=0, device=DEVICE),
              "llama-tiny": build_adapter(
                  "llama-tiny", {"vocab_size": 32000, "block_size": 1024}, seed=0,
                  device=DEVICE)}
    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    attention.FLASH_FWD_LAUNCHES = 0
    plain, wall = drive_engine(LLMEngine(target), prompts, SERVE_MAX_TOKENS)
    # the plain engine again, without the serve phase's prefill timing: the
    # same streams, or (checked against the CPU) near-greedy ones
    replay_equal = plain == serve_outputs
    if not replay_equal:
        gaps = greedy_gaps(cpu_model, prompts, plain)
        if max(max(g) for g in gaps.values()) > GREEDY_TOL:
            raise AssertionError("the plain replay leaves the greedy stream")
    log(f"[spec] plain: {n_tokens / wall:.1f} tokens/s on {card}; streams equal to "
        f"the llama serve phase's: {replay_equal}")
    results = {"plain_tokens_per_s": n_tokens / wall, "plain_replay_equal": replay_equal}
    for name, draft in drafts.items():
        engine = LLMEngine(target, draft_adapter=draft, spec_k=SPEC_K)
        outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
        differ = {i: next(c for c, (a, b) in enumerate(zip(toks, plain[i])) if a != b)
                  for i, toks in outputs.items() if toks != plain[i]}
        worst = 0.0
        if differ:   # each differing stream must be near-greedy from there on
            gaps = greedy_gaps(cpu_model, prompts, {i: outputs[i] for i in differ})
            worst = max(max(g[differ[i]:]) for i, g in gaps.items())
        stats = engine.stats()
        res = {"acceptance": engine.spec_acceptance(),
               "rounds": stats["spec_rounds_total"], "steps": stats["steps_total"],
               "tokens_per_s": n_tokens / wall, "streams_equal": len(prompts) - len(differ),
               "first_differences": differ, "worst_gap_after_difference": worst}
        log(f"[spec] draft {name}, k = {SPEC_K}: {json.dumps(res)} on {card}")
        if worst > GREEDY_TOL:
            raise AssertionError(f"speculative stream with draft {name} leaves the "
                                 f"plain stream by more than a near tie: {res}")
        results[name] = res
    results["launches"] = attention.FLASH_FWD_LAUNCHES
    if results["launches"] == 0:
        raise AssertionError("the spec runs launched no forward kernel")
    if results["same-seed llama-160m"]["acceptance"] < 0.5:
        raise AssertionError(f"a draft with the target's own weights accepted "
                             f"{results['same-seed llama-160m']['acceptance']}")
    del target, drafts
    torch.cuda.empty_cache()
    return results


def routing_of(model, idx):
    """Per MoE block, the dispatch mask (B, S, E, C) its router gives the
    block's input in a forward of ``idx`` on ``model``'s device."""
    from ray_tpu_torch.models.gpt2_moe import MoEBlock
    from ray_tpu_torch.ops.moe import top_k_routing

    seen = []
    hooks = [blk.moe.register_forward_pre_hook(lambda mod, args: seen.append(
        (mod, args[0].detach()))) for blk in model.h if isinstance(blk, MoEBlock)]
    with torch.no_grad():
        model(idx)
    for h in hooks:
        h.remove()
    out = []
    for mod, x in seen:
        probs = torch.softmax(mod.router(x.float()), dim=-1)
        dispatch, _ = top_k_routing(probs, mod.moe.top_k, mod.capacity(x.shape[1]))
        out.append((dispatch.cpu(), probs.cpu()))
    return out


def phase_moe(card: str):
    """GPT-2-MoE (GPT2MoEConfig(): GPT-2-124M widths, 8 experts, top-2,
    an MoE block every 2nd layer) trains on the card; one fp32 step against
    the CPU, dispatch masks first; gpt2-moe-tiny serves against the CPU."""
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    cfg = GPT2MoEConfig()
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.moe.num_experts,
            cfg.moe.top_k, cfg.moe_every) != MOE_WIDTH or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"not the JAX package's default GPT-2-MoE: {cfg}")
    train = train_run(card, "moe", "gpt2-moe", cfg, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS,
                      profiled=False)

    # fp32 step against the CPU: the routing first, so that a flip from a
    # near tie shows as such and not as a gradient error
    fp32 = GPT2MoEConfig(dtype=torch.float32)
    model = init_params(fp32, torch.Generator().manual_seed(1), device=DEVICE)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, fp32.vocab_size, PARITY_BATCH))
    card_routes = routing_of(model, idx.to(DEVICE))
    host_routes = routing_of(copy.deepcopy(model).to("cpu"), idx)
    flips = []
    for layer, ((dc, pc), (dh, ph)) in enumerate(zip(card_routes, host_routes)):
        rows = (dc != dh).flatten(2).any(-1).nonzero().tolist()
        for b, s in rows:
            top = ph[b, s].sort(descending=True).values
            flips.append({"layer": layer, "token": [b, s],
                          "gap_k_k1": (top[cfg.moe.top_k - 1] - top[cfg.moe.top_k]).item()})
    log(f"[moe] fp32 routing {PARITY_BATCH}, card vs CPU: "
        f"{sum(d.sum().item() for d, _ in card_routes):.0f} dispatched slots over "
        f"{len(card_routes)} MoE blocks, flips {flips}")
    if flips:
        raise AssertionError(f"dispatch masks differ between card and CPU (gaps "
                             f"between the k-th and next expert's probability): {flips}")
    del model
    train["parity"] = train_parity(card, "moe", fp32)

    # gpt2-moe-tiny serves 4 requests (dropless routing) on the card and on
    # the CPU from one seed; the streams must be equal
    prompts = [np.random.default_rng(i).integers(0, 512, n).tolist()
               for i, n in enumerate((5, 17, 40, 90))]
    streams, adapters = {}, {}
    for key, dev in (("card", DEVICE), ("cpu", "cpu")):
        adapters[key] = build_adapter("gpt2-moe-tiny", seed=0, device=dev)
        engine = LLMEngine(adapters[key])
        rids = [engine.submit(p, SamplingParams(max_tokens=16)) for p in prompts]
        engine.run_until_drained()
        streams[key] = [engine.pull(r)[0] for r in rids]
        engine.cache.assert_no_leaks()
        if any(len(t) != 16 for t in streams[key]):
            raise AssertionError(f"gpt2-moe-tiny on {dev}: {streams[key]}")
    # where a card stream differs, every token from the first difference on
    # must lie within GREEDY_TOL of the CPU adapter's max logit (a near tie)
    worst = 0.0
    for p, card_toks, cpu_toks in zip(prompts, streams["card"], streams["cpu"]):
        if card_toks == cpu_toks:
            continue
        first = next(c for c, (a, b) in enumerate(zip(card_toks, cpu_toks)) if a != b)
        for c in range(first, len(card_toks)):
            logits = adapters["cpu"].prefill(np.asarray(p + card_toks[:c]))[0]
            worst = max(worst, (logits.max() - logits[card_toks[c]]).item())
    equal = sum(a == b for a, b in zip(streams["card"], streams["cpu"]))
    log(f"[moe] gpt2-moe-tiny serving 4 requests x 16 tokens: {equal} of 4 card "
        f"streams equal the CPU's; worst gap after a difference {worst:.3g} "
        f"(limit {GREEDY_TOL})")
    if worst > GREEDY_TOL:
        raise AssertionError(f"gpt2-moe-tiny card streams leave the CPU's: {streams}")
    train["serve_streams_equal"] = equal
    torch.cuda.empty_cache()
    return train


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)
    from ray_tpu_torch._private.device import set_fp32_policy

    set_fp32_policy()
    card = phase_device()
    phase_build()
    fwd_cases = phase_kernel(card)
    bwd_cases = phase_bwd(card)
    phase_model(card)
    serve_launches = phase_serve(card)
    train = phase_train(card)
    llama = phase_llama(card)
    spec = phase_spec(card, llama["prompts"], llama["outputs"], llama.pop("cpu_model"))
    moe = phase_moe(card)

    fwd_head = next(c for c in fwd_cases if "ms" in c and c["shape"] == list(HEADLINE[0])
                    and c["dtype"] == dtype_name(HEADLINE[1]))
    bwd_head = next(c for c in bwd_cases if "dq" in c and c["shape"] == list(HEADLINE[0])
                    and c["dtype"] == dtype_name(HEADLINE[1]))

    at = {"shape": list(HEADLINE[0]), "dtype": dtype_name(HEADLINE[1])}
    fp32_bwd = [c for c in bwd_cases if c["dtype"] == "float32"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:42",
        "launches": train["launches"][0],
        "launches_by_path": {"train": train["launches"][0], "serve": serve_launches,
                             "llama_train": llama["train"]["launches"][0],
                             "llama_serve": llama["serve_launches"],
                             "spec": spec["launches"],
                             "moe_train": moe["launches"][0]},
        "max_abs_err": max(max(c["err_o"], c["err_lse"]) for c in fwd_cases
                           if c["dtype"] == "float32"),
        "max_abs_err_by_dtype": {dt: max(max(c["err_o"], c["err_lse"]) for c in fwd_cases
                                         if c["dtype"] == dt)
                                 for dt in ("float32", "bfloat16")},
        "ms": fwd_head["ms"],
        "plain_ms": fwd_head["plain_ms"],
        "bound_ms": fwd_head["bound_ms"],
        "bound_by": fwd_head["bound_by"],
        "library_ms": fwd_head["library_ms"],
        "design": DESIGN["flash_attn_fwd"],
        "tflops": fwd_head["tflops"],
        "bound_share": fwd_head["bound_share"],
        "at": dict(at, max_abs_err_over="o and lse, every fp32 case",
                   library="SDPA forward"),
        "cases": fwd_cases,
    }]
    for name, kernel, outputs, line in (("flash_attn_bwd_dq", "dq", ("dq",), 114),
                                        ("flash_attn_bwd_dkv", "dkv", ("dk", "dv"), 146)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            "launches": train["launches"][1 if kernel == "dq" else 2],
            "launches_by_path": {path: run["launches"][1 if kernel == "dq" else 2]
                                 for path, run in (("train", train),
                                                   ("llama_train", llama["train"]),
                                                   ("moe_train", moe))},
            "max_abs_err": max(c["abs_err"][o] for c in fp32_bwd for o in outputs),
            "max_abs_err_by_dtype": {dt: max(c["abs_err"][o] for c in bwd_cases
                                             if c["dtype"] == dt for o in outputs)
                                     for dt in ("float32", "bfloat16")},
            "ms": bwd_head[kernel]["ms"],
            "plain_ms": bwd_head["plain_ms"],
            "bound_ms": bwd_head[kernel]["bound_ms"],
            "bound_by": bwd_head[kernel]["bound_by"],
            "library_ms": bwd_head["library_ms"],
            "design": DESIGN[name],
            "tflops": bwd_head[kernel]["tflops"],
            "bound_share": bwd_head[kernel]["bound_share"],
            "at": dict(at, max_abs_err_over=f"{'/'.join(outputs)}, every fp32 case",
                       plain="plain_causal_attention_bwd: dq, dk and dv together",
                       library="autograd.grad of an SDPA output: dq, dk and dv "
                               "together",
                       pair_ms=bwd_head["dq"]["ms"] + bwd_head["dkv"]["ms"],
                       whole_backward_ms=bwd_head["bwd_ms"]),
        })
    kernels[1]["cases"] = bwd_cases
    log(f"[train] {json.dumps(train)}")
    llama.pop("prompts")
    llama.pop("outputs")
    log(f"[llama] {json.dumps(llama)}")
    log(f"[spec] {json.dumps(spec)}")
    log(f"[moe] {json.dumps(moe)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
