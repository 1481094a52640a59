#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card and check
every kernel of its main paths.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports nothing of
JAX or of the JAX package. Phases, in order; any failure raises and the
script exits non-zero:

  1. device  the card's name and power limit (nvidia-smi)
  2. build   compile ray_tpu_torch/csrc with nvcc, one process per source,
             all at once (timed); show ptxas's register / spill report
  3. kernel  flash_attn_fwd against its plain PyTorch version on the card,
             o and lse, fp32 and bf16, head dims 32, 64 and 128, ragged and
             aligned lengths, bitwise repeatable; times of the kernel, the
             plain version and SDPA (yardstick only) at the serving and
             training shapes, beside the least time the card could take,
             with the kernel's achieved TFLOP/s, its share of that bound
             and its ratio to SDPA
  4. bwd     flash_attn_bwd's dq and dk/dv kernels against their plain
             version on the card (and, in fp32, against autograd of the
             plain attention), fp32 and bf16, head dims 32, 64 and 128,
             ragged and aligned lengths, bitwise repeatable; times at the
             training shapes beside the bound, the plain backward and
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

Then one JSON line of kernels and, last, ``{"ok": true, "device": ...}``.
Without CUDA it exits 2 before printing any result.
"""

from __future__ import annotations

import copy
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
DEVICE = "cuda"   # the card; the kernel, bwd and train phases run on it

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
          "flash_attn_bwd_dq": {"bfloat16": CUDA_CORES, "float32": CUDA_CORES},
          "flash_attn_bwd_dkv": {"bfloat16": TENSOR_CORES, "float32": CUDA_CORES}}

SERVE_WIDTH = (12, 12, 768, 50257, 1024)  # layers, heads, width, vocab, context
TRAIN_BATCH = (16, 1024)      # bench.py's GPT-2-124M batch
TRAIN_STEPS = 5               # timed steps after one warm-up step
PARITY_BATCH = (2, 128)       # the fp32 card-vs-CPU step
SERVE_PROMPT_LENS = (16, 41, 97, 150, 233, 318, 480, 600)
SERVE_MAX_TOKENS = 32
SHARED_PREFIX = 64


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
    # followed by its spill and register lines: the CUDA-core kernels are
    # templates on <type, d>, the bf16 tensor-core ones on <d>
    entry = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
    entry90 = re.compile(r"(flash_(?:fwd|bwd_dkv)_sm90_kernel)ILi(\d+)E")
    for name in sorted(libs):
        label = name
        for line in _cuda.build_log(name).splitlines():
            found, found90 = entry.search(line), entry90.search(line)
            if found:
                kernel, dtype, d = found.groups()
                label = f"{kernel}<{'float' if dtype == 'f' else 'bf16'}, {d}>"
            elif found90:
                kernel, d = found90.groups()
                label = f"{kernel}<bf16, {d}>"
            elif "registers" in line or "spill" in line:
                log(f"[build] {label}: {line.split(':', 1)[-1].strip()}")
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
                "repeatable": repeatable}
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


def phase_model(card: str) -> None:
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_params
    from ray_tpu_torch.ops import attention

    cfg = GPT2Config.gpt2_124m(dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    idx = torch.randint(0, cfg.vocab_size, (4, 512),
                        generator=torch.Generator().manual_seed(1))
    cpu_model = copy.deepcopy(model).to("cpu")
    idx_card = idx.to("cuda")
    attention.FLASH_FWD_LAUNCHES = 0
    with torch.inference_mode():
        logits = model(idx_card)
        torch.cuda.synchronize()
        launches = attention.FLASH_FWD_LAUNCHES
        ms = cuda_ms(lambda: model(idx_card), iters=5, warmup=1)
        ref = cpu_model(idx)
    if launches != cfg.n_layer:
        raise AssertionError(f"forward launched the kernel {launches} times, "
                             f"expected {cfg.n_layer}")
    got = logits.cpu()
    err = (got - ref).abs().max().item()
    if got.shape != (4, 512, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits {tuple(got.shape)}")
    log(f"[model] gpt2-124m fp32 forward (4, 512): {ms:.2f} ms on {card}; "
        f"kernel launches {launches}; max |logit - cpu| {err:.3g}")
    if err > LOGIT_TOL:
        raise AssertionError(f"card logits differ from the CPU plain path by {err}")
    del model, logits, idx_card
    torch.cuda.empty_cache()


def phase_serve(card: str) -> int:
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    adapter = build_adapter("gpt2", seed=0)
    cfg = adapter.cfg
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or adapter.dtype != torch.float32:
        raise AssertionError(f"not GPT-2-124M at full width in fp32: {cfg}")
    engine = LLMEngine(adapter)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
    # requests 3 and 4 share the first 64 tokens
    prompts[3] = shared + prompts[3][SHARED_PREFIX:]
    prompts[4] = shared + prompts[4][SHARED_PREFIX:]

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
    sp = SamplingParams(max_tokens=SERVE_MAX_TOKENS)

    attention.FLASH_FWD_LAUNCHES = 0
    t0 = time.perf_counter()
    rids = {i: engine.submit(p, sp) for i, p in enumerate(prompts) if i != 4}
    engine.step()   # prefills request 3, whose blocks the index then holds
    rids[4] = engine.submit(prompts[4], sp)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attention.FLASH_FWD_LAUNCHES

    outputs = {}
    for i, rid in sorted(rids.items()):
        toks, done, reason = engine.pull(rid)
        if not done or reason != "length" or len(toks) != SERVE_MAX_TOKENS:
            raise AssertionError(f"request {i}: done={done} reason={reason} "
                                 f"tokens={len(toks)}")
        outputs[i] = toks
    problems = engine.cache.check_integrity()
    if problems:
        raise AssertionError(f"KV cache integrity: {problems}")
    engine.cache.assert_no_leaks()
    if engine.cache.num_used_blocks != 0:
        raise AssertionError("KV blocks still held after drain")

    cold = [p for p in prefills if p[1] == 0]
    hits = [p for p in prefills if p[1] > 0]
    if len(hits) != 1 or hits[0][1] != SHARED_PREFIX:
        raise AssertionError(f"expected one {SHARED_PREFIX}-token prefix hit, "
                             f"got prefills {prefills}")
    if launches < cfg.n_layer * len(cold):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(cold)} cold prefills x {cfg.n_layer} layers")

    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    log(f"[serve] {len(prompts)} requests x {SERVE_MAX_TOKENS} tokens in "
        f"{wall:.3f} s: {n_tokens / wall:.1f} tokens/s on {card} "
        f"(fp32, LLMEngine defaults, prefill timings synchronised)")
    for n, start, ms in prefills:
        log(f"[serve] prefill {n} tokens at start {start}: {ms:.2f} ms on {card}")
    log(f"[serve] flash_attn_fwd launches {launches} for {len(cold)} cold "
        f"prefills x {cfg.n_layer} layers; stats {engine.stats()}")

    # teacher-forced: every greedy token is the CPU plain forward's argmax
    # to within GREEDY_TOL of the max logit at its position
    cpu_model = copy.deepcopy(adapter.model).to("cpu")
    worst = 0.0
    with torch.inference_mode():
        for i, prompt in enumerate(prompts):
            ctx = torch.tensor([prompt + outputs[i]])
            logits = cpu_model(ctx)[0, len(prompt) - 1:-1]
            chosen = logits[torch.arange(SERVE_MAX_TOKENS), torch.tensor(outputs[i])]
            gap = (logits.max(dim=-1).values - chosen).max().item()
            worst = max(worst, gap)
            if gap > GREEDY_TOL:
                raise AssertionError(f"request {i}: a greedy token is {gap} "
                                     f"below the CPU max logit")
    log(f"[serve] teacher-forced: worst greedy gap {worst:.3g} (limit {GREEDY_TOL})")
    return launches


def device_kernel_times(prof):
    """{kernel name: total device microseconds} from a torch.profiler run."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def phase_train(card: str):
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel.train_step import TrainStep

    cfg = GPT2Config.gpt2_124m()   # JAX's default: bf16 compute, remat
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or cfg.dtype != torch.bfloat16 or not cfg.remat:
        raise AssertionError(f"not GPT-2-124M at full width in bf16: {cfg}")
    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    if any(p.dtype != torch.float32 for p in state["params"].parameters()):
        raise AssertionError("master weights are not fp32")
    rng = np.random.default_rng(0)
    idx = rng.integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    state, m = ts.step(state, batch)     # warm-up, booked as the compile step
    warm_s = time.perf_counter() - t0
    losses, norms, step_ms, counts = [m["loss"].item()], [m["grad_norm"].item()], [], []
    for _ in range(TRAIN_STEPS):
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
    log(f"[train] gpt2-124m bf16 compute / fp32 params, batch {TRAIN_BATCH}: "
        f"warm-up {warm_s:.2f} s, then steps {[round(x, 2) for x in step_ms]} ms "
        f"on {card}")
    log(f"[train] loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, launches per step (fwd, dq, dkv) {counts}")
    log(f"[train] recorder: {json.dumps(summary)}")
    want = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer)
    if any(c != want for c in counts):
        raise AssertionError(f"launches per step {counts}, expected {want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")

    # where one step's device time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernel_us = device_kernel_times(prof)
    busy_ms = sum(kernel_us.values()) / 1e3
    attn_ms = sum(us for name, us in kernel_us.items() if "flash_" in name) / 1e3
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:12]
    log(f"[train] profiled step: wall {prof_ms:.2f} ms, kernels {busy_ms:.2f} ms "
        f"({len(kernel_us)} distinct), hand-written attention kernels "
        f"{attn_ms:.2f} ms = {attn_ms / max(busy_ms, 1e-9):.3f} of kernel time")
    for name, us in top:
        log(f"[train]   {us / 1e3:9.3f} ms  {name[:110]}")
    train = {"step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
             "losses": losses, "grad_norms": norms,
             "launches": [sum(c[i] for c in counts) for i in range(3)],
             "summary": summary, "profiled_step_ms": prof_ms,
             "attention_ms_profiled": attn_ms, "kernel_ms_profiled": busy_ms}
    del ts, state, batch, m, prof
    torch.cuda.empty_cache()
    train["parity"] = train_parity(card)
    return train


def train_parity(card: str):
    """One fp32 step at full width on the card and on the CPU plain path
    from the same weights (drawn on the CPU from one seed)."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.train_step import TrainStep

    cfg = GPT2Config.gpt2_124m(dtype=torch.float32)
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
    log(f"[train] fp32 step {PARITY_BATCH}, card vs CPU plain path: {json.dumps(out)}")
    param_tol = 2 * card_ts.learning_rate + 1e-6
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"], out["step_loss_rel_err"],
            out["grad_rel_err"]) > TRAIN_REL_TOL or out["param_abs_err"] > param_tol):
        raise AssertionError(f"card train step differs from the CPU plain path: {out}")
    return out


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
        "launches_by_path": {"train": train["launches"][0], "serve": serve_launches},
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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
