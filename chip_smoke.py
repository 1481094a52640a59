#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card and check
every kernel of its main path.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports nothing of
JAX or of the JAX package. Phases, in order; any failure raises and the
script exits non-zero:

  1. device  the card's name and power limit (nvidia-smi)
  2. build   compile ray_tpu_torch/csrc with nvcc (timed), show ptxas's
             register / spill report
  3. kernel  flash_attn_fwd against its plain PyTorch version on the card,
             o and lse, fp32 and bf16, ragged and aligned lengths; times of
             the kernel, the plain version and SDPA (yardstick only) at the
             serving widths, beside the least time the card could take
  4. model   GPT-2-124M forward at (4, 512) on the card against the same
             weights' forward on the CPU plain path
  5. serve   the slice's main path: LLMEngine over build_adapter("gpt2") at
             full width answers 8 requests (one prefix-cache hit); the
             kernel's launch counter, the cache's integrity, and a
             teacher-forced check of every greedy token against the CPU
             plain forward

Then one JSON line of kernels and, last, ``{"ok": true, "device": ...}``.
Without CUDA it exits 2 before printing any result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

FP32_TOL = 2e-5   # kernel vs plain, both fp32 with TF32 off: summation order
BF16_TOL = 2e-2   # bf16 kernel output vs the plain version in fp32 on the
#                   same bf16 inputs: one bf16 rounding of o (|o| < ~3)
LOGIT_TOL = 1e-3  # GPT-2 logits, card vs CPU, fp32 through 12 layers
GREEDY_TOL = 1e-3  # a card-chosen greedy token vs the CPU's max logit

KERNEL_SHAPES = [(1, 12, t, 64) for t in (1, 7, 100, 512, 1024)] + [(2, 4, 128, 32)]
TIMED_T = (512, 1024)
HEADLINE = ((1, 12, 512, 64), torch.float32)  # serving width and type

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s for
# the inputs' type (fp32 outside the tensor cores; bf16 dense tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SERVE_WIDTH = (12, 12, 768, 50257, 1024)  # layers, heads, width, vocab, context
SERVE_PROMPT_LENS = (16, 41, 97, 150, 233, 318, 480, 600)
SERVE_MAX_TOKENS = 32
SHARED_PREFIX = 64


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median time of one call on the card (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(shape, dtype):
    """Least time (ms) for causal attention on these inputs: each of q, k,
    v read once and o, lse written once over HBM bandwidth, against the
    causal products (2 * d multiply-adds per visible (query, key) pair) over
    the peak rate of the inputs' type. Returns (ms, "bytes"|"operations")."""
    b, h, t, d = shape
    bh = b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * t * d * esize + bh * t * 4
    flops = 2 * 2 * d * bh * t * (t + 1) // 2
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
    for name in sorted(libs):
        for line in _cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return dt


def phase_kernel(card: str):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape in KERNEL_SHAPES:
        base = [torch.randn(shape, generator=gen) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to("cuda", dtype) for x in base)
            o, lse = attention.flash_causal_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            o_ref, lse_ref = attention.plain_causal_attention_fwd(
                q.float(), k.float(), v.float())
            if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"non-finite kernel output at {shape} {dtype}")
            err_o = (o.float() - o_ref).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            case = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                    "err_o": err_o, "err_lse": err_lse, "tol": tol}
            if shape[2] in TIMED_T:
                bound_ms, bound_by = attention_bound(shape, dtype)
                case.update(
                    ms=cuda_ms(lambda: attention.flash_causal_attention_fwd(q, k, v)),
                    plain_ms=cuda_ms(lambda: attention.plain_causal_attention_fwd(q, k, v)),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
                    bound_ms=bound_ms, bound_by=bound_by)
            log(f"[kernel] {json.dumps(case)}")
            if err_o > tol or err_lse > tol:
                raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                     f"version: {case}")
            cases.append(case)
    for c in cases:
        if "ms" in c:
            log(f"[kernel] flash_attn_fwd {c['shape']} {c['dtype']}: "
                f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, SDPA "
                f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']}) on {card}")
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
    cases = phase_kernel(card)
    phase_model(card)
    launches = phase_serve(card)

    head = next(c for c in cases if c["shape"] == list(HEADLINE[0])
                and c["dtype"] == str(HEADLINE[1]).split(".")[-1])
    fp32_err = max(max(c["err_o"], c["err_lse"]) for c in cases
                   if c["dtype"] == "float32")
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:42",
        "launches": launches,
        "max_abs_err": fp32_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": {"shape": head["shape"], "dtype": head["dtype"],
               "max_abs_err_over": "o and lse, every fp32 case"},
        "cases": cases,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
