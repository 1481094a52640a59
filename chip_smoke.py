#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card and check
every kernel of its main paths.

    python3 chip_smoke.py              # one card, every phase below
    python3 chip_smoke.py --ranks 4    # four cards: the mesh path only

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
             plain forward; the engine's six ray_tpu_llm_* series and the
             count of each llm.* flight event (a series the engine
             publishes unset, or an expected event absent, fails)
  7. train   the training path: TrainStep on GPT-2-124M at full width, bf16
             compute over fp32 master weights, B = 16, T = 1024: a warm-up
             step, then timed steps on a repeated batch with a falling
             loss and exactly 24 forward, 12 dq and 12 dk/dv launches per
             step; step time, tokens/s, MFU and peak memory from the
             port's recorder; one more step inside a device-trace window
             the recorder opens (request_device_trace(1): torch.profiler,
             written as a Chrome trace), read back for its kernel times,
             the attention kernels' share and the device's busy share; the
             recorder's slow-step flag; then one fp32 step at full width
             on (2, 128) on the card and on the CPU plain path from the
             same weights
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
 11. head_dims  head dims the kernels are not built for run on them,
             zero-padded to the next kernel size (16 to 32, 48 to 64):
             gpt2-tiny at head dim 16 serves 4 requests through a small KV
             pool (with preemptions) against the CPU, a GPT2Config(n_head=16)
             bf16 step at head dim 48 takes 24 / 12 / 12 launches and one
             fp32 step on (2, 128) agrees with the CPU, and the padded
             forward and backward at both head dims agree with the plain
             version, all with no plain call; a (5462, 12, 16, 64) bf16
             forward and backward (B * H = 65544, over the grid's 65535)
             runs the kernels in two chunks, against the plain version
 12. mesh    TrainStep on a device mesh at world size 1 over NCCL
             (make_mesh({"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}): FSDP2 over
             the one rank, the tp and sp paths off): GPT-2-124M at full
             width as in phase 7 (bf16, B = 16, T = 1024, a warm-up and five
             timed steps, 24 / 12 / 12 launches and no plain call a step,
             one more in a device-trace window), its step times beside
             phase 7's median; then one fp32 step of
             a 4-layer GPT-2-124M-width and of a 4-layer Llama-160M-width
             model on the mesh against the same step off it (loss and
             grad_norm within 1e-5 relative, parameters within 2 * lr)
 13. moe_mesh  GPT2MoEConfig() through TrainStep on the same one-rank group,
             make_mesh({"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, "ep": 1}), at
             B = 8, T = 1024 bf16 (a warm-up and three timed steps, 24 / 12 /
             12 launches and no plain call a step, one more in a
             device-trace window), its step times beside the moe phase's
             median; then one fp32 step of a 4-layer
             GPT2MoEConfig on the mesh against the same step off it (1e-5
             relative, 2 * lr)
 14. pipeline  PipelineTrainStep(GPT2Config.gpt2_124m(), make_mesh({"dp": 1,
             "pp": 1}), num_microbatches=2) at B = 16, T = 1024 bf16 (a
             warm-up and three timed steps; launches per step the
             schedule's: 12 x 2 x 2 forward with remat, 12 x 2 dq, 12 x 2
             dk/dv, no plain call); then fp32 steps of a 4-layer
             GPT-2-124M-width model on (4, 128): 4 microbatches against 1
             on the card, and the card against the port's CPU step from
             the same weights (1e-5 relative, 2 * lr)

Then one JSON line of kernels (launches and plain attention calls per
path: GPT-2 train and serve, Llama train and serve, spec, MoE train, mesh
train, MoE on the mesh, the pipeline; every full-width path must show 0
plain calls) and, last, ``{"ok": true, "device": ...}``.

With ``--ranks N`` it needs N cards and runs, after the device and build
phases, only the mesh path across them: N processes, one card each, over
NCCL (``tcp://localhost``). An all-reduce of 256 MB over every card
gives the interconnect's bus bandwidth. Each card trains GPT-2-124M alone
(the one-device step, as in phase 7); then GPT-2-124M trains on each mesh
of RANKS_TRAIN_MESHES (bf16, B = 16, T = 1024, global), launches checked
per rank (2L / L / L at sp = 1; the ring's einsum replaces the kernels at
sp > 1), step times beside the one-device median, and one more step of
each in a device-trace window (kernel time, NCCL's kernels among them,
and the device's busy share); then one fp32 step of
the 4-layer GPT-2-124M-width and Llama-160M-width models on each mesh of
RANKS_PARITY_MESHES against the one-device step on each card (loss and
grad_norm within 1e-4 relative: the sums run in another order across
ranks; parameters within 2 * lr). Then GPT2MoEConfig() trains alone on
each card and on each mesh of RANKS_MOE_MESHES ({"ep": 4}, {"dp": 2,
"ep": 2}) at B = 8, T = 1024, one step of each traced, with a 4-layer
fp32 step on each mesh against one card; the pipeline trains GPT-2-124M on each mesh of
RANKS_PIPE_MESHES ({"dp": 2, "pp": 2}, {"pp": 4}) beside one card's run
at dp 1 x pp 1 (made by the parent process on card 0 before the ranks
start), with a 4-layer fp32 step on each against that card's; and a
GPT-2-124M-width model with 2 heads trains one fp32 step at {"tp": 4}
(each head computed by 2 ranks) against one card.
Without CUDA it exits 2 before printing any result.
"""

from __future__ import annotations

import copy
import hashlib
import json
import re
import socket
import statistics
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"   # the card; every phase runs on it
LOG = True        # print; off on every rank but 0 with --ranks

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
# the head_dims phase: gpt2-tiny as the JAX package's serving test builds it
# (head dim 16), served through a pool small enough to preempt; a 16-head
# GPT-2-124M (head dim 48) step; the padded kernels alone at the shapes those
# paths give them, in fp32 and bf16; and a B * H over the grid's 65535
MESH_AXES = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}   # one rank, every axis named
MESH_PARITY_LAYERS = 4
MESH_REL_TOL = 1e-5           # mesh step vs the same step off the mesh, fp32
RANKS_TRAIN_MESHES = ({"dp": 4}, {"fsdp": 4}, {"tp": 4}, {"sp": 4})
RANKS_PARITY_MESHES = ({"fsdp": 4}, {"tp": 4}, {"sp": 4}, {"dp": 2, "tp": 2})
RANKS_PARITY_BATCH = (4, 128)  # rows split over dp x fsdp, positions over sp
RANKS_REL_TOL = 1e-4           # fp32, sums across ranks in another order
RANKS_TRAIN_STEPS = 3
RANKS_DEADLINE_S = 900
# the moe_mesh phase: GPT2MoEConfig() on a one-rank mesh naming every axis
MOE_MESH_AXES = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, "ep": 1}
# the pipeline phase: GPT-2-124M on a one-rank (dp, pp) mesh
PIPE_AXES = {"dp": 1, "pp": 1}
PIPE_MICRO = 2
PIPE_BATCH = (16, 1024)
PIPE_STEPS = 3                # timed steps after one warm-up step
PIPE_PARITY_BATCH = (4, 128)  # fp32, 4 layers: rows split into 1 or 4 microbatches
PIPE_LR = 3e-4                # PipelineTrainStep's default learning rate
RANKS_MOE_MESHES = ({"ep": 4}, {"dp": 2, "ep": 2})
RANKS_PIPE_MESHES = ({"dp": 2, "pp": 2}, {"pp": 4})
# fault 3 on the cards: 2 heads of 384 over tp = 4 (the einsum attention:
# the kernels take head dims up to 128)
RANKS_FAULT3 = ({"tp": 4}, 2)
TINY_SERVE = {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 96,
              "block_size": 64}
TINY_POOL = {"num_blocks": 24, "block_size": 4}
HEAD48_TRAIN_BATCH = (4, 1024)
PADDED_SHAPES = ((1, 4, 40, 16), (4, 16, 1024, 48))
BIG_BH_SHAPE = (5462, 12, 16, 64)
LLM_SERIES = ("ray_tpu_llm_tokens_per_s", "ray_tpu_llm_kv_utilization",
              "ray_tpu_llm_batch_size", "ray_tpu_llm_preemptions_total",
              "ray_tpu_llm_prefix_hit_rate", "ray_tpu_llm_spec_acceptance")


def log(msg: str) -> None:
    if LOG:
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


def reset_counts() -> None:
    """Every kernel's launch counter and the plain-call counter to 0."""
    from ray_tpu_torch.ops import attention

    attention.FLASH_FWD_LAUNCHES = 0
    attention.FLASH_BWD_DQ_LAUNCHES = 0
    attention.FLASH_BWD_DKV_LAUNCHES = 0
    attention.PLAIN_ATTENTION_CALLS = 0


def read_counts():
    """(forward, dq, dk/dv launches, plain attention calls) since the last
    reset."""
    from ray_tpu_torch.ops import attention

    return (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DQ_LAUNCHES,
            attention.FLASH_BWD_DKV_LAUNCHES, attention.PLAIN_ATTENTION_CALLS)


def flight_mark() -> int:
    """The flight recorder's newest sequence number."""
    from ray_tpu_torch._private import flight_recorder

    snap = flight_recorder.get_recorder().snapshot()
    return snap[-1][0] if snap else 0


def flight_events(mark: int, prefix: str):
    """{event: count} of the events named ``prefix``* recorded after
    ``mark``."""
    from ray_tpu_torch._private import flight_recorder

    out = {}
    for e in flight_recorder.dump():
        if e["seq"] > mark and e["event"].startswith(prefix):
            out[e["event"]] = out.get(e["event"], 0) + 1
    return out


def llm_telemetry(tag: str, engine, mark: int, expect_events):
    """The engine's six ray_tpu_llm_* series, read from the port's metric
    table under the engine's deployment tag, and the count of each llm.*
    flight event recorded after ``mark``. Fails if a series this engine
    publishes is unset (the prefix hit rate with the prefix cache on, the
    acceptance with a draft, the preemption counter after a preemption),
    if the tokens/s EMA is not positive, or if an expected event is
    absent: a swallowed telemetry error cannot pass silently."""
    from ray_tpu_torch.util import metrics

    name = engine._tags["deployment"]
    series = {r["name"]: r["value"] for r in metrics.drain_records()
              if r["name"] in LLM_SERIES and r["labels"]["deployment"] == name}
    events = flight_events(mark, "llm.")
    published = ["ray_tpu_llm_tokens_per_s", "ray_tpu_llm_kv_utilization",
                 "ray_tpu_llm_batch_size"]
    if engine.prefix_cache_enabled:
        published.append("ray_tpu_llm_prefix_hit_rate")
    if engine.draft_cache is not None:
        published.append("ray_tpu_llm_spec_acceptance")
    preemptions = engine.scheduler.preemptions_total
    if preemptions:
        published.append("ray_tpu_llm_preemptions_total")
    shown = {n: series.get(n, "unset") for n in LLM_SERIES}
    log(f"[{tag}] series {json.dumps(shown)}; llm.* events {json.dumps(events)}; "
        f"scheduler preemptions {preemptions}")
    missing = [n for n in published if n not in series]
    absent = [e for e in expect_events if not events.get(e)]
    counted = series.get("ray_tpu_llm_preemptions_total", 0)
    if (missing or absent or counted > preemptions
            or series.get("ray_tpu_llm_tokens_per_s", 0) <= 0):
        raise AssertionError(f"{tag}: series unset {missing}, events absent "
                             f"{absent}, series {shown}, events {events}")
    return {"series": shown, "events": events, "preemptions": preemptions}


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
    cards = out.stdout.strip().splitlines()
    for line in cards:
        log(f"[device] {line}")
    # one name for the run where every card reads alike (the one-card run)
    card = cards[0] if len(set(cards)) == 1 else " / ".join(cards)
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
    one forward kernel launch per layer, no plain attention call."""
    idx = torch.randint(0, vocab, FORWARD_SHAPE,
                        generator=torch.Generator().manual_seed(1))
    cpu_model = copy.deepcopy(model).to("cpu")
    idx_card = idx.to(DEVICE)
    reset_counts()
    with torch.inference_mode():
        logits = model(idx_card)
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()[0], read_counts()[3]
        ms = cuda_ms(lambda: model(idx_card), iters=5, warmup=1)
        ref = cpu_model(idx)
    n_layer = model.config.n_layer
    if launches != n_layer or plain_calls:
        raise AssertionError(f"forward launched the kernel {launches} times, "
                             f"expected {n_layer}, with {plain_calls} plain calls")
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
    kernel's launches and no plain attention call, the cache's integrity,
    the engine's series and llm.* events, and every greedy token
    teacher-forced against the CPU plain forward. Returns a dict with the
    launches, plain calls, telemetry, prompts, outputs and the CPU model."""
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = adapter.cfg
    engine = LLMEngine(adapter, name=tag)
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
    mark = flight_mark()
    reset_counts()
    outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
    launches, plain_calls = read_counts()[0], read_counts()[3]
    del adapter.prefill_ctx

    cold = [p for p in prefills if p[1] == 0]
    hits = [p for p in prefills if p[1] > 0]
    if len(hits) != 1 or hits[0][1] != SHARED_PREFIX:
        raise AssertionError(f"expected one {SHARED_PREFIX}-token prefix hit, "
                             f"got prefills {prefills}")
    if launches < cfg.n_layer * len(cold) or plain_calls:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(cold)} cold prefills x {cfg.n_layer} layers, "
                             f"{plain_calls} plain attention calls")

    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    log(f"[{tag}] {len(prompts)} requests x {SERVE_MAX_TOKENS} tokens in "
        f"{wall:.3f} s: {n_tokens / wall:.1f} tokens/s on {card} "
        f"(fp32, LLMEngine defaults, prefill timings synchronised)")
    for n, start, ms in prefills:
        log(f"[{tag}] prefill {n} tokens at start {start}: {ms:.2f} ms on {card}")
    log(f"[{tag}] flash_attn_fwd launches {launches} for {len(cold)} cold "
        f"prefills x {cfg.n_layer} layers, plain attention calls {plain_calls}; "
        f"stats {engine.stats()}")
    telemetry = llm_telemetry(tag, engine, mark,
                              ("llm.admit", "llm.finish", "llm.prefix_hit"))

    # teacher-forced: every greedy token is the CPU plain forward's argmax
    # to within GREEDY_TOL of the max logit at its position
    cpu_model = copy.deepcopy(adapter.model).to("cpu")
    gaps = greedy_gaps(cpu_model, prompts, outputs)
    worst = max(max(g) for g in gaps.values())
    log(f"[{tag}] teacher-forced: worst greedy gap {worst:.3g} (limit {GREEDY_TOL})")
    if worst > GREEDY_TOL:
        raise AssertionError(f"a greedy token is {worst} below the CPU max logit")
    return {"launches": launches, "plain_calls": plain_calls,
            "tokens_per_s": n_tokens / wall, "telemetry": telemetry,
            "prompts": prompts, "outputs": outputs, "cpu_model": cpu_model}


def phase_serve(card: str):
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    adapter = build_adapter("gpt2", seed=0, device=DEVICE)
    cfg = adapter.cfg
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or adapter.dtype != torch.float32:
        raise AssertionError(f"not GPT-2-124M at full width in fp32: {cfg}")
    run = serve_run(card, "serve", adapter)
    del adapter
    torch.cuda.empty_cache()
    return {k: run[k] for k in ("launches", "plain_calls", "tokens_per_s", "telemetry")}


def traced_step(ts, state, batch):
    """One ``ts.step`` inside a device-trace window the step's recorder
    opens (``request_device_trace(1)``), its Chrome trace written to a
    temporary directory and read back. Returns (state, metrics, what
    ``read_device_trace`` says, host ms of the call including the window's
    start, synchronise, stop and export, the trace's MB)."""
    import tempfile

    from ray_tpu_torch.train import _telemetry

    with tempfile.TemporaryDirectory() as trace_dir:
        if not _telemetry.request_device_trace(1, trace_dir):
            raise AssertionError("no current recorder to open a trace window")
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        trace = ts.telemetry.device_trace.last_trace
        if trace is None or not trace.startswith(trace_dir):
            raise AssertionError(f"the trace window wrote no trace: {trace}")
        trace_mb = Path(trace).stat().st_size / 1e6
        read = _telemetry.read_device_trace(trace)
    if not read["kernel_us"]:
        raise AssertionError(f"the trace window holds no kernel: {read}")
    return state, m, read, host_ms, trace_mb


def window_line(read) -> str:
    """The window, its kernels and where the device's idle time sits."""
    ms = lambda us: f"{us / 1e3:.2f}"
    runtime = sorted(read["runtime_us"].items(), key=lambda kv: -kv[1])[:5]
    kernels = sum(read["kernel_us"].values())
    return (f"window {ms(read['window_us'])} ms, kernels {ms(kernels)} ms "
            f"({len(read['kernel_us'])} distinct; with copies and memsets "
            f"{ms(kernels + read['copy_us'])} ms), device busy {ms(read['busy_us'])} ms = "
            f"{read['busy_share']:.3f} of the window (idle before the first "
            f"kernel {ms(read['lead_us'])} ms, between kernels {ms(read['gap_us'])} "
            f"ms, after the last {ms(read['tail_us'])} ms); host CUDA calls "
            + ", ".join(f"{name} {ms(us)} ms x{read['runtime_calls'][name]}"
                        for name, us in runtime))


def train_run(card: str, tag: str, name: str, cfg, batch_shape, steps: int,
              profiled: bool, mesh=None):
    """``TrainStep(cfg, mesh)`` on the card, bf16 compute over fp32 master weights:
    one warm-up step, then ``steps`` timed steps on a repeated batch with a
    falling loss and exactly 2L forward, L dq and L dk/dv launches and no
    plain attention call per step (forward + remat), then (if ``profiled``)
    one step inside the recorder's device-trace window
    (``request_device_trace(1)``), read back from its Chrome trace for the
    largest kernels and the device's busy share; the recorder's slow-step
    flag and its train.step events. Returns the run's numbers."""
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.train_step import TrainStep
    from ray_tpu_torch.train import _telemetry

    ts = TrainStep(cfg, mesh, device=DEVICE)
    if _telemetry.current_recorder() is not ts.telemetry:
        raise AssertionError("TrainStep did not make its recorder current")
    mark = flight_mark()
    state = ts.init(torch.Generator().manual_seed(0))
    if any(p.dtype != torch.float32 for p in state["params"].parameters()):
        raise AssertionError("master weights are not fp32")
    model = state["params"]   # whole parameters, where a mesh rank holds a tp shard
    n_params = sum(int(np.prod(_flax.full_shape(model, n, p)))
                   for n, p in model.named_parameters())
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
        reset_counts()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)   # ends in a synchronise (telemetry)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    summary = ts.telemetry.summary()
    tokens_per_s = summary["tokens_per_s"]
    # the exact 6N count (every parameter, the untied head included) beside
    # the recorder's estimate 12 L d^2 + V d, over every card of the mesh
    cards = 1 if mesh is None else mesh.size()
    exact_mfu = 6 * n_active * tokens_per_s / (PEAK_FLOPS[torch.bfloat16] * cards)
    log(f"[{tag}] {name} {dtype_name(cfg.dtype)} compute / fp32 params, batch {batch_shape}: "
        f"warm-up {warm_s:.2f} s, then steps {[round(x, 2) for x in step_ms]} ms "
        f"on {card}")
    log(f"[{tag}] loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, launches and plain calls per step "
        f"(fwd, dq, dkv, plain) {counts}")
    log(f"[{tag}] recorder: {json.dumps(summary)}; at the median step "
        f"{batch_shape[0] * batch_shape[1] / (statistics.median(step_ms) / 1e3):.0f} "
        f"tokens/s")
    log(f"[{tag}] {n_params} parameters, {n_active} active per token; MFU "
        f"{summary.get('mfu')} by the recorder's 12 L d^2 + V d count, "
        f"{exact_mfu:.6f} by the exact 6N count of active parameters "
        f"({6 * n_active:.4g} FLOP per token) over 989 TFLOP/s x {cards}")
    # ring attention over sp (an einsum, as in JAX) replaces the kernels
    ring = mesh is not None and axis_size(mesh, "sp") > 1
    want = (0, 0, 0, 0) if ring else (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer, 0)
    if any(c != want for c in counts):
        raise AssertionError(f"launches and plain calls per step {counts}, "
                             f"expected {want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    out = {"step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "losses": losses, "grad_norms": norms, "n_params": n_params,
           "n_active_params": n_active,
           "exact_mfu": exact_mfu,
           "median_tokens_per_s": batch_shape[0] * batch_shape[1]
                                  / (statistics.median(step_ms) / 1e3),
           "launches": [sum(c[i] for c in counts) for i in range(3)],
           "plain_calls": sum(c[3] for c in counts),
           "launches_per_step": list(want[:3]), "summary": summary}

    if profiled:   # where one step's device time goes: the recorder's window
        state, m, read, prof_ms, trace_mb = traced_step(ts, state, batch)
        kernel_us = read["kernel_us"]
        busy_ms = sum(kernel_us.values()) / 1e3
        attn_ms = sum(us for name, us in kernel_us.items() if "flash_" in name) / 1e3
        top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:16]
        log(f"[{tag}] profiled step (device-trace window, {trace_mb:.1f} MB Chrome "
            f"trace; host {prof_ms:.2f} ms with the window's start, stop and "
            f"export): {window_line(read)}; hand-written attention kernels "
            f"{attn_ms:.2f} ms = {attn_ms / max(busy_ms, 1e-9):.3f} of kernel time "
            f"on {card}")
        for name, us in top:
            log(f"[{tag}]   {us / 1e3:9.3f} ms  {name[:110]}")
        if not kernel_us or (attn_ms <= 0) != ring:
            raise AssertionError(f"the trace window holds no attention kernel: {read}")
        out.update(profiled_step_ms=prof_ms, attention_ms_profiled=attn_ms,
                   kernel_ms_profiled=busy_ms,
                   kernel_and_copy_ms_profiled=busy_ms + read["copy_us"] / 1e3,
                   window_ms=read["window_us"] / 1e3,
                   device_busy_ms=read["busy_us"] / 1e3,
                   device_busy_share=read["busy_share"],
                   idle_lead_ms=read["lead_us"] / 1e3, idle_gap_ms=read["gap_us"] / 1e3,
                   idle_tail_ms=read["tail_us"] / 1e3)
    slow = ts.telemetry.pop_slow_step()
    steps_seen = flight_events(mark, "train.step")
    log(f"[{tag}] slow-step flag: {json.dumps(slow) if slow else 'none raised'} "
        f"(factor {ts.telemetry._slow_factor} x the trailing median); "
        f"train.step events {steps_seen}")
    if steps_seen.get("train.step", 0) != steps + 1 + int(profiled):
        raise AssertionError(f"expected {steps + 1 + int(profiled)} train.step "
                             f"events, got {steps_seen}")
    out.update(slow_step=slow, train_step_events=steps_seen.get("train.step", 0))
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


def first_steps_probe(card: str, tag: str, cfg):
    """A fresh ``TrainStep(cfg)`` on the card: the warm-up step untraced,
    then the two next steps each inside its own device-trace window. The
    timed runs' first step after the warm-up is an outlier for Llama; these
    windows show what that step does on the host and the card beside a
    steady one. No step here is one of the timed steps."""
    from ray_tpu_torch.parallel.train_step import TrainStep

    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    warm_ms = (time.perf_counter() - t0) * 1e3
    out = {"warm_up_ms": warm_ms}
    for name in ("first_after_warm_up", "second_after_warm_up"):
        state, m, read, host_ms, _ = traced_step(ts, state, batch)
        log(f"[{tag}] probe, {name.replace('_', ' ')} step (fresh TrainStep, "
            f"warm-up {warm_ms:.1f} ms untraced): {window_line(read)} on {card}")
        out[name] = {k: read[k] for k in ("window_us", "busy_us", "busy_share",
                                          "lead_us", "gap_us", "tail_us",
                                          "runtime_us", "runtime_calls")}
        out[name]["kernel_ms"] = sum(read["kernel_us"].values()) / 1e3
    del ts, state, batch, m
    torch.cuda.empty_cache()
    return out


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
    serve = serve_run(card, "llama", adapter)
    del adapter
    torch.cuda.empty_cache()

    train = train_run(card, "llama", "llama-160m", LlamaConfig.llama_160m(),
                      TRAIN_BATCH, TRAIN_STEPS, profiled=True)
    train["first_steps"] = first_steps_probe(card, "llama", LlamaConfig.llama_160m())
    train["parity"] = train_parity(card, "llama", cfg)
    return {"serve_launches": serve["launches"], "serve_plain_calls": serve["plain_calls"],
            "serve_tokens_per_s": serve["tokens_per_s"],
            "serve_telemetry": serve["telemetry"], "train": train,
            "prompts": serve["prompts"], "outputs": serve["outputs"],
            "cpu_model": serve["cpu_model"]}


def phase_spec(card: str, prompts, serve_outputs, cpu_model):
    """Speculative decoding on the card: the Llama-160M target answers the
    serve phases' prompts without a draft and with each of two drafts (the
    target's own weights from its seed; llama-tiny at vocabulary 32000).
    Every speculative stream must equal the plain one; where one differs,
    its first differing token and every token after must lie within
    GREEDY_TOL of the CPU plain forward's max logit (a near tie). Each
    engine's series and llm.* events are read as in the serve phase."""
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    target = build_adapter("llama-160m", seed=0, device=DEVICE)
    drafts = {"same-seed llama-160m": build_adapter("llama-160m", seed=0, device=DEVICE),
              "llama-tiny": build_adapter(
                  "llama-tiny", {"vocab_size": 32000, "block_size": 1024}, seed=0,
                  device=DEVICE)}
    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    reset_counts()
    mark = flight_mark()
    engine = LLMEngine(target, name="spec-plain")
    plain, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
    # the plain engine again, without the serve phase's prefill timing: the
    # same streams, or (checked against the CPU) near-greedy ones
    replay_equal = plain == serve_outputs
    if not replay_equal:
        gaps = greedy_gaps(cpu_model, prompts, plain)
        if max(max(g) for g in gaps.values()) > GREEDY_TOL:
            raise AssertionError("the plain replay leaves the greedy stream")
    log(f"[spec] plain: {n_tokens / wall:.1f} tokens/s on {card}; streams equal to "
        f"the llama serve phase's: {replay_equal}")
    results = {"plain_tokens_per_s": n_tokens / wall, "plain_replay_equal": replay_equal,
               "plain_telemetry": llm_telemetry(
                   "spec", engine, mark, ("llm.admit", "llm.finish", "llm.prefix_hit"))}
    for name, draft in drafts.items():
        engine = LLMEngine(target, draft_adapter=draft, spec_k=SPEC_K,
                           name=f"spec-{name.split()[0]}")
        mark = flight_mark()
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
        res["telemetry"] = llm_telemetry(
            "spec", engine, mark,
            ("llm.admit", "llm.finish", "llm.prefix_hit", "llm.spec_verify"))
        accept = res["telemetry"]["series"]["ray_tpu_llm_spec_acceptance"]
        if abs(accept - engine.spec_acceptance()) > 1e-12:
            raise AssertionError(f"acceptance series {accept} != the engine's "
                                 f"{engine.spec_acceptance()}")
        if worst > GREEDY_TOL:
            raise AssertionError(f"speculative stream with draft {name} leaves the "
                                 f"plain stream by more than a near tie: {res}")
        results[name] = res
    results["launches"], results["plain_calls"] = read_counts()[0], read_counts()[3]
    if results["launches"] == 0 or results["plain_calls"]:
        raise AssertionError(f"the spec runs launched {results['launches']} forward "
                             f"kernels, with {results['plain_calls']} plain calls")
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


def serve_against_cpu(card: str, tag: str, model: str, config, prompts, engine_kw,
                      expect_events=("llm.admit", "llm.finish")):
    """``model`` from the zoo (``config`` its model_config) serves
    ``prompts`` (4 requests) x 16 greedy tokens on the card and on the CPU
    from one seed, through
    engines built with ``engine_kw``. Where a card stream differs, every
    token from the first difference on must lie within GREEDY_TOL of the
    CPU adapter's max logit (a near tie). Returns (streams equal, worst
    gap, the card run's (forward, dq, dk/dv launches, plain calls), its
    telemetry as :func:`llm_telemetry` reads it, expecting
    ``expect_events``)."""
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    streams, adapters = {}, {}
    for key, dev in (("card", DEVICE), ("cpu", "cpu")):
        adapters[key] = build_adapter(model, config, seed=0, device=dev)
        engine = LLMEngine(adapters[key], name=f"{tag}-{key}", **engine_kw)
        mark = flight_mark()
        reset_counts()
        rids = [engine.submit(p, SamplingParams(max_tokens=16)) for p in prompts]
        engine.run_until_drained()
        streams[key] = [engine.pull(r)[0] for r in rids]
        engine.cache.assert_no_leaks()
        if any(len(t) != 16 for t in streams[key]):
            raise AssertionError(f"{model} on {dev}: {streams[key]}")
        if key == "card":
            counts = read_counts()
            log(f"[{tag}] {model} on the card: (fwd, dq, dkv) launches and plain "
                f"attention calls {counts}; engine stats {engine.stats()}")
            telemetry = llm_telemetry(tag, engine, mark, expect_events)
    worst = 0.0
    for p, card_toks, cpu_toks in zip(prompts, streams["card"], streams["cpu"]):
        if card_toks == cpu_toks:
            continue
        first = next(c for c, (a, b) in enumerate(zip(card_toks, cpu_toks)) if a != b)
        for c in range(first, len(card_toks)):
            logits = adapters["cpu"].prefill(np.asarray(p + card_toks[:c]))[0]
            worst = max(worst, (logits.max() - logits[card_toks[c]]).item())
    equal = sum(a == b for a, b in zip(streams["card"], streams["cpu"]))
    log(f"[{tag}] {model} serving {len(prompts)} requests x 16 tokens: {equal} of "
        f"{len(prompts)} card streams equal the CPU's; worst gap after a difference "
        f"{worst:.3g} (limit {GREEDY_TOL})")
    if worst > GREEDY_TOL:
        raise AssertionError(f"{model} card streams leave the CPU's: {streams}")
    return {"streams_equal": equal, "worst_gap": worst, "counts": list(counts),
            "telemetry": telemetry}


def phase_moe(card: str):
    """GPT-2-MoE (GPT2MoEConfig(): GPT-2-124M widths, 8 experts, top-2,
    an MoE block every 2nd layer) trains on the card; one fp32 step against
    the CPU, dispatch masks first; gpt2-moe-tiny serves against the CPU."""
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig, init_params

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
    served = serve_against_cpu(card, "moe", "gpt2-moe-tiny", None, prompts, {})
    if served["counts"][3]:
        raise AssertionError(f"gpt2-moe-tiny made plain attention calls: {served}")
    train["serve_streams_equal"] = served["streams_equal"]
    torch.cuda.empty_cache()
    return train


def check_attention(q, k, v, do):
    """The public forward and backward on the card (the kernels, padded or
    chunked as the shape needs) against the plain version in fp32 on the
    same inputs: the (forward, dq, dk/dv launches, plain calls) they took,
    the errors (o and lse absolute, dq/dk/dv normalised) and a digest."""
    from ray_tpu_torch.ops import attention

    reset_counts()
    o, lse = attention.flash_causal_attention_fwd(q, k, v)
    grads = attention.flash_causal_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    counts = read_counts()
    o_ref, lse_ref = attention.plain_causal_attention_fwd(q.float(), k.float(), v.float())
    ref = attention.plain_causal_attention_bwd(q.float(), k.float(), v.float(),
                                               o.float(), lse, do.float())
    fp32 = q.dtype == torch.float32
    out = {"shape": list(q.shape), "dtype": dtype_name(q.dtype),
           "kernel_head_dim": attention.kernel_head_dim(q.shape[-1]),
           "counts": list(counts),
           "err_o": (o.float() - o_ref).abs().max().item(),
           "err_lse": (lse - lse_ref).abs().max().item(),
           "err": {n: norm_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, ref)},
           "tol": [FP32_TOL if fp32 else BF16_TOL, BWD_FP32_TOL if fp32 else BWD_BF16_TOL],
           "digest": digest(o, lse, *grads)}
    if (out["err_o"] > out["tol"][0] or out["err_lse"] > out["tol"][0]
            or max(out["err"].values()) > out["tol"][1]):
        raise AssertionError(f"attention kernels disagree with the plain version: {out}")
    return out, o, lse


def phase_head_dims(card: str):
    """Head dims the kernels are not built for (16, 48) run on them,
    zero-padded to the next kernel size, with no plain call, on a serving
    path, a training step and alone against the plain version; a B * H
    above the grid's 65535 runs the kernels in chunks."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel.train_step import TrainStep

    # gpt2-tiny at head dim 16, 4 requests through a pool small enough to
    # preempt, against the CPU
    prompts = [np.random.default_rng(i).integers(0, 96, n).tolist()
               for i, n in enumerate((5, 17, 40, 30))]
    served = serve_against_cpu(card, "head_dims", "gpt2-tiny", TINY_SERVE, prompts,
                               TINY_POOL, ("llm.admit", "llm.finish", "llm.preempt"))
    if served["counts"][0] <= 0 or served["counts"][1:] != [0, 0, 0]:
        raise AssertionError(f"head dim 16 should take only forward launches: {served}")
    if not served["telemetry"]["preemptions"]:
        raise AssertionError("the small pool preempted nothing")

    # one GPT2Config(n_head=16) bf16 step (head dim 48) at full width
    cfg = GPT2Config.gpt2_124m(n_head=16)
    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, HEAD48_TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    reset_counts()
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    log(f"[head_dims] GPT2Config(n_head=16) bf16 step, head dim "
        f"{cfg.n_embd // cfg.n_head}, batch {HEAD48_TRAIN_BATCH}: loss {loss:.4f}, "
        f"grad_norm {norm:.4f}, {step_ms:.1f} ms (first call) on {card}; (fwd, dq, "
        f"dkv) launches and plain calls {counts}")
    per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer, 0)
    if counts != per_step or not np.isfinite([loss, norm]).all():
        raise AssertionError(f"head dim 48 step: counts {counts} (want {per_step}), "
                             f"loss {loss}, grad_norm {norm}")
    del ts, state, batch, m
    torch.cuda.empty_cache()
    parity = train_parity(card, "head_dims", GPT2Config.gpt2_124m(
        n_head=16, dtype=torch.float32))

    # the padded kernels alone at the shapes of the two paths above
    padded = []
    for shape in PADDED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(DEVICE).manual_seed(shape[-1])
            q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                           for _ in range(4))
            case, _, _ = check_attention(q, k, v, do)
            log(f"[head_dims] padded {json.dumps(case)}")
            if case["counts"] != [1, 1, 1, 0]:
                raise AssertionError(f"padded head dim left the kernels: {case}")
            padded.append(case)
            del q, k, v, do

    # B * H = 65544: two chunks of each kernel, against the plain version
    gen = torch.Generator(DEVICE).manual_seed(2)
    q, k, v, do = (torch.randn(BIG_BH_SHAPE, generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    big, o, lse = check_attention(q, k, v, do)
    # the last batch element is the second chunk: alone it must give the same bits
    o_last, lse_last = attention.flash_causal_attention_fwd(q[-1:], k[-1:], v[-1:])
    big["second_chunk_bitwise"] = torch.equal(o_last, o[-1:]) and torch.equal(
        lse_last, lse[-1:])
    log(f"[head_dims] B * H = {BIG_BH_SHAPE[0] * BIG_BH_SHAPE[1]}: {json.dumps(big)}")
    if big["counts"] != [2, 2, 2, 0] or not big["second_chunk_bitwise"]:
        raise AssertionError(f"chunked kernels: {big}")
    del q, k, v, do, o, lse, o_last, lse_last
    torch.cuda.empty_cache()
    return {"head_dim_16_serve": served, "head_dim_48_train": {
        "counts": list(counts), "loss": loss, "grad_norm": norm, "step_ms": step_ms,
        "fp32_parity": parity}, "padded": padded, "big_bh": big}


def mesh_parity(card: str, name: str, cfg, mesh, batch_shape=PARITY_BATCH,
                rel_tol: float = MESH_REL_TOL, tag: str = "mesh"):
    """One fp32 step of ``cfg`` on ``mesh`` and off it, on the card, from the
    same weights and batch: loss and grad_norm to ``rel_tol`` relative,
    every parameter (gathered from the mesh) to 2 * lr."""
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.parallel.train_step import TrainStep

    plain = TrainStep(cfg, device=DEVICE, telemetry=False)
    meshed = TrainStep(cfg, mesh, device=DEVICE, telemetry=False)
    a = plain.init(torch.Generator().manual_seed(2))
    b = meshed.init(torch.Generator().manual_seed(2))
    idx = np.random.default_rng(2).integers(0, cfg.vocab_size, batch_shape)
    raw = {"idx": idx, "targets": np.roll(idx, -1, axis=1)}
    a, ma = plain.step(a, plain.shard_batch(raw))
    b, mb = meshed.step(b, meshed.shard_batch(raw))
    rel = lambda x, y: abs(x.item() - y.item()) / abs(y.item())
    model = b["params"]
    out = {"loss_rel_err": rel(mb["loss"], ma["loss"]),
           "grad_norm_rel_err": rel(mb["grad_norm"], ma["grad_norm"]),
           "param_abs_err": max(
               (_flax.gather_full(model, n, q, meshed.tp, meshed.ep)
                - p.detach().cpu()).abs().max().item()
               for (n, q), p in zip(model.named_parameters(), a["params"].parameters())),
           "loss": mb["loss"].item(), "grad_norm": mb["grad_norm"].item()}
    log(f"[{tag}] fp32 step {batch_shape}, {name} ({cfg.n_layer} layers), on the mesh "
        f"vs off it on {card}: {json.dumps(out)}")
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"]) > rel_tol
            or out["param_abs_err"] > 2 * plain.learning_rate):
        raise AssertionError(f"the mesh step differs from the one-device step: {out}")
    del plain, meshed, a, b, model
    torch.cuda.empty_cache()
    return out


def phase_mesh(card: str, train):
    """``TrainStep`` on a world-size-1 mesh over NCCL: GPT-2-124M training
    as in phase 7, its step times beside phase 7's median, and the fp32
    mesh step against the one-device step for GPT-2 and Llama widths."""
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MESH_AXES, device=DEVICE)
    backend, world = dist.get_backend(), dist.get_world_size()
    run = train_run(card, "mesh", "gpt2-124m", GPT2Config.gpt2_124m(), TRAIN_BATCH,
                    TRAIN_STEPS, profiled=True, mesh=mesh)
    log(f"[mesh] {backend}, world size {world}, mesh {MESH_AXES}: steps "
        f"{[round(x, 2) for x in run['step_ms']]} ms, median "
        f"{run['median_step_ms']:.2f} ms beside the one-device train phase's median "
        f"{train['median_step_ms']:.2f} ms (x{run['median_step_ms'] / train['median_step_ms']:.4f}) "
        f"on {card}")
    run["backend"], run["world_size"] = backend, world
    run["one_device_median_step_ms"] = train["median_step_ms"]
    fp32 = dict(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32)
    run["parity"] = {
        "gpt2-124m": mesh_parity(card, "gpt2-124m", GPT2Config.gpt2_124m(**fp32), mesh),
        "llama-160m": mesh_parity(card, "llama-160m", LlamaConfig.llama_160m(**fp32), mesh)}
    return run


def phase_moe_mesh(card: str, moe):
    """GPT2MoEConfig() through ``TrainStep`` on a one-rank mesh that names
    every axis of it, ep included (the same process group as phase 12):
    24 / 12 / 12 launches and no plain call a step, step times beside the
    moe phase's median, one step traced; then
    one fp32 step of a 4-layer GPT2MoEConfig on the mesh against the same
    step off it."""
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MOE_MESH_AXES, device=DEVICE)
    run = train_run(card, "moe_mesh", "gpt2-moe", GPT2MoEConfig(), MOE_TRAIN_BATCH,
                    MOE_TRAIN_STEPS, profiled=True, mesh=mesh)
    log(f"[moe_mesh] mesh {MOE_MESH_AXES}: steps {[round(x, 2) for x in run['step_ms']]} "
        f"ms, median {run['median_step_ms']:.2f} ms beside the moe phase's median "
        f"{moe['median_step_ms']:.2f} ms (x{run['median_step_ms'] / moe['median_step_ms']:.4f}) "
        f"on {card}")
    run["one_device_median_step_ms"] = moe["median_step_ms"]
    run["parity"] = mesh_parity(
        card, "gpt2-moe", GPT2MoEConfig(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32),
        mesh, tag="moe_mesh")
    return run


def pipeline_run(card: str, tag: str, name: str, cfg, mesh, batch_shape, steps: int,
                 micro=None):
    """``PipelineTrainStep(cfg, mesh)`` on the card, bf16 compute over fp32
    master weights: one warm-up step, then ``steps`` timed steps (host
    clock around a step and a synchronise) on a repeated batch with a
    falling loss; launches per step must be the schedule's: each of this
    stage's blocks runs the forward kernel twice per microbatch (forward
    and remat) and each backward kernel once per microbatch, with no plain
    attention call. Returns the run's numbers."""
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.pipeline import PipelineTrainStep

    pts = PipelineTrainStep(cfg, mesh, num_microbatches=micro, device=DEVICE)
    state = pts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, batch_shape)
    batch = pts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = pts.step(state, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses, norms, step_ms, counts = [m["loss"].item()], [m["grad_norm"].item()], [], []
    for _ in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        state, m = pts.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    blocks = cfg.n_layer // axis_size(mesh, "pp")
    want = (2 * blocks * pts.num_micro, blocks * pts.num_micro, blocks * pts.num_micro, 0)
    median = statistics.median(step_ms)
    log(f"[{tag}] {name} {dtype_name(cfg.dtype)} compute / fp32 params, batch {batch_shape}, "
        f"{pts.num_micro} microbatches, {blocks} blocks on this stage: warm-up "
        f"{warm_s:.2f} s, then steps {[round(x, 2) for x in step_ms]} ms (median "
        f"{median:.2f} ms, {batch_shape[0] * batch_shape[1] / (median / 1e3):.0f} tokens/s "
        f"over the mesh), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")
    log(f"[{tag}] loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, launches and plain calls per step "
        f"(fwd, dq, dkv, plain) {counts}, the schedule's {want}")
    if any(c != want for c in counts):
        raise AssertionError(f"launches and plain calls per step {counts}, expected {want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    out = {"step_ms": step_ms, "median_step_ms": median, "losses": losses,
           "grad_norms": norms, "num_microbatches": pts.num_micro,
           "median_tokens_per_s": batch_shape[0] * batch_shape[1] / (median / 1e3),
           "launches": [sum(c[i] for c in counts) for i in range(3)],
           "plain_calls": sum(c[3] for c in counts), "launches_per_step": list(want[:3]),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    del pts, state, batch, m
    torch.cuda.empty_cache()
    return out


def pipeline_step(cfg, mesh, micro: int, device, batch_shape=PIPE_PARITY_BATCH):
    """One fp32 ``PipelineTrainStep`` step from the weights of seed 2 on a
    batch of seed 2: (loss, grad_norm, the whole parameters on the CPU)."""
    from ray_tpu_torch.parallel.pipeline import PipelineTrainStep, full_state

    pts = PipelineTrainStep(cfg, mesh, num_microbatches=micro, learning_rate=PIPE_LR,
                            device=device)
    state = pts.init(torch.Generator().manual_seed(2))
    idx = np.random.default_rng(2).integers(0, cfg.vocab_size, batch_shape)
    state, m = pts.step(state, pts.shard_batch({"idx": idx,
                                                "targets": np.roll(idx, -1, axis=1)}))
    return m["loss"].item(), m["grad_norm"].item(), full_state(pts, state)["params"]


def pipeline_compare(tag: str, what: str, got, ref, rel_tol: float):
    """``got`` against ``ref`` (each from :func:`pipeline_step`): loss and
    grad_norm within ``rel_tol`` relative, parameters within 2 * lr."""
    out = {"loss_rel_err": abs(got[0] - ref[0]) / abs(ref[0]),
           "grad_norm_rel_err": abs(got[1] - ref[1]) / abs(ref[1]),
           "param_abs_err": max((got[2][k] - ref[2][k]).abs().max().item() for k in ref[2]),
           "loss": got[0], "grad_norm": got[1]}
    log(f"[{tag}] fp32 pipeline step {PIPE_PARITY_BATCH}, {what}: {json.dumps(out)}")
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"]) > rel_tol
            or out["param_abs_err"] > 2 * PIPE_LR):
        raise AssertionError(f"{what}: the pipeline steps differ: {out}")
    return out


def phase_pipeline(card: str):
    """``PipelineTrainStep`` on a one-rank (dp, pp) mesh: GPT-2-124M at
    (16, 1024) bf16 over 2 microbatches, launches against the schedule's
    count; then two fp32 steps of a 4-layer GPT-2-124M-width model: 1
    microbatch against 4 on the card (the schedule must not change the
    numbers), and the card against the port's own CPU step from the same
    weights."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(PIPE_AXES, device=DEVICE)
    run = pipeline_run(card, "pipeline", "gpt2-124m", GPT2Config.gpt2_124m(), mesh,
                       PIPE_BATCH, PIPE_STEPS, PIPE_MICRO)
    fp32 = GPT2Config.gpt2_124m(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32)
    one = pipeline_step(fp32, mesh, 1, DEVICE)
    four = pipeline_step(fp32, mesh, 4, DEVICE)
    host = pipeline_step(fp32, make_mesh(PIPE_AXES, device="cpu"), 1, "cpu")
    run["parity"] = {
        "micro_4_vs_1": pipeline_compare("pipeline", f"4 microbatches vs 1 on {card}",
                                         four, one, MESH_REL_TOL),
        "card_vs_cpu": pipeline_compare("pipeline", f"{card} vs the CPU, 1 microbatch",
                                        one, host, MESH_REL_TOL)}
    torch.cuda.empty_cache()
    return run


def phase_ranks(card: str, world: int, pipe_ref):
    """This rank's part of ``--ranks``: the one-device GPT-2-124M step on
    its card, then GPT-2-124M on each mesh of RANKS_TRAIN_MESHES, then the
    fp32 mesh steps against the one-device step (RANKS_PARITY_MESHES); then
    GPT-2-MoE alone on its card and on each mesh of RANKS_MOE_MESHES (fp32
    parity too), the pipeline on each mesh of RANKS_PIPE_MESHES beside
    ``pipe_ref``, the one-card run of :func:`pipeline_reference`, and
    GPT-2 with 2 heads over tp = 4 (fault 3) against one card."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    keep = ("step_ms", "median_step_ms", "median_tokens_per_s", "losses", "grad_norms",
            "launches", "plain_calls", "launches_per_step", "summary", "exact_mfu",
            "kernel_ms_profiled", "device_busy_share", "idle_gap_ms")
    # the interconnect: an all-reduce of 256 MB of fp32 over every rank
    x = torch.ones(64 << 20, device=DEVICE)
    ms = cuda_ms(lambda: torch.distributed.all_reduce(x), iters=5, warmup=2)
    bus = 2 * (world - 1) / world * x.numel() * 4 / (ms / 1e3) / 1e9
    log(f"[ranks] all_reduce of 256 MB fp32 over {world} cards: {ms:.3f} ms, "
        f"{bus:.1f} GB/s bus bandwidth (2 (n - 1) / n x bytes / time) on {card}")
    del x
    single = train_run(card, "ranks", "gpt2-124m, one device", GPT2Config.gpt2_124m(),
                       TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True)
    out = {"world_size": world, "all_reduce_256mb_ms": ms, "all_reduce_bus_gb_s": bus,
           "one_device": {k: single[k] for k in keep}, "meshes": {}, "parity": {}}
    for axes in RANKS_TRAIN_MESHES:
        run = train_run(card, "ranks", f"gpt2-124m on {axes}", GPT2Config.gpt2_124m(),
                        TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True,
                        mesh=make_mesh(axes, device=DEVICE))
        log(f"[ranks] {axes} over {world} cards: median step "
            f"{run['median_step_ms']:.2f} ms, {run['median_tokens_per_s']:.0f} tokens/s "
            f"(global batch {TRAIN_BATCH}) beside one card's {single['median_step_ms']:.2f}"
            f" ms, {single['median_tokens_per_s']:.0f} tokens/s, on {card} each")
        out["meshes"][json.dumps(axes)] = {k: run[k] for k in keep}
    fp32 = dict(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32)
    for axes in RANKS_PARITY_MESHES:
        mesh = make_mesh(axes, device=DEVICE)
        for name, cfg in (("gpt2-124m", GPT2Config.gpt2_124m(**fp32)),
                          ("llama-160m", LlamaConfig.llama_160m(**fp32))):
            out["parity"][f"{name} {json.dumps(axes)}"] = mesh_parity(
                card, f"{name} on {axes}", cfg, mesh, RANKS_PARITY_BATCH, RANKS_REL_TOL)

    # GPT-2-MoE: one card alone, then the ep meshes, each with fp32 parity
    moe = train_run(card, "ranks", "gpt2-moe, one device", GPT2MoEConfig(),
                    MOE_TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True)
    out["moe_one_device"] = {k: moe[k] for k in keep}
    out["moe_meshes"] = {}
    for axes in RANKS_MOE_MESHES:
        mesh = make_mesh(axes, device=DEVICE)
        run = train_run(card, "ranks", f"gpt2-moe on {axes}", GPT2MoEConfig(),
                        MOE_TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True, mesh=mesh)
        log(f"[ranks] gpt2-moe on {axes} over {world} cards: median step "
            f"{run['median_step_ms']:.2f} ms beside one card's {moe['median_step_ms']:.2f} "
            f"ms (global batch {MOE_TRAIN_BATCH}), on {card} each")
        out["moe_meshes"][json.dumps(axes)] = {k: run[k] for k in keep}
        out["parity"][f"gpt2-moe {json.dumps(axes)}"] = mesh_parity(
            card, f"gpt2-moe on {axes}", GPT2MoEConfig(**fp32), mesh, RANKS_PARITY_BATCH,
            RANKS_REL_TOL, tag="ranks")

    # the pipeline at GPT-2-124M width, beside and against one card's
    ref = (pipe_ref["loss"], pipe_ref["grad_norm"], torch.load(pipe_ref["path"]))
    out["pipeline_meshes"] = {}
    for axes in RANKS_PIPE_MESHES:
        mesh = make_mesh(axes, device=DEVICE)
        run = pipeline_run(card, "ranks", f"gpt2-124m pipeline on {axes}",
                           GPT2Config.gpt2_124m(), mesh, PIPE_BATCH, RANKS_TRAIN_STEPS)
        log(f"[ranks] gpt2-124m pipeline on {axes} over {world} cards: median step "
            f"{run['median_step_ms']:.2f} ms beside one card's "
            f"{pipe_ref['median_step_ms']:.2f} ms (global batch {PIPE_BATCH}), on {card} each")
        out["pipeline_meshes"][json.dumps(axes)] = run
        got = pipeline_step(GPT2Config.gpt2_124m(**fp32), mesh, 2, DEVICE, RANKS_PARITY_BATCH)
        out["parity"][f"pipeline {json.dumps(axes)}"] = pipeline_compare(
            "ranks", f"on {axes} vs one card", got, ref, RANKS_REL_TOL)
    del ref

    # fault 3 on the cards: a head computed by tp / n_head ranks alike
    axes, heads = RANKS_FAULT3
    out["parity"][f"gpt2-124m-width {heads} heads {json.dumps(axes)}"] = mesh_parity(
        card, f"gpt2-124m width, {heads} heads, on {axes}",
        GPT2Config.gpt2_124m(n_head=heads, use_flash_attention=False, **fp32),
        make_mesh(axes, device=DEVICE), RANKS_PARITY_BATCH, RANKS_REL_TOL, tag="ranks")
    return out


def pipeline_reference(card: str, path: str):
    """One card alone, before ``--ranks`` starts its processes: the
    pipeline's GPT-2-124M run at dp 1 x pp 1 (its median step is what the
    pp meshes are timed beside) and the fp32 4-layer step (1 microbatch)
    they are held to, its parameters saved to ``path``. Starts and ends its
    own one-process NCCL group."""
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(PIPE_AXES, device=DEVICE)
    run = pipeline_run(card, "ranks", "gpt2-124m pipeline, one card",
                       GPT2Config.gpt2_124m(), mesh, PIPE_BATCH, RANKS_TRAIN_STEPS,
                       PIPE_MICRO)
    loss, norm, params = pipeline_step(
        GPT2Config.gpt2_124m(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32), mesh, 1,
        DEVICE, RANKS_PARITY_BATCH)
    torch.save(params, path)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"median_step_ms": run["median_step_ms"], "step_ms": run["step_ms"],
            "loss": loss, "grad_norm": norm, "path": path}


def _rank_main(rank: int, world: int, port: int, card: str, device: str, results,
               pipe_ref):
    """One process of ``--ranks``: its card, NCCL over ``tcp://localhost``."""
    import torch.distributed as dist

    global DEVICE, LOG
    DEVICE, LOG = device, rank == 0
    try:
        sys.path.insert(0, str(ROOT))
        from ray_tpu_torch._private.device import set_fp32_policy

        if device == "cuda":
            torch.cuda.set_device(rank)
            set_fp32_policy()
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=300))
        results.put((rank, "ok", phase_ranks(card, world, pipe_ref)))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def main_ranks(world: int) -> int:
    """``--ranks N``: the mesh path over N cards, one process each."""
    import multiprocessing as mp
    import queue

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke.py --ranks {world} needs {world} CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    import tempfile

    from ray_tpu_torch._private.device import set_fp32_policy

    set_fp32_policy()
    card = phase_device()
    phase_build()
    scratch = tempfile.TemporaryDirectory()
    pipe_ref = pipeline_reference(card, str(Path(scratch.name) / "pipeline_ref.pt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, card, DEVICE, results, pipe_ref))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + RANKS_DEADLINE_S
    try:
        while len(got) < world:
            try:
                rank, status, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(f"ranks {sorted(set(range(world)) - set(got))} gave "
                                     f"nothing within {RANKS_DEADLINE_S} s") from None
            if status == "error":
                raise AssertionError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:   # a failed or hung rank's peers wait in collectives
            if p.is_alive():
                p.kill()
            p.join()
        scratch.cleanup()
    got[0]["pipeline_one_card"] = {k: v for k, v in pipe_ref.items() if k != "path"}
    log(f"[ranks] {json.dumps(got[0])}")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    serve = phase_serve(card)
    train = phase_train(card)
    llama = phase_llama(card)
    spec = phase_spec(card, llama["prompts"], llama["outputs"], llama.pop("cpu_model"))
    moe = phase_moe(card)
    head_dims = phase_head_dims(card)
    mesh = phase_mesh(card, train)
    moe_mesh = phase_moe_mesh(card, moe)
    pipeline = phase_pipeline(card)
    torch.distributed.destroy_process_group()

    fwd_head = next(c for c in fwd_cases if "ms" in c and c["shape"] == list(HEADLINE[0])
                    and c["dtype"] == dtype_name(HEADLINE[1]))
    bwd_head = next(c for c in bwd_cases if "dq" in c and c["shape"] == list(HEADLINE[0])
                    and c["dtype"] == dtype_name(HEADLINE[1]))

    at = {"shape": list(HEADLINE[0]), "dtype": dtype_name(HEADLINE[1])}
    # plain attention calls on each full-width path: all must be 0
    plain_calls = {"train": train["plain_calls"], "serve": serve["plain_calls"],
                   "llama_train": llama["train"]["plain_calls"],
                   "llama_serve": llama["serve_plain_calls"],
                   "spec": spec["plain_calls"], "moe_train": moe["plain_calls"],
                   "mesh": mesh["plain_calls"], "moe_mesh": moe_mesh["plain_calls"],
                   "pipeline": pipeline["plain_calls"]}
    if any(plain_calls.values()):
        raise AssertionError(f"a full-width path left the kernels: {plain_calls}")
    fp32_bwd = [c for c in bwd_cases if c["dtype"] == "float32"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:42",
        "launches": train["launches"][0],
        "launches_by_path": {"train": train["launches"][0], "serve": serve["launches"],
                             "llama_train": llama["train"]["launches"][0],
                             "llama_serve": llama["serve_launches"],
                             "spec": spec["launches"],
                             "moe_train": moe["launches"][0],
                             "mesh": mesh["launches"][0],
                             "moe_mesh": moe_mesh["launches"][0],
                             "pipeline": pipeline["launches"][0]},
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
        "plain_calls_by_path": plain_calls,
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
                                                   ("moe_train", moe),
                                                   ("mesh", mesh),
                                                   ("moe_mesh", moe_mesh),
                                                   ("pipeline", pipeline))},
            "max_abs_err": max(c["abs_err"][o] for c in fp32_bwd for o in outputs),
            "max_abs_err_by_dtype": {dt: max(c["abs_err"][o] for c in bwd_cases
                                             if c["dtype"] == dt for o in outputs)
                                     for dt in ("float32", "bfloat16")},
            "ms": bwd_head[kernel]["ms"],
            "plain_ms": bwd_head["plain_ms"],
            "bound_ms": bwd_head[kernel]["bound_ms"],
            "bound_by": bwd_head[kernel]["bound_by"],
            "library_ms": bwd_head["library_ms"],
            "plain_calls_by_path": {path: plain_calls[path] for path in
                                    ("train", "llama_train", "moe_train", "mesh",
                                     "moe_mesh", "pipeline")},
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
    log(f"[serve] {json.dumps(serve)}")
    log(f"[head_dims] {json.dumps(head_dims)}")
    log(f"[mesh] {json.dumps(mesh)}")
    log(f"[moe_mesh] {json.dumps(moe_mesh)}")
    log(f"[pipeline] {json.dumps(pipeline)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        sys.exit(main_ranks(int(sys.argv[2])))
    sys.exit(main())
