"""Step-level training telemetry: the port of ``ray_tpu/train/_telemetry.py``.

A :class:`StepRecorder` takes one ``record_step`` per step call and gives
goodput, tokens and examples per second, MFU and a summary dict, with the
same formulas and keys as the JAX package's, and publishes them as the JAX
package does:

  1. ``ray_tpu_torch.util.metrics`` records with the JAX package's
     ``ray_tpu_train_*`` names, help strings and histogram boundaries
     (a runtime worker flushes them to the GCS; elsewhere read them with
     ``drain_records``);
  2. a ``train.step`` event in the flight recorder per step call;
  3. one span per step call, built as the JAX package builds it, into
     the task-event buffer of this process's runtime worker when there is
     one (none outside the runtime, as in the JAX package where
     ``global_worker`` is None);
  4. :func:`auto_report_metrics` and :func:`publish_report_summary`, the
     ``telemetry/*`` keys a trainer's report attaches.

It raises the same two flags for a watchdog to pop: a step slower than
``RTPU_TORCH_profile_slow_step_factor`` x the trailing median
(:meth:`StepRecorder.pop_slow_step`), and a storm of compile steps after
warm-up (:meth:`StepRecorder.pop_compile_storm`). Its
:class:`DeviceTraceController` opens a device-trace window over the next
N step calls with ``torch.profiler`` (CUDA kernels beside the host ops),
writes it as a Chrome trace, and, in a runtime worker, registers it with
the GCS, where ``profiling.list_registered(gcs, "device_trace")`` lists it
for the dashboard and scripts. ``publish_report_summary`` lives in the
torch-free ``_report_gauges`` (the driver and the Tune trial actor call it
without a card) and is re-exported here.

What differs on the card:

  - The peak table is keyed by substrings of ``torch.cuda.get_device_name``
    and holds the H100 SXM's dense bf16 peak; an unknown device (the CPU,
    another card) gets no MFU rather than a wrong one. As in the JAX
    package, the peak is per device times ``n_devices`` (a mesh
    ``TrainStep`` passes its mesh size and books the global batch's
    tokens).
  - HBM comes from ``torch.cuda.memory_allocated`` (in use) and
    ``torch.cuda.max_memory_allocated`` (peak); absent on the CPU.
  - Torch keeps no jit cache, so there is no cache miss to detect: the
    caller books its first step (the kernels' build and cuBLAS's warm-up)
    as the compile step. A compile storm needs a caller that books more.

Metric names are a stability contract — see ``ray_tpu_torch/util/metrics.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.train._report_gauges import publish_report_summary  # noqa: F401

# Peak dense matmul throughput per card (bf16 FLOP/s), keyed by substrings of
# torch.cuda.get_device_name: NVIDIA's H100 SXM data sheet (the SXM part
# reports itself as "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts, whose
# peaks are lower, do not match).
_PEAK_FLOPS_BY_NAME = {
    "H100 80GB HBM3": 989e12,
}

# Histogram boundaries for step seconds (the JAX package's): log-spaced
# 1 ms .. 60 s.
_STEP_SECONDS_BOUNDARIES = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def peak_flops_per_device(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a ``torch.cuda.get_device_name`` string,
    or None for a device the table does not know."""
    for name, flops in _PEAK_FLOPS_BY_NAME.items():
        if name.lower() in device_name.lower():
            return flops
    return None


def estimate_flops_per_token(model_cfg: Any) -> Optional[float]:
    """~6N FLOPs/token (forward + backward) from a transformer config's
    shape fields (n_layer, n_embd, vocab_size): N = 12 L d^2 + vocab d.
    Attention's sequence-length-dependent FLOPs are left out, as in the JAX
    package, which underestimates MFU by a few percent."""
    n_layer = getattr(model_cfg, "n_layer", None)
    n_embd = getattr(model_cfg, "n_embd", None)
    vocab = getattr(model_cfg, "vocab_size", None)
    if not (n_layer and n_embd and vocab):
        return None
    params = 12 * n_layer * n_embd * n_embd + vocab * n_embd
    return 6.0 * params


class StepRecorder:
    """Accumulates step-level training telemetry for one run and publishes
    it.

    Thread-safe; one recorder per training run (``TrainStep`` creates one
    and makes it the process's current recorder). ``device`` (a torch
    device) is where HBM is read and, when ``peak_flops`` is not given,
    whose name picks the peak; ``n_devices`` (default 1) is how many such
    devices the run's steps and tokens span, each with that peak. ``emit_metrics`` and ``emit_spans`` turn the
    metric records and the spans off; ``clock`` (durations) and
    ``wall_clock`` (span and flag times) are injectable for tests."""

    def __init__(
        self,
        *,
        flops_per_step: Optional[float] = None,
        flops_per_token: Optional[float] = None,
        peak_flops: Optional[float] = None,
        n_devices: Optional[int] = None,
        device=None,
        run_name: str = "",
        emit_metrics: bool = True,
        emit_spans: bool = True,
        publish_interval_s: float = 0.5,
        clock=time.monotonic,
        wall_clock=time.time,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        self._wall = wall_clock
        self._flops_per_step = flops_per_step
        self._flops_per_token = flops_per_token
        self._explicit_peak = peak_flops
        self._n_devices = n_devices
        self._device = torch.device(device) if device is not None else None
        self.run_name = run_name
        self._emit_metrics = emit_metrics
        self._emit_spans = emit_spans
        self._start = self._clock()
        self._trace_id = uuid.uuid4().hex
        self.steps = 0
        self.productive_steps = 0
        self.productive_s = 0.0
        self.compile_s = 0.0
        self.tokens = 0
        self.examples = 0
        self._last_step_s = 0.0
        self._metrics = None
        # Derived gauges (goodput, MFU, throughput) recompute at most every
        # publish_interval_s; the per-step cost stays at one histogram
        # observe and one counter increment.
        self._publish_interval = publish_interval_s
        self._last_gauge_pub = float("-inf")
        self._last_step_at = self._start
        # Slow-step flag: per-step durations feed a trailing window; a step
        # slower than factor x the window's median (refreshed every 8
        # steps) is flagged for pop_slow_step. Flags are read once here:
        # each CONFIG read is an os.environ probe.
        self._slow_factor = CONFIG.profile_slow_step_factor
        self._recent_steps: deque = deque(maxlen=32)
        self._median_cache: Optional[float] = None
        self._steps_since_median = 0
        self._slow_step: Optional[Dict[str, float]] = None
        # Compile-storm flag: >= K compile steps within the window, once
        # more than the warm-up's steps were recorded.
        self._storm_k = int(CONFIG.perf_compile_storm_k)
        self._storm_window = float(CONFIG.perf_compile_storm_window_s)
        self._storm_warmup = int(CONFIG.perf_compile_warmup_steps)
        self._compile_times: deque = deque(maxlen=64)
        self._compile_storm: Optional[Dict[str, float]] = None
        # Device-trace window (torch.profiler), armed by request_device_trace
        # or RTPU_TORCH_device_trace_steps; driven by TrainStep around a step.
        self.device_trace = DeviceTraceController()

    # ------------------------------------------------------------ recording

    def record_step(
        self,
        duration_s: float,
        *,
        steps: int = 1,
        tokens: Optional[int] = None,
        examples: Optional[int] = None,
        compile_step: bool = False,
        start_wall: Optional[float] = None,
    ) -> None:
        """Record ``steps`` optimizer steps that took ``duration_s`` of wall
        time in total. A ``compile_step`` is booked as compile time, not
        productive time, so MFU and throughput are not poisoned by it."""
        duration_s = max(0.0, float(duration_s))
        _fr.record("train.step", b"",
                   f"{steps}x {duration_s:.4f}s"
                   + (" compile" if compile_step else ""))
        with self._lock:
            self.steps += steps
            self._last_step_at = self._clock()
            if compile_step:
                self.compile_s += duration_s
                if self._storm_k > 0 and self.steps > self._storm_warmup:
                    now_m = self._clock()
                    self._compile_times.append(now_m)
                    recent = [t for t in self._compile_times
                              if now_m - t <= self._storm_window]
                    if len(recent) >= self._storm_k:
                        self._compile_storm = {
                            "compiles": len(recent),
                            "window_s": self._storm_window,
                            "step": self.steps,
                            "compile_s": self.compile_s,
                            "time": self._wall(),
                        }
            else:
                self.productive_s += duration_s
                self.productive_steps += steps
                per_step = duration_s / max(steps, 1)
                self._last_step_s = per_step
                # flag before appending: the outlier must not dilute the
                # median it is judged against
                med = self._median_cache
                if (self._slow_factor > 0 and med is not None and med > 0
                        and per_step > self._slow_factor * med):
                    self._slow_step = {
                        "step": self.steps,
                        "duration_s": per_step,
                        "median_s": med,
                        "ratio": per_step / med,
                        "time": self._wall(),
                    }
                self._recent_steps.append(per_step)
                self._steps_since_median += 1
                if (self._steps_since_median >= 8
                        and len(self._recent_steps) >= 8):
                    self._median_cache = statistics.median(self._recent_steps)
                    self._steps_since_median = 0
            if tokens:
                self.tokens += tokens
            if examples:
                self.examples += examples
        if self._emit_metrics:
            self._publish(duration_s, steps, compile_step)
        if self._emit_spans:
            self._emit_step_span(duration_s, steps, tokens, compile_step,
                                 start_wall)

    def step_timer(self):
        """Context manager measuring one step call: ``with rec.step_timer():``"""
        return _StepTimer(self)

    def seconds_since_last_step(self) -> Optional[float]:
        """Age of the newest recorded step; None before the first step (what
        a stall watchdog reads to find a loop that went silent)."""
        with self._lock:
            if self.steps == 0:
                return None
            return self._clock() - self._last_step_at

    def pop_slow_step(self) -> Optional[Dict[str, float]]:
        """Latest pending slow-step flag (a step slower than
        profile_slow_step_factor x the trailing median), cleared on read."""
        with self._lock:
            out, self._slow_step = self._slow_step, None
            return out

    def pop_compile_storm(self) -> Optional[Dict[str, float]]:
        """Pending compile-storm flag (>= K post-warm-up compile steps
        within the configured window), cleared on read."""
        with self._lock:
            out, self._compile_storm = self._compile_storm, None
            return out

    # ------------------------------------------------------------- derived

    def _elapsed(self) -> float:
        return max(self._clock() - self._start, 1e-9)

    def goodput(self) -> float:
        """Fraction of elapsed wall time spent in productive steps."""
        return min(1.0, self.productive_s / self._elapsed())

    def tokens_per_second(self) -> Optional[float]:
        if not self.tokens or self.productive_s <= 0:
            return None
        return self.tokens / self.productive_s

    def examples_per_second(self) -> Optional[float]:
        if not self.examples or self.productive_s <= 0:
            return None
        return self.examples / self.productive_s

    def _peak_flops(self) -> Optional[float]:
        """Peak FLOP/s of the whole run: per device times ``n_devices``."""
        n = self._n_devices or 1
        if self._explicit_peak is not None:
            return self._explicit_peak * n
        if self._device is None or self._device.type != "cuda":
            return None
        per = peak_flops_per_device(torch.cuda.get_device_name(self._device))
        return None if per is None else per * n

    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization: achieved FLOP/s over peak FLOP/s; None
        without a FLOPs estimate or a known peak."""
        peak = self._peak_flops()
        if peak is None or self.productive_s <= 0:
            return None
        if self._flops_per_step is not None:
            achieved = self._flops_per_step * self.productive_steps
        elif self._flops_per_token is not None and self.tokens:
            achieved = self._flops_per_token * self.tokens
        else:
            return None
        return achieved / self.productive_s / peak

    def hbm_bytes(self) -> Dict[str, float]:
        """``{"in_use": ..., "peak": ...}`` bytes allocated by PyTorch on the
        recorder's CUDA device; {} elsewhere."""
        if self._device is None or self._device.type != "cuda":
            return {}
        return {"in_use": float(torch.cuda.memory_allocated(self._device)),
                "peak": float(torch.cuda.max_memory_allocated(self._device))}

    def hbm_bytes_in_use(self) -> Dict[str, float]:
        """Bytes in use per device, ``{"cuda:<i>": bytes}``, as the JAX
        package keys its devices; {} on the CPU."""
        hbm = self.hbm_bytes()
        if not hbm:
            return {}
        index = self._device.index
        index = torch.cuda.current_device() if index is None else index
        return {f"cuda:{index}": hbm["in_use"]}

    def summary(self) -> Dict[str, Any]:
        """Rolling summary dict, with the JAX package's keys (plus
        ``hbm_peak_bytes``)."""
        with self._lock:
            steps = self.steps
            productive = self.productive_s
            compile_s = self.compile_s
            last = self._last_step_s
        out = {
            "steps": steps,
            "step_time_s": last,
            "productive_time_s": round(productive, 6),
            "compile_time_s": round(compile_s, 6),
            "goodput": round(self.goodput(), 6),
        }
        tps = self.tokens_per_second()
        if tps is not None:
            out["tokens_per_s"] = round(tps, 3)
        eps = self.examples_per_second()
        if eps is not None:
            out["examples_per_s"] = round(eps, 3)
        mfu = self.mfu()
        if mfu is not None:
            out["mfu"] = round(mfu, 6)
        hbm = self.hbm_bytes()
        if hbm:
            out["hbm_bytes_in_use"] = hbm["in_use"]
            out["hbm_peak_bytes"] = hbm["peak"]
        return out

    # ------------------------------------------------------------ emission

    def _metric_objects(self):
        if self._metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

            tags = ("run",)
            self._metrics = {
                "step_seconds": Histogram(
                    "ray_tpu_train_step_seconds",
                    "wall time per optimizer step",
                    boundaries=_STEP_SECONDS_BOUNDARIES, tag_keys=tags),
                "steps_total": Counter(
                    "ray_tpu_train_steps_total",
                    "optimizer steps completed", tag_keys=tags),
                "tokens_per_s": Gauge(
                    "ray_tpu_train_tokens_per_second",
                    "training throughput, tokens/s", tag_keys=tags),
                "examples_per_s": Gauge(
                    "ray_tpu_train_examples_per_second",
                    "training throughput, examples/s", tag_keys=tags),
                "mfu": Gauge(
                    "ray_tpu_train_mfu_ratio",
                    "estimated model FLOPs utilization (0-1)", tag_keys=tags),
                "goodput": Gauge(
                    "ray_tpu_train_goodput_ratio",
                    "productive step time / elapsed wall time (0-1)",
                    tag_keys=tags),
                "compile_s": Gauge(
                    "ray_tpu_train_compile_seconds",
                    "cumulative jit compile time", tag_keys=tags),
                "hbm": Gauge(
                    "ray_tpu_train_hbm_bytes_in_use",
                    "per-device HBM bytes in use",
                    tag_keys=tags + ("device",)),
            }
        return self._metrics

    def _publish(self, duration_s: float, steps: int, compile_step: bool):
        try:
            m = self._metric_objects()
            tags = {"run": self.run_name}
            if compile_step:
                m["compile_s"].set(self.compile_s, tags=tags)
            else:
                # one observation per step call at the per-step duration
                m["step_seconds"].observe(
                    duration_s / max(steps, 1), tags=tags)
            m["steps_total"].inc(steps, tags=tags)
            now = self._clock()
            if (now - self._last_gauge_pub < self._publish_interval
                    and not compile_step):
                return
            self._last_gauge_pub = now
            m["goodput"].set(self.goodput(), tags=tags)
            tps = self.tokens_per_second()
            if tps is not None:
                m["tokens_per_s"].set(tps, tags=tags)
            eps = self.examples_per_second()
            if eps is not None:
                m["examples_per_s"].set(eps, tags=tags)
            mfu = self.mfu()
            if mfu is not None:
                m["mfu"].set(mfu, tags=tags)
            for dev, used in self.hbm_bytes_in_use().items():
                m["hbm"].set(used, tags={**tags, "device": dev})
        except Exception:
            pass  # telemetry must never fail a training step

    def _emit_step_span(self, duration_s, steps, tokens, compile_step,
                        start_wall):
        """One SPAN task event per step call, ``(name, start, end, trace
        context, attributes)``, handed to this process's runtime worker (the
        timeline renders step boundaries beside task execution) when there
        is one, as in the JAX package; returned either way (None on an
        error)."""
        try:
            end = self._wall()
            start = start_wall if start_wall is not None else end - duration_s
            ctx = {
                "trace_id": self._trace_id,
                "span_id": uuid.uuid4().hex[:16],
                "parent_span_id": "",
            }
            name = "train_step.compile" if compile_step else "train_step"
            attrs = {"step": self.steps, "num_steps": steps}
            if tokens:
                attrs["tokens"] = tokens
            # no import: a process that never loaded the runtime has no
            # worker, and the runtime's modules are not free to import
            worker_mod = sys.modules.get("ray_tpu_torch._private.worker")
            w = getattr(worker_mod, "global_worker", None)
            if w is not None:
                w.task_events.record_span(name, start, end, ctx, attrs)
            return name, start, end, ctx, attrs
        except Exception:
            return None


class _StepTimer:
    def __init__(self, recorder: StepRecorder):
        self._rec = recorder
        self._t0 = None
        self._w0 = None
        self.tokens: Optional[int] = None
        self.examples: Optional[int] = None
        self.steps = 1
        self.compile_step = False

    def __enter__(self):
        self._t0 = self._rec._clock()
        self._w0 = self._rec._wall()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._rec.record_step(
                self._rec._clock() - self._t0,
                steps=self.steps, tokens=self.tokens, examples=self.examples,
                compile_step=self.compile_step, start_wall=self._w0,
            )
        return False


# ------------------------------------------------------ device-trace window
# A host clock sees when a step call returns; what the card did inside it
# needs a device trace. This controller opens a torch.profiler window
# (host ops and, on a CUDA device, the kernels) around N step calls —
# TrainStep calls on_step_begin/on_step_end around each — and writes it as
# a Chrome trace (open in chrome://tracing or Perfetto).


class DeviceTraceController:
    """Arm-once device-trace windows; inert (two attribute reads per step)
    unless armed via ``request()`` or ``RTPU_TORCH_device_trace_steps=N``.
    ``last_trace`` is the path of the last window's Chrome trace."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active = False
        self._dir: Optional[str] = None
        self._count = 0
        self._target = 0
        self._requested_dir: Optional[str] = None
        self._profiler = None
        self.last_trace: Optional[str] = None
        self._armed = max(0, int(CONFIG.device_trace_steps))

    # ------------------------------------------------------------- control

    def request(self, num_steps: int = 3,
                trace_dir: Optional[str] = None) -> None:
        """Arm a trace window around the next ``num_steps`` step calls."""
        with self._lock:
            if not self._active:
                self._armed = max(1, int(num_steps))
                self._requested_dir = trace_dir

    @staticmethod
    def supported() -> bool:
        """Device tracing is a no-op without a CUDA device;
        RTPU_TORCH_device_trace_force=1 overrides (tests, host-trace
        debugging)."""
        if CONFIG.device_trace_force:
            return True
        return torch.cuda.is_available()

    def _trace_dir(self) -> str:
        if self._requested_dir:
            return self._requested_dir
        base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_device_traces")
        return os.path.join(base, f"trace_{int(time.time() * 1000)}")

    # ----------------------------------------------------------- per step

    def on_step_begin(self) -> None:
        if not self._armed or self._active:
            return
        with self._lock:
            if not self._armed or self._active:
                return
            target, self._armed = self._armed, 0
            if not self.supported():
                return  # silently disarm: no-op without a device
            try:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                path = self._trace_dir()
                os.makedirs(path, exist_ok=True)
                prof = profile(activities=activities)
                prof.start()
            except Exception:
                return
            self._profiler = prof
            self._active = True
            self._dir = path
            self._target = target
            self._count = 0

    def on_step_end(self, out=None) -> None:
        """Count a step call; after the window's last one, synchronise the
        device (so the window holds the whole step, not its launch), stop
        the profiler and write ``<dir>/trace.json``. ``out`` is the step's
        result, kept for the JAX package's signature."""
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            self._count += 1
            if self._count < self._target:
                return
            self._active = False
            path, self._dir = self._dir, None
            prof, self._profiler = self._profiler, None
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.stop()
                trace = os.path.join(path, "trace.json")
                prof.export_chrome_trace(trace)
            except Exception:
                return
            self.last_trace = trace
        self._register(path)

    def _register(self, path: str) -> None:
        """Register the window with the GCS (``profiling.register_device_trace``)
        when this process is a runtime worker (probed in ``sys.modules``,
        never imported)."""
        worker_mod = sys.modules.get("ray_tpu_torch._private.worker")
        w = worker_mod.global_worker if worker_mod is not None else None
        if w is None:
            return
        try:
            from ray_tpu_torch._private import profiling

            profiling.register_device_trace(w.gcs, path, steps=self._target)
        except Exception:
            pass


def read_device_trace(path: str) -> Dict[str, Any]:
    """What a window's Chrome trace says of the device and the host's CUDA
    calls: ``kernel_us`` (total microseconds per kernel name),
    ``runtime_us`` and ``runtime_calls`` (per CUDA runtime or driver call
    on the host: cudaMalloc, cudaLaunchKernel, ...), ``copy_us`` (total
    microseconds of device copies and memsets), ``window_us`` (from the
    first to the last event of the trace, host or device), ``busy_us`` (the
    union of kernel, copy and memset intervals), ``busy_share`` = busy /
    window, and where the idle time sits: ``lead_us`` before the first
    device interval, ``tail_us`` after the last, ``gap_us`` between."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernel_us: Dict[str, float] = {}
    runtime_us: Dict[str, float] = {}
    runtime_calls: Dict[str, int] = {}
    device = []
    copy_us = 0.0
    for e in spans:
        cat = str(e.get("cat", "")).lower()
        if cat == "kernel":
            kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) + float(e["dur"])
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copy_us += float(e["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if cat in ("cuda_runtime", "cuda_driver"):
            runtime_us[e["name"]] = runtime_us.get(e["name"], 0.0) + float(e["dur"])
            runtime_calls[e["name"]] = runtime_calls.get(e["name"], 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(device):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = lead = tail = 0.0
    if spans:
        first = min(float(e["ts"]) for e in spans)
        last = max(float(e["ts"]) + float(e["dur"]) for e in spans)
        window = last - first
        if device:
            lead = min(a for a, _ in device) - first
            tail = last - max(b for _, b in device)
    return {"kernel_us": kernel_us, "copy_us": copy_us, "runtime_us": runtime_us,
            "runtime_calls": runtime_calls, "window_us": window, "busy_us": busy,
            "busy_share": busy / window if window > 0 else 0.0,
            "lead_us": lead, "tail_us": tail,
            "gap_us": max(0.0, window - busy - lead - tail) if device else 0.0}


def request_device_trace(num_steps: int = 3,
                         trace_dir: Optional[str] = None) -> bool:
    """Arm a device-trace window on the current recorder; False when no
    recorder is registered in this process."""
    rec = current_recorder()
    if rec is None:
        return False
    rec.device_trace.request(num_steps, trace_dir)
    return True


# ----------------------------------------------------- process-global hookup
# TrainStep registers its recorder here; a trainer's report attaches the
# summary of whatever recorder is current in this process.

_current: Optional[StepRecorder] = None
_current_lock = threading.Lock()


def set_current_recorder(recorder: Optional[StepRecorder]) -> None:
    global _current
    with _current_lock:
        _current = recorder


def current_recorder() -> Optional[StepRecorder]:
    return _current


def get_or_create_recorder(**kwargs) -> StepRecorder:
    global _current
    with _current_lock:
        if _current is None:
            _current = StepRecorder(**kwargs)
        return _current


def auto_report_metrics() -> Dict[str, Any]:
    """Telemetry keys merged into every trainer report (namespaced so they
    never collide with user metrics)."""
    rec = current_recorder()
    if rec is None:
        return {}
    return {f"telemetry/{k}": v for k, v in rec.summary().items()}
