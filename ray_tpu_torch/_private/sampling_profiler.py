"""Periodic sampling CPU profiler: the capture half of the profiling plane.

Pure-Python py-spy analogue (reference: the dashboard's py-spy integration,
dashboard/modules/reporter/profile_manager.py — here without the binary
dependency): a daemon thread wakes at a fixed rate, walks every thread's
frame via ``sys._current_frames``, and records *timestamped* samples — not
just aggregated counts — so the samples can later be laid onto the cluster
timeline next to task/span events (``_private/timeline.py``
``merged_profile_trace``). Folded flamegraph output is derived from the
same samples (``fold_samples``).

Design constraints:
  - **Idle cost is zero.** Nothing on any hot path consults this module;
    a profiler exists only between StartProfile and CollectProfile RPCs
    (worker/raylet/GCS handlers) or an explicit ``start_profile()`` call.
    The only always-resident state is one module-level ``_active`` slot.
  - **Bounded memory.** Stacks are interned (most samples repeat a few
    distinct stacks); the sample list is capped by ``max_samples``
    (RTPU_TORCH_profile_max_samples), after which sampling keeps aggregating
    into the folded counters but stops appending timeline samples.
  - **Wire-friendly result.** ``result()`` is a plain msgpack-able dict:
    {"t0", "t1", "hz", "pid", "role", "threads": [name, ...],
     "stacks": ["a;b;c", ...], "samples": [[dt_s, thread_i, stack_i], ...],
     "truncated": bool} — indices into the interned tables.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import CONFIG

_MAX_DEPTH = 128
_MAX_DURATION_S = 120.0
_MAX_HZ = 500.0

# Threads that are ~always parked in epoll/wait and would only add noise
# lanes; same skip rule as profiling.sample_stacks.
_IDLE_PREFIXES = ("rtpu-io",)
_IDLE_SUFFIXES = ("-watchdog",)


def frame_label(frame) -> str:
    code = frame.f_code
    fname = code.co_filename.rsplit("/", 1)[-1]
    return f"{code.co_name} ({fname}:{frame.f_lineno})"


def walk_stack(frame) -> str:
    """Root→leaf ';'-joined stack for one thread's current frame."""
    stack: List[str] = []
    f = frame
    depth = 0
    while f is not None and depth < _MAX_DEPTH:
        stack.append(frame_label(f))
        f = f.f_back
        depth += 1
    stack.reverse()
    return ";".join(stack)


def _is_idle_thread(name: str) -> bool:
    return name.startswith(_IDLE_PREFIXES) or name.endswith(_IDLE_SUFFIXES)


class SamplingProfiler:
    """One timed capture of this process's thread stacks.

    ``start(duration_s)`` spawns the sampler thread; ``collect()`` joins it
    (waiting out the remaining window) and returns the result dict. A
    profiler object is single-use.
    """

    def __init__(self, hz: float = 99.0, *, include_idle: bool = False,
                 max_samples: Optional[int] = None, role: str = ""):
        self.hz = min(max(1.0, float(hz)), _MAX_HZ)
        self.include_idle = include_idle
        self.max_samples = (
            int(max_samples) if max_samples is not None
            else CONFIG.profile_max_samples
        )
        self.role = role
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._t0 = 0.0
        self._t1 = 0.0
        self._threads: List[str] = []
        self._thread_index: Dict[str, int] = {}
        self._stacks: List[str] = []
        self._stack_index: Dict[str, int] = {}
        self._samples: List[list] = []  # [dt_s, thread_i, stack_i]
        self._truncated = False

    # ------------------------------------------------------------ lifecycle

    def start(self, duration_s: float) -> None:
        if self._thread is not None:
            raise RuntimeError("profiler already started")
        duration_s = min(max(0.05, float(duration_s)), _MAX_DURATION_S)
        self._t0 = time.time()
        self._deadline = time.monotonic() + duration_s
        self._thread = threading.Thread(
            # the sampler skips itself by ident, but keep the -watchdog
            # suffix so the legacy one-shot sampler skips it too when both
            # run at once
            target=self._loop, name="rtpu-sampler-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def collect(self, extra_timeout: float = 10.0) -> dict:
        """Wait out the remaining window and return the result dict."""
        t = self._thread
        if t is not None:
            remaining = max(0.0, self._deadline - time.monotonic())
            t.join(remaining + extra_timeout)
            if t.is_alive():  # wedged sampler: cut it loose, return partial
                self._stop.set()
        return self.result()

    # ------------------------------------------------------------- sampling

    def _loop(self):
        period = 1.0 / self.hz
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        refresh = 0
        while not self._stop.is_set() and time.monotonic() < self._deadline:
            now = time.time()
            try:
                frames = sys._current_frames()
            except Exception:
                break
            for tid, frame in frames.items():
                if tid == me:
                    continue
                name = names.get(tid) or str(tid)
                if not self.include_idle and _is_idle_thread(name):
                    continue
                self._record(now, name, walk_stack(frame))
            refresh += 1
            if refresh >= 32:  # new threads appear mid-capture
                refresh = 0
                names = {t.ident: t.name for t in threading.enumerate()}
            self._stop.wait(period)
        self._t1 = time.time()

    def _record(self, now: float, thread_name: str, stack: str):
        ti = self._thread_index.get(thread_name)
        if ti is None:
            ti = self._thread_index[thread_name] = len(self._threads)
            self._threads.append(thread_name)
        si = self._stack_index.get(stack)
        if si is None:
            si = self._stack_index[stack] = len(self._stacks)
            self._stacks.append(stack)
        if len(self._samples) < self.max_samples:
            self._samples.append([round(now - self._t0, 6), ti, si])
        else:
            self._truncated = True

    # -------------------------------------------------------------- results

    def result(self) -> dict:
        return {
            "t0": self._t0,
            "t1": self._t1 or time.time(),
            "hz": self.hz,
            "pid": os.getpid(),
            "role": self.role,
            "threads": list(self._threads),
            "stacks": list(self._stacks),
            "samples": list(self._samples),
            "truncated": self._truncated,
        }


def fold_samples(profile: dict, *, thread_prefix: bool = True) -> Dict[str, int]:
    """Aggregate a profile's samples into {folded_stack: count}
    (flamegraph.pl / speedscope 'folded' input, same shape as
    profiling.sample_stacks)."""
    threads = profile.get("threads", [])
    stacks = profile.get("stacks", [])
    counts: Dict[str, int] = {}
    for _dt, ti, si in profile.get("samples", []):
        try:
            stack = stacks[si]
        except (IndexError, TypeError):
            continue
        if thread_prefix:
            name = threads[ti] if 0 <= ti < len(threads) else str(ti)
            stack = f"{name};{stack}"
        counts[stack] = counts.get(stack, 0) + 1
    return counts


# ------------------------------------------------- per-process active slot
# One capture at a time per process: StartProfile replaces nothing — a
# second start while one runs is an error surfaced to the caller, EXCEPT
# an already-finished capture which is silently discarded (an operator who
# never collected shouldn't wedge the process forever).

_active: Optional[SamplingProfiler] = None
_active_lock = threading.Lock()


def start_profile(duration_s: float, hz: float = 99.0, *,
                  include_idle: bool = False, role: str = "") -> SamplingProfiler:
    global _active
    with _active_lock:
        if _active is not None and _active.running:
            raise RuntimeError("a profile capture is already running")
        prof = SamplingProfiler(hz, include_idle=include_idle, role=role)
        prof.start(duration_s)
        _active = prof
        return prof


def collect_profile() -> Optional[dict]:
    """Collect (blocking until the window closes) and clear the active
    capture; None when nothing was started."""
    global _active
    with _active_lock:
        prof, _active = _active, None
    if prof is None:
        return None
    return prof.collect()


def is_active() -> bool:
    prof = _active
    return prof is not None and prof.running
