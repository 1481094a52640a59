"""Stall watchdog: turn silent hangs into GCS incidents with evidence.

The dominant failure mode on TPU pods is not a crash but a *hang*: one
mismatched collective or dead host blocks every worker in the mesh and the
operator sees nothing but a stuck progress bar (arxiv 2011.03641 §5,
arxiv 2412.14374 — straggler/hang diagnosis is the hard operational
problem at scale). This watchdog runs beside the driver (this module) and
beside every raylet (NodeManager._watchdog_loop) and fires when:

  - a submitted task has not resolved for ``RTPU_TORCH_watchdog_task_timeout_s``
    (driver side) / a lease has been held that long (raylet side);
  - work is pending but the completion counter has not moved for the same
    window (actor queue growing without completions);
  - train-step telemetry (train/_telemetry.StepRecorder) recorded steps
    and then went silent for ``RTPU_TORCH_watchdog_step_timeout_s``;
  - the StepRecorder flagged a slow step (``slow_step``) or a post-warmup
    recompilation storm (``jit_cache_miss_storm``,
    ``RTPU_TORCH_perf_compile_storm_k`` compiles inside
    ``RTPU_TORCH_perf_compile_storm_window_s``).

On trigger it captures evidence while the hang is still live — its own
stacks via profiling.sample_stacks, the stuck task's executing worker via
profiling.profile_via_raylets, and a flight-recorder ring snapshot — and
publishes an **incident** record to the GCS (``ReportIncident``), where
``ray-tpu-torch status`` counts it and ``ray-tpu-torch debug incidents`` / ``debug
dump`` retrieve it. Each condition fires once per subject (task id / lease
id / recorder) — a stuck mesh must not turn into an incident storm.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private.config import CONFIG

_RING_SNAPSHOT_LIMIT = 200
_STACK_SAMPLE_S = 0.2


def capture_local_stacks(label: str) -> dict:
    """Sample THIS process's threads into a folded-stack section."""
    from ray_tpu_torch._private import profiling

    counts = profiling.sample_stacks(_STACK_SAMPLE_S, hz=50.0,
                                     include_idle=True)
    return {"target": label, "folded": profiling.folded_text(counts)}


def build_incident(kind: str, source: str, detail: str, *,
                   node_id: str = "", worker_id: str = "",
                   task_id: str = "", task_name: str = "",
                   stacks: Optional[list] = None) -> dict:
    return {
        "kind": kind,
        "source": source,
        "detail": detail,
        "node_id": node_id,
        "worker_id": worker_id,
        "task_id": task_id,
        "task_name": task_name,
        "time": time.time(),
        "status": "open",
        "stacks": stacks or [],
        "ring": _fr.dump(limit=_RING_SNAPSHOT_LIMIT),
    }


def capture_incident_profile(core, reason: str) -> Optional[str]:
    """Automatic evidence capture for the profiling plane: one short
    cluster-wide sampling window (profiling.capture_cluster_profile),
    merged with the current task/span timeline and any registered device
    traces into a Perfetto-loadable JSON under
    ``<session>/logs/profiles/``. Returns the file path (registered in the
    GCS capture registry so `ray-tpu-torch debug dump` and the dashboard find
    it), or None when capture failed — incident publishing must never
    depend on it."""
    import json

    from ray_tpu_torch._private import profiling
    from ray_tpu_torch._private import timeline as _tl

    try:
        nodes = core.gcs.get_all_node_info()
        bundle = profiling.capture_cluster_profile(
            nodes, core.gcs,
            duration=CONFIG.profile_trigger_duration_s,
            hz=CONFIG.profile_trigger_hz,
        )
        try:
            task_events = core.gcs.call(
                "GetTaskEvents", {"limit": 20_000}, timeout=10)["events"]
        except Exception:
            task_events = []
        device = profiling.list_registered(core.gcs, "device_trace")
        trace = _tl.merged_profile_trace(bundle, task_events, device)
        base = core.session_dir
        if not base:
            try:
                base = core.gcs.call(
                    "GetInternalConfig", {}, timeout=5).get("session_dir", "")
            except Exception:
                base = ""
        if base:
            out_dir = os.path.join(base, "logs", "profiles")
        else:
            import tempfile

            out_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_profiles")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"profile_{reason}_{int(time.time() * 1000)}.json")
        with open(path, "w") as f:
            json.dump(trace, f)
        profiling.register_capture(core.gcs, path, reason=reason)
        _record_capture_metric(reason)
        return path
    except Exception:
        return None


_capture_counter = None
_storm_counter = None


def _record_storm_metric():
    global _storm_counter
    try:
        from ray_tpu_torch.util.metrics import Counter

        if _storm_counter is None:
            _storm_counter = Counter(
                "ray_tpu_perf_compile_storms_total",
                "jit_cache_miss_storm incidents raised by the watchdog")
        _storm_counter.inc()
    except Exception:
        pass


def _record_capture_metric(reason: str):
    global _capture_counter
    try:
        from ray_tpu_torch.util.metrics import Counter

        if _capture_counter is None:
            _capture_counter = Counter(
                "ray_tpu_profile_captures_total",
                "automatic cluster-profile captures", tag_keys=("trigger",))
        _capture_counter.inc(tags={"trigger": reason})
    except Exception:
        pass


class StallWatchdog:
    """Per-CoreWorker watchdog thread (drivers AND workers: the driver
    watches its submitted tasks; a train worker carries the step-stall
    check because the StepRecorder lives in its process)."""

    def __init__(self, core):
        self.core = core
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fired: set = set()  # dedupe keys, one incident per subject
        self._progress = (0, time.time())  # (tasks_completed, t of change)
        # Slow steps and compile storms recur by nature, so they rate-limit
        # on a cooldown instead of the once-per-subject set.
        self._last_slow_capture = 0.0
        self._last_storm_fire = 0.0

    def start(self):
        self._thread = threading.Thread(
            # name ends in "-watchdog": profiling.sample_stacks skips it
            target=self._loop, name="rtpu-stall-watchdog", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        interval = CONFIG.watchdog_interval_s
        while not self._stop.wait(interval):
            if self.core.is_shutdown:
                return
            try:
                self.check()
            except Exception:
                pass

    # ------------------------------------------------------------- checks

    def check(self):
        core = self.core
        now = time.time()
        task_timeout = CONFIG.watchdog_task_timeout_s

        completed = core.tasks_completed
        if completed != self._progress[0]:
            self._progress = (completed, now)

        # 1. a specific submitted task stuck past the threshold
        stuck_id, stuck_rec = None, None
        for task_id, rec in list(core._pending_tasks.items()):
            t0 = rec.get("t_submit")
            if t0 and now - t0 > task_timeout:
                stuck_id, stuck_rec = task_id, rec
                break
        if stuck_id is not None and ("task", stuck_id) not in self._fired:
            self._fired.add(("task", stuck_id))
            self._fire_stuck_task(stuck_id, stuck_rec, now)
        # 2. generic no-progress: work outstanding, counter frozen
        elif (core._pending_tasks
              and now - self._progress[1] > task_timeout
              and ("progress", self._progress[0]) not in self._fired):
            self._fired.add(("progress", self._progress[0]))
            self._fire(
                "no_progress",
                f"{len(core._pending_tasks)} tasks outstanding and no "
                f"completion for {now - self._progress[1]:.0f}s",
            )

        # 3. train-step telemetry went silent
        step_timeout = CONFIG.watchdog_step_timeout_s
        # no import: the train telemetry module imports torch, and a process
        # that never loaded it has no recorder (a worker that never trained
        # must not pay for torch on a watchdog tick)
        telemetry = sys.modules.get("ray_tpu_torch.train._telemetry")
        try:
            rec = telemetry.current_recorder() if telemetry is not None else None
        except Exception:
            rec = None
        if rec is not None and step_timeout > 0:
            age = rec.seconds_since_last_step()
            if (age is not None and age > step_timeout
                    and ("train", id(rec)) not in self._fired):
                self._fired.add(("train", id(rec)))
                self._fire(
                    "train_stall",
                    f"train-step telemetry silent for {age:.0f}s "
                    f"after {rec.steps} recorded steps",
                )

        # 4. a train step blew past the trailing median: capture a cluster
        #    profile while the cause (input stall, straggler host, noisy
        #    neighbor) is still warm and publish it as a slow_step incident
        if rec is not None and hasattr(rec, "pop_slow_step"):
            slow = rec.pop_slow_step()
            cooldown = CONFIG.profile_slow_step_cooldown_s
            if (slow is not None
                    and now - self._last_slow_capture >= cooldown):
                self._last_slow_capture = now
                self._fire_slow_step(slow)

        # 5. jit-cache-miss storm: the StepRecorder counts post-warmup
        #    recompilations (previously detected, logged, and dropped) —
        #    many inside one window means throughput is being eaten by XLA
        #    retracing (unstable shapes/dtypes), which deserves an incident
        #    with an attached capture, not a log line nobody reads.
        if rec is not None and hasattr(rec, "pop_compile_storm"):
            storm = rec.pop_compile_storm()
            cooldown = CONFIG.profile_slow_step_cooldown_s
            if (storm is not None
                    and now - self._last_storm_fire >= cooldown):
                self._last_storm_fire = now
                self._fire_compile_storm(storm)

    # -------------------------------------------------------------- firing

    def _fire_stuck_task(self, task_id: bytes, rec: dict, now: float):
        spec = rec.get("spec", {})
        lease = rec.get("lease")
        stacks = self._gather_stacks(
            lease["worker_id"] if lease else None)
        self._publish(build_incident(
            "stuck_task", self.core.mode,
            f"task {spec.get('name', '?')} submitted "
            f"{now - rec.get('t_submit', now):.0f}s ago and never resolved",
            node_id=self.core.node_id.hex() if self.core.node_id else "",
            worker_id=self.core.worker_id.hex(),
            task_id=task_id.hex(),
            task_name=spec.get("name", ""),
            stacks=stacks,
        ), task_id)

    def _fire(self, kind: str, detail: str):
        stacks = self._gather_stacks(None)
        self._publish(build_incident(
            kind, self.core.mode, detail,
            node_id=self.core.node_id.hex() if self.core.node_id else "",
            worker_id=self.core.worker_id.hex(),
            stacks=stacks,
        ), b"")

    def _fire_slow_step(self, slow: dict):
        incident = build_incident(
            "slow_step", self.core.mode,
            f"train step {int(slow.get('step', 0))} took "
            f"{slow.get('duration_s', 0):.3f}s — "
            f"{slow.get('ratio', 0):.1f}x the trailing median "
            f"({slow.get('median_s', 0):.3f}s)",
            node_id=self.core.node_id.hex() if self.core.node_id else "",
            worker_id=self.core.worker_id.hex(),
        )
        incident["slow_step"] = {
            k: float(v) for k, v in slow.items()}
        path = capture_incident_profile(self.core, "slow_step")
        if path:
            incident["profile_path"] = path
        self._publish(incident, b"")

    def _fire_compile_storm(self, storm: dict):
        incident = build_incident(
            "jit_cache_miss_storm", self.core.mode,
            f"{int(storm.get('compiles', 0))} jit compiles within "
            f"{storm.get('window_s', 0):.0f}s after warmup (at step "
            f"{int(storm.get('step', 0))}, {storm.get('compile_s', 0):.1f}s "
            "cumulative compile time) — the step fn is being retraced",
            node_id=self.core.node_id.hex() if self.core.node_id else "",
            worker_id=self.core.worker_id.hex(),
        )
        incident["compile_storm"] = {
            k: float(v) for k, v in storm.items()}
        _record_storm_metric()
        self._publish(incident, b"")

    def _gather_stacks(self, exec_worker_id) -> list:
        stacks = []
        try:
            stacks.append(capture_local_stacks(
                f"{self.core.mode}:{os.getpid()}"))
        except Exception:
            pass
        if exec_worker_id:
            # The stuck task's executing worker: the existing profiling
            # fan-out resolves it across raylets and samples its stacks.
            try:
                from ray_tpu_torch._private import profiling

                nodes = self.core.gcs.get_all_node_info()
                status, payload = profiling.profile_via_raylets(
                    nodes, worker_id=exec_worker_id, duration=0.5)
                if status == 200:
                    stacks.append({
                        "target": f"worker:{exec_worker_id.hex()[:12]}",
                        "folded": payload.get("folded", ""),
                    })
                else:
                    stacks.append({
                        "target": f"worker:{exec_worker_id.hex()[:12]}",
                        "folded": "",
                        "error": str(payload.get("error", status)),
                    })
            except Exception:
                pass
        return stacks

    def _publish(self, incident: dict, subject: bytes):
        _fr.record("watchdog.fire", subject, incident["kind"])
        if ("profile_path" not in incident
                and CONFIG.profile_on_incident):
            # Evidence while the hang is live: a short cluster profile
            # rides every incident this watchdog opens
            # (RTPU_TORCH_profile_on_incident=0 disables).
            path = capture_incident_profile(self.core, incident["kind"])
            if path:
                incident["profile_path"] = path
        if incident.get("profile_path"):
            # Auto-analysis: read the capture back and record the "why"
            # (top stacks, compile share, scheduling delay) inside the
            # incident itself — the record must stay useful even when the
            # capture file's host is gone by the time someone looks.
            try:
                from ray_tpu_torch._private import perf_analysis

                perf_analysis.attach_analysis(incident)
            except Exception:
                pass
        try:
            self.core.gcs.call(
                "ReportIncident", {"incident": incident}, timeout=10)
        except Exception:
            pass
