"""Task timeline + merged profiling view: Chrome-trace dumps of the GCS
task-event log, optionally folded with cluster CPU-sample captures.

Counterpart of ``ray timeline`` (reference: python/ray/_private/state.py:944
chrome_tracing_dump :434 — task state transitions buffered by every core
worker, flushed to the GCS task-event sink, rendered as Chrome's trace-event
JSON). Open the output in chrome://tracing or https://ui.perfetto.dev.

This module is also the merge point of the profiling plane
(``merged_profile_trace``): CPU samples from every process
(_private/sampling_profiler.py via the StartProfile/CollectProfile fan-out),
task state transitions, tracing spans, and registered device-trace
directories all land in ONE time-aligned Chrome trace — every timestamp in
every lane is wall-clock ``time.time()`` microseconds, so "the input
pipeline stalled while the collective waited" is visible as adjacent lanes
of the same Perfetto view.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

_TERMINAL = ("FINISHED", "FAILED")


def chrome_trace_events(events: List[dict]) -> List[dict]:
    """Fold raw task events into Chrome 'X' (complete) + 'i' (instant) events."""
    by_task: Dict[str, List[dict]] = {}
    for ev in events:
        by_task.setdefault(ev["task_id"], []).append(ev)
    out: List[dict] = []
    for task_id, evs in by_task.items():
        evs.sort(key=lambda e: e["ts"])
        running_ev = None
        submitted_ev = None
        for ev in evs:
            if ev["state"] == "SPAN":
                # User/tracing span (ray_tpu_torch.util.tracing) — duration baked in.
                out.append(
                    {
                        "cat": "span",
                        "name": ev.get("name") or "span",
                        "ph": "X",
                        "ts": ev["ts"] * 1e6,
                        "dur": max(0.0, ev.get("dur", 0.0) * 1e6),
                        "pid": f"node:{(ev.get('node_id') or '?')[:8]}",
                        "tid": f"worker:{(ev.get('worker_id') or '?')[:8]}",
                        "args": {
                            "trace_id": ev.get("trace_id", ""),
                            "span_id": ev.get("task_id", ""),
                            "parent_span_id": ev.get("parent_span_id", ""),
                            **(ev.get("attributes") or {}),
                            "error": ev.get("error", ""),
                        },
                    }
                )
                continue
            if ev["state"] == "RUNNING":
                running_ev = ev
            elif ev["state"] in _TERMINAL and running_ev is None:
                # Terminal event whose RUNNING was dropped (task-event ring
                # overflow / flush loss, or a path that never emits RUNNING,
                # e.g. async-actor tasks): without a start there is no 'X'
                # duration to draw — emit an instant so the task is still
                # visible in the trace instead of silently vanishing.
                out.append(
                    {
                        "cat": "task",
                        "name": f"{ev.get('name') or task_id[:8]}:{ev['state']}",
                        "ph": "i",
                        "s": "t",
                        "ts": ev["ts"] * 1e6,
                        "pid": f"node:{(ev.get('node_id') or '?')[:8]}",
                        "tid": f"worker:{(ev.get('worker_id') or '?')[:8]}",
                        "args": {
                            "task_id": task_id,
                            "job_id": ev.get("job_id", ""),
                            "state": ev["state"],
                            "error": ev.get("error", ""),
                            "note": "RUNNING event missing (dropped or never emitted)",
                        },
                    }
                )
            elif ev["state"] in _TERMINAL and running_ev is not None:
                out.append(
                    {
                        "cat": "task",
                        "name": ev.get("name") or task_id[:8],
                        "ph": "X",
                        "ts": running_ev["ts"] * 1e6,
                        "dur": max(0.0, (ev["ts"] - running_ev["ts"]) * 1e6),
                        "pid": f"node:{(ev.get('node_id') or '?')[:8]}",
                        "tid": f"worker:{(ev.get('worker_id') or '?')[:8]}",
                        "args": {
                            "task_id": task_id,
                            "job_id": ev.get("job_id", ""),
                            "state": ev["state"],
                            "error": ev.get("error", ""),
                        },
                        "cname": (
                            "thread_state_runnable"
                            if ev["state"] == "FINISHED"
                            else "terrible"
                        ),
                    }
                )
                if submitted_ev is not None:
                    # Causality arrow: Chrome flow events connect the
                    # SUBMITTED instant (submitter's lane) to the start of
                    # the RUNNING slice (executing worker's lane) — in
                    # Perfetto the scheduling delay is a drawn edge instead
                    # of two unconnected marks.
                    flow = {
                        "cat": "task_flow",
                        "name": "submit",
                        "id": task_id,
                    }
                    out.append({
                        **flow,
                        "ph": "s",
                        "ts": submitted_ev["ts"] * 1e6,
                        "pid": f"node:{(submitted_ev.get('node_id') or '?')[:8]}",
                        "tid": f"worker:{(submitted_ev.get('worker_id') or '?')[:8]}",
                    })
                    out.append({
                        **flow,
                        "ph": "f",
                        "bp": "e",  # bind to the enclosing RUNNING slice
                        "ts": running_ev["ts"] * 1e6,
                        "pid": f"node:{(ev.get('node_id') or '?')[:8]}",
                        "tid": f"worker:{(ev.get('worker_id') or '?')[:8]}",
                    })
                    submitted_ev = None
                running_ev = None
            elif ev["state"] in ("SUBMITTED", "RETRY"):
                if ev["state"] == "SUBMITTED":
                    submitted_ev = ev
                out.append(
                    {
                        "cat": "task",
                        "name": f"{ev.get('name') or task_id[:8]}:{ev['state']}",
                        "ph": "i",
                        "s": "t",
                        "ts": ev["ts"] * 1e6,
                        "pid": f"node:{(ev.get('node_id') or '?')[:8]}",
                        "tid": f"worker:{(ev.get('worker_id') or '?')[:8]}",
                    }
                )
    out.sort(key=lambda e: e["ts"])
    return out


_FLIGHT_INSTANTS = {
    "obj.spill": "spill",
    "obj.restore": "restore",
    "obj.leak": "leak",
}


def flight_instant_events(node_hex: str, events: List[dict]) -> List[dict]:
    """Render a raylet flight-recorder ring's object-plane events
    (``obj.spill`` / ``obj.restore`` / ``obj.leak``) as Chrome instants on
    the owning node's lane, which the timeline otherwise would not show.
    ``events`` is the formatted dump
    (flight_recorder.dump / DumpFlightRecorder reply)."""
    out: List[dict] = []
    for ev in events:
        name = _FLIGHT_INSTANTS.get(ev.get("event", ""))
        if name is None:
            continue
        oid = ev.get("a", "")
        out.append({
            "cat": "object_store",
            "name": f"obj.{name}",
            "ph": "i",
            "s": "t",
            "ts": float(ev.get("ts", 0.0)) * 1e6,
            "pid": f"node:{(node_hex or '?')[:8]}",
            "tid": "object_store",
            "args": {
                "object_id": oid if isinstance(oid, str) else str(oid),
                "bytes": ev.get("b", ""),
                "event": ev.get("event", ""),
            },
        })
    return out


# ------------------------------------------------ profiling-plane merging


def profile_trace_events(bundle: dict, *, max_events: int = 300_000) -> List[dict]:
    """Render a cluster profile bundle (profiling.capture_cluster_profile)
    as Chrome slices: one ``cpu:`` lane per sampled thread, consecutive
    samples of the same stack collapsed into one slice. Lane pids reuse the
    task timeline's ``node:<id8>`` grouping so CPU time and task execution
    for a node sit under one Perfetto process group."""
    out: List[dict] = []

    def _one_profile(profile: dict, node_hex: str):
        period = 1.0 / max(1.0, float(profile.get("hz") or 99.0))
        t0 = float(profile.get("t0") or 0.0)
        threads = profile.get("threads", [])
        stacks = profile.get("stacks", [])
        role = profile.get("role") or "proc"
        pid_lane = f"node:{node_hex[:8]}" if node_hex else "node:?"
        proc = f"{role}:{profile.get('pid', 0)}"
        # group samples per thread, preserving time order
        by_thread: Dict[int, List[list]] = {}
        for s in profile.get("samples", []):
            by_thread.setdefault(s[1], []).append(s)
        for ti, samples in by_thread.items():
            tname = threads[ti] if 0 <= ti < len(threads) else str(ti)
            tid_lane = f"cpu:{proc}:{tname}"
            samples.sort(key=lambda s: s[0])
            run_start = run_end = None
            run_stack = -1
            run_n = 0

            def _emit():
                if run_stack < 0 or run_n == 0:
                    return
                stack = (stacks[run_stack]
                         if 0 <= run_stack < len(stacks) else "?")
                leaf = stack.rsplit(";", 1)[-1]
                out.append({
                    "cat": "cpu_sample",
                    "name": leaf,
                    "ph": "X",
                    "ts": (t0 + run_start) * 1e6,
                    "dur": max(period, run_end - run_start + period) * 1e6,
                    "pid": pid_lane,
                    "tid": tid_lane,
                    "args": {"stack": stack, "samples": run_n,
                             "process": proc},
                })

            for dt, _ti, si in samples:
                if si == run_stack and dt - run_end <= 2.5 * period:
                    run_end = dt
                    run_n += 1
                    continue
                _emit()
                run_start = run_end = dt
                run_stack = si
                run_n = 1
            _emit()

    for node in bundle.get("nodes", []):
        for p in node.get("profiles", []):
            _one_profile(p, node.get("node_id", ""))
    for p in bundle.get("drivers", []):
        _one_profile(p, "driver")
    if bundle.get("gcs"):
        _one_profile(bundle["gcs"], "gcs")
    if len(out) > max_events:
        del out[max_events:]
    return out


def merged_profile_trace(bundle: dict, task_events: Optional[List[dict]] = None,
                         device_traces: Optional[List[dict]] = None) -> dict:
    """ONE Perfetto-loadable object: cluster CPU samples + task/span events
    + links to registered device-trace directories, all on the shared
    wall-clock microsecond axis. The return shape is the Chrome trace
    "object format" ({"traceEvents": [...]}), which both chrome://tracing
    and ui.perfetto.dev accept."""
    events = chrome_trace_events(task_events or [])
    events += profile_trace_events(bundle)
    for dt in device_traces or []:
        # The device trace itself is a TensorBoard/XPlane directory — too
        # alien to inline, so mark WHEN it was captured and WHERE it lives;
        # open it with `tensorboard --logdir` / xprof for the device view.
        events.append({
            "cat": "device_trace",
            "name": "jax_device_trace",
            "ph": "i",
            "s": "g",
            "ts": float(dt.get("time", 0.0)) * 1e6,
            "pid": "device_traces",
            "tid": dt.get("host", "") or "host",
            "args": {"path": dt.get("path", ""),
                     "steps": dt.get("steps", 0)},
        })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "clock": "wall (time.time), microseconds",
            "capture_t0": bundle.get("t0"),
            "capture_duration_s": bundle.get("duration"),
            "capture_hz": bundle.get("hz"),
            "errors": bundle.get("errors", []),
            "device_traces": [
                {"path": d.get("path", ""), "steps": d.get("steps", 0)}
                for d in device_traces or []
            ],
        },
    }


def timeline(filename: Optional[str] = None, *,
             job_id: Optional[str] = None, trace_id: Optional[str] = None):
    """Dump the cluster's task timeline; returns the event list (and writes
    Chrome-trace JSON to ``filename`` if given). ``job_id`` (hex) and
    ``trace_id`` filter server-side — a large cluster ships one job's
    events, not the whole 100k-event log."""
    from ray_tpu_torch._private import worker as worker_mod

    if worker_mod.global_worker is None:
        raise RuntimeError("ray_tpu_torch is not initialized")
    req: dict = {"limit": 100_000}
    if job_id is not None:
        req["job_id"] = job_id
    if trace_id is not None:
        req["trace_id"] = trace_id
    raw = worker_mod.global_worker.gcs.call("GetTaskEvents", req)["events"]
    events = chrome_trace_events(raw)
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
