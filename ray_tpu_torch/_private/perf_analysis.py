"""Incident auto-analysis: turn an attached profile capture into a "why".

The watchdog already attaches a merged Perfetto capture (CPU samples +
task/span timeline + device-trace links) to every incident it opens — but a
multi-MB trace is an artifact an operator has to go open. This pass closes
the loop: it inspects the capture the moment it is written and records a
compact, human-readable analysis *inside the incident record itself*, so
``ray-tpu-torch debug incidents`` / ``GET /api/perf`` show the probable cause
without anyone loading Perfetto:

  - **top folded stacks** — where the cluster's CPU time actually went
    during the capture window (per-stack share of all samples);
  - **compile share** — fraction of CPU samples inside jit/XLA compile
    frames, plus the wall-clock share of ``train_step.compile`` spans (the
    StepRecorder's jit-cache-miss bookkeeping): the smoking gun for a
    ``jit_cache_miss_storm`` or a compile-dominated slow step;
  - **scheduling delay** — from the timeline's SUBMITTED→RUNNING flow
    events (``ph:"s"``/``ph:"f"`` pairs): how long tasks sat between
    submission and execution, the signature of a saturated control plane.

Everything here is read-only over the already-written capture file; a
failure to analyze must never lose the incident (callers guard)."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

# Frames that indicate tracing/lowering/compilation rather than execution.
# Conservative on purpose: matching real XLA/jax internals, not any frame
# that happens to contain "run".
_COMPILE_MARKERS = (
    "compile", "xla_bridge", "pxla", "lower", "jaxpr", "trace_to_",
    "make_jaxpr", "backend_compile",
)

_TOP_STACKS = 5
_STACK_TAIL_FRAMES = 5  # keep the leaf-most frames; full stacks are huge


def _is_compile_stack(stack: str) -> bool:
    s = stack.lower()
    return any(m in s for m in _COMPILE_MARKERS)


def _short_stack(stack: str) -> str:
    frames = stack.split(";")
    if len(frames) <= _STACK_TAIL_FRAMES + 1:
        return stack
    # keep the thread name (first element) + the leaf-most frames
    return frames[0] + ";…;" + ";".join(frames[-_STACK_TAIL_FRAMES:])


def analyze_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Analyze one merged-profile trace object (timeline.merged_profile_trace
    shape: {"traceEvents": [...]}). Pure function over the event list."""
    events = trace.get("traceEvents", []) or []

    stack_us: Dict[str, float] = {}
    total_cpu_us = 0.0
    compile_cpu_us = 0.0
    span_step_us = 0.0
    span_compile_us = 0.0
    task_run_us = 0.0
    flow_starts: Dict[str, float] = {}
    delays_us: List[float] = []

    for ev in events:
        cat = ev.get("cat")
        ph = ev.get("ph")
        if cat == "cpu_sample" and ph == "X":
            dur = float(ev.get("dur") or 0.0)
            stack = (ev.get("args") or {}).get("stack") or ev.get("name", "?")
            stack_us[stack] = stack_us.get(stack, 0.0) + dur
            total_cpu_us += dur
            if _is_compile_stack(stack):
                compile_cpu_us += dur
        elif cat == "span" and ph == "X":
            name = ev.get("name") or ""
            if name.startswith("train_step"):
                dur = float(ev.get("dur") or 0.0)
                span_step_us += dur
                if name == "train_step.compile":
                    span_compile_us += dur
        elif cat == "task" and ph == "X":
            task_run_us += float(ev.get("dur") or 0.0)
        elif cat == "task_flow":
            fid = ev.get("id")
            if ph == "s":
                flow_starts[fid] = float(ev.get("ts") or 0.0)
            elif ph == "f" and fid in flow_starts:
                delays_us.append(
                    max(0.0, float(ev.get("ts") or 0.0)
                        - flow_starts.pop(fid)))

    top = sorted(stack_us.items(), key=lambda kv: -kv[1])[:_TOP_STACKS]
    out: Dict[str, Any] = {
        "cpu_seconds": round(total_cpu_us / 1e6, 3),
        "top_stacks": [
            {"stack": _short_stack(s),
             "share": round(us / total_cpu_us, 4) if total_cpu_us else 0.0,
             "cpu_s": round(us / 1e6, 3)}
            for s, us in top
        ],
        "compile_share": (round(compile_cpu_us / total_cpu_us, 4)
                          if total_cpu_us else None),
    }
    if span_step_us:
        out["compile_span_share"] = round(span_compile_us / span_step_us, 4)
    if delays_us:
        sched = {
            "count": len(delays_us),
            "mean_ms": round(sum(delays_us) / len(delays_us) / 1e3, 3),
            "max_ms": round(max(delays_us) / 1e3, 3),
        }
        busy = sum(delays_us) + task_run_us
        if busy:
            sched["share"] = round(sum(delays_us) / busy, 4)
        out["sched_delay"] = sched
    return out


def summarize(analysis: Dict[str, Any], kind: str = "") -> str:
    """One operator-readable sentence chain — the incident record's 'why'."""
    parts: List[str] = []
    top = analysis.get("top_stacks") or []
    if top:
        leaf = top[0]["stack"].rsplit(";", 1)[-1]
        parts.append(
            f"hottest stack: {leaf} "
            f"({top[0]['share'] * 100:.0f}% of {analysis['cpu_seconds']:.1f} "
            "sampled CPU-s)")
    cs = analysis.get("compile_share")
    if cs is not None:
        span_share = analysis.get("compile_span_share")
        msg = f"jit/XLA compile frames: {cs * 100:.0f}% of CPU samples"
        if span_share is not None:
            msg += (f" (train_step.compile spans: {span_share * 100:.0f}% "
                    "of step wall time)")
        parts.append(msg)
        if kind == "jit_cache_miss_storm" and (cs > 0.2 or
                                               (span_share or 0) > 0.2):
            parts.append("likely cause: recompilation — check for unstable "
                         "input shapes/dtypes or non-hashable static args")
    sd = analysis.get("sched_delay")
    if sd:
        msg = (f"scheduling delay: {sd['count']} submits, "
               f"mean {sd['mean_ms']:.1f} ms, max {sd['max_ms']:.1f} ms")
        if "share" in sd:
            msg += f" ({sd['share'] * 100:.0f}% of task wall time)"
        parts.append(msg)
    if not parts:
        return "capture attached but contained no analyzable events"
    return "; ".join(parts)


def analyze_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        trace = json.load(f)
    return analyze_trace(trace)


def attach_analysis(incident: Dict[str, Any]) -> bool:
    """Analyze ``incident['profile_path']`` and write the result (plus the
    human-readable ``summary``) into ``incident['analysis']``. Returns
    False — leaving the incident untouched — when there is no capture or it
    is unreadable."""
    path = incident.get("profile_path")
    if not path:
        return False
    try:
        analysis = analyze_file(path)
    except Exception:
        return False
    analysis["summary"] = summarize(analysis, kind=incident.get("kind", ""))
    incident["analysis"] = analysis
    return True


def latest_incident_analysis(gcs, limit: int = 20) -> Optional[Dict[str, Any]]:
    """Newest incident that carries an analysis (dashboard convenience)."""
    try:
        incidents = gcs.call(
            "ListIncidents", {"limit": limit}, timeout=10)["incidents"]
    except Exception:
        return None
    for inc in reversed(incidents):
        if inc.get("analysis"):
            return {"id": inc.get("id"), "kind": inc.get("kind"),
                    "time": inc.get("time"),
                    "analysis": inc["analysis"]}
    return None
