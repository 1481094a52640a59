"""User-defined application metrics: Counter, Gauge, Histogram.

A copy of ``ray_tpu/util/metrics.py`` (the port imports nothing of the JAX
package; reference: python/ray/util/metrics.py:19). Metric updates are
recorded in a process-global table keyed by name and tags. In a worker or
driver of the port's runtime they are pushed to the GCS with the periodic
task-event flush; the GCS aggregates them (summing counters, last-write
gauges, bucket-merging histograms) and exports everything on its Prometheus
/metrics endpoint. Without a runtime, a caller (a test, the card's smoke
run) reads the table with :func:`drain_records`.

Metric-name stability contract
------------------------------
The framework's own workload series (the JAX package's names, help
strings, label keys and histogram boundaries) are a public interface:
dashboards, alerts and the ``/api/train`` / ``/api/serve`` summaries key on
these exact names and label keys, so renaming or re-labeling any of them is
a breaking change (add new series instead). The stable set:

  training (train/_telemetry.py, labels: run, +WorkerId/JobId at flush)
    ray_tpu_train_step_seconds         histogram, wall time per step
    ray_tpu_train_steps_total          counter
    ray_tpu_train_tokens_per_second    gauge
    ray_tpu_train_examples_per_second  gauge
    ray_tpu_train_mfu_ratio            gauge, 0-1
    ray_tpu_train_goodput_ratio        gauge, 0-1
    ray_tpu_train_compile_seconds      gauge, cumulative
    ray_tpu_train_last_step_seconds    gauge (driver-side re-publish)
    ray_tpu_train_hbm_bytes_in_use     gauge, labels +device (CUDA only)

  serving (serve/_replica.py + serve/_handle.py, labels: deployment
  [, replica]; the serve deployment comes to the port later)
    ray_tpu_serve_requests_total                 counter
    ray_tpu_serve_request_errors_total           counter
    ray_tpu_serve_inflight_requests              gauge
    ray_tpu_serve_queue_depth                    gauge
    ray_tpu_serve_request_latency_seconds        histogram (replica-side)
    ray_tpu_serve_handle_latency_seconds         histogram (caller-side)
    ray_tpu_serve_handle_requests_total          counter

  llm serving (serve/llm/engine.py, labels: deployment, replica)
    ray_tpu_llm_tokens_per_s           gauge, generated tokens/s (EMA
                                       over engine steps)
    ray_tpu_llm_kv_utilization         gauge, 0-1 fraction of paged KV
                                       blocks in use
    ray_tpu_llm_batch_size             gauge, sequences in the last
                                       engine step
    ray_tpu_llm_preemptions_total      counter, sequences requeued on KV
                                       exhaustion
    ray_tpu_llm_prefix_hit_rate        gauge, 0-1 cumulative fraction of
                                       looked-up prompt tokens served
                                       from the shared-prefix KV index
                                       (only published with
                                       RTPU_TORCH_llm_prefix_cache on)
    ray_tpu_llm_spec_acceptance        gauge, 0-1 cumulative fraction of
                                       proposed draft tokens the target
                                       model accepted (only published
                                       when a draft model is loaded)

  profiling plane (_private/watchdog.py, labels: trigger — the incident
  kind or trigger that caused the capture: slow_step, stuck_task, ...)
    ray_tpu_profile_captures_total               counter, automatic
                                                 cluster-profile captures

  perf regression plane (_private/perf_gate.py + _private/watchdog.py)
    ray_tpu_perf_regressions_total     counter, labels: metric — gate
                                       comparisons landing beyond the
                                       noise band (perf check/compare)
    ray_tpu_perf_gate_ratio            gauge, labels: metric — latest
                                       current/baseline ratio per metric
    ray_tpu_perf_compile_storms_total  counter — jit_cache_miss_storm
                                       incidents raised by the watchdog

  chaos / robustness plane (_private/chaos.py + serve failover paths)
    ray_tpu_chaos_injections_total     counter, labels: site, action —
                                       faults fired by the chaos plane
                                       (zero unless RTPU_TORCH_chaos_plan is
                                       armed)
    ray_tpu_serve_failovers_total      counter, labels: deployment —
                                       mid-stream llm failovers (the
                                       remaining generation resubmitted
                                       to a surviving replica) plus
                                       ActorDiedError retries of
                                       idempotent DeploymentHandle calls

  memory observability plane (raylet _collect_metrics, labels: node)
    ray_tpu_object_store_pinned_bytes  gauge — bytes held by pinned
                                       primary copies in this node's
                                       plasma store
    ray_tpu_object_store_leaked_bytes  gauge — bytes in primaries the
                                       leak detector confirmed have no
                                       live owner reference (two-sweep
                                       cross-check)
    ray_tpu_memory_rss_bytes           gauge, labels +role
                                       (raylet|worker|agent) — resident
                                       set size per process role on the
                                       node (worker = sum over workers)

  node system series (raylet _collect_metrics, labels: node unless noted
  — the Grafana cluster panels key on these)
    ray_tpu_node_resource_total        gauge, labels +resource
    ray_tpu_node_resource_available    gauge, labels +resource
    ray_tpu_node_workers               gauge, labels +state (idle|leased)
    ray_tpu_node_leases                gauge, outstanding worker leases
    ray_tpu_node_pg_bundles            gauge, placed placement-group
                                       bundles
    ray_tpu_node_cpu_percent           gauge
    ray_tpu_node_mem_used_bytes        gauge
    ray_tpu_node_mem_total_bytes       gauge
    ray_tpu_object_store_used_bytes    gauge
    ray_tpu_object_store_capacity_bytes  gauge
    ray_tpu_object_store_num_objects   gauge
    ray_tpu_object_store_evicted_bytes gauge, cumulative
    ray_tpu_spilled_objects            gauge, objects currently on disk
    ray_tpu_spilled_bytes              gauge, bytes currently on disk
    ray_tpu_pulls_in_flight            gauge
    ray_tpu_worker_rss_bytes           gauge, labels +pid

  GCS system series (gcs/server.py _collect_metrics)
    ray_tpu_gcs_nodes                  gauge, labels: state
    ray_tpu_gcs_actors                 gauge, labels: state
    ray_tpu_gcs_placement_groups       gauge, labels: state
    ray_tpu_gcs_jobs                   gauge, labels: state
    ray_tpu_gcs_task_events_buffered   gauge
    ray_tpu_gcs_incidents_open         gauge
    ray_tpu_gcs_uptime_seconds         gauge

  dashboard-agent host series (dashboard/agent.py, labels: node)
    ray_tpu_agent_cpu_percent          gauge
    ray_tpu_agent_mem_used_bytes       gauge
    ray_tpu_agent_mem_total_bytes      gauge
    ray_tpu_agent_uptime_seconds       gauge
    ray_tpu_agent_disk_used_bytes      gauge
    ray_tpu_agent_worker_rss_bytes     gauge, labels +pid

The RTPU_TORCH_profile_* / RTPU_TORCH_device_trace_steps /
RTPU_TORCH_perf_* / RTPU_TORCH_memory_* / RTPU_TORCH_llm_* /
RTPU_TORCH_chaos_* / RTPU_TORCH_serve_failover_* config flags are likewise
a stability contract — see the profiling-plane,
perf-regression-plane, memory-observability-plane, serve.llm and
chaos-plane sections of ``ray_tpu_torch/_private/config.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_lock = threading.Lock()
# (name, frozenset(label items)) -> record dict
_records: Dict[Tuple[str, frozenset], dict] = {}


def _record(kind: str, name: str, help_: str, labels: Dict[str, str], **kw):
    key = (name, frozenset(labels.items()))
    with _lock:
        rec = _records.get(key)
        if rec is None:
            rec = {
                "kind": kind,
                "name": name,
                "help": help_,
                "labels": dict(labels),
                "value": 0.0,
                "buckets": {},  # boundary -> count (histogram)
                "count": 0,
                "sum": 0.0,
            }
            _records[key] = rec
        return rec


def drain_records() -> List[dict]:
    """Called by the worker's flush loop; returns a snapshot (counters and
    histograms are cumulative deltas since the last drain)."""
    with _lock:
        out = []
        for rec in _records.values():
            snap = {k: (dict(v) if isinstance(v, dict) else v) for k, v in rec.items()}
            out.append(snap)
            if rec["kind"] in ("counter", "histogram"):
                rec["value"] = 0.0
                rec["buckets"] = {}
                rec["count"] = 0
                rec["sum"] = 0.0
        return [s for s in out if s["kind"] == "gauge" or s["count"] or s["value"]]


def restore_records(records: List[dict]) -> None:
    """Re-merge drained deltas after a failed flush so counter/histogram
    increments survive a GCS outage instead of being silently lost."""
    with _lock:
        for snap in records:
            # The flush stamps WorkerId/JobId; strip them to match local keys.
            labels = {
                k: v
                for k, v in snap.get("labels", {}).items()
                if k not in ("WorkerId", "JobId")
            }
            key = (snap["name"], frozenset(labels.items()))
            rec = _records.get(key)
            if rec is None or rec["kind"] != snap["kind"]:
                continue
            if snap["kind"] in ("counter", "histogram"):
                rec["value"] += snap.get("value", 0.0)
                for b, c in snap.get("buckets", {}).items():
                    rec["buckets"][b] = rec["buckets"].get(b, 0) + c
                rec["count"] += snap.get("count", 0)
                rec["sum"] += snap.get("sum", 0.0)


class _Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self._tag_keys)
        if extra:
            raise ValueError(
                f"tag(s) {sorted(extra)} not declared in tag_keys={self._tag_keys}"
            )
        return merged


class Counter(_Metric):
    """Monotonically increasing value (reference: util/metrics.py Counter)."""

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc() requires value >= 0")
        rec = _record("counter", self._name, self._description, self._tags(tags))
        with _lock:
            rec["value"] += value
            rec["count"] += 1


class Gauge(_Metric):
    """Last-set value."""

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        rec = _record("gauge", self._name, self._description, self._tags(tags))
        with _lock:
            rec["value"] = float(value)
            rec["count"] += 1


class Histogram(_Metric):
    """Bucketed observations."""

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = (),
        tag_keys: Sequence[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        if not boundaries:
            raise ValueError("Histogram requires bucket boundaries")
        self._boundaries = sorted(float(b) for b in boundaries)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        rec = _record("histogram", self._name, self._description, self._tags(tags))
        with _lock:
            rec.setdefault("boundaries", self._boundaries)
            for b in self._boundaries:
                if value <= b:
                    key = str(b)
                    break
            else:
                key = "+Inf"  # above the largest boundary
            rec["buckets"][key] = rec["buckets"].get(key, 0) + 1
            rec["count"] += 1
            rec["sum"] += float(value)
