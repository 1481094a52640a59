"""Application metrics: Counter, Gauge, Histogram.

A copy of ``ray_tpu/util/metrics.py`` (the port imports nothing of the JAX
package). Updates are recorded in a process-global table keyed by name and
tags; :func:`drain_records` returns a snapshot (counters and histograms as
deltas since the last drain, gauges as their last value) and
:func:`restore_records` merges a drained snapshot back. The port has no
runtime yet, so nothing flushes the table: a caller (a test, a bench, the
card's smoke run) reads it with ``drain_records``.

Metric-name stability contract
------------------------------
The series the port publishes keep the JAX package's names, help strings,
label keys and histogram boundaries, so a dashboard reads either package:

  training (train/_telemetry.py, labels: run)
    ray_tpu_train_step_seconds         histogram, wall time per step
    ray_tpu_train_steps_total          counter
    ray_tpu_train_tokens_per_second    gauge
    ray_tpu_train_examples_per_second  gauge
    ray_tpu_train_mfu_ratio            gauge, 0-1
    ray_tpu_train_goodput_ratio        gauge, 0-1
    ray_tpu_train_compile_seconds      gauge, cumulative
    ray_tpu_train_last_step_seconds    gauge (publish_report_summary)
    ray_tpu_train_hbm_bytes_in_use     gauge, labels +device (CUDA only)

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
                                       (only with the prefix cache on)
    ray_tpu_llm_spec_acceptance        gauge, 0-1 cumulative fraction of
                                       proposed draft tokens the target
                                       model accepted (only when a draft
                                       model is loaded)
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
    """Returns a snapshot (counters and histograms are cumulative deltas
    since the last drain); in the JAX package the worker's flush loop calls
    it, in the port its reader does."""
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
    """Re-merge drained deltas (after a failed flush, or a reader that only
    looked) so counter/histogram increments are not lost."""
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
