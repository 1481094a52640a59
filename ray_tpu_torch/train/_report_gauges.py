"""The ``ray_tpu_train_*`` gauges a trainer re-publishes from the process
that polls its workers (the driver, or the Tune trial actor), which
outlives them. Torch-free: those processes hold no card and never load
torch. ``train._telemetry`` re-exports :func:`publish_report_summary`."""

from __future__ import annotations

from typing import Any, Dict

_REPORT_GAUGES = {
    "telemetry/goodput": "ray_tpu_train_goodput_ratio",
    "telemetry/tokens_per_s": "ray_tpu_train_tokens_per_second",
    "telemetry/examples_per_s": "ray_tpu_train_examples_per_second",
    "telemetry/mfu": "ray_tpu_train_mfu_ratio",
    "telemetry/compile_time_s": "ray_tpu_train_compile_seconds",
    "telemetry/step_time_s": "ray_tpu_train_last_step_seconds",
    "telemetry/hbm_bytes_in_use": "ray_tpu_train_hbm_bytes_in_use",
}
_report_gauge_objs: Dict[str, Any] = {}


def publish_report_summary(metrics: Dict[str, Any], run_name: str = ""):
    """Re-publish a report's ``telemetry/*`` keys as gauges from the calling
    process (the one that started a trainer's workers and outlives them)."""
    try:
        from ray_tpu_torch.util.metrics import Gauge

        for key, name in _REPORT_GAUGES.items():
            value = metrics.get(key)
            if not isinstance(value, (int, float)):
                continue
            g = _report_gauge_objs.get(name)
            if g is None:
                g = _report_gauge_objs[name] = Gauge(
                    name, "driver-side rolling train telemetry",
                    tag_keys=("run",))
            g.set(float(value), tags={"run": run_name})
    except Exception:
        pass  # telemetry must never fail a report round
