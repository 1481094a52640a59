"""Grafana dashboard generation from the framework's metric catalog (a
copy of ``ray_tpu/dashboard/grafana.py`` whose device panel counts GPUs).

Reference: dashboard/modules/metrics/grafana_dashboard_factory.py — the
dashboard ships ready-made Grafana JSON for its Prometheus metrics. Same
here: `generate_dashboard()` returns an importable Grafana dashboard
covering the node/scheduler/object-store/worker gauges the GCS and
raylets expose on their /metrics endpoints, and the dashboard head serves
it at GET /api/grafana_dashboard.
"""

from __future__ import annotations

import json
from typing import List

_PANELS = [
    ("Cluster CPU utilization", [
        ("sum(ray_tpu_node_resource_total{resource=\"CPU\"}) - "
         "sum(ray_tpu_node_resource_available{resource=\"CPU\"})", "used"),
        ("sum(ray_tpu_node_resource_total{resource=\"CPU\"})", "total"),
    ], "short"),
    ("GPUs in use", [
        ("sum(ray_tpu_node_resource_total{resource=\"GPU\"}) - "
         "sum(ray_tpu_node_resource_available{resource=\"GPU\"})", "used"),
        ("sum(ray_tpu_node_resource_total{resource=\"GPU\"})", "total"),
    ], "short"),
    ("Workers by state", [
        ("sum(ray_tpu_node_workers) by (state)", "{{state}}"),
    ], "short"),
    ("Active leases", [
        ("sum(ray_tpu_node_leases)", "leases"),
    ], "short"),
    ("Object store used", [
        ("sum(ray_tpu_object_store_used_bytes)", "used"),
        ("sum(ray_tpu_object_store_capacity_bytes)", "capacity"),
    ], "bytes"),
    ("Objects in store", [
        ("sum(ray_tpu_object_store_num_objects)", "objects"),
    ], "short"),
    ("Spilled bytes", [
        ("sum(ray_tpu_spilled_bytes)", "spilled"),
    ], "bytes"),
    ("Object pulls in flight", [
        ("sum(ray_tpu_pulls_in_flight)", "pulls"),
    ], "short"),
    ("Node CPU percent", [
        ("ray_tpu_node_cpu_percent", "{{node}}"),
    ], "percent"),
    ("Node memory used", [
        ("ray_tpu_node_mem_used_bytes", "{{node}}"),
    ], "bytes"),
    ("Worker RSS", [
        ("ray_tpu_worker_rss_bytes", "{{node}}/{{pid}}"),
    ], "bytes"),
    ("Placement-group bundles", [
        ("sum(ray_tpu_node_pg_bundles)", "bundles"),
    ], "short"),
    # ---- workload telemetry (train/_telemetry.py + serve metrics): the
    # step-level training and request-level serving series the GCS exports
    # from the ray_tpu_torch.util.metrics pipeline.
    ("Training throughput (tokens/s)", [
        ("sum(ray_tpu_train_tokens_per_second) by (JobId)", "{{JobId}}"),
    ], "short"),
    ("Training step time", [
        ("histogram_quantile(0.5, sum(rate("
         "ray_tpu_train_step_seconds_bucket[5m])) by (le))", "p50"),
        ("histogram_quantile(0.95, sum(rate("
         "ray_tpu_train_step_seconds_bucket[5m])) by (le))", "p95"),
    ], "s"),
    ("Model FLOPs utilization", [
        ("avg(ray_tpu_train_mfu_ratio) by (JobId)", "{{JobId}}"),
    ], "percentunit"),
    ("Training goodput", [
        ("avg(ray_tpu_train_goodput_ratio) by (JobId)", "{{JobId}}"),
    ], "percentunit"),
    ("HBM in use", [
        ("sum(ray_tpu_train_hbm_bytes_in_use) by (WorkerId)",
         "{{WorkerId}}"),
    ], "bytes"),
    ("Serve request rate", [
        ("sum(rate(ray_tpu_serve_requests_total[1m])) by (deployment)",
         "{{deployment}}"),
        ("sum(rate(ray_tpu_serve_request_errors_total[1m])) "
         "by (deployment)", "{{deployment}} errors"),
    ], "reqps"),
    ("Serve request latency", [
        ("histogram_quantile(0.5, sum(rate("
         "ray_tpu_serve_request_latency_seconds_bucket[5m])) "
         "by (le, deployment))", "{{deployment}} p50"),
        ("histogram_quantile(0.99, sum(rate("
         "ray_tpu_serve_request_latency_seconds_bucket[5m])) "
         "by (le, deployment))", "{{deployment}} p99"),
    ], "s"),
    ("Serve in-flight / queue depth", [
        ("sum(ray_tpu_serve_inflight_requests) by (deployment)",
         "{{deployment}} in-flight"),
        ("sum(ray_tpu_serve_queue_depth) by (deployment)",
         "{{deployment}} queued"),
    ], "short"),
]


def _panel(panel_id: int, title: str, targets: List[tuple], unit: str,
           x: int, y: int) -> dict:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "targets": [
            {"expr": expr, "legendFormat": legend, "refId": chr(65 + i)}
            for i, (expr, legend) in enumerate(targets)
        ],
    }


def generate_dashboard() -> dict:
    """Importable Grafana dashboard JSON for the cluster's metrics."""
    panels = []
    for i, (title, targets, unit) in enumerate(_PANELS):
        panels.append(
            _panel(i + 1, title, targets, unit,
                   x=(i % 2) * 12, y=(i // 2) * 8)
        )
    return {
        "title": "ray_tpu_torch cluster",
        "uid": "ray-tpu-torch-cluster",
        "timezone": "browser",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource",
            "type": "datasource",
            "query": "prometheus",
        }]},
        "panels": panels,
    }


def dashboard_json() -> str:
    return json.dumps(generate_dashboard(), indent=2)
