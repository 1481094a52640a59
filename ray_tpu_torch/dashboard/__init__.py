"""ray_tpu_torch.dashboard — HTTP surface over the cluster's state + jobs
(``head.py``, started by ``ray-tpu-torch start --head --dashboard-port``),
its Grafana dashboard (``grafana.py``), and the per-node agent
(``agent.py``) that the raylet spawns."""

from ray_tpu_torch.dashboard.head import DashboardHead, start_dashboard

__all__ = ["DashboardHead", "start_dashboard"]
