"""Autoscaler (v2-shaped): slice-granular demand-driven scaling.

Counterpart of the reference's autoscaler v2
(reference: python/ray/autoscaler/v2/autoscaler.py:42 — instance manager +
ResourceDemandScheduler v2/scheduler.py:624 consuming the GCS
AutoscalerStateService). TPU-first difference: the scaling unit is a node
*type* that represents a whole ICI slice (e.g. a v5e-8 host group), never a
fraction of one — demand for a ``TPU-<type>-head`` resource launches an
entire slice.
"""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, NodeTypeConfig
from ray_tpu_torch.autoscaler.node_provider import FakeMultiNodeProvider, NodeProvider
from ray_tpu_torch.autoscaler.scheduler import ResourceDemandScheduler

__all__ = [
    "Autoscaler",
    "NodeTypeConfig",
    "NodeProvider",
    "FakeMultiNodeProvider",
    "ResourceDemandScheduler",
]
