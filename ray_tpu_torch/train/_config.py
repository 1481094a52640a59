"""Train/AIR configuration dataclasses (reference: python/ray/air/config.py —
ScalingConfig :103, RunConfig :594, FailureConfig :395, CheckpointConfig :445).
The port of ``ray_tpu/train/_config.py``: a worker asks for a card with
``use_gpu``; the backend's process-group settings live in
``ray_tpu_torch.train.torch.TorchConfig``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one owns.

    ``use_gpu`` (the default): each worker leases one card (``{"GPU": 1,
    "CPU": 1}``); the raylet gives each lease its own
    ``CUDA_VISIBLE_DEVICES``, so a worker sees its card as ``cuda:0``.
    CPU workers (``{"CPU": 1}``) need an explicit ``use_gpu=False``.
    ``resources_per_worker`` overrides both.
    """

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        if self.use_gpu:
            return {"GPU": 1, "CPU": 1}
        return {"CPU": 1}


@dataclasses.dataclass
class FailureConfig:
    """Group-restart fault tolerance: on worker failure the whole group
    restarts from the last checkpoint (reference: air/config.py:395; no
    elastic resize, same as the reference)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
