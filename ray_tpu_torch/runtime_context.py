"""Runtime context (reference: python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.worker import get_global_worker


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_node_id(self) -> str:
        return self._worker.node_id.hex()

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        spec = self._worker.current_task_spec()
        return spec["task_id"].hex() if spec else None

    def get_actor_id(self) -> Optional[str]:
        return self._worker.actor_id.hex() if self._worker.actor_id else None

    def get_actor_name(self) -> Optional[str]:
        spec = self._worker._actor_spec
        if spec is None:
            return None
        return spec.get("name", "").split(".")[0] or None

    @property
    def gcs_address(self) -> str:
        return self._worker.gcs.address

    def get_assigned_resources(self) -> dict:
        spec = self._worker.current_task_spec()
        if spec is not None:
            return dict(spec.get("resources", {}))
        if self._worker._actor_spec is not None:
            return dict(self._worker._actor_spec.get("resources", {}))
        return {}

    def get_accelerator_ids(self) -> dict:
        import os

        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        gpus = [c for c in visible.split(",") if c] if visible else []
        if not gpus:
            n = int(self.get_assigned_resources().get("GPU", 0))
            gpus = [str(i) for i in range(n)]
        return {"GPU": gpus}

    def was_current_actor_reconstructed(self) -> bool:
        return False


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(get_global_worker())
