"""TorchTrainer: data-parallel torch training over the actor worker group
(reference: python/ray/train/torch/torch_trainer.py:11 + config.py:65
_setup_torch_process_group + train_loop_utils.py:453 prepare_model / :313
prepare_data_loader).

The port's flagship trainer, in the place of the JAX package's
``JaxTrainer`` and of its gloo-only ``TorchTrainer``. Each worker leases
its card (``ScalingConfig(use_gpu=True)``: one ``{"GPU": 1, "CPU": 1}``
bundle per worker, its own ``CUDA_VISIBLE_DEVICES``); with more than one
worker they form one ``torch.distributed`` group, NCCL on cards and gloo
on CPUs, before the loop starts. ``parallel.mesh.make_mesh`` inside the
loop then takes that group (it starts its own only when none exists), so
the port's ``TrainStep`` runs on a mesh over the workers' cards; DDP
through :func:`prepare_model` works too. Reports and checkpoints go
through the session machinery every trainer shares.

Nothing here imports torch at import time: the trial actor that drives a
``fit()`` holds no card and never loads it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ray_tpu_torch.train._trainer import DataParallelTrainer, logger


@dataclasses.dataclass
class TorchConfig:
    """Process-group config (reference: train/torch/config.py:65).
    ``backend`` None: NCCL when each worker holds a card, else gloo."""

    backend: Optional[str] = None
    init_timeout_s: float = 120.0


class TorchTrainer(DataParallelTrainer):
    """Runs `train_loop_per_worker` on every worker inside one
    torch.distributed process group."""

    def __init__(self, *args, torch_config: Optional[TorchConfig] = None, **kw):
        super().__init__(*args, **kw)
        self.torch_config = torch_config or TorchConfig()

    def _worker_env(self) -> Dict[str, str]:
        # the rendezvous env is set per worker in _on_group_start
        return {}

    def _backend(self) -> str:
        if self.torch_config.backend:
            return self.torch_config.backend
        gpus = self.scaling_config.worker_resources().get("GPU", 0)
        return "nccl" if gpus >= 1 else "gloo"

    def _on_group_start(self, group):
        if group.num_workers <= 1:
            return
        ip = group.execute_single(0, "node_ip")
        port = group.execute_single(0, "free_port")
        import ray_tpu_torch

        backend = self._backend()
        refs = [
            group.async_call(
                i, "init_torch_process_group",
                ip, port, group.num_workers, i,
                backend, self.torch_config.init_timeout_s,
            )
            for i in range(group.num_workers)
        ]
        ray_tpu_torch.get(refs, timeout=self.torch_config.init_timeout_s + 60)
        logger.info("torch.distributed(%s) up: %d ranks", backend,
                    group.num_workers)


# ------------------------------------------------------- worker-side helpers


def get_device():
    """The device this worker should use (reference:
    train/torch/train_loop_utils.py get_device): its leased card, which is
    ``cuda:0`` under the lease's ``CUDA_VISIBLE_DEVICES``, or the CPU when
    the worker holds no card. A worker whose lease holds a card but whose
    process sees no CUDA raises rather than fall back to the CPU."""
    import torch

    import ray_tpu_torch

    gpus = ray_tpu_torch.get_runtime_context().get_assigned_resources().get("GPU", 0)
    if not gpus:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this train worker leased a GPU, but torch.cuda.is_available() is "
            "False in its process")
    return torch.device("cuda", torch.cuda.current_device())


def prepare_model(model):
    """Move the model to :func:`get_device` and wrap it for distributed
    training (reference: train_loop_utils.py:453 — DDP when world_size > 1,
    with ``device_ids`` on the card)."""
    import torch.distributed as dist

    device = get_device()
    model = model.to(device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        ids = [device.index] if device.type == "cuda" else None
        return DistributedDataParallel(model, device_ids=ids)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across workers with a DistributedSampler
    (reference: train_loop_utils.py:313). Preserves the loader's shuffle
    setting; loaders built with a custom batch_sampler can't be resharded
    automatically and are rejected."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return loader
    import torch.utils.data as tud

    if loader.batch_size is None:
        raise ValueError(
            "prepare_data_loader cannot reshard a DataLoader built with a "
            "custom batch_sampler; construct a DistributedSampler-aware "
            "batch_sampler yourself"
        )
    shuffle = isinstance(loader.sampler, tud.RandomSampler)
    sampler = tud.distributed.DistributedSampler(
        loader.dataset, shuffle=shuffle
    )
    return tud.DataLoader(
        loader.dataset,
        batch_size=loader.batch_size,
        sampler=sampler,
        num_workers=0,
        collate_fn=loader.collate_fn,
        drop_last=loader.drop_last,
    )
