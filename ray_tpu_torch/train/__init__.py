"""ray_tpu_torch.train — data-parallel training over actor worker groups.

The port of ``ray_tpu/train`` (reference: python/ray/train/, call stack
SURVEY.md §3.4): one worker actor per leased card, gang-scheduled through a
placement group, one ``torch.distributed`` group over the workers (NCCL on
cards), the port's ``TrainStep`` (or DDP) inside the loop, and reports and
checkpoints back through the session. ``TorchTrainer(...).fit()`` is a
one-trial Tune run, as in the reference.

The names resolve on first access (PEP 562): ``parallel.train_step``
imports ``train._telemetry``, and that must not load the runtime; nothing
here imports torch at import time, so a CPU-only trial actor never loads
it. A trainer's ``datasets=`` (``ray_tpu_torch.data`` Datasets) are split
by blocks over the workers (``split_blocks``, one shard per rank), and
``get_dataset_shard(name)`` returns this rank's, which streams its blocks
through ``iter_batches`` or onto the card through ``iter_torch_batches``.
"""

import importlib

_EXPORTS = {
    "Checkpoint": "_checkpoint",
    "CheckpointConfig": "_config",
    "FailureConfig": "_config",
    "RunConfig": "_config",
    "ScalingConfig": "_config",
    "get_checkpoint": "_session",
    "get_context": "_session",
    "get_dataset_shard": "_session",
    "report": "_session",
    "DataParallelTrainer": "_trainer",
    "Result": "_trainer",
    "TrainingFailedError": "_trainer",
    "TorchConfig": "torch",
    "TorchTrainer": "torch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    if name == "torch":
        return importlib.import_module(f"{__name__}.torch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
