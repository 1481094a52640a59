"""ray_tpu_torch.util — placement groups, scheduling strategies, collectives,
actor pool, queue, state API."""

import importlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.util import collective  # noqa: F401

_LAZY_SUBMODULES = ("check_serialize", "client", "collective", "multiprocessing", "placement_group", "queue", "state")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool

        return ActorPool
    raise AttributeError(f"module 'ray_tpu_torch.util' has no attribute '{name}'")
