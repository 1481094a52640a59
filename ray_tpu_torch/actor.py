"""Actor API: ActorClass / ActorHandle / ActorMethod
(reference: python/ray/actor.py — ActorClass :566, ActorHandle :1223,
ActorMethod :116)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.worker import get_global_worker
from ray_tpu_torch.util.scheduling_strategies import strategy_to_dict

_ACTOR_OPTION_DEFAULTS = dict(
    num_cpus=None,
    num_tpus=None,
    num_gpus=None,
    memory=None,
    resources=None,
    # None = RTPU_TORCH_actor_max_restarts_default (0 unless overridden), so
    # operators can give every actor a restart budget cluster-wide without
    # touching call sites — mirrors max_retries in remote_function.py
    max_restarts=None,
    max_task_retries=0,
    max_concurrency=None,
    name=None,
    namespace=None,
    lifetime=None,
    get_if_exists=False,
    scheduling_strategy=None,
    runtime_env=None,
    max_pending_calls=-1,
)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, num_returns: Optional[int] = None, name: str = ""):
        m = ActorMethod(self._handle, self._method_name, num_returns or self._num_returns)
        return m

    def bind(self, *args, **kwargs):
        """Build a DAG node calling this method on the live actor
        (reference: actor.py ActorMethod.bind for dag/compiled use)."""
        from ray_tpu_torch.dag.node import ClassMethodNode, _LiveActorNode

        return ClassMethodNode(
            _LiveActorNode(self._handle), self._method_name, args, kwargs
        )

    def remote(self, *args, **kwargs):
        worker = get_global_worker()
        refs = worker.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            name=f"{self._handle._class_name}.{self._method_name}",
        )
        if self._num_returns == 1:
            return refs[0]
        if self._num_returns == 0:
            return None
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            "use .remote()"
        )


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str = "Actor", method_meta: Optional[dict] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_meta = method_meta or {}

    @property
    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()

    def __getattr__(self, item):
        if item == "__ray_call__":
            # run an arbitrary fn against the actor instance:
            # handle.__ray_call__.remote(lambda self, ...: ...)
            return ActorMethod(self, item, 1)
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item, self._method_meta.get(item, 1))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._method_meta))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(_ACTOR_OPTION_DEFAULTS)
        if options:
            self._apply(options)
        functools.update_wrapper(self, cls, updated=[])

    def _apply(self, overrides):
        for k, v in overrides.items():
            if k not in _ACTOR_OPTION_DEFAULTS:
                raise ValueError(f"unknown option '{k}' for actor")
            self._options[k] = v

    def options(self, **overrides) -> "ActorClass":
        ac = ActorClass(self._cls, None)
        ac._options = dict(self._options)
        ac._apply(overrides)
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = get_global_worker()
        o = self._options
        if o["num_tpus"]:
            raise ValueError("num_tpus is not supported on a GPU cluster; use num_gpus")
        if o["get_if_exists"] and o["name"]:
            try:
                return get_actor(o["name"], o["namespace"])
            except ValueError:
                pass
        resources = ts.normalize_resources(
            o["num_cpus"], o["num_gpus"], o["memory"], o["resources"], default_cpus=1.0
        )
        max_restarts = o["max_restarts"]
        if max_restarts is None:
            from ray_tpu_torch._private.config import CONFIG

            max_restarts = CONFIG.actor_max_restarts_default
        actor_id = worker.create_actor(
            self._cls,
            args,
            kwargs,
            name=o["name"] or "",
            namespace=o["namespace"] or "",
            resources=resources,
            max_restarts=max_restarts,
            max_concurrency=o["max_concurrency"] or 1,
            lifetime=o["lifetime"] or "",
            scheduling_strategy=strategy_to_dict(o["scheduling_strategy"]),
            runtime_env=o["runtime_env"],
        )
        method_meta = {
            m: getattr(getattr(self._cls, m), "_rtpu_num_returns")
            for m in dir(self._cls)
            if hasattr(getattr(self._cls, m, None), "_rtpu_num_returns")
        }
        return ActorHandle(actor_id, self._cls.__name__, method_meta)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            "use .remote()"
        )

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.node import ClassNode

        return ClassNode(self, args, kwargs)


def method(num_returns: int = 1):
    """Per-method option decorator (reference: python/ray/actor.py ray.method)."""

    def deco(fn):
        fn._rtpu_num_returns = num_returns
        return fn

    return deco


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    worker = get_global_worker()
    reply = worker.gcs.call(
        "GetActorByName", {"name": name, "namespace": namespace or ""}
    )
    if not reply.get("found"):
        raise ValueError(f"no actor named '{name}'")
    rec = reply["actor"]
    if rec["state"] == "DEAD":
        # the cause (a constructor's traceback, a kill) is what the caller
        # needs to act on, e.g. a serve replica that found no CUDA device
        cause = rec.get("death_cause")
        raise ValueError(f"actor '{name}' is dead" + (f": {cause}" if cause else ""))
    return ActorHandle(rec["actor_id"], name)
