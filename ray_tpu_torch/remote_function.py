"""@ray_tpu_torch.remote functions (reference: python/ray/remote_function.py:40)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch._private.worker import get_global_worker
from ray_tpu_torch.util.scheduling_strategies import strategy_to_dict


_OPTION_DEFAULTS = dict(
    num_cpus=None,
    num_tpus=None,  # accepted for API compat; GPU is the accelerator here
    num_gpus=None,
    memory=None,
    resources=None,
    num_returns=1,
    max_retries=None,
    retry_exceptions=False,
    scheduling_strategy=None,
    runtime_env=None,
    name=None,
    _metadata=None,
)


def _merge_options(base: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overrides.items():
        if k not in _OPTION_DEFAULTS:
            raise ValueError(f"unknown option '{k}' for remote function")
        out[k] = v
    return out


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        if isinstance(fn, RemoteFunction):
            fn = fn._function
        self._function = fn
        self._options = dict(_OPTION_DEFAULTS)
        if options:
            self._options = _merge_options(self._options, options)
        functools.update_wrapper(self, fn)

    def options(self, **overrides) -> "RemoteFunction":
        rf = RemoteFunction(self._function, None)
        rf._options = _merge_options(self._options, overrides)
        return rf

    def remote(self, *args, **kwargs):
        worker = get_global_worker()
        o = self._options
        if o["num_tpus"]:
            raise ValueError(
                "num_tpus is not supported on a GPU cluster; use num_gpus"
            )
        resources = ts.normalize_resources(
            o["num_cpus"], o["num_gpus"], o["memory"], o["resources"]
        )
        max_retries = o["max_retries"]
        if max_retries is None:
            from ray_tpu_torch._private.config import CONFIG

            max_retries = CONFIG.task_max_retries_default
        refs = worker.submit_task(
            self._function,
            args,
            kwargs,
            name=o["name"] or self._function.__qualname__,
            num_returns=o["num_returns"],
            resources=resources,
            max_retries=max_retries,
            retry_exceptions=bool(o["retry_exceptions"]),
            scheduling_strategy=strategy_to_dict(o["scheduling_strategy"]),
            runtime_env=o["runtime_env"],
        )
        if o["num_returns"] == 1:
            return refs[0]
        if o["num_returns"] == 0:
            return None
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__qualname__}' cannot be called "
            "directly; use .remote()"
        )

    def bind(self, *args, **kwargs):
        """DAG-building entrypoint (reference: python/ray/dag)."""
        from ray_tpu_torch.dag.node import FunctionNode

        return FunctionNode(self, args, kwargs)
