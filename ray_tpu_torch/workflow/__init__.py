"""Durable workflows: checkpointed DAG execution with resume, the port of
``ray_tpu/workflow/`` (reference: python/ray/workflow/ —
workflow_executor.py, workflow_state_from_dag.py, task_executor.py; the
function-step subset).

A workflow takes a ``ray_tpu_torch.dag`` graph, executes it step by step as tasks,
and writes every step's output to storage before moving on. If the driver (or
the whole cluster) dies, ``workflow.resume(workflow_id)`` reloads the graph
and skips every step whose checkpoint exists — exactly-once step semantics by
way of write-ahead results.

Dynamic continuation is supported the way the reference's
``workflow.continuation`` works: a step may return another DAG, which is
spliced in and executed (with namespaced step ids) before its caller's value
resolves.

    import ray_tpu_torch
    from ray_tpu_torch import workflow

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    workflow.init(storage="/tmp/wf")
    out = workflow.run(add.bind(1, add.bind(2, 3)), workflow_id="w1")

Storage is the JAX package's layout: ``<root>/<workflow_id>/dag.pkl`` (the
graph and its input), ``meta.json`` (``status``, ``start_time``,
``end_time``), and ``steps/<step_id>.pkl`` per finished step, its id the
node's structural path and function name (``r.0_mul``), with the final
value under ``__output__``. Step values reach the driver through ``get``
and are written with cloudpickle: a step that returns a CUDA tensor
(``num_gpus=1``) reaches the driver, and storage, as a CPU tensor of the
same dtype (the port's serializer copies it to the host once), so what
``resume`` and ``get_output`` give back is that CPU tensor, on a machine
with a card or without one; the step that needs it on a card moves it
there. Reading a stored tensor needs torch in the reading process, as
writing it did.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.dag.node import (
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
    _AttrProxy,
)

_storage_root: Optional[str] = None

RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"


def init(storage: Optional[str] = None):
    """Set the workflow storage root (a directory; any shared filesystem)."""
    global _storage_root
    _storage_root = storage or os.environ.get(
        "RTPU_TORCH_WORKFLOW_STORAGE",
        os.path.expanduser("~/.ray_tpu_torch/workflows")
    )
    os.makedirs(_storage_root, exist_ok=True)


def _root() -> str:
    if _storage_root is None:
        init()
    return _storage_root


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_root(), workflow_id)


def _meta_path(workflow_id: str) -> str:
    return os.path.join(_wf_dir(workflow_id), "meta.json")


def _write_meta(workflow_id: str, **updates):
    path = _meta_path(workflow_id)
    meta = {}
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
    meta.update(updates)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)
    return meta


class _StepStore:
    """Write-ahead step results under <wf>/steps/<step_id>.pkl."""

    def __init__(self, workflow_id: str):
        self.dir = os.path.join(_wf_dir(workflow_id), "steps")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step_id: str) -> str:
        # continuation step ids are namespaced with '/'; store flat
        return os.path.join(self.dir, step_id.replace("/", "--") + ".pkl")

    def has(self, step_id: str) -> bool:
        return os.path.exists(self._path(step_id))

    def load(self, step_id: str):
        with open(self._path(step_id), "rb") as f:
            return cloudpickle.load(f)

    def save(self, step_id: str, value):
        tmp = self._path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(value, f)
        os.replace(tmp, self._path(step_id))


def _step_name(node: FunctionNode) -> str:
    fn = getattr(node._remote_fn, "_function", None)
    return getattr(fn, "__name__", "step")


class _Executor:
    """Deterministic DFS walk: a node's step id is its structural PATH in the
    graph (child-index chain from the root), so ids are stable under resume
    regardless of which subtrees short-circuit on cached checkpoints — a
    counter would shift when a cached node skips walking its children."""

    def __init__(self, workflow_id: str, store: _StepStore):
        self.workflow_id = workflow_id
        self.store = store

    def exec_node(self, node, input_value, path: str = "r") -> Any:
        if isinstance(node, InputNode):
            return input_value
        if isinstance(node, _AttrProxy):
            base = self.exec_node(node._base, input_value, path + ".p")
            return base[node._key]
        if isinstance(node, MultiOutputNode):
            return [self.exec_node(n, input_value, f"{path}.{i}")
                    for i, n in enumerate(node._nodes)]
        if isinstance(node, FunctionNode):
            step_id = f"{path}_{_step_name(node)}"
            if self.store.has(step_id):
                return self.store.load(step_id)
            args = [self.exec_node(a, input_value, f"{path}.{i}")
                    if isinstance(a, DAGNode) else a
                    for i, a in enumerate(node._bound_args)]
            kwargs = {k: self.exec_node(v, input_value, f"{path}.k{k}")
                      if isinstance(v, DAGNode) else v
                      for k, v in node._bound_kwargs.items()}
            result = ray_tpu_torch.get(node._remote_fn.remote(*args, **kwargs))
            if isinstance(result, DAGNode):
                # continuation: splice the returned DAG in, namespaced so its
                # step ids cannot collide with ours
                result = self.exec_node(
                    result, input_value, path=step_id + "/r"
                )
            self.store.save(step_id, result)
            return result
        raise TypeError(
            f"workflow steps must be function DAG nodes, got {type(node)}"
        )


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        input_value: Any = None) -> Any:
    """Execute the DAG durably; returns the final output."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    # persist the graph itself so resume() can rebuild it
    with open(os.path.join(wf_dir, "dag.pkl"), "wb") as f:
        cloudpickle.dump((dag, input_value), f)
    _write_meta(workflow_id, status=RUNNING, start_time=time.time())
    store = _StepStore(workflow_id)
    try:
        result = _Executor(workflow_id, store).exec_node(dag, input_value)
    except Exception:
        _write_meta(workflow_id, status=FAILED, end_time=time.time())
        raise
    store.save("__output__", result)
    _write_meta(workflow_id, status=SUCCESSFUL, end_time=time.time())
    return result


def resume(workflow_id: str) -> Any:
    """Re-run a workflow from storage; completed steps are skipped."""
    dag_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    if not os.path.exists(dag_path):
        raise ValueError(f"no workflow '{workflow_id}' in {_root()}")
    with open(dag_path, "rb") as f:
        dag, input_value = cloudpickle.load(f)
    _write_meta(workflow_id, status=RUNNING)
    store = _StepStore(workflow_id)
    try:
        result = _Executor(workflow_id, store).exec_node(dag, input_value)
    except Exception:
        _write_meta(workflow_id, status=FAILED, end_time=time.time())
        raise
    store.save("__output__", result)
    _write_meta(workflow_id, status=SUCCESSFUL, end_time=time.time())
    return result


def get_output(workflow_id: str) -> Any:
    store = _StepStore(workflow_id)
    if not store.has("__output__"):
        raise ValueError(f"workflow '{workflow_id}' has no output yet")
    return store.load("__output__")


def get_status(workflow_id: str) -> str:
    path = _meta_path(workflow_id)
    if not os.path.exists(path):
        raise ValueError(f"no workflow '{workflow_id}'")
    with open(path) as f:
        return json.load(f)["status"]


def list_all(status_filter: Optional[str] = None) -> List[Dict[str, Any]]:
    out = []
    root = _root()
    for wid in sorted(os.listdir(root)):
        mp = _meta_path(wid)
        if not os.path.exists(mp):
            continue
        with open(mp) as f:
            meta = json.load(f)
        if status_filter and meta.get("status") != status_filter:
            continue
        out.append({"workflow_id": wid, **meta})
    return out


def delete(workflow_id: str):
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)


# ------------------------------------------------------------ virtual actors
from ray_tpu_torch.workflow.virtual_actor import (  # noqa: E402,F401
    VirtualActorHandle,
    get_actor,
    list_actors,
    virtual_actor,
)
