"""Top-level API: init/shutdown/remote/get/put/wait/kill/cancel and cluster
introspection (reference: python/ray/_private/worker.py — init :1225,
remote :3149, get :2576, put :2691, wait :2756)."""

from __future__ import annotations

import atexit
import inspect
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import (
    MODE_DRIVER,
    CoreWorker,
    get_global_worker,
    set_global_worker,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction

_init_lock = threading.Lock()
_local_node: Optional[Node] = None
_job_counter = 0


def is_initialized() -> bool:
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker is not None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    _system_config: Optional[dict] = None,
    log_to_driver: bool = True,
):
    """Start (or connect to) a cluster and attach this process as the driver."""
    global _local_node, _job_counter
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch.init() called twice")
        CONFIG.apply_system_config(_system_config)

        if address is None:
            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = float(num_cpus)
            res.setdefault("CPU", float(os.cpu_count() or 1))
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            else:
                auto_res, auto_labels = accelerators.node_resources_and_labels()
                for k, v in auto_res.items():
                    res.setdefault(k, v)
                labels = {**auto_labels, **(labels or {})}
            _local_node = Node(
                head=True,
                resources=res,
                labels=labels or {},
                object_store_memory=object_store_memory,
            )
            gcs_address = _local_node.gcs_address
            raylet_addr = _local_node.raylet_address
        else:
            if address == "auto":
                address = os.environ.get("RTPU_TORCH_ADDRESS", "")
                if not address:
                    raise ValueError("address='auto' requires RTPU_TORCH_ADDRESS env var")
            from ray_tpu_torch._private.gcs.client import GcsClient

            gcs = GcsClient.from_address(address)
            nodes = [n for n in gcs.get_all_node_info() if n["state"] == "ALIVE"]
            if not nodes:
                raise RuntimeError(f"no alive nodes in cluster at {address}")
            import socket

            my_ips = {"127.0.0.1", "0.0.0.0", socket.gethostname()}
            try:
                my_ips.add(socket.gethostbyname(socket.gethostname()))
            except Exception:
                pass
            local = [n for n in nodes if n["ip"] in my_ips]
            head = [n for n in nodes if n.get("is_head")]
            target = (local or head or nodes)[0]
            gcs_address = address
            raylet_addr = (target["ip"], target["raylet_port"])

        _job_counter += 1
        job_id = JobID.from_int((os.getpid() << 8 | (_job_counter & 0xFF)) & 0xFFFFFFFF)
        worker = CoreWorker(
            mode=MODE_DRIVER,
            gcs_address=gcs_address,
            raylet_addr=raylet_addr,
            job_id=job_id,
            startup_token=-1,
        )
        worker.namespace = namespace or ""
        set_global_worker(worker)
        import sys as _sys

        worker.gcs.call(
            "AddJob",
            {
                "job_id": job_id.binary(),
                "driver_addr": list(worker.address),
                "entrypoint": " ".join(os.sys.argv if hasattr(os, "sys") else []),
                # Workers extend their sys.path with the driver's so that
                # by-reference-pickled functions (modules importable on the
                # driver) resolve on workers too (reference: job_config
                # code-search-path propagation).
                "driver_sys_path": [p for p in _sys.path if p],
            },
        )
        if log_to_driver:
            worker.enable_log_to_driver()
        atexit.register(shutdown)
        return _ClientContext(gcs_address)


class _ClientContext:
    def __init__(self, address):
        self.address_info = {"gcs_address": address}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()


def shutdown():
    global _local_node
    from ray_tpu_torch._private import worker as worker_mod

    with _init_lock:
        worker = worker_mod.global_worker
        if worker is not None:
            try:
                worker.gcs.call("MarkJobFinished", {"job_id": worker.job_id.binary()}, timeout=5)
            except Exception:
                pass
            worker.shutdown()
            set_global_worker(None)
        if _local_node is not None:
            _local_node.shutdown()
            _local_node = None
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass


def remote(*args, **kwargs):
    """Decorator: turn a function into a RemoteFunction / class into an ActorClass."""

    def make(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, kwargs or None)
        return RemoteFunction(obj, kwargs or None)

    if len(args) == 1 and not kwargs and (inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return make


def get(
    object_refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    worker = get_global_worker()
    single = isinstance(object_refs, ObjectRef)
    refs = [object_refs] if single else list(object_refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = worker.get(refs, timeout=timeout)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return get_global_worker().put(value)


def wait(
    object_refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    worker = get_global_worker()
    refs = list(object_refs)
    if num_returns > len(refs):
        raise ValueError("num_returns > len(object_refs)")
    seen = set()
    for r in refs:
        if r in seen:
            raise ValueError("wait() got duplicate ObjectRefs")
        seen.add(r)
    return worker.wait(refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    get_global_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    get_global_worker().cancel_task(ref, force, recursive)


def nodes() -> List[dict]:
    out = []
    for n in get_global_worker().gcs.get_all_node_info():
        out.append(
            {
                "NodeID": n["node_id"].hex(),
                "Alive": n["state"] == "ALIVE",
                "NodeManagerAddress": n["ip"],
                "NodeManagerPort": n["raylet_port"],
                "Resources": n["resources_total"],
                "Available": n["resources_available"],
                "Labels": n.get("labels", {}),
                "IsHead": n.get("is_head", False),
            }
        )
    return out


def cluster_resources() -> Dict[str, float]:
    return get_global_worker().gcs.get_cluster_resources()["total"]


def available_resources() -> Dict[str, float]:
    return get_global_worker().gcs.get_cluster_resources()["available"]


def timeline(filename: Optional[str] = None, *,
             job_id: Optional[str] = None, trace_id: Optional[str] = None):
    """Chrome-tracing dump of task events (reference: _private/state.py:944
    chrome_tracing_dump; open in chrome://tracing or ui.perfetto.dev).
    ``job_id`` (hex) / ``trace_id`` filter server-side."""
    from ray_tpu_torch._private.timeline import timeline as _timeline

    get_global_worker()  # raise early if not initialized
    result = _timeline(filename, job_id=job_id, trace_id=trace_id)
    return filename if filename else result
