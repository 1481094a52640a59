"""Worker group: N long-lived actors, one per card (or per CPU worker),
gang-scheduled via a placement group (reference:
train/_internal/worker_group.py:102 + backend_executor.py:67). The port of
``ray_tpu/train/_worker_group.py``. The driver never holds device tensors:
each worker is its own torch process on the card its lease gave it
(``CUDA_VISIBLE_DEVICES``, so ``cuda:0``), joined to the others by one
``torch.distributed`` group (NCCL on cards, gloo on CPUs)."""

from __future__ import annotations

import logging
import os
import socket
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._session import (
    TrainContext,
    get_session,
    init_session,
    shutdown_session,
)
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

logger = logging.getLogger("ray_tpu_torch.train")


def _to_actor_options(res: Dict[str, float]) -> Dict[str, Any]:
    """Split a bundle-style resources dict into actor options (CPU/GPU/memory
    use dedicated options; the rest ride the custom-resources dict). A
    ``"TPU"`` key is refused, as the port's actors refuse ``num_tpus``."""
    res = dict(res)
    if "TPU" in res:
        raise ValueError("TPU is not a resource of a GPU cluster; use GPU")
    return {
        "num_cpus": res.pop("CPU", 0),
        "num_gpus": res.pop("GPU", 0),
        "memory": res.pop("memory", 0),
        "resources": res,
    }


class _TrainWorker:
    """Actor hosting one training process (one torch process per worker).
    It imports torch only when its loop or ``init_torch_process_group``
    does, so a CPU-only trial actor never loads it."""

    def __init__(self, rank: int, env: Dict[str, str]):
        for k, v in env.items():
            os.environ[k] = str(v)
        self._rank = rank
        self._thread: Optional[threading.Thread] = None

    def node_ip(self) -> str:
        return socket.gethostbyname(socket.gethostname())

    def free_port(self) -> int:
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def init_torch_process_group(self, master_ip: str, master_port: int,
                                 world_size: int, rank: int,
                                 backend: str = "gloo",
                                 timeout_s: float = 120.0):
        """torch.distributed bootstrap (reference: train/torch/config.py:65
        _setup_torch_process_group — MASTER_ADDR/PORT + init_process_group).
        Under NCCL the worker first takes its leased card as its device
        (``cuda:0`` under the lease's ``CUDA_VISIBLE_DEVICES``)."""
        import datetime

        import torch
        import torch.distributed as dist

        if backend == "nccl":
            torch.cuda.set_device(0)
        os.environ["MASTER_ADDR"] = master_ip
        os.environ["MASTER_PORT"] = str(master_port)
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{master_ip}:{master_port}",
            world_size=world_size,
            rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        return dist.get_rank()

    def start_run(
        self,
        train_fn: Callable,
        config: Optional[dict],
        ctx: TrainContext,
        checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[Dict[str, Any]] = None,
        pipeline_depth: int = 1,
    ):
        session = init_session(ctx, checkpoint, dataset_shards, pipeline_depth)

        import inspect

        try:
            takes_config = len(inspect.signature(train_fn).parameters) > 0
        except (TypeError, ValueError):
            takes_config = True

        def runner():
            try:
                if takes_config:
                    train_fn(config if config is not None else {})
                else:
                    train_fn()
            except BaseException as e:  # noqa: BLE001 — reported to driver
                session.error = e
                session.error_tb = traceback.format_exc()
            finally:
                # Flush telemetry/user metrics BEFORE signaling finished:
                # the driver kills the group right after consuming the
                # finished report, and the 1s async flush cadence would
                # lose the run's final step deltas.
                try:
                    from ray_tpu_torch._private import worker as worker_mod

                    if worker_mod.global_worker is not None:
                        worker_mod.global_worker.flush_user_metrics_sync()
                except Exception:
                    pass
                session.finished = True
                # wake any blocked report consumer hand-off
                session.reports.put(None)

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        return True

    def _report_to_wire(self, item) -> dict:
        session = get_session()
        if item is None:
            if session.error is not None:
                return {
                    "type": "error",
                    "error": str(session.error),
                    "traceback": getattr(session, "error_tb", ""),
                }
            return {"type": "finished"}
        out = {"type": "report", "metrics": item["metrics"]}
        ckpt = item["checkpoint"]
        if ckpt is not None:
            out["checkpoint_path"] = ckpt.path
        return out

    def next_report(self) -> dict:
        """Block until the worker's loop reports, errors, or finishes."""
        return self._report_to_wire(get_session().reports.get())

    def drain_reports(self, ack: int = 0) -> List[dict]:
        """Non-blocking batched drain with piggybacked acks — the Train
        driver's consumption path. Crucially there is NO thread parked on
        the report queue: report() is then a bare deque append, so the
        training thread's launches are never preempted by report-handler
        wakeups. The driver polls at 10Hz; Tune keeps the blocking
        per-report next_report so schedulers decide on every round."""
        import queue as _q

        session = get_session()
        if ack:
            session.ack(ack)
        items = []
        while True:
            try:
                items.append(session.reports.get_nowait())
            except _q.Empty:
                break
            if items[-1] is None:
                break
        return [self._report_to_wire(i) for i in items]

    def ack_report(self, n: int = 1):
        session = get_session()
        if session is not None:
            session.ack(n)
        return True

    def upload_checkpoint(self, local_path: str, experiment_uri: str,
                          rel: str) -> str:
        """Upload this worker's checkpoint dir into experiment storage from
        the worker's own node (reference: StorageContext uploads happen
        worker-side, train/_internal/storage.py:352 — the driver never
        touches worker-local paths)."""
        from ray_tpu_torch.train._storage import get_storage

        return get_storage(experiment_uri).upload_dir(local_path, rel)

    def finish(self):
        shutdown_session()
        return True


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        placement_strategy: str = "PACK",
        env: Optional[Dict[str, str]] = None,
    ):
        self.num_workers = num_workers
        self._pg = placement_group(
            [dict(resources_per_worker)] * num_workers,
            strategy=placement_strategy,
        )
        if not self._pg.wait(120):
            remove_placement_group(self._pg)
            raise RuntimeError(
                f"could not reserve {num_workers} x {resources_per_worker} "
                "for the train worker group"
            )
        actor_cls = ray_tpu_torch.remote(_TrainWorker)
        opts = _to_actor_options(resources_per_worker)
        self.workers = [
            actor_cls.options(
                **opts,
                scheduling_strategy=PlacementGroupSchedulingStrategy(self._pg, i),
            ).remote(i, env or {})
            for i in range(num_workers)
        ]

    def execute(self, method: str, *args, per_worker_args: Optional[List[tuple]] = None,
                timeout: Optional[float] = None) -> List[Any]:
        refs = []
        for i, w in enumerate(self.workers):
            call_args = per_worker_args[i] if per_worker_args is not None else args
            refs.append(getattr(w, method).remote(*call_args))
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_single(self, i: int, method: str, *args) -> Any:
        return ray_tpu_torch.get(getattr(self.workers[i], method).remote(*args))

    def async_call(self, i: int, method: str, *args):
        return getattr(self.workers[i], method).remote(*args)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass
