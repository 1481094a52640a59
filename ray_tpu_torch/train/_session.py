"""Per-worker training session: rank info + report() channel back to the
trainer (reference: train/_internal/session.py:111 _TrainSession, report
:667). The user loop runs on a thread inside the worker actor; report() blocks
until the driver has consumed the report, which gives the same per-report
barrier semantics as the reference."""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint


class TrainContext:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 local_world_size: int, node_ip: str,
                 experiment_name: str = ""):
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_ip = node_ip
        self._experiment_name = experiment_name

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_ip(self) -> str:
        return self._node_ip

    def get_experiment_name(self) -> str:
        return self._experiment_name


class _Session:
    def __init__(self, ctx: TrainContext, latest_checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 pipeline_depth: int = 1):
        self.ctx = ctx
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.reports: "queue.Queue" = queue.Queue()
        self.consumed = threading.Event()
        # Pipelined reports (reference: _internal/session.py uses a bounded
        # result queue): report(i) returns immediately while the driver
        # consumes asynchronously; report(i+depth) blocks until i is acked.
        # Strict per-report lockstep (depth 1, the Tune-trial default) puts
        # a full driver round-trip on the step critical path; the Train
        # worker group uses a deeper pipeline + batched drains so reporting
        # every step costs ~nothing relative to the compiled step.
        self.pipeline_depth = max(1, pipeline_depth)
        self._slot = threading.Semaphore(self.pipeline_depth)
        self._ack_cond = threading.Condition()
        self._submitted = 0
        self._acked = 0
        self.finished = False
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint]):
        self._slot.acquire()  # wait for a free pipeline slot
        with self._ack_cond:
            seq = self._submitted
            self._submitted += 1
        self.consumed.clear()
        self.reports.put({"metrics": metrics, "checkpoint": checkpoint})
        if self.pipeline_depth == 1:
            # strict barrier: return only after the consumer acked THIS
            # report — Tune trial loops rely on it (a checkpoint dir may be
            # reused right after report() returns)
            self.consumed.wait()
        elif checkpoint is not None:
            # Reference semantics (train/_internal/session.py report :667):
            # the checkpoint is persisted before report() returns, so the
            # user may delete or reuse the dir immediately after. Block
            # until the driver acked THIS report (acks are released only
            # after _consume_round copied/uploaded the dir). Metrics-only
            # reports keep the deep pipeline.
            with self._ack_cond:
                while self._acked <= seq:
                    self._ack_cond.wait()

    def ack(self, n: int = 1):
        self.consumed.set()
        with self._ack_cond:
            self._acked += n
            self._ack_cond.notify_all()
        for _ in range(n):
            self._slot.release()


_session: Optional[_Session] = None
_session_lock = threading.Lock()


def init_session(ctx: TrainContext, checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 pipeline_depth: int = 1) -> _Session:
    global _session
    # A reused worker process must not report the previous run's telemetry.
    # Probed, never imported: a loop that never loaded it has no recorder,
    # and importing it would load torch.
    _telemetry = sys.modules.get("ray_tpu_torch.train._telemetry")
    if _telemetry is not None:
        _telemetry.set_current_recorder(None)
    with _session_lock:
        _session = _Session(ctx, checkpoint, dataset_shards, pipeline_depth)
        return _session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None


def get_session() -> Optional[_Session]:
    return _session


# ------------------------------------------------------------- public API


def get_context() -> TrainContext:
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() outside a train worker")
    return s.ctx


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() outside a train worker")
    # Auto-attach step telemetry (train/_telemetry.py): if this worker runs
    # a TrainStep (or registered a StepRecorder), every report carries the
    # rolling step-time/MFU/goodput/throughput summary under telemetry/*
    # keys — user metrics always win on collision. Probed as in init_session.
    _telemetry = sys.modules.get("ray_tpu_torch.train._telemetry")
    auto = _telemetry.auto_report_metrics() if _telemetry is not None else {}
    if auto:
        metrics = {**auto, **metrics}
    s.report(metrics, checkpoint)


def get_dataset_shard(name: str = "train"):
    """This worker's split of a dataset passed to the trainer
    (reference: train.get_dataset_shard / DataConfig sharding): a
    ``ray_tpu_torch.data.Dataset`` that streams this rank's blocks."""
    s = get_session()
    if s is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_dataset_shard() outside a train worker"
        )
    shard = s.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset {name!r} was passed to the trainer "
            f"(available: {list(s.dataset_shards)})"
        )
    return shard


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.get_checkpoint() outside a train worker")
    return s.latest_checkpoint
