"""DataParallelTrainer: drive a worker group through a training run with
report/checkpoint rounds and group-restart fault tolerance. The port of
``ray_tpu/train/_trainer.py``; its backend subclass is
``ray_tpu_torch.train.torch.TorchTrainer``.

Reference call stack (SURVEY.md §3.4): TorchTrainer.fit →
BackendExecutor.start → WorkerGroup actors → _setup_torch_process_group →
start_training → poll reports (train/base_trainer.py:567,
_internal/backend_executor.py:67/:445, data_parallel_trainer.py:428)."""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._session import TrainContext
from ray_tpu_torch.train._worker_group import WorkerGroup

logger = logging.getLogger("ray_tpu_torch.train")


class TrainingFailedError(RuntimeError):
    pass


class Result:
    def __init__(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint],
                 path: str, error: Optional[Exception] = None,
                 metrics_history: Optional[List[Dict[str, Any]]] = None):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.path = path
        self.error = error
        self.metrics_history = metrics_history or []

    def __repr__(self):
        return (f"Result(metrics={self.metrics!r}, "
                f"checkpoint={self.checkpoint!r}, error={self.error!r})")


class DataParallelTrainer:
    """SPMD function trainer: run `train_loop_per_worker` on every worker.

    Subclasses configure the worker runtime (TorchTrainer brings up the
    torch.distributed group); the base class owns scheduling, report
    rounds, checkpoint persistence and group restarts."""

    # Worker report pipeline depth: the loop may run this many reports
    # ahead of the driver's consumption (drained at 20Hz in batches), so
    # per-step report() costs ~nothing relative to a train step. Tune trial
    # sessions use depth 1 (schedulers decide per report).
    _report_pipeline_depth = 64

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._train_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._resume_checkpoint = resume_from_checkpoint
        self._datasets = datasets or {}
        name = self.run_config.name or f"train_{int(time.time())}"
        from ray_tpu_torch.train._storage import is_remote_uri

        self._remote_storage = is_remote_uri(self.run_config.storage_path)
        if self._remote_storage:
            # URI storage (mock://, s3://, ...): checkpoints upload from the
            # workers' nodes; the driver only tracks URIs (no shared FS).
            self.experiment_dir = (
                self.run_config.storage_path.rstrip("/") + "/" + name
            )
        else:
            storage = self.run_config.storage_path or os.path.join(
                os.path.expanduser("~"), "ray_tpu_torch_results"
            )
            self.experiment_dir = os.path.join(storage, name)

    # ------------------------------------------------------------ backend hooks

    def _worker_env(self) -> Dict[str, str]:
        return {}

    def _on_group_start(self, group: WorkerGroup):
        """Backend setup after actors exist, before the user loop starts."""

    # ------------------------------------------------------------------- fit

    def fit(self) -> Result:
        """Run training. Like the reference (base_trainer.py:819 wraps the
        trainer into a Tune Trainable), fit() is a 1-trial Tune run; inside a
        trial actor it runs the training loop directly."""
        from ray_tpu_torch.train._session import get_session

        if get_session() is not None:
            return self._fit_direct()
        from ray_tpu_torch.tune import Tuner

        grid = Tuner(self).fit()
        r = grid[0]
        if r.error:
            raise TrainingFailedError(
                f"training failed (trial {r.trial_id}):\n{r.error}"
            )
        # Final telemetry gauges re-published from THIS process: the GCS
        # drops dead workers' gauges, and the trial/train actors are gone
        # by now — the driver keeps the run's summary scrapeable.
        from ray_tpu_torch.train._report_gauges import publish_report_summary

        publish_report_summary(
            dict(r.metrics or {}), os.path.basename(self.experiment_dir))
        return Result(
            metrics=dict(r.metrics or {}),
            # The trial persisted its own copy of the latest checkpoint the
            # inner workers reported; fall back to any checkpoints a direct
            # run left in this trainer's experiment dir.
            checkpoint=r.checkpoint or self._latest_persisted_checkpoint(),
            path=self.experiment_dir,
            metrics_history=list(r.metrics_history),
        )

    def _fit_direct(self, report_callback=None) -> Result:
        if not self._remote_storage:
            os.makedirs(self.experiment_dir, exist_ok=True)
        failure_config = self.run_config.failure_config or FailureConfig()
        ckpt_config = self.run_config.checkpoint_config or CheckpointConfig()
        retries_left = failure_config.max_failures
        latest_checkpoint = self._resume_checkpoint
        while True:
            try:
                return self._fit_once(latest_checkpoint, ckpt_config,
                                      report_callback)
            except TrainingFailedError:
                raise
            except Exception as e:
                # group failure (worker/actor death) — restart from the last
                # persisted checkpoint (reference: FailureConfig(max_failures),
                # whole-group restart, air/config.py:395)
                latest_checkpoint = self._latest_persisted_checkpoint()
                if retries_left == 0:
                    raise TrainingFailedError(
                        f"training failed with no retries left: {e}"
                    ) from e
                retries_left -= 1
                logger.warning(
                    "worker group failed (%s); restarting from %s "
                    "(%d retries left)", e, latest_checkpoint, retries_left,
                )

    def _fit_once(self, checkpoint: Optional[Checkpoint],
                  ckpt_config: CheckpointConfig,
                  report_callback=None) -> Result:
        sc = self.scaling_config
        group = WorkerGroup(
            sc.num_workers,
            sc.worker_resources(),
            placement_strategy=sc.placement_strategy,
            env=self._worker_env(),
        )
        try:
            self._on_group_start(group)
            ips = group.execute("node_ip")
            local_ranks = self._local_ranks(ips)
            # Shard datasets across workers: lazy block-granular split so
            # every rank STREAMS a disjoint slice without materializing the
            # plan on the driver (reference: DataConfig/streaming_split).
            shards_by_rank = [dict() for _ in range(sc.num_workers)]
            for ds_name, ds in self._datasets.items():
                if sc.num_workers > 1:
                    splits = ds.split_blocks(sc.num_workers)
                else:
                    splits = [ds]
                for rank, shard in enumerate(splits):
                    shards_by_rank[rank][ds_name] = shard
            per_worker = []
            for rank in range(sc.num_workers):
                ctx = TrainContext(
                    world_rank=rank,
                    world_size=sc.num_workers,
                    local_rank=local_ranks[rank],
                    local_world_size=ips.count(ips[rank]) if ips else 1,
                    node_ip=ips[rank],
                    experiment_name=os.path.basename(self.experiment_dir),
                )
                per_worker.append(
                    (self._train_fn, self._train_config, ctx, checkpoint,
                     shards_by_rank[rank], self._report_pipeline_depth)
                )
            group.execute("start_run", per_worker_args=per_worker)
            return self._poll_reports(group, ckpt_config, report_callback)
        finally:
            group.shutdown()

    def _local_ranks(self, ips: List[str]) -> List[int]:
        counters: Dict[str, int] = {}
        out = []
        for ip in ips:
            out.append(counters.get(ip, 0))
            counters[ip] = out[-1] + 1
        return out

    def _poll_reports(self, group: WorkerGroup,
                      ckpt_config: CheckpointConfig,
                      report_callback=None) -> Result:
        import ray_tpu_torch

        metrics_history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        result_checkpoint: Optional[Checkpoint] = None
        # Continue numbering after any checkpoints a previous (crashed)
        # attempt persisted, so restarts never overwrite newer state.
        if self._remote_storage:
            from ray_tpu_torch.train._storage import get_storage

            existing = [
                d for d in get_storage(self.experiment_dir).list_dirs()
                if d.startswith("checkpoint_")
            ]
        else:
            existing = [
                d for d in os.listdir(self.experiment_dir)
                if d.startswith("checkpoint_")
            ] if os.path.isdir(self.experiment_dir) else []
        ckpt_index = (
            max(int(d.split("_")[-1]) for d in existing) + 1 if existing else 0
        )
        active = list(range(group.num_workers))
        saved: List[tuple] = []  # (score, path)
        rs = {
            "ckpt_index": ckpt_index,
            "last_metrics": last_metrics,
            "result_checkpoint": result_checkpoint,
        }
        # Polling drains at 10Hz with piggybacked acks: the workers' report
        # queues have NO parked consumer thread, so report() never preempts
        # the training thread's launches (see drain_reports). Workers
        # may be drained at different report offsets — buffer per worker by
        # global round number and consume a round once every active worker
        # has reached it (reports are lockstep per round index).
        buf: Dict[int, Dict[int, dict]] = {i: {} for i in active}
        seen: Dict[int, int] = {i: 0 for i in active}  # reports received
        pending_ack: Dict[int, int] = {i: 0 for i in active}
        next_round = 0
        while active or any(buf[i] for i in buf):
            if active:
                refs = [
                    (i, group.async_call(i, "drain_reports", pending_ack[i]))
                    for i in active
                ]
                for i, _ in refs:
                    pending_ack[i] = 0
                batches = {i: ray_tpu_torch.get(ref) for i, ref in refs}
            else:
                batches = {}
            got_any = False
            for i, items in batches.items():
                for rep in items:
                    got_any = True
                    if rep["type"] == "error":
                        raise TrainingFailedError(
                            f"worker {i} failed:\n"
                            f"{rep['traceback'] or rep['error']}"
                        )
                    if rep["type"] == "finished":
                        active.remove(i)
                    else:
                        buf[i][seen[i]] = rep
                        seen[i] += 1
            # consume every globally-complete round, in order
            while True:
                if any(seen[i] <= next_round for i in active):
                    break  # an active worker hasn't reached this round yet
                reports = {
                    i: buf[i].pop(next_round)
                    for i in buf if next_round in buf[i]
                }
                if not reports:
                    break
                self._consume_round(
                    reports, ckpt_config, report_callback, group,
                    metrics_history, saved, rs,
                )
                for i in reports:
                    pending_ack[i] += 1
                next_round += 1
            if active:
                # Pace the polls even while reports flow: draining in a
                # tight RPC loop steals the worker's GIL from the train
                # thread's launches.
                # A deep pipeline (Train workers, depth 64) absorbs a 100 ms
                # consumption latency for free and every poll RPC costs the
                # worker two thread wakeups mid-dispatch, so poll at 10 Hz
                # there; shallow pipelines (Tune trials) keep the snappier
                # 25/50 ms cadence for per-report scheduler decisions.
                if self._report_pipeline_depth >= 16:
                    time.sleep(0.1 if got_any else 0.15)
                else:
                    time.sleep(0.025 if got_any else 0.05)
        # release the final acks so the workers' sessions unblock cleanly
        for i, n in pending_ack.items():
            if n and i < group.num_workers:
                try:
                    group.async_call(i, "ack_report", n)
                except Exception:
                    pass
        return Result(
            metrics=rs["last_metrics"],
            checkpoint=rs["result_checkpoint"],
            path=self.experiment_dir,
            metrics_history=metrics_history,
        )

    def _consume_round(self, reports, ckpt_config, report_callback, group,
                       metrics_history, saved, rs):
        """Process one lockstep report round (metrics + optional checkpoint
        persistence/retention); state carries across rounds in `rs`."""
        if not reports:
            return
        # rank-0 metrics win; lowest reporting rank if 0 has finished
        lead = reports[min(reports)]["metrics"]
        rs["last_metrics"] = lead
        metrics_history.append(lead)
        # live per-round gauges from the polling process (it outlives the
        # workers, so the series survive worker-group shutdown)
        from ray_tpu_torch.train._report_gauges import publish_report_summary

        publish_report_summary(
            lead, os.path.basename(self.experiment_dir))
        ckpt_worker, ckpt_path = next(
            ((i, r["checkpoint_path"]) for i, r in reports.items()
             if "checkpoint_path" in r), (None, None),
        )
        if ckpt_path:
            rel = f"checkpoint_{rs['ckpt_index']:06d}"
            rs["ckpt_index"] += 1
            if self._remote_storage:
                # the reporting worker uploads from ITS node — no shared
                # filesystem assumed
                dest = group.execute_single(
                    ckpt_worker, "upload_checkpoint",
                    ckpt_path, self.experiment_dir, rel,
                )
            else:
                dest = os.path.join(self.experiment_dir, rel)
                shutil.copytree(ckpt_path, dest, dirs_exist_ok=True)
            attr = ckpt_config.checkpoint_score_attribute
            score = lead.get(attr, 0.0) if attr else None
            saved.append((score, dest))
            rs["result_checkpoint"] = Checkpoint(dest)
            if (ckpt_config.num_to_keep
                    and len(saved) > ckpt_config.num_to_keep):
                if attr:
                    # drop the worst-scoring checkpoint
                    sign = (1 if ckpt_config.checkpoint_score_order
                            == "max" else -1)
                    worst = min(
                        range(len(saved)),
                        key=lambda j: sign * saved[j][0],
                    )
                else:
                    worst = 0  # FIFO
                _, drop = saved.pop(worst)
                if self._remote_storage:
                    from ray_tpu_torch.train._storage import get_storage

                    get_storage(self.experiment_dir).delete_dir(
                        drop.rsplit("/", 1)[-1]
                    )
                else:
                    shutil.rmtree(drop, ignore_errors=True)
                if rs["result_checkpoint"].path == drop:
                    rs["result_checkpoint"] = Checkpoint(saved[-1][1])
        if report_callback is not None:
            # forward the round (and any just-persisted checkpoint) to the
            # enclosing Tune trial session
            report_callback(
                lead,
                rs["result_checkpoint"].path
                if (ckpt_path and rs["result_checkpoint"]) else None,
            )

    def _latest_persisted_checkpoint(self) -> Optional[Checkpoint]:
        if self._remote_storage:
            from ray_tpu_torch.train._storage import get_storage

            storage = get_storage(self.experiment_dir)
            ckpts = sorted(
                d for d in storage.list_dirs() if d.startswith("checkpoint_")
            )
            if not ckpts:
                return self._resume_checkpoint
            return Checkpoint(storage.uri_of(ckpts[-1]))
        if not os.path.isdir(self.experiment_dir):
            return None
        ckpts = sorted(
            d for d in os.listdir(self.experiment_dir)
            if d.startswith("checkpoint_")
        )
        if not ckpts:
            return self._resume_checkpoint
        return Checkpoint(os.path.join(self.experiment_dir, ckpts[-1]))

