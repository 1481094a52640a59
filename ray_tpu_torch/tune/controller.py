"""Tune controller: the event loop driving trial actors.

Reference call stack (SURVEY.md §3.4): Tuner.fit (tune/tuner.py:44) →
tune.run → TuneController event loop (tune/execution/tune_controller.py:68)
driving trial actors. Here each trial is one `_TrainWorker` actor (the same
actor class Train's WorkerGroup uses — a trial IS a 1-worker group, sharing
the session report/ack protocol), and the loop multiplexes trials with
ray_tpu_torch.wait over their outstanding next_report calls.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._session import TrainContext
from ray_tpu_torch.train._worker_group import _TrainWorker, _to_actor_options
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, FIFOScheduler, STOP

logger = logging.getLogger("ray_tpu_torch.tune")

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERRORED = "ERRORED"


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any], local_dir: str):
        self.id = trial_id
        self.config = config
        self.local_dir = local_dir  # <experiment>/<trial_id>
        self.state = PENDING
        self.actor = None
        self.last_result: Optional[Dict[str, Any]] = None
        self.metrics_history: List[Dict[str, Any]] = []
        self.iteration = 0
        self.latest_checkpoint: Optional[str] = None
        self.error: Optional[str] = None
        self.restore_from: Optional[str] = None
        # PBT handshake
        self.exploit_from: Optional["Trial"] = None
        self.exploit_config: Optional[Dict[str, Any]] = None
        self._ckpt_index = 0

    def snapshot(self) -> dict:
        # Persist only the JSON-safe config entries; record which keys were
        # dropped so restore() can re-inject them (e.g. __trainer__) instead
        # of crashing on a repr string.
        cfg, dropped = {}, []
        for k, v in (self.config or {}).items():
            try:
                json.dumps(v)
                cfg[k] = v
            except (TypeError, ValueError):
                dropped.append(k)
        return {
            "id": self.id,
            "config": cfg,
            "config_dropped_keys": dropped,
            "state": self.state,
            "iteration": self.iteration,
            "latest_checkpoint": self.latest_checkpoint,
            "last_result": _jsonable(self.last_result),
            "error": self.error,
        }


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class TuneController:
    def __init__(
        self,
        trial_fn: Callable,
        configs: List[Dict[str, Any]],
        experiment_dir: str,
        *,
        scheduler: Optional[FIFOScheduler] = None,
        stop: Optional[Dict[str, Any]] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_concurrent: int = 0,
        restored_trials: Optional[List[Trial]] = None,
        searcher=None,
        num_samples: int = 0,
    ):
        self.trial_fn = trial_fn
        # searcher mode: trials are suggested lazily as slots free, and
        # completions feed back (reference: tune/search Searcher protocol)
        self.searcher = searcher
        self.num_samples = num_samples
        self.experiment_dir = experiment_dir
        self.scheduler = scheduler or FIFOScheduler()
        self.stop_criteria = stop or {}
        self.resources = resources_per_trial or {"CPU": 1}
        self.max_concurrent = max_concurrent
        if restored_trials is not None:
            self.trials = restored_trials
        else:
            self.trials = [
                Trial(f"trial_{i:05d}", cfg,
                      os.path.join(experiment_dir, f"trial_{i:05d}"))
                for i, cfg in enumerate(configs)
            ]
        self._report_refs: Dict[Any, Trial] = {}

    # --------------------------------------------------------------- helpers

    def live_trials(self) -> List[Trial]:
        return [t for t in self.trials if t.state == RUNNING]

    def _start_trial(self, trial: Trial):
        os.makedirs(trial.local_dir, exist_ok=True)
        actor_cls = ray_tpu_torch.remote(_TrainWorker)
        trial.actor = actor_cls.options(
            **_to_actor_options(dict(self.resources))
        ).remote(0, {})
        ctx = TrainContext(
            world_rank=0, world_size=1, local_rank=0, local_world_size=1,
            node_ip="", experiment_name=trial.id,
        )
        restore = None
        if trial.restore_from:
            restore = Checkpoint(trial.restore_from)
            trial.restore_from = None
        trial.actor.start_run.remote(
            self.trial_fn, trial.config, ctx, restore
        )
        trial.state = RUNNING
        ref = trial.actor.next_report.remote()
        self._report_refs[ref] = trial

    def _requeue(self, trial: Trial):
        """Ack the consumed report and arm the next round."""
        trial.actor.ack_report.remote()
        ref = trial.actor.next_report.remote()
        self._report_refs[ref] = trial

    def _stop_trial(self, trial: Trial, state: str):
        trial.state = state
        # Drop outstanding report refs for the old actor: a killed actor's
        # ref resolves to ActorDiedError, which must not be mistaken for a
        # failure of the restarted trial (PBT exploit path).
        for ref, t in list(self._report_refs.items()):
            if t is trial:
                del self._report_refs[ref]
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None

    def _persist_checkpoint(self, trial: Trial, worker_path: str) -> str:
        from ray_tpu_torch.train._storage import is_remote_uri

        if is_remote_uri(worker_path):
            # already durable in URI storage (the trainer's workers uploaded
            # it); record the URI instead of copying by path
            trial.latest_checkpoint = worker_path
            return worker_path
        dest = os.path.join(trial.local_dir,
                            f"checkpoint_{trial._ckpt_index:06d}")
        trial._ckpt_index += 1
        shutil.copytree(worker_path, dest, dirs_exist_ok=True)
        trial.latest_checkpoint = dest
        return dest

    def _should_stop(self, result: Dict[str, Any]) -> bool:
        for k, v in self.stop_criteria.items():
            if k in result and result[k] >= v:
                return True
        return False

    def _save_state(self):
        state = {
            "timestamp": time.time(),
            "trials": [t.snapshot() for t in self.trials],
        }
        tmp = os.path.join(self.experiment_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, os.path.join(self.experiment_dir,
                                     "experiment_state.json"))

    # ------------------------------------------------------------------ run

    def run(self) -> List[Trial]:
        os.makedirs(self.experiment_dir, exist_ok=True)
        pending = [t for t in self.trials if t.state == PENDING]
        done_states = (TERMINATED, ERRORED)

        def trial_limit():
            # generators expanding grids can produce more than num_samples
            # variants (num_samples per grid point); honor their total
            return max(
                self.num_samples,
                getattr(self.searcher, "total_variants", 0) or 0,
            )

        def current_cap():
            if self.max_concurrent:
                return self.max_concurrent
            # match the non-searcher path's parallelism: a grid sweep must
            # not serialize just because it came through a searcher
            return trial_limit() if self.searcher else len(self.trials)

        def maybe_launch():
            while pending and len(self.live_trials()) < current_cap():
                self._start_trial(pending.pop(0))
            if self.searcher is None:
                return
            # caps recompute per iteration: grid totals are only known
            # after the generator's first suggest() expands the space
            while (len(self.trials) < trial_limit()
                   and len(self.live_trials()) < current_cap()):
                tid = f"trial_{len(self.trials):05d}"
                cfg = self.searcher.suggest(tid)
                if cfg is None:
                    break  # waiting on results (or exhausted)
                trial = Trial(
                    tid, cfg, os.path.join(self.experiment_dir, tid)
                )
                self.trials.append(trial)
                self._start_trial(trial)

        maybe_launch()
        self._save_state()
        try:
            while True:
                if not self._report_refs:
                    maybe_launch()
                    if not self._report_refs:
                        break
                ready, _ = ray_tpu_torch.wait(
                    list(self._report_refs), num_returns=1, timeout=5.0
                )
                if not ready:
                    continue
                for ref in ready:
                    trial = self._report_refs.pop(ref)
                    if trial.state in done_states:
                        continue
                    try:
                        report = ray_tpu_torch.get(ref)
                    except Exception as e:
                        trial.error = f"trial actor died: {e}"
                        self._stop_trial(trial, ERRORED)
                        if self.searcher is not None:
                            # the searcher must see EVERY terminal outcome
                            # or ConcurrencyLimiter slots leak
                            self.searcher.on_trial_complete(
                                trial.id, error=True
                            )
                        continue
                    self._handle_report(trial, report)
                maybe_launch()
                self._save_state()
        finally:
            # Never leak running trial actors, whatever takes us out.
            for t in self.live_trials():
                self._stop_trial(t, t.state)
            self._save_state()
        return self.trials

    def _handle_report(self, trial: Trial, report: dict):
        kind = report["type"]
        if kind == "finished":
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(self, trial, trial.last_result)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.id, trial.last_result)
            return
        if kind == "error":
            trial.error = report.get("traceback") or report.get("error")
            self._stop_trial(trial, ERRORED)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.id, error=True)
            return
        # a live report round
        trial.iteration += 1
        result = dict(report["metrics"])
        result.setdefault("training_iteration", trial.iteration)
        trial.last_result = result
        trial.metrics_history.append(result)
        if "checkpoint_path" in report:
            self._persist_checkpoint(trial, report["checkpoint_path"])
        if self._should_stop(result):
            decision = STOP
        else:
            try:
                decision = self.scheduler.on_trial_result(self, trial, result)
            except Exception:
                # A scheduler bug (or a report missing its metric) must not
                # abort the experiment; let the trial continue.
                logger.exception("scheduler failed on result for %s", trial.id)
                decision = CONTINUE
        if self.searcher is not None:
            self.searcher.on_trial_result(trial.id, result)
        if decision == STOP:
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(self, trial, result)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.id, result)
            return
        if decision == EXPLOIT:
            self._exploit(trial)
            return
        self._requeue(trial)

    def _exploit(self, trial: Trial):
        """PBT: restart this trial from the donor's checkpoint with the
        perturbed config (reference pbt.py _exploit)."""
        donor, new_config = trial.exploit_from, trial.exploit_config
        trial.exploit_from = trial.exploit_config = None
        if donor is None or donor.latest_checkpoint is None:
            self._requeue(trial)
            return
        logger.info("PBT exploit: %s <- %s", trial.id, donor.id)
        self._stop_trial(trial, PENDING)
        trial.config = new_config
        trial.restore_from = donor.latest_checkpoint
        self._start_trial(trial)
