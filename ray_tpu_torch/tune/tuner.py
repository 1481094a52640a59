"""Tuner: the user-facing Tune entry point (reference: tune/tuner.py:44).

`Tuner(fn_or_trainer, param_space=..., tune_config=...).fit()` expands the
search space into trials, runs them through the TuneController over trial
actors, and returns a ResultGrid. A DataParallelTrainer/TorchTrainer is a valid
trainable — its `fit()` is a 1-trial Tune run, exactly like the reference
(train/base_trainer.py:819 wraps the trainer into a Tune Trainable).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.tune.controller import (
    ERRORED,
    PENDING,
    RUNNING,
    TERMINATED,
    Trial,
    TuneController,
)
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import FIFOScheduler
from ray_tpu_torch.tune.search_space import generate_variants


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0  # 0 = unbounded
    scheduler: Optional[Any] = None
    # pluggable suggestion algorithm (reference: tune/search Searcher);
    # None = grid/random expansion of param_space
    search_alg: Optional[Any] = None
    seed: int = 0


def with_resources(trainable: Callable, resources: Dict[str, float]):
    """Attach a per-trial resource request (reference: tune.with_resources)."""
    trainable._tune_resources = dict(resources)
    return trainable


def with_parameters(trainable: Callable, **kwargs):
    """Bind large objects to a trainable via the object store (reference:
    tune.with_parameters — datasets/models are put once and fetched
    zero-copy by each trial instead of being pickled into every trial's
    config)."""
    import ray_tpu_torch
    from ray_tpu_torch.train._trainer import DataParallelTrainer

    if isinstance(trainable, DataParallelTrainer):
        # match the reference: trainers carry their own config/datasets —
        # wrapping one would silently bypass the Tuner's trainer path
        raise ValueError(
            "tune.with_parameters() only supports function trainables; "
            "pass datasets/config to the trainer directly"
        )
    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    def wrapped(config):
        resolved = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


def _trainer_trial_fn(config):
    """Runs a DataParallelTrainer inside a trial actor, forwarding every
    inner report round to the trial's session."""
    import os as _os

    from ray_tpu_torch import train as train_mod

    trainer = config["__trainer__"]
    overrides = {k: v for k, v in config.items() if k != "__trainer__"}
    if overrides:
        base = dict(trainer._train_config or {})
        base.update(overrides)
        trainer._train_config = base
    # Re-root this trial's trainer into a private subdir: concurrent trials
    # of one tuned trainer must not share checkpoint numbering/pruning.
    ctx = train_mod.get_context()
    trainer.experiment_dir = _os.path.join(
        trainer.experiment_dir, f"worker_of_{ctx.get_experiment_name()}"
    )

    def forward(metrics, checkpoint_path):
        ckpt = None
        if checkpoint_path:
            from ray_tpu_torch.train._checkpoint import Checkpoint

            ckpt = Checkpoint(checkpoint_path)
        train_mod.report(metrics, checkpoint=ckpt)

    trainer._fit_direct(report_callback=forward)


class Tuner:
    def __init__(
        self,
        trainable: Any,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[Any] = None,
        _restored_trials=None,
    ):
        from ray_tpu_torch.train._config import RunConfig
        from ray_tpu_torch.train._trainer import DataParallelTrainer

        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._is_trainer = isinstance(trainable, DataParallelTrainer)
        self._restored_trials = _restored_trials
        if self._is_trainer:
            self._trial_fn = _trainer_trial_fn
            self._resources = {"CPU": 0}  # inner worker group holds the CPUs
            base_space = dict(param_space or {})
            base_space["__trainer__"] = trainable
            self._param_space = base_space
            if run_config is None and trainable.run_config is not None:
                self._run_config = trainable.run_config
        else:
            self._trial_fn = trainable
            self._resources = getattr(trainable, "_tune_resources",
                                      {"CPU": 1})
            self._param_space = dict(param_space or {})
        name = self._run_config.name or f"tune_{int(time.time())}"
        from ray_tpu_torch.train._storage import is_remote_uri

        storage = self._run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results"
        )
        if is_remote_uri(storage):
            # URI storage is for checkpoints (uploaded worker-side by the
            # inner trainer); the tuner's own trial-state bookkeeping is
            # driver-local state and stays on the driver's disk.
            storage = os.path.join(os.path.expanduser("~"),
                                   "ray_tpu_torch_results")
        self.experiment_dir = os.path.join(storage, name)

    # ------------------------------------------------------------------ fit

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        if self._restored_trials is not None:
            controller = TuneController(
                self._trial_fn, [], self.experiment_dir,
                scheduler=tc.scheduler or FIFOScheduler(),
                resources_per_trial=self._resources,
                max_concurrent=tc.max_concurrent_trials,
                restored_trials=self._restored_trials,
            )
        elif tc.search_alg is not None:
            # lazy suggestion mode: the searcher hands out configs as trial
            # slots free and consumes completions (sequential optimization)
            space = {
                k: v for k, v in self._param_space.items()
                if k != "__trainer__"
            }
            tc.search_alg.set_search_properties(tc.metric, tc.mode, space)
            # generators that expand a static variant list need the sample
            # count (BasicVariantGenerator; custom ones may ignore it)
            if hasattr(tc.search_alg, "num_samples"):
                tc.search_alg.num_samples = tc.num_samples
            inner = getattr(tc.search_alg, "searcher", None)
            if inner is not None and hasattr(inner, "num_samples"):
                inner.num_samples = tc.num_samples
            if self._is_trainer:
                base = tc.search_alg

                class _TrainerWrap:
                    def __getattr__(self, n):
                        return getattr(base, n)

                    def suggest(self, tid):
                        cfg = base.suggest(tid)
                        if cfg is not None:
                            cfg = dict(
                                cfg,
                                __trainer__=self_outer._param_space["__trainer__"],
                            )
                        return cfg

                self_outer = self
                searcher = _TrainerWrap()
            else:
                searcher = tc.search_alg
            controller = TuneController(
                self._trial_fn, [], self.experiment_dir,
                scheduler=tc.scheduler or FIFOScheduler(),
                resources_per_trial=self._resources,
                max_concurrent=tc.max_concurrent_trials,
                searcher=searcher,
                num_samples=tc.num_samples,
            )
        else:
            configs = generate_variants(
                self._param_space, tc.num_samples, seed=tc.seed
            )
            controller = TuneController(
                self._trial_fn, configs, self.experiment_dir,
                scheduler=tc.scheduler or FIFOScheduler(),
                resources_per_trial=self._resources,
                max_concurrent=tc.max_concurrent_trials,
            )
        trials = controller.run()
        return ResultGrid(trials, self.experiment_dir)

    # -------------------------------------------------------------- restore

    @classmethod
    def can_restore(cls, path: str) -> bool:
        return os.path.exists(os.path.join(path, "experiment_state.json"))

    @classmethod
    def restore(cls, path: str, trainable: Any,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results; unfinished ones re-run from their latest checkpoint
        (reference: Tuner.restore, tune/tuner.py)."""
        import json

        from ray_tpu_torch.train._config import RunConfig

        from ray_tpu_torch.train._trainer import DataParallelTrainer

        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        is_trainer = isinstance(trainable, DataParallelTrainer)
        trials = []
        for snap in state["trials"]:
            config = dict(snap["config"])
            dropped = set(snap.get("config_dropped_keys", []))
            if is_trainer:
                config["__trainer__"] = trainable
                dropped.discard("__trainer__")
            if dropped:
                # Non-JSON config values can't be reconstructed; the trial
                # can only be kept if it already finished.
                if snap["state"] not in (TERMINATED, ERRORED):
                    snap = dict(snap, state=ERRORED)
                    snap["error"] = (
                        f"cannot restore config keys {sorted(dropped)}"
                    )
            t = Trial(snap["id"], config,
                      os.path.join(path, snap["id"]))
            t.iteration = snap.get("iteration", 0)
            t.latest_checkpoint = snap.get("latest_checkpoint")
            t.last_result = snap.get("last_result")
            t.error = snap.get("error")
            if snap["state"] in (TERMINATED, ERRORED):
                t.state = snap["state"]
            else:
                t.state = PENDING
                t.restore_from = t.latest_checkpoint
            trials.append(t)
        run_config = RunConfig(
            name=os.path.basename(path),
            storage_path=os.path.dirname(path),
        )
        return cls(trainable, tune_config=tune_config, run_config=run_config,
                   _restored_trials=trials)
