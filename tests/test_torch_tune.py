"""Tune of the port (``ray_tpu_torch.tune``): a copy of tests/test_tune.py
against ``ray_tpu_torch`` (reference: python/ray/tune/tests/).

The deterministic cases also hold the port's objects to the JAX
package's own on the same inputs and seeds: grid/random expansion, ASHA's
rung decisions, HyperBand's brackets and the median stopping rule decide
alike. ``TorchTrainer(...).fit()`` is the one-trial Tune run. The module's
helpers travel to the trial actors by value (a worker that imported this
module by name would import the JAX package with it).
"""

import json
import os
import sys
import tempfile

import cloudpickle
import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch import tune
from ray_tpu_torch.train import Checkpoint
from ray_tpu_torch.tune import (
    ASHAScheduler,
    PopulationBasedTraining,
    TuneConfig,
    Tuner,
)


@pytest.fixture(scope="module")
def tune_cluster():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=18)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def _exp_dir():
    return tempfile.mkdtemp(prefix="rtpu_tune_")


def objective(config):
    """Converges toward config['target']; higher lr converges faster."""
    score = 0.0
    for i in range(config.get("iters", 8)):
        score += config["lr"]
        tune.report({"score": score})


def _space(t):
    """One search space built from either package's primitives."""
    return {"a": t.grid_search([1, 2, 3]), "b": t.uniform(0, 1), "c": 7,
            "d": t.loguniform(1e-4, 1e-1), "e": t.randint(0, 10),
            "f": t.choice(["x", "y", "z"])}


def test_grid_and_random_expansion():
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search_space import generate_variants as jgenerate
    from ray_tpu_torch.tune.search_space import generate_variants

    space = {"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1), "c": 7}
    variants = generate_variants(space, num_samples=2, seed=0)
    assert len(variants) == 6
    assert sorted(v["a"] for v in variants) == [1, 1, 2, 2, 3, 3]
    assert all(0 <= v["b"] <= 1 and v["c"] == 7 for v in variants)
    for seed in (0, 7):
        assert generate_variants(_space(tune), 3, seed=seed) == jgenerate(
            _space(jtune), 3, seed=seed)


def test_16_concurrent_trials(tune_cluster):
    from ray_tpu_torch.train._config import RunConfig

    tuner = Tuner(
        objective,
        param_space={"lr": tune.grid_search(
            [round(0.1 * (i + 1), 1) for i in range(16)]
        )},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="grid16", storage_path=_exp_dir()),
    )
    grid = tuner.fit()
    assert len(grid) == 16
    assert not grid.errors
    best = grid.get_best_result("score")
    assert best.config["lr"] == 1.6
    assert best.metrics["score"] == pytest.approx(1.6 * 8)


def test_asha_early_stopping(tune_cluster):
    from ray_tpu_torch.train._config import RunConfig

    def slow_objective(config):
        score = 0.0
        for _ in range(32):
            score += config["lr"]
            tune.report({"score": score})

    scheduler = ASHAScheduler(
        metric="score", mode="max", max_t=32, grace_period=2,
        reduction_factor=4,
    )
    tuner = Tuner(
        slow_objective,
        param_space={"lr": tune.grid_search(
            [0.01 * (i + 1) for i in range(16)]
        )},
        tune_config=TuneConfig(scheduler=scheduler),
        run_config=RunConfig(name="asha16", storage_path=_exp_dir()),
    )
    grid = tuner.fit()
    assert not grid.errors
    iters = [r.metrics.get("training_iteration", 0) for r in grid]
    # at least one winner ran to completion; whether losers get rung-stopped
    # depends on arrival order (ASHA is asynchronous), so early-stop
    # decisions are asserted deterministically in test_asha_rung_decisions
    assert max(iters) == 32, iters
    best = grid.get_best_result("score")
    assert best.config["lr"] == pytest.approx(0.16)


def test_asha_rung_decisions():
    """Deterministic unit test of the rung cutoff logic: trials arriving at
    a milestone below the top-1/rf quantile are stopped."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP

    sched = ASHAScheduler(metric="score", mode="max", max_t=100,
                          grace_period=4, reduction_factor=4)

    class T:
        def __init__(self, tid):
            self.id = tid

    # descending scores arriving at the milestone: first passes freely,
    # later (worse) arrivals fall below the cutoff and stop
    decisions = [
        sched.on_trial_result(None, T(f"t{i}"),
                              {"training_iteration": 4, "score": 100 - i})
        for i in range(8)
    ]
    assert decisions[0] == CONTINUE
    assert STOP in decisions[1:], decisions
    assert decisions.count(STOP) >= 4, decisions
    # a strictly better late arrival is promoted
    assert sched.on_trial_result(
        None, T("late"), {"training_iteration": 4, "score": 1000}
    ) == CONTINUE
    # the JAX package's ASHA decides alike on the same arrivals
    from ray_tpu.tune import ASHAScheduler as JASHAScheduler

    jsched = JASHAScheduler(metric="score", mode="max", max_t=100,
                            grace_period=4, reduction_factor=4)
    arrivals = [(f"t{i}", {"training_iteration": 4, "score": 100 - i})
                for i in range(8)]
    arrivals.append(("late", {"training_iteration": 4, "score": 1000}))
    arrivals += [(f"t{i}", {"training_iteration": 16, "score": 200 - 3 * i})
                 for i in (0, 2, 1)]
    fresh = ASHAScheduler(metric="score", mode="max", max_t=100,
                          grace_period=4, reduction_factor=4)
    assert [fresh.on_trial_result(None, T(t), r) for t, r in arrivals] == [
        jsched.on_trial_result(None, T(t), r) for t, r in arrivals]


def test_pbt_perturbation(tune_cluster):
    from ray_tpu_torch.train._config import RunConfig

    def ckpt_objective(config):
        start = 0
        score = 0.0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                st = json.load(f)
            start, score = st["i"], st["score"]
        for i in range(start, 16):
            score += config["lr"]
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"i": i + 1, "score": score}, f)
            tune.report({"score": score}, checkpoint=Checkpoint(d))

    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0]},
    )
    tuner = Tuner(
        ckpt_objective,
        param_space={"lr": tune.grid_search([0.1, 0.5, 1.0, 2.0])},
        tune_config=TuneConfig(scheduler=pbt),
        run_config=RunConfig(name="pbt4", storage_path=_exp_dir()),
    )
    grid = tuner.fit()
    assert not grid.errors
    assert pbt.num_perturbations > 0
    best = grid.get_best_result("score")
    # exploiting the lr=2.0 donor means even former losers end near the top
    assert best.metrics["score"] >= 16 * 2.0 * 0.5


def test_stop_criteria_and_state_file(tune_cluster):
    from ray_tpu_torch.train._config import RunConfig
    from ray_tpu_torch.tune.controller import TuneController

    storage = _exp_dir()
    exp = os.path.join(storage, "stopit")

    def forever(config):
        i = 0
        while True:
            i += 1
            tune.report({"x": i})

    controller = TuneController(
        forever, [{}, {}], exp, stop={"training_iteration": 3},
    )
    trials = controller.run()
    assert all(t.state == "TERMINATED" for t in trials)
    assert all(t.iteration == 3 for t in trials)
    with open(os.path.join(exp, "experiment_state.json")) as f:
        state = json.load(f)
    assert len(state["trials"]) == 2


def test_tuner_restore_resumes_unfinished(tune_cluster):
    from ray_tpu_torch.train._config import RunConfig

    storage = _exp_dir()

    def ckpt_objective(config):
        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["i"]
        for i in range(start, 6):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"i": i + 1}, f)
            tune.report({"i": i + 1}, checkpoint=Checkpoint(d))

    tuner = Tuner(
        ckpt_objective,
        param_space={"z": tune.grid_search([1, 2])},
        run_config=RunConfig(name="resume_exp", storage_path=storage),
    )
    grid = tuner.fit()
    assert not grid.errors

    # simulate an interruption: mark trial_00001 unfinished at iteration 3
    exp = os.path.join(storage, "resume_exp")
    path = os.path.join(exp, "experiment_state.json")
    with open(path) as f:
        state = json.load(f)
    state["trials"][1]["state"] = "RUNNING"
    state["trials"][1]["iteration"] = 3
    state["trials"][1]["latest_checkpoint"] = os.path.join(
        exp, "trial_00001", "checkpoint_000002"
    )
    with open(path, "w") as f:
        json.dump(state, f)

    restored = Tuner.restore(exp, ckpt_objective)
    grid2 = restored.fit()
    assert not grid2.errors
    # trial 0 kept its result without re-running (no new reports); trial 1
    # resumed from the checkpoint at i=3 and only re-ran rounds 4..6
    assert grid2[0].metrics["i"] == 6
    assert len(grid2[0].metrics_history) == 0
    assert grid2[1].metrics["i"] == 6
    assert len(grid2[1].metrics_history) == 3


def test_trainer_fit_is_one_trial_tune_run(tune_cluster):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        from ray_tpu_torch import train

        for step in range(3):
            train.report({"step": step, "lr": config["lr"]})

    trainer = TorchTrainer(
        loop,
        train_loop_config={"lr": 0.5},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="fit_via_tune", storage_path=_exp_dir()),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 2
    assert result.metrics["lr"] == 0.5
    assert len(result.metrics_history) == 3
    # the tune experiment state lives next to the trainer's checkpoints
    assert os.path.exists(
        os.path.join(trainer.experiment_dir, "experiment_state.json")
    )


def test_median_stopping_rule():
    """Unit: a trial whose running average trails the median is stopped
    after the grace period (reference: schedulers/median_stopping_rule.py)."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, MedianStoppingRule

    class _T:
        def __init__(self, tid):
            self.id = tid
            self.iteration = 0

    from ray_tpu.tune.schedulers import MedianStoppingRule as JMedianStoppingRule

    sched = MedianStoppingRule(metric="score", mode="max", grace_period=2,
                               min_samples_required=3)
    jsched = JMedianStoppingRule(metric="score", mode="max", grace_period=2,
                                 min_samples_required=3)
    good = [_T(f"g{i}") for i in range(3)]
    bad = _T("bad")
    decisions, jdecisions = [], []
    for step in range(1, 7):
        for t in good:
            r = {"score": 10.0}
            assert sched.on_trial_result(None, t, r) == CONTINUE
            jdecisions.append(jsched.on_trial_result(None, t, r))
            decisions.append(CONTINUE)
        decision = sched.on_trial_result(None, bad, {"score": 1.0})
        decisions.append(decision)
        jdecisions.append(jsched.on_trial_result(None, bad, {"score": 1.0}))
    assert decision == STOP
    assert decisions == jdecisions


def test_hyperband_scheduler_brackets():
    """Unit: bracket assignment round-robins; bottom scorers at a rung get
    stopped, everyone stops at max_t."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, HyperBandScheduler

    class _T:
        def __init__(self, tid):
            self.id = tid
            self.iteration = 0

    from ray_tpu.tune.schedulers import HyperBandScheduler as JHyperBandScheduler

    sched = HyperBandScheduler(metric="score", mode="max", max_t=9,
                               reduction_factor=3)
    assert sched.num_brackets == 3
    # the JAX package's HyperBand assigns the same brackets and decides
    # alike on the same reports
    jsched = JHyperBandScheduler(metric="score", mode="max", max_t=9,
                                 reduction_factor=3)
    reports = [(f"u{i}", {"score": float((7 * i) % 5),
                          "training_iteration": it})
               for it in (1, 3, 9) for i in range(7)]
    got = [sched.on_trial_result(None, _T(t), dict(r)) for t, r in reports]
    want = [jsched.on_trial_result(None, _T(t), dict(r)) for t, r in reports]
    assert got == want and sched._assignment == jsched._assignment
    sched = HyperBandScheduler(metric="score", mode="max", max_t=9,
                               reduction_factor=3)
    trials = [_T(f"t{i}") for i in range(6)]
    # all trials report at step 1 with spread scores
    decisions = [
        sched.on_trial_result(None, t, {"score": float(i),
                                        "training_iteration": 1})
        for i, t in enumerate(trials)
    ]
    assert CONTINUE in decisions
    # a terrible score arriving at a populated rung is stopped
    late = _T("late")
    sched._assignment["late"] = 0  # same bracket as t0/t3
    d = sched.on_trial_result(None, late, {"score": -100.0,
                                           "training_iteration": 1})
    assert d == STOP
    # max_t always stops
    assert sched.on_trial_result(
        None, trials[0], {"score": 100.0, "training_iteration": 9}
    ) == STOP


def test_median_stopping_e2e(tune_cluster):
    """16 trials, half clearly worse: median stopping prunes losers while a
    winner completes."""
    from ray_tpu_torch.train._config import RunConfig
    from ray_tpu_torch.tune.schedulers import MedianStoppingRule

    def objective(config):
        score = 0.0
        for _ in range(16):
            score += config["lr"]
            tune.report({"score": score})

    tuner = Tuner(
        objective,
        param_space={"lr": tune.grid_search(
            [0.01 * (i + 1) for i in range(8)]
        )},
        tune_config=TuneConfig(scheduler=MedianStoppingRule(
            metric="score", mode="max", grace_period=3)),
        run_config=RunConfig(name="median8", storage_path=_exp_dir()),
    )
    grid = tuner.fit()
    assert not grid.errors
    iters = [r.metrics.get("training_iteration", 0) for r in grid]
    assert max(iters) == 16
    best = grid.get_best_result("score")
    assert best.config["lr"] == pytest.approx(0.08)


def test_with_parameters(tune_cluster):
    """Large objects bind through the object store, not per-trial configs
    (reference: tune.with_parameters)."""
    import numpy as np

    from ray_tpu_torch.train._config import RunConfig

    big = np.arange(100_000, dtype=np.float64)

    def objective(config, data=None):
        tune.report({"score": float(data.sum()) * config["w"]})

    grid = Tuner(
        tune.with_parameters(objective, data=big),
        param_space={"w": tune.grid_search([1.0, 2.0])},
        run_config=RunConfig(name="withparams", storage_path=_exp_dir()),
    ).fit()
    assert not grid.errors
    best = grid.get_best_result("score")
    assert best.config["w"] == 2.0
    assert best.metrics["score"] == pytest.approx(big.sum() * 2.0)
