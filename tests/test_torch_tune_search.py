"""The port's searcher framework (``ray_tpu_torch.tune.search``): a copy of
tests/test_tune_search.py against ``ray_tpu_torch`` (reference:
tune/search/): pluggable suggest/feedback protocol, native TPE,
concurrency limiting. TPE's suggestions are also held to the JAX
package's ``TPESearcher`` fed the same results from the same seed. The
module's helpers travel to the trial actors by value.
"""

import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch import tune
from ray_tpu_torch.tune import (
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
    TuneConfig,
    Tuner,
)


@pytest.fixture(scope="module")
def cluster():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=8)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def _objective(config):
    from ray_tpu_torch import train

    # quadratic bowl: best at x=0.3, y='b'
    score = -((config["x"] - 0.3) ** 2) + (0.5 if config["y"] == "b" else 0.0)
    train.report({"score": score})


def test_tpe_beats_pure_random_on_average(cluster):
    space = {"x": tune.uniform(-2.0, 2.0), "y": tune.choice(["a", "b", "c"])}
    tuner = Tuner(
        _objective,
        param_space=space,
        tune_config=TuneConfig(
            metric="score", mode="max", num_samples=24,
            search_alg=ConcurrencyLimiter(
                TPESearcher(n_initial=6, seed=1), max_concurrent=4
            ),
        ),
    )
    grid = tuner.fit()
    best = grid.get_best_result(metric="score", mode="max")
    # near-optimal x found (pure random expectation over 24 draws on
    # [-2,2] leaves E[min (x-0.3)^2] ~ 0.007; TPE should do better or
    # comparable — the hard assert is concentration below)
    assert best.metrics["score"] > -0.05, best.metrics
    # late trials concentrate near the optimum: the searcher actually
    # used feedback (pure random keeps E|x-0.3| ~ 1.03 over x)
    xs = [r.config["x"] for r in list(grid)[12:]]
    assert float(np.mean(np.abs(np.asarray(xs) - 0.3))) < 0.75, xs


def test_custom_searcher_plugin(cluster):
    """The Searcher seam works for user-defined algorithms."""

    class FixedSequence(Searcher):
        def __init__(self, seq):
            super().__init__()
            self._seq = list(seq)
            self.completed = []

        def suggest(self, trial_id):
            return self._seq.pop(0) if self._seq else None

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append((trial_id, result and result.get("score")))

    searcher = FixedSequence([{"x": 0.0, "y": "a"}, {"x": 0.3, "y": "b"}])
    tuner = Tuner(
        _objective,
        param_space={},
        tune_config=TuneConfig(
            metric="score", mode="max", num_samples=2, search_alg=searcher
        ),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    assert len(searcher.completed) == 2
    best = grid.get_best_result(metric="score", mode="max")
    assert abs(best.config["x"] - 0.3) < 1e-9


def test_grid_rejected_by_tpe():
    with pytest.raises(ValueError, match="grid_search"):
        TPESearcher().set_search_properties(
            "score", "max", {"x": tune.grid_search([1, 2])}
        )


def _score(config):
    return -((config["x"] - 0.3) ** 2) + (0.5 if config["y"] == "b" else 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_tpe_suggestions_equal_the_jax_searcher(seed):
    """Twenty suggest / complete rounds, past the random start into the
    model-based phase: the same configs from the same seed and results."""
    from ray_tpu import tune as jtune
    from ray_tpu.tune import TPESearcher as JTPESearcher

    def space(t):
        return {"x": t.uniform(-2.0, 2.0), "y": t.choice(["a", "b", "c"]),
                "z": t.loguniform(1e-3, 1.0), "n": t.randint(1, 9)}

    port, ref = TPESearcher(n_initial=6, seed=seed), JTPESearcher(n_initial=6, seed=seed)
    port.set_search_properties("score", "max", space(tune))
    ref.set_search_properties("score", "max", space(jtune))
    for i in range(20):
        tid = f"trial_{i:05d}"
        got, want = port.suggest(tid), ref.suggest(tid)
        assert got == want, (i, got, want)
        result = {"score": _score(got) - got["z"] + 0.01 * got["n"]}
        port.on_trial_complete(tid, result)
        ref.on_trial_complete(tid, result)
