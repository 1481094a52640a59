"""Trial schedulers: FIFO, ASHA (async successive halving), PBT,
median-stopping, HyperBand.

Reference: python/ray/tune/schedulers/async_hyperband.py:19 (ASHA brackets /
rung cutoffs), schedulers/pbt.py:221 (exploit top quantile + explore by
perturbation at a fixed interval), schedulers/median_stopping_rule.py,
schedulers/hyperband.py.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: replace this trial's state+config from a donor and restart.
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_trial_result(self, controller, trial, result) -> str:
        return CONTINUE

    def on_trial_complete(self, controller, trial, result):
        pass


class _Rung:
    def __init__(self, milestone: int):
        self.milestone = milestone
        self.recorded: Dict[str, float] = {}  # trial_id -> metric at milestone

    def cutoff(self, reduction_factor) -> Optional[float]:
        if not self.recorded:
            return None
        vals = sorted(self.recorded.values())
        # keep the top 1/reduction_factor
        k = len(vals) - max(1, int(len(vals) / reduction_factor))
        return vals[k] if 0 <= k < len(vals) else None


class AsyncHyperBandScheduler(FIFOScheduler):
    """ASHA: promote only trials in the top 1/reduction_factor at each rung;
    stop the rest as soon as they report at a milestone."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.max_t, self.grace = max_t, grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        rungs = []
        t = grace_period
        while t < max_t:
            rungs.append(_Rung(t))
            t *= reduction_factor
        self.rungs = rungs[::-1]  # highest milestone first

    def _score(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        if self.metric not in result:
            return CONTINUE  # warm-up / heartbeat rounds carry no metric
        action = CONTINUE
        for rung in self.rungs:
            if t < rung.milestone:
                continue
            if trial.id in rung.recorded:
                break
            score = self._score(result)
            cutoff = rung.cutoff(self.rf)
            rung.recorded[trial.id] = score
            if cutoff is not None and score < cutoff:
                action = STOP
            break
        return action


ASHAScheduler = AsyncHyperBandScheduler


class PopulationBasedTraining(FIFOScheduler):
    """PBT: every perturbation_interval iterations, a bottom-quantile trial
    clones a top-quantile trial's checkpoint and perturbs its hyperparams."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self.num_perturbations = 0

    def _score(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def _quantiles(self, controller):
        scored = [
            (t, self._score(t.last_result))
            for t in controller.live_trials()
            if t.last_result and self.metric in t.last_result
        ]
        if len(scored) < 2:
            return [], []
        scored.sort(key=lambda kv: kv[1])
        k = max(1, int(len(scored) * self.quantile))
        return [t for t, _ in scored[:k]], [t for t, _ in scored[-k:]]

    def perturbed(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for k, spec in self.mutations.items():
            if isinstance(spec, list):
                out[k] = self._rng.choice(spec)
            elif callable(spec):
                out[k] = spec()
            elif k in out and isinstance(out[k], (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[k] = type(out[k])(out[k] * factor)
        return out

    def on_trial_result(self, controller, trial, result) -> str:
        if self.metric not in result:
            return CONTINUE
        t = result.get(self.time_attr, 0)
        last = self._last_perturb.get(trial.id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial.id] = t
        bottom, top = self._quantiles(controller)
        if trial in bottom and top:
            donor = self._rng.choice(top)
            if donor is not trial and donor.latest_checkpoint:
                trial.exploit_from = donor
                trial.exploit_config = self.perturbed(donor.config)
                self.num_perturbations += 1
                return EXPLOIT
        return CONTINUE


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose running-average metric falls below the median of
    other trials' running averages at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 4, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial_id -> list of metric values per reported step
        self._history: Dict[str, List[float]] = {}

    def _score(self, result) -> float:
        v = float(result.get(self.metric, 0.0))
        return v if self.mode == "max" else -v

    def on_trial_result(self, controller, trial, result) -> str:
        if self.metric not in result:
            return CONTINUE  # warm-up / heartbeat rounds carry no metric
        hist = self._history.setdefault(trial.id, [])
        hist.append(self._score(result))
        step = len(hist)
        if step <= self.grace_period:
            return CONTINUE
        # running averages of OTHER trials truncated to this step
        others = [
            sum(h[:step]) / min(step, len(h))
            for tid, h in self._history.items()
            if tid != trial.id and len(h) >= 1
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        mine = sum(hist) / len(hist)
        return STOP if mine < median else CONTINUE


class HyperBandScheduler(FIFOScheduler):
    """Synchronous-flavor HyperBand approximated asynchronously: trials are
    assigned round-robin to brackets with different starting rungs, each
    bracket running successive halving (reference: schedulers/hyperband.py;
    asynchronous assignment like ASHA so stragglers can't stall a bracket)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 81, reduction_factor: int = 3):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        # bracket b starts halving at rung rf^b
        # integer loop, not int(log()): FP rounds log(243, 3) down to
        # 4.999..., silently losing the no-early-stopping bracket
        self.num_brackets = 1
        t = reduction_factor
        while t <= max_t:
            self.num_brackets += 1
            t *= reduction_factor
        self._brackets: List[List[_Rung]] = []
        for b in range(self.num_brackets):
            milestones = []
            t = reduction_factor ** b
            while t <= max_t:
                milestones.append(t)
                t *= reduction_factor
            self._brackets.append([_Rung(m) for m in reversed(milestones)])
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def _score(self, result) -> float:
        v = float(result.get(self.metric, 0.0))
        return v if self.mode == "max" else -v

    def on_trial_result(self, controller, trial, result) -> str:
        if self.metric not in result:
            return CONTINUE  # warm-up / heartbeat rounds carry no metric
        b = self._assignment.get(trial.id)
        if b is None:
            b = self._next_bracket % self.num_brackets
            self._next_bracket += 1
            self._assignment[trial.id] = b
        step = int(result.get("training_iteration", trial.iteration))
        score = self._score(result)
        decision = CONTINUE
        for rung in self._brackets[b]:  # highest milestone first
            if step >= rung.milestone and trial.id not in rung.recorded:
                rung.recorded[trial.id] = score
                cutoff = rung.cutoff(self.rf)
                if cutoff is not None and score < cutoff:
                    decision = STOP
                break
        if step >= self.max_t:
            decision = STOP
        return decision
