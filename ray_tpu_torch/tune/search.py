"""Pluggable search algorithms (reference: tune/search/ — Searcher API,
searcher.py suggest/on_trial_complete, basic_variant.py, and the
hyperopt/optuna integrations' role).

The integrations themselves wrap third-party libraries; here the framework
SHAPE is the point: `Searcher` is the plugin seam (suggest pulls the next
config when a trial slot frees; completions feed back), with three
built-ins — BasicVariantGenerator (grid/random, the default),
TPESearcher (a native tree-structured Parzen estimator over the Domain
space — the hyperopt algorithm, reimplemented), and ConcurrencyLimiter.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search_space import (
    Categorical,
    Domain,
    GridSearch,
    LogUniform,
    Randint,
    Uniform,
    generate_variants,
)


class Searcher:
    """Suggestion algorithm plugin. The controller calls suggest(trial_id)
    when it can start a trial (None = nothing to suggest right now; the
    search ends when nothing is running and suggest stays None), and
    feeds results back through on_trial_result/on_trial_complete."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: str,
                              param_space: Dict[str, Any]) -> None:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid/random expansion, served lazily (reference:
    tune/search/basic_variant.py)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self._seed = seed
        self._variants: Optional[List[dict]] = None
        self._i = 0
        self.num_samples = 1
        # grid expansion can exceed num_samples (num_samples x |grid|);
        # the controller raises its trial cap to this once known
        self.total_variants = 0

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        self._variants = None

    def suggest(self, trial_id):
        if self._variants is None:
            self._variants = generate_variants(
                self.param_space, self.num_samples, seed=self._seed
            )
            self.total_variants = len(self._variants)
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class TPESearcher(Searcher):
    """Native tree-structured Parzen estimator (Bergstra et al. 2011 — the
    algorithm behind hyperopt, reimplemented): completed trials split into
    good (top gamma) and bad sets; numeric dims get per-dim Gaussian
    Parzen densities l(x) (good) and g(x) (bad), categoricals get
    smoothed count distributions; candidates drawn from l, the one
    maximizing l/g wins. Grid dims are unsupported (use
    BasicVariantGenerator for grids)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        super().__init__(metric, mode)
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested = 0
        self._history: List[tuple] = []  # (config, score)
        self._live: Dict[str, dict] = {}

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "TPESearcher does not support grid_search dims; "
                    "use BasicVariantGenerator"
                )

    # ------------------------------------------------------------- internals

    def _sample_random(self) -> dict:
        cfg = {}
        for k, v in self.param_space.items():
            cfg[k] = v.sample(self._rng) if isinstance(v, Domain) else v
        return cfg

    @staticmethod
    def _to_unit(dom, x) -> float:
        if isinstance(dom, LogUniform):
            # LogUniform stores log-space bounds (_lo/_hi)
            return (math.log(x) - dom._lo) / max(1e-12, dom._hi - dom._lo)
        if isinstance(dom, (Uniform, Randint)):
            return (x - dom.low) / max(1e-12, dom.high - dom.low)
        raise TypeError(dom)

    @staticmethod
    def _from_unit(dom, u: float):
        u = min(1.0, max(0.0, u))
        if isinstance(dom, LogUniform):
            return math.exp(dom._lo + u * (dom._hi - dom._lo))
        if isinstance(dom, Randint):
            return min(dom.high - 1, int(dom.low + u * (dom.high - dom.low)))
        return dom.low + u * (dom.high - dom.low)

    @staticmethod
    def _parzen(u: float, centers: List[float], bw: float) -> float:
        if not centers:
            return 1.0
        s = sum(
            math.exp(-0.5 * ((u - c) / bw) ** 2) for c in centers
        )
        return s / (len(centers) * bw) + 1e-12

    def _suggest_tpe(self) -> dict:
        scored = sorted(
            self._history, key=lambda t: t[1],
            reverse=(self.mode == "max"),
        )
        n_good = max(1, int(len(scored) * self.gamma))
        good = [c for c, _ in scored[:n_good]]
        bad = [c for c, _ in scored[n_good:]] or good
        bw = max(0.08, 1.0 / max(1, len(good)))

        best_cfg, best_ratio = None, -math.inf
        for _ in range(self.n_candidates):
            cfg = {}
            log_ratio = 0.0
            for k, dom in self.param_space.items():
                if not isinstance(dom, Domain):
                    cfg[k] = dom
                    continue
                if isinstance(dom, Categorical):
                    counts_g = {c: 1.0 for c in dom.categories}
                    counts_b = {c: 1.0 for c in dom.categories}
                    for g in good:
                        counts_g[g[k]] = counts_g.get(g[k], 1.0) + 1.0
                    for b in bad:
                        counts_b[b[k]] = counts_b.get(b[k], 1.0) + 1.0
                    total_g = sum(counts_g.values())
                    cats, weights = zip(*counts_g.items())
                    choice = self._rng.choices(
                        cats, [w / total_g for w in weights]
                    )[0]
                    cfg[k] = choice
                    pg = counts_g[choice] / total_g
                    pb = counts_b[choice] / sum(counts_b.values())
                    log_ratio += math.log(pg / pb)
                else:
                    centers = [self._to_unit(dom, g[k]) for g in good]
                    centers_b = [self._to_unit(dom, b[k]) for b in bad]
                    # draw from l: pick a good center, add bandwidth noise
                    c = self._rng.choice(centers) if centers else self._rng.random()
                    u = c + self._rng.gauss(0.0, bw)
                    cfg[k] = self._from_unit(dom, u)
                    u = self._to_unit(dom, cfg[k])
                    log_ratio += math.log(
                        self._parzen(u, centers, bw)
                        / self._parzen(u, centers_b, bw)
                    )
            if log_ratio > best_ratio:
                best_cfg, best_ratio = cfg, log_ratio
        return best_cfg

    # ------------------------------------------------------------- interface

    def suggest(self, trial_id):
        if self._suggested < self.n_initial or len(self._history) < 2:
            cfg = self._sample_random()
        else:
            cfg = self._suggest_tpe()
        self._suggested += 1
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        self._history.append((cfg, float(result[self.metric])))


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (reference: tune/search/
    concurrency_limiter.py): sequential algorithms like TPE degrade to
    random search if every trial launches before any result lands."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    @property
    def total_variants(self) -> int:
        # grid-expansion totals must see through the wrapper or the
        # controller under-counts the trial cap
        return getattr(self.searcher, "total_variants", 0)

    @property
    def num_samples(self) -> int:
        return getattr(self.searcher, "num_samples", 1)

    @num_samples.setter
    def num_samples(self, v: int):
        if hasattr(self.searcher, "num_samples"):
            self.searcher.num_samples = v

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        self.searcher.set_search_properties(metric, mode, param_space)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return None  # wait: slots free on completion
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)
