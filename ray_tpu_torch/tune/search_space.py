"""Search-space primitives + the basic variant generator.

Reference: python/ray/tune/search/sample.py (Domain/Categorical/Float/Integer)
and search/basic_variant.py (grid cross-product x num_samples expansion).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math

        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))


class Randint(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> Randint:
    return Randint(low, high)


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Expand grid_search dims into a cross-product; draw num_samples of the
    stochastic dims for each grid point (reference basic_variant semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
    grids: List[Dict[str, Any]] = [{}]
    for k in grid_keys:
        grids = [dict(g, **{k: v}) for g in grids
                 for v in param_space[k].values]
    variants = []
    for _ in range(num_samples):
        for g in grids:
            cfg = {}
            for k, v in param_space.items():
                if k in g:
                    cfg[k] = g[k]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
