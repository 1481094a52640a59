"""Fixed-point resource accounting.

Mirrors the reference's FixedPoint resource arithmetic
(reference: src/ray/common/scheduling/fixed_point.h,
cluster_resource_data.h:36): quantities are stored in integer 1/10000 units so
repeated grant/release cycles can't drift the way float arithmetic does.
Fractional resources (e.g. num_cpus=0.5) therefore work exactly.
"""

from __future__ import annotations

from typing import Dict, Iterable

PRECISION = 10_000


def to_fixed(resources: Dict[str, float]) -> Dict[str, int]:
    return {k: int(round(v * PRECISION)) for k, v in resources.items() if v}


def from_fixed(resources: Dict[str, int]) -> Dict[str, float]:
    return {k: v / PRECISION for k, v in resources.items()}


class ResourceSet:
    """Mutable set of named resource quantities in fixed-point units."""

    __slots__ = ("_r",)

    def __init__(self, resources: Dict[str, float] | None = None, fixed: Dict[str, int] | None = None):
        if fixed is not None:
            self._r = {k: v for k, v in fixed.items() if v}
        else:
            self._r = to_fixed(resources or {})

    def fits(self, demand: "ResourceSet") -> bool:
        return all(self._r.get(k, 0) >= v for k, v in demand._r.items())

    def acquire(self, demand: "ResourceSet") -> bool:
        if not self.fits(demand):
            return False
        for k, v in demand._r.items():
            self._r[k] = self._r.get(k, 0) - v
        return True

    def release(self, demand: "ResourceSet"):
        for k, v in demand._r.items():
            self._r[k] = self._r.get(k, 0) + v

    def add(self, other: "ResourceSet"):
        self.release(other)

    def subtract_capped(self, other: "ResourceSet"):
        for k, v in other._r.items():
            self._r[k] = max(0, self._r.get(k, 0) - v)

    def get(self, name: str) -> float:
        return self._r.get(name, 0) / PRECISION

    def to_dict(self) -> Dict[str, float]:
        return from_fixed(self._r)

    def copy(self) -> "ResourceSet":
        rs = ResourceSet()
        rs._r = dict(self._r)
        return rs

    def keys(self) -> Iterable[str]:
        return self._r.keys()

    def is_empty(self) -> bool:
        return not any(v > 0 for v in self._r.values())

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"
