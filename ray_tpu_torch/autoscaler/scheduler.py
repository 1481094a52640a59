"""Resource-demand scheduler: bin-pack pending demand, pick node types.

Counterpart of the reference's v2 scheduler
(reference: python/ray/autoscaler/v2/scheduler.py:624
ResourceDemandScheduler — simulate placing the pending demand onto existing
+ already-launching nodes, launch the cheapest node types covering the
rest). Slice granularity: a node type is an indivisible unit (one TPU
slice); we never launch partial slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items())


def _take(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class ResourceDemandScheduler:
    """Pure function of (demand, capacity, config) -> launch decisions."""

    def __init__(self, node_types: Dict[str, dict]):
        # node_types: name -> {"resources": {...}, "max_workers": int,
        #                      "min_workers": int, "labels": {...}}
        self.node_types = node_types

    def schedule(
        self,
        demands: List[Dict[str, float]],
        node_capacities: List[Dict[str, float]],
        counts_by_type: Dict[str, int],
    ) -> Tuple[Dict[str, int], List[Dict[str, float]]]:
        """Returns (to_launch {node_type: count}, infeasible demands).

        ``node_capacities``: available resources of existing + pending
        nodes. ``counts_by_type``: current node count per type (enforces
        max_workers).
        """
        capacities = [dict(c) for c in node_capacities]
        to_launch: Dict[str, int] = {}
        launched_capacity: List[Dict[str, float]] = []
        infeasible: List[Dict[str, float]] = []

        # Largest demands first: classic first-fit-decreasing keeps a big
        # slice demand from being starved by many small CPU demands.
        def size(d):
            return (len(d), sum(d.values()))

        for demand in sorted(demands, key=size, reverse=True):
            if not demand:
                continue
            placed = False
            for cap in capacities + launched_capacity:
                if _fits(cap, demand):
                    _take(cap, demand)
                    placed = True
                    break
            if placed:
                continue
            node_type = self._pick_type(demand, counts_by_type, to_launch)
            if node_type is None:
                infeasible.append(demand)
                continue
            to_launch[node_type] = to_launch.get(node_type, 0) + 1
            cap = dict(self.node_types[node_type].get("resources", {}))
            _take(cap, demand)
            launched_capacity.append(cap)
        return to_launch, infeasible

    def _pick_type(
        self,
        demand: Dict[str, float],
        counts_by_type: Dict[str, int],
        to_launch: Dict[str, int],
    ) -> Optional[str]:
        """Smallest node type that satisfies the demand and has headroom."""
        candidates = []
        for name, cfg in self.node_types.items():
            res = cfg.get("resources", {})
            if not _fits(dict(res), demand):
                continue
            current = counts_by_type.get(name, 0) + to_launch.get(name, 0)
            if current >= cfg.get("max_workers", 2**31):
                continue
            candidates.append((sum(res.values()), len(res), name))
        if not candidates:
            return None
        candidates.sort()
        return candidates[0][2]

    def min_workers_to_launch(
        self, counts_by_type: Dict[str, int]
    ) -> Dict[str, int]:
        out = {}
        for name, cfg in self.node_types.items():
            deficit = cfg.get("min_workers", 0) - counts_by_type.get(name, 0)
            if deficit > 0:
                out[name] = deficit
        return out
