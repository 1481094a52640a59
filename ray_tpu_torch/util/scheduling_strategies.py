"""User-facing scheduling strategies
(reference: python/ray/util/scheduling_strategies.py)."""

from __future__ import annotations

from typing import Optional, Union


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: Union[str, bytes], soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}


SchedulingStrategyT = Union[
    None, str, PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
]

# per-PG round-robin cursor for bundle_index=-1 ("any bundle") submissions
_rr_counters: dict = {}


def strategy_to_dict(strategy: SchedulingStrategyT) -> dict:
    if strategy is None or strategy == "DEFAULT":
        return {}
    if strategy == "SPREAD":
        return {"type": "spread"}
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        node_id = strategy.node_id
        if isinstance(node_id, str):
            node_id = bytes.fromhex(node_id)
        return {"type": "node_affinity", "node_id": node_id, "soft": strategy.soft}
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        pg_id = pg.id if isinstance(pg.id, bytes) else pg.id.binary()
        index = strategy.placement_group_bundle_index
        if index < 0:
            # "any bundle": round-robin across the group's bundles per
            # submission so tasks spread instead of pinning to bundle 0
            n = max(pg.bundle_count, 1)
            index = _rr_counters.get(pg_id, 0) % n
            _rr_counters[pg_id] = index + 1
        return {
            "type": "placement_group",
            "pg_id": pg_id,
            "bundle_index": index,
        }
    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return {"type": "node_label", "hard": strategy.hard, "soft": strategy.soft}
    raise ValueError(f"unknown scheduling strategy {strategy!r}")
