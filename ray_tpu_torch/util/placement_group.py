"""Placement groups: gang reservation of resource bundles across nodes
(reference: python/ray/util/placement_group.py:41,:145; GCS-side 2PC in
gcs_placement_group_scheduler.h). The port of ``ray_tpu/util/placement_group.py``
over the port's GCS calls. On a GPU cluster the canonical use is a train
worker group: one ``{"GPU": 1, "CPU": 1}`` bundle per worker, each
bundle's lease then getting a card of its own (the raylet's
``CUDA_VISIBLE_DEVICES``)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import get_global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]],
                 created: bool = False):
        self.id = pg_id
        self._bundles = bundles
        # CreatePlacementGroup's reply carries the state when the GCS
        # reserved the group inline; ready()/wait() then skip their RPC.
        self._created = created

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self, timeout: float = 600.0):
        """Block until the group is reserved; returns self (the reference
        returns an ObjectRef — here waiting is direct and synchronous)."""
        if not self.wait(timeout):
            raise TimeoutError("placement group not ready within timeout")
        return self

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        if self._created:
            return True
        worker = get_global_worker()
        reply = worker.gcs.call(
            "WaitPlacementGroupReady",
            {"pg_id": self.id, "timeout": timeout_seconds},
            timeout=timeout_seconds + 5,
        )
        self._created = bool(reply.get("ready"))
        return self._created

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    worker = get_global_worker()
    pg_id = PlacementGroupID.from_random().binary()
    reply = worker.gcs.call(
        "CreatePlacementGroup",
        {
            "pg_id": pg_id,
            "bundles": bundles,
            "strategy": strategy,
            "name": name,
            "job_id": worker.job_id.binary(),
            # Fate-sharing (reference: PGs are owned by their creating
            # worker/job and reclaimed when it dies) unless detached.
            "owner_worker_id": (
                None if lifetime == "detached"
                else worker.worker_id.binary()
            ),
        },
    )
    return PlacementGroup(pg_id, bundles,
                          created=reply.get("state") == "CREATED")


def remove_placement_group(pg: PlacementGroup):
    worker = get_global_worker()
    worker.gcs.call("RemovePlacementGroup", {"pg_id": pg.id})


def get_placement_group(name: str) -> PlacementGroup:
    worker = get_global_worker()
    reply = worker.gcs.call("ListPlacementGroups", {})
    for rec in reply["pgs"]:
        if rec.get("name") == name and rec["state"] != "REMOVED":
            return PlacementGroup(rec["pg_id"], [b["resources"] for b in rec["bundles"]])
    raise ValueError(f"no placement group named '{name}'")


def placement_group_table() -> dict:
    worker = get_global_worker()
    reply = worker.gcs.call("ListPlacementGroups", {})
    out = {}
    for rec in reply["pgs"]:
        out[rec["pg_id"].hex()] = {
            "name": rec.get("name", ""),
            "strategy": rec["strategy"],
            "state": rec["state"],
            "bundles": {
                b["index"]: b["resources"] for b in rec["bundles"]
            },
            "bundles_to_node_id": {
                b["index"]: (b["node_id"].hex() if b.get("node_id") else None)
                for b in rec["bundles"]
            },
        }
    return out
