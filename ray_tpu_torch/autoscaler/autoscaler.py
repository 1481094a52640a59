"""The autoscaler control loop.

Counterpart of the reference's v2 Autoscaler
(reference: python/ray/autoscaler/v2/autoscaler.py:42 — read cluster state
from the GCS AutoscalerStateService, run the demand scheduler, reconcile
through the instance manager / node provider; v1 loop shape:
autoscaler/_private/autoscaler.py:172 StandardAutoscaler.update + Monitor
monitor.py:126). Scaling unit = node type = one whole TPU slice.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private.gcs.client import GcsClient
from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.autoscaler.scheduler import ResourceDemandScheduler

logger = logging.getLogger("ray_tpu_torch.autoscaler")


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    labels: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "resources": dict(self.resources),
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "labels": dict(self.labels),
        }


class Autoscaler:
    def __init__(
        self,
        gcs_address: str,
        provider: NodeProvider,
        node_types: Dict[str, NodeTypeConfig],
        idle_timeout_s: float = 60.0,
        update_interval_s: float = 1.0,
        launch_cooldown_s: float = 10.0,
        boot_grace_s: float = 300.0,
    ):
        self.gcs = GcsClient.from_address(gcs_address)
        self.provider = provider
        self.node_types = {
            name: cfg.to_dict() if isinstance(cfg, NodeTypeConfig) else dict(cfg)
            for name, cfg in node_types.items()
        }
        self.scheduler = ResourceDemandScheduler(self.node_types)
        self.idle_timeout_s = idle_timeout_s
        self.update_interval_s = update_interval_s
        self.launch_cooldown_s = launch_cooldown_s
        self.boot_grace_s = boot_grace_s
        self._idle_since: Dict[str, float] = {}  # provider id -> ts
        self._last_launch: Dict[str, float] = {}  # node_type -> ts
        self._launched_at: Dict[str, float] = {}  # provider id -> ts
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control

    def start(self):
        # Announce ourselves: raylets switch infeasible demand from
        # fail-fast to queue-and-wait while an autoscaler can add capacity.
        # The value is a timestamp, refreshed every round — a crashed
        # autoscaler goes stale within 30s and raylets fail fast again.
        self._announce()
        self._thread = threading.Thread(
            target=self._run, name="autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self.gcs.kv_del("", b"__autoscaler_active__")
        except Exception:
            pass

    def _announce(self):
        try:
            self.gcs.kv_put("", b"__autoscaler_active__", str(time.time()).encode())
        except Exception:
            logger.exception("could not announce autoscaler")

    def _run(self):
        while not self._stop.is_set():
            try:
                self._announce()
                self.update()
            except Exception:
                logger.exception("autoscaler update failed")
            self._stop.wait(self.update_interval_s)

    # -------------------------------------------------------------- update

    def update(self) -> Dict[str, int]:
        """One reconciliation round; returns what was launched (by type)."""
        load = self.gcs.call("GetClusterLoad", {})
        provider_nodes = self.provider.non_terminated_nodes()
        counts_by_type: Dict[str, int] = {}
        for node_type in provider_nodes.values():
            counts_by_type[node_type] = counts_by_type.get(node_type, 0) + 1

        demands: List[Dict[str, float]] = []
        demands.extend(load.get("pending_tasks", []))
        demands.extend(load.get("pending_actors", []))
        demands.extend(b["resources"] for b in load.get("pending_pg_bundles", []))

        states = self._node_states(load, provider_nodes)
        capacities = [dict(n["resources_available"]) for n in load.get("nodes", [])]
        # Provider nodes still inside their boot window count as pending
        # capacity (reference: v2 scheduler counts launching instances), so
        # one demand never double-launches across rounds. Nodes that never
        # registered within the grace window (or whose raylet died) are
        # terminated — phantom capacity would suppress a needed launch
        # forever.
        for pid, st in states.items():
            if st["registered"]:
                continue
            if st["age"] < self.boot_grace_s:
                capacities.append(
                    dict(self.node_types.get(st["type"], {}).get("resources", {}))
                )
            else:
                logger.warning("terminating dead/unregistered node %s", pid)
                try:
                    self.provider.terminate_node(pid)
                except Exception:
                    # Keep it in the counts: max_workers must still see it,
                    # or repeated failed terminations over-launch unboundedly.
                    logger.exception("termination of %s failed", pid)
                    continue
                provider_nodes.pop(pid, None)
                counts_by_type[st["type"]] -= 1

        to_launch, infeasible = self.scheduler.schedule(
            demands, capacities, counts_by_type
        )
        for name, deficit in self.scheduler.min_workers_to_launch(
            counts_by_type
        ).items():
            to_launch[name] = max(to_launch.get(name, 0), deficit)

        launched: Dict[str, int] = {}
        now = time.time()
        for node_type, count in to_launch.items():
            # Cooldown: load reports lag placement by a report period, so a
            # demand satisfied moments ago can look pending while the node
            # it landed on already shows the capacity as consumed. Don't
            # launch the same type again until the dust settles.
            if now - self._last_launch.get(node_type, 0.0) < self.launch_cooldown_s:
                logger.info("launch of %s suppressed by cooldown", node_type)
                continue
            try:
                created = self.provider.create_node(node_type, count)
                for pid in created:
                    self._launched_at[pid] = time.time()
                launched[node_type] = count
                self._last_launch[node_type] = time.time()
                logger.info("launched %d x %s", count, node_type)
            except Exception:
                logger.exception("launch of %s failed", node_type)
        if infeasible:
            logger.warning(
                "infeasible demand (no node type fits, or max_workers hit): %s",
                infeasible[:5],
            )

        self._terminate_idle(states, provider_nodes, counts_by_type)
        return launched

    def _node_states(self, load, provider_nodes) -> Dict[str, dict]:
        """Per provider node: {type, age, registered, row}. Uses an exact
        provider-node -> raylet-node-id mapping when the provider exposes
        one (FakeMultiNodeProvider does); otherwise matches GCS rows to
        provider nodes of the same node_type label by count."""
        now = time.time()
        node_id_of = getattr(self.provider, "raylet_node_id", None)
        rows_by_id = {n["node_id"]: n for n in load.get("nodes", [])}
        rows_by_label: Dict[str, List[dict]] = {}
        for n in load.get("nodes", []):
            label = n.get("labels", {}).get("node_type", "")
            rows_by_label.setdefault(label, []).append(n)

        states: Dict[str, dict] = {}
        claimed: set = set()
        for pid, node_type in provider_nodes.items():
            st = {
                "type": node_type,
                # setdefault: a node first seen NOW (autoscaler restart,
                # pre-existing provider nodes) starts aging from discovery —
                # a .get(pid, now) default would pin its age at 0 forever,
                # making a dead node permanent phantom capacity.
                "age": now - self._launched_at.setdefault(pid, now),
                "registered": False,
                "row": None,
            }
            if node_id_of is not None:
                nid = node_id_of(pid)
                row = rows_by_id.get(nid)
                if row is not None:
                    st["registered"] = True
                    st["row"] = row
            else:
                for row in rows_by_label.get(node_type, []):
                    if id(row) not in claimed:
                        claimed.add(id(row))
                        st["registered"] = True
                        st["row"] = row
                        break
            states[pid] = st
        return states

    def _terminate_idle(self, states, provider_nodes, counts_by_type):
        """Scale down nodes idle past the timeout, never below min_workers
        (reference: v1 autoscaler idle termination). Per-node busyness from
        that node's own GCS row; unregistered (booting) nodes are never
        idle candidates."""
        now = time.time()
        for pid, st in list(states.items()):
            if pid not in provider_nodes or not st["registered"]:
                self._idle_since.pop(pid, None)
                continue
            row = st["row"]
            busy = (
                row.get("num_leases", 0) > 0
                or row["resources_available"] != row["resources_total"]
            )
            if busy:
                self._idle_since.pop(pid, None)
                continue
            first_idle = self._idle_since.setdefault(pid, now)
            node_type = st["type"]
            cfg = self.node_types.get(node_type, {})
            if (
                now - first_idle > self.idle_timeout_s
                and counts_by_type.get(node_type, 0) > cfg.get("min_workers", 0)
            ):
                logger.info("terminating idle node %s (%s)", pid, node_type)
                try:
                    self.provider.terminate_node(pid)
                    counts_by_type[node_type] -= 1
                except Exception:
                    logger.exception("termination of %s failed", pid)
                self._idle_since.pop(pid, None)
                self._launched_at.pop(pid, None)
