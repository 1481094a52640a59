"""GCS — the cluster control plane (one per cluster).

Counterpart of the reference's gcs_server
(reference: src/ray/gcs/gcs_server/gcs_server.h:78): node membership and
health, the actor directory with restart fault-tolerance, placement groups
with two-phase reserve/commit, jobs, a namespaced KV (which also backs the
function table), long-poll batched pubsub (reference: src/ray/pubsub/), task
events, and the cluster resource view that feeds scheduling/spillback and the
autoscaler. Everything runs on one asyncio loop, like the reference's single
asio io_context.

State is in-memory, persisted through a msgpack append log
(``persistence.GcsLog``) covering the KV/job/actor/named-actor/placement-
group/node tables. On restart the log replays and the cluster resumes:
raylets re-register on their next heartbeat, pubsub subscribers re-subscribe
when they observe a new server epoch (reference uses Redis for this —
src/ray/gcs/store_client/redis_store_client.h).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.gcs.persistence import GcsLog
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch._private.rpc import ClientPool, RpcServer

logger = logging.getLogger("ray_tpu_torch.gcs")

# Actor lifecycle states (reference: protobuf gcs.proto ActorTableData.ActorState)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class KVStore:
    def __init__(self):
        self._data: Dict[str, Dict[bytes, bytes]] = {}

    def _ns(self, ns: str) -> Dict[bytes, bytes]:
        return self._data.setdefault(ns or "", {})

    def put(self, ns, key, value, overwrite=True) -> bool:
        table = self._ns(ns)
        if not overwrite and key in table:
            return False
        table[key] = value
        return True

    def get(self, ns, key):
        return self._ns(ns).get(key)

    def delete(self, ns, key) -> bool:
        return self._ns(ns).pop(key, None) is not None

    def keys(self, ns, prefix=b""):
        return [k for k in self._ns(ns) if k.startswith(prefix)]

    def exists(self, ns, key) -> bool:
        return key in self._ns(ns)


class PubSub:
    """Long-poll batched pubsub, one queue per subscriber.

    The reference replaced per-key long-polling with batched channel polling
    (reference: src/ray/pubsub/README.md); same design here: subscribers poll
    and receive every buffered (channel, message) batch at once.
    """

    def __init__(self):
        self._subs: Dict[bytes, Dict[str, Any]] = {}
        # Exact-channel and wildcard-prefix indexes: publish() must not scan
        # every subscriber's channel set (a driver watching N actors holds N
        # channels — the scan made actor-burst publishing O(N^2)).
        self._exact: Dict[str, set] = {}
        self._prefix: Dict[str, set] = {}

    def subscribe(self, sub_id: bytes, channel: str):
        sub = self._subs.setdefault(
            sub_id, {"channels": set(), "queue": [], "event": asyncio.Event()}
        )
        sub["channels"].add(channel)
        if channel.endswith("*"):
            self._prefix.setdefault(channel[:-1], set()).add(sub_id)
        else:
            self._exact.setdefault(channel, set()).add(sub_id)

    def _unindex(self, sub_id: bytes, channel: str):
        table, key = (
            (self._prefix, channel[:-1]) if channel.endswith("*")
            else (self._exact, channel)
        )
        ids = table.get(key)
        if ids is not None:
            ids.discard(sub_id)
            if not ids:
                del table[key]

    def unsubscribe(self, sub_id: bytes, channel: Optional[str]):
        sub = self._subs.get(sub_id)
        if not sub:
            return
        if channel is None:
            for ch in sub["channels"]:
                self._unindex(sub_id, ch)
            del self._subs[sub_id]
        else:
            sub["channels"].discard(channel)
            self._unindex(sub_id, channel)

    def publish(self, channel: str, message):
        targets = set(self._exact.get(channel, ()))
        for prefix, ids in self._prefix.items():
            if channel.startswith(prefix):
                targets |= ids
        for sub_id in targets:
            sub = self._subs.get(sub_id)
            if sub is None:
                continue
            q = sub["queue"]
            q.append([channel, message])
            if len(q) > CONFIG.pubsub_max_batch:
                del q[: len(q) - CONFIG.pubsub_max_batch]
            sub["event"].set()

    async def poll(self, sub_id: bytes, timeout: float):
        sub = self._subs.setdefault(
            sub_id, {"channels": set(), "queue": [], "event": asyncio.Event()}
        )
        if not sub["queue"]:
            sub["event"].clear()
            try:
                await asyncio.wait_for(sub["event"].wait(), timeout)
            except asyncio.TimeoutError:
                pass
        batch = sub["queue"]
        sub["queue"] = []
        return batch


class GcsServer:
    def __init__(self, host="127.0.0.1", session_dir: str = "", persist_path: str = ""):
        self.host = host
        self.session_dir = session_dir
        self.server = RpcServer(host)
        from ray_tpu_torch._private import schema as _schema

        self.server.set_validator(_schema.make_validator(_schema.GCS_SCHEMAS))
        self.kv = KVStore()
        self.pubsub = PubSub()
        self.pool = ClientPool()  # clients to raylets / workers
        self.start_time = time.time()
        # A fresh epoch per server process: clients detect a restart by the
        # epoch changing and re-subscribe their pubsub channels.
        self.epoch = uuid.uuid4().hex
        if not persist_path and session_dir and CONFIG.gcs_persistence:
            persist_path = os.path.join(session_dir, "gcs.log")
        self.log: Optional[GcsLog] = (
            GcsLog(persist_path, fsync=CONFIG.gcs_log_fsync)
            if persist_path
            else None
        )
        self._compacting = False
        self._compact_buffer: List[Tuple[str, Any]] = []

        # node_id(bytes) -> info dict
        self.nodes: Dict[bytes, dict] = {}
        self.node_last_beat: Dict[bytes, float] = {}
        # actor_id(bytes) -> record
        self.actors: Dict[bytes, dict] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}  # (ns, name) -> actor_id
        self.pending_actor_queue: List[bytes] = []
        # Concurrent actor creation: the pump leases workers for many pending
        # actors at once (reference: gcs_actor_scheduler.cc leases in parallel
        # per actor); the semaphore bounds in-flight creations and
        # _actor_inflight stops concurrent picks from over-committing a node
        # before its next resource report lands.
        self._actor_create_sem = asyncio.Semaphore(
            CONFIG.actor_creation_parallelism
        )
        self._actor_inflight: Dict[bytes, Dict[str, float]] = {}
        # kill() seen before the (async-batched) registration arrived
        self._kill_tombstones: set = set()
        # pg_id(bytes) -> record
        self.placement_groups: Dict[bytes, dict] = {}
        self.pending_pg_queue: List[bytes] = []
        self.jobs: Dict[bytes, dict] = {}
        self.task_events: List[dict] = []
        self._worker_failures: List[dict] = []
        # Incident table (stall watchdog + forensics): bounded append log of
        # stall/hang reports with captured stacks and flight-recorder rings.
        self.incidents: List[dict] = []
        # (name, sorted-label-items) -> aggregated user-metric record
        self.user_metrics: Dict[Tuple[str, tuple], dict] = {}
        self.metrics_port = 0
        self._bg_tasks = []

    # ------------------------------------------------------------------ util

    def _raylet_client(self, node_id: bytes):
        info = self.nodes[node_id]
        return self.pool.get(info["ip"], info["raylet_port"])

    def alive_nodes(self) -> List[bytes]:
        return [nid for nid, n in self.nodes.items() if n["state"] == "ALIVE"]

    # ---------------------------------------------------------- persistence

    def _persist(self, kind: str, data):
        if self.log is None:
            return
        if self._compacting:
            # A snapshot write is in flight off-loop; appends to the old file
            # would be clobbered by the rename. Buffer and flush after.
            self._compact_buffer.append((kind, data))
            return
        try:
            self.log.append(kind, data)
        except Exception:
            logger.exception("gcs log append failed")

    def _persist_actor(self, rec: dict):
        self._persist("actor", rec)

    def _persist_pg(self, pg: dict):
        self._persist("pg", {k: v for k, v in pg.items() if k != "ready_event"})

    def _restore(self):
        """Replay the append log into the in-memory tables, then compact.

        A malformed record (version skew, partial corruption past the frame
        check) is skipped, never fatal: a GCS that cannot start is strictly
        worse than one missing a record, and the node monitor would respawn
        a crashing GCS forever.
        """
        if self.log is None:
            return
        n = 0
        try:
            replay = list(self.log.replay())
        except Exception:
            logger.exception("gcs log unreadable; starting empty")
            return
        for kind, data in replay:
            try:
                n += 1
                if kind == "kv":
                    ns, key, value = data
                    if value is None:
                        self.kv.delete(ns, key)
                    else:
                        self.kv.put(ns, key, value)
                elif kind == "job":
                    self.jobs[data["job_id"]] = data
                elif kind == "actor":
                    self.actors[data["actor_id"]] = data
                elif kind == "named":
                    ns, name, actor_id = data
                    if actor_id is None:
                        self.named_actors.pop((ns, name), None)
                    else:
                        self.named_actors[(ns, name)] = actor_id
                elif kind == "pg":
                    data["ready_event"] = None
                    self.placement_groups[data["pg_id"]] = data
                elif kind == "node":
                    self.nodes[data["node_id"]] = data
            except Exception:
                logger.exception("skipping malformed gcs log record kind=%r", kind)
        if n == 0:
            return
        now = time.time()
        for node_id, info in self.nodes.items():
            # Give restored nodes a full grace window to heartbeat back in.
            self.node_last_beat[node_id] = now
        for actor_id, rec in self.actors.items():
            if rec["state"] in (PENDING_CREATION, RESTARTING):
                self.pending_actor_queue.append(actor_id)
        for pg_id, pg in self.placement_groups.items():
            if pg["state"] in ("PENDING", "RESCHEDULING"):
                self.pending_pg_queue.append(pg_id)
        logger.info(
            "GCS restored from %s: %d records, %d nodes, %d actors, %d pgs, %d jobs",
            self.log.path, n, len(self.nodes), len(self.actors),
            len(self.placement_groups), len(self.jobs),
        )
        self._compact()

    def _snapshot_records(self) -> List[Tuple[str, Any]]:
        records: List[Tuple[str, Any]] = []
        for ns, table in self.kv._data.items():
            for key, value in table.items():
                records.append(("kv", [ns, key, value]))
        for job in self.jobs.values():
            records.append(("job", job))
        for rec in self.actors.values():
            records.append(("actor", rec))
        for (ns, name), actor_id in self.named_actors.items():
            records.append(("named", [ns, name, actor_id]))
        for pg in self.placement_groups.values():
            records.append(
                ("pg", {k: v for k, v in pg.items() if k != "ready_event"})
            )
        for info in self.nodes.values():
            records.append(("node", info))
        return records

    def _compact(self):
        if self.log is None:
            return
        try:
            self.log.compact(self._snapshot_records())
        except Exception:
            logger.exception("gcs log compaction failed")

    async def _compaction_loop(self):
        """Compact off-loop: the snapshot is captured synchronously (cheap,
        point-in-time consistent) but the serialize+fsync runs in a thread so
        a large state dump cannot stall heartbeat handling past the health
        threshold and wrongly kill every node."""
        limit = CONFIG.gcs_log_compact_bytes
        while True:
            await asyncio.sleep(5.0)
            if self.log is None or self.log.size() <= limit or self._compacting:
                continue
            # Pack on the loop (consistent point-in-time view of the live
            # table dicts); only the write+fsync goes to the thread.
            blob = GcsLog.pack(self._snapshot_records())
            self._compacting = True
            self._compact_buffer = []
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.log.compact_packed, blob
                )
            except Exception:
                logger.exception("gcs log compaction failed")
            finally:
                self._compacting = False
                buffered, self._compact_buffer = self._compact_buffer, []
                for kind, data in buffered:
                    self._persist(kind, data)

    # ------------------------------------------------------------- lifecycle

    async def start(self, port: int = 0) -> int:
        self._restore()
        self.server.register_all(self)
        port = await self.server.start(port)
        try:
            from ray_tpu_torch._private.metrics import start_metrics_http_server

            self.metrics_server, self.metrics_port = await start_metrics_http_server(
                self.host, self._collect_metrics
            )
        except Exception:
            logger.exception("metrics endpoint failed to start")
            self.metrics_port = 0
        self._bg_tasks.append(asyncio.ensure_future(self._health_check_loop()))
        self._bg_tasks.append(asyncio.ensure_future(self._compaction_loop()))
        if self.session_dir:
            try:
                _fr.install_exit_dump(os.path.join(
                    self.session_dir, "logs", f"flight_gcs-{os.getpid()}.jsonl"))
            except Exception:
                pass
        if self.pending_actor_queue:
            asyncio.ensure_future(self._schedule_pending_actors())
        if self.pending_pg_queue:
            asyncio.ensure_future(self._schedule_pending_pgs())
        logger.info("GCS listening on %s:%s", self.host, port)
        return port

    async def _health_check_loop(self):
        period = CONFIG.health_check_period_ms / 1000.0
        threshold = CONFIG.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            now = time.time()
            for node_id, info in list(self.nodes.items()):
                if info["state"] != "ALIVE":
                    continue
                last = self.node_last_beat.get(node_id, now)
                if now - last > period * threshold:
                    await self._mark_node_dead(node_id, "missed heartbeats")

    async def _mark_node_dead(self, node_id: bytes, reason: str):
        info = self.nodes.get(node_id)
        if info is None or info["state"] == "DEAD":
            return
        info["state"] = "DEAD"
        info["end_time"] = time.time()
        _fr.record("node.dead", node_id, reason[:120])
        logger.warning("node %s dead: %s", node_id.hex(), reason)
        self._persist("node", info)
        self.pubsub.publish("node", {"node_id": node_id, "state": "DEAD"})
        # Fail/restart actors that lived on this node.
        for actor_id, rec in list(self.actors.items()):
            if rec.get("node_id") == node_id and rec["state"] in (ALIVE, PENDING_CREATION):
                await self._on_actor_worker_lost(actor_id, f"node died: {reason}")
        # Re-schedule placement groups that had bundles there.
        for pg_id, pg in list(self.placement_groups.items()):
            if pg["state"] == "CREATED" and any(
                b.get("node_id") == node_id for b in pg["bundles"]
            ):
                pg["state"] = "RESCHEDULING"
                for b in pg["bundles"]:
                    if b.get("node_id") == node_id:
                        b["node_id"] = None
                self._persist_pg(pg)
                self.pending_pg_queue.append(pg_id)
                asyncio.ensure_future(self._schedule_pending_pgs())

    # ------------------------------------------------------------ node table

    async def handle_RegisterNode(self, req):
        node_id = req["node_id"]
        self.nodes[node_id] = {
            "node_id": node_id,
            "ip": req["ip"],
            "raylet_port": req["raylet_port"],
            "object_manager_port": req.get("object_manager_port", req["raylet_port"]),
            "plasma_name": req.get("plasma_name", ""),
            "resources_total": dict(req.get("resources", {})),
            "resources_available": dict(req.get("resources", {})),
            "labels": dict(req.get("labels", {})),
            "state": "ALIVE",
            "start_time": time.time(),
            "is_head": bool(req.get("is_head")),
            "metrics_port": req.get("metrics_port", 0),
        }
        self.node_last_beat[node_id] = time.time()
        self._persist("node", self.nodes[node_id])
        self.pubsub.publish("node", {"node_id": node_id, "state": "ALIVE"})
        # New capacity: retry pending actors/PGs.
        asyncio.ensure_future(self._schedule_pending_actors())
        asyncio.ensure_future(self._schedule_pending_pgs())
        return {"ok": True}

    async def handle_UnregisterNode(self, req):
        await self._mark_node_dead(req["node_id"], "unregistered")
        return {"ok": True}

    def _autoscaler_active_now(self) -> bool:
        """True while an autoscaler heartbeat (timestamped KV) is fresh — a
        crashed autoscaler must not leave raylets queueing infeasible work
        forever."""
        v = self.kv.get("", b"__autoscaler_active__")
        if not v:
            return False
        try:
            return time.time() - float(v) < 30.0
        except (TypeError, ValueError):
            return True  # legacy non-timestamped value

    async def handle_GetAutoscalerActive(self, req):
        return {"active": self._autoscaler_active_now()}

    async def handle_Heartbeat(self, req):
        node_id = req["node_id"]
        self.node_last_beat[node_id] = time.time()
        # "known" lets a raylet detect a GCS that restarted without its
        # registration (e.g. persistence disabled) and re-register.
        info = self.nodes.get(node_id)
        return {
            "known": info is not None and info["state"] == "ALIVE",
            "autoscaler_active": self._autoscaler_active_now(),
        }

    async def handle_ReportResources(self, req):
        node = self.nodes.get(req["node_id"])
        if node is None:
            return
        node["resources_available"] = req["available"]
        node["resources_total"] = req["total"]
        node["pending_demands"] = req.get("pending_demands", [])
        node["num_leases"] = req.get("num_leases", 0)
        node["num_workers"] = req.get("num_workers", 0)
        self.node_last_beat[req["node_id"]] = time.time()
        # Push the delta to every raylet's cluster view (the RaySyncer
        # broadcast plane, reference: common/ray_syncer/ray_syncer.h:88 —
        # here a pubsub channel drained by batched long-polls).
        self.pubsub.publish("resources", {
            "node_id": req["node_id"],
            "available": req["available"],
            "total": req["total"],
            "num_leases": node["num_leases"],
            "num_workers": node["num_workers"],
        })
        if self.pending_actor_queue:
            asyncio.ensure_future(self._schedule_pending_actors())
        if self.pending_pg_queue:
            asyncio.ensure_future(self._schedule_pending_pgs())

    async def handle_GetAllNodeInfo(self, req):
        nodes = list(self.nodes.values())
        limit = req.get("limit")
        return {"nodes": nodes[:limit] if limit else nodes}

    async def handle_GetClusterResources(self, req):
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for nid in self.alive_nodes():
            n = self.nodes[nid]
            for k, v in n["resources_total"].items():
                total[k] = total.get(k, 0) + v
            for k, v in n["resources_available"].items():
                avail[k] = avail.get(k, 0) + v
        return {"total": total, "available": avail}

    async def handle_GetInternalConfig(self, req):
        return {"config": CONFIG.dump(), "session_dir": self.session_dir}

    async def handle_GetClusterLoad(self, req):
        """Autoscaler input: everything waiting for resources right now
        (reference: GcsAutoscalerStateManager::HandleGetClusterResourceState,
        gcs_autoscaler_state_manager.h:30 — pending task shapes, pending
        actors, unplaced placement-group bundles, per-node utilization)."""
        pending_tasks: List[dict] = []
        for nid in self.alive_nodes():
            pending_tasks.extend(self.nodes[nid].get("pending_demands", []))
        pending_actors = []
        for actor_id in self.pending_actor_queue:
            rec = self.actors.get(actor_id)
            if rec is not None and rec["state"] in (PENDING_CREATION, RESTARTING):
                pending_actors.append(dict(rec["creation_spec"].get("resources", {})))
        pending_pg_bundles = []
        for pg_id in self.pending_pg_queue:
            pg = self.placement_groups.get(pg_id)
            if pg is not None and pg["state"] in ("PENDING", "RESCHEDULING"):
                for b in pg["bundles"]:
                    if b.get("node_id") is None:
                        pending_pg_bundles.append(
                            {"resources": dict(b["resources"]), "strategy": pg["strategy"]}
                        )
        nodes = [
            {
                "node_id": nid,
                "resources_total": self.nodes[nid]["resources_total"],
                "resources_available": self.nodes[nid]["resources_available"],
                "num_leases": self.nodes[nid].get("num_leases", 0),
                "num_workers": self.nodes[nid].get("num_workers", 0),
                "labels": self.nodes[nid].get("labels", {}),
                "is_head": self.nodes[nid].get("is_head", False),
            }
            for nid in self.alive_nodes()
        ]
        return {
            "pending_tasks": pending_tasks,
            "pending_actors": pending_actors,
            "pending_pg_bundles": pending_pg_bundles,
            "nodes": nodes,
        }

    # --------------------------------------------------------------------- kv

    async def handle_KVPut(self, req):
        added = self.kv.put(req["ns"], req["key"], req["value"], req.get("overwrite", True))
        if added:
            self._persist("kv", [req["ns"], req["key"], req["value"]])
        return {"added": added}

    async def handle_KVGet(self, req):
        return {"value": self.kv.get(req["ns"], req["key"])}

    async def handle_KVDel(self, req):
        deleted = self.kv.delete(req["ns"], req["key"])
        if deleted:
            self._persist("kv", [req["ns"], req["key"], None])
        return {"deleted": deleted}

    async def handle_KVKeys(self, req):
        return {"keys": self.kv.keys(req["ns"], req.get("prefix", b""))}

    async def handle_KVExists(self, req):
        return {"exists": self.kv.exists(req["ns"], req["key"])}

    # ------------------------------------------------------------------ pubsub

    async def handle_Subscribe(self, req):
        self.pubsub.subscribe(req["sub_id"], req["channel"])
        # Epoch lets the subscriber baseline restart detection atomically
        # with the subscription (a restart between Subscribe and the first
        # poll would otherwise go unnoticed forever).
        return {"ok": True, "epoch": self.epoch}

    async def handle_SubscribeMany(self, req):
        """Batch subscribe: one round-trip for a burst of channels (the
        driver's batched actor registration subscribes N watch channels at
        once)."""
        for ch in req["channels"]:
            self.pubsub.subscribe(req["sub_id"], ch)
        return {"ok": True, "epoch": self.epoch}

    async def handle_Unsubscribe(self, req):
        self.pubsub.unsubscribe(req["sub_id"], req.get("channel"))
        return {"ok": True}

    async def handle_PubsubPoll(self, req):
        timeout = min(req.get("timeout", 30.0), CONFIG.pubsub_poll_timeout_s)
        batch = await self.pubsub.poll(req["sub_id"], timeout)
        # Epoch lets pollers detect a GCS restart (subscriber state is
        # process-local) and re-subscribe their channels.
        return {"batch": batch, "epoch": self.epoch}

    async def handle_Publish(self, req):
        self.pubsub.publish(req["channel"], req["message"])
        return {"ok": True}

    # -------------------------------------------------------------------- jobs

    async def handle_AddJob(self, req):
        self.jobs[req["job_id"]] = {
            "job_id": req["job_id"],
            "driver_addr": req.get("driver_addr"),
            "start_time": time.time(),
            "end_time": None,
            "state": "RUNNING",
            "entrypoint": req.get("entrypoint", ""),
            "metadata": req.get("metadata", {}),
            "driver_sys_path": req.get("driver_sys_path", []),
        }
        self._persist("job", self.jobs[req["job_id"]])
        self.pubsub.publish("job", {"job_id": req["job_id"], "state": "RUNNING"})
        return {"ok": True}

    async def handle_GetJob(self, req):
        job = self.jobs.get(req["job_id"])
        return {"found": job is not None, "job": job or {}}

    async def handle_MarkJobFinished(self, req):
        job = self.jobs.get(req["job_id"])
        if job:
            job["state"] = "FINISHED"
            job["end_time"] = time.time()
            self._persist("job", job)
        self.pubsub.publish("job", {"job_id": req["job_id"], "state": "FINISHED"})
        # Tell raylets to reap this job's workers.
        for nid in self.alive_nodes():
            try:
                client = await self._raylet_client(nid)
                await client.notify("JobFinished", {"job_id": req["job_id"]})
            except Exception:
                pass
        return {"ok": True}

    async def handle_GetAllJobInfo(self, req):
        jobs = list(self.jobs.values())
        limit = req.get("limit")
        return {"jobs": jobs[:limit] if limit else jobs}

    # ------------------------------------------------------------------ actors

    async def handle_RegisterActors(self, req):
        """Batched registration of anonymous actors: one RPC, one pump kick
        (the driver coalesces a `.remote()` burst into this)."""
        for item in req["items"]:
            self._register_actor_record(item)
        asyncio.ensure_future(self._schedule_pending_actors())
        return {"ok": True}

    async def handle_RegisterActor(self, req):
        """Register + asynchronously schedule an actor creation.

        req: {actor_id, creation_spec(task spec dict), name, ray_namespace,
              max_restarts, detached}
        """
        self._register_actor_record(req)
        asyncio.ensure_future(self._schedule_pending_actors())
        return {"ok": True}

    def _register_actor_record(self, req):
        actor_id = req["actor_id"]
        if actor_id in self.actors:
            # Idempotent: a client retry of its own registration (after a
            # dropped reply / GCS failover) must not reset a live actor back
            # to PENDING_CREATION and re-schedule it.
            return
        if actor_id in self._kill_tombstones:
            self._kill_tombstones.discard(actor_id)
            rec = {
                "actor_id": actor_id, "state": DEAD,
                "creation_spec": req["creation_spec"], "name": req.get("name") or "",
                "namespace": req.get("namespace") or "",
                "max_restarts": 0, "num_restarts": 0,
                "detached": req.get("detached", False),
                "owner_worker_id": req["creation_spec"].get("owner_worker_id"),
                "node_id": None, "worker_id": None, "addr": None,
                "job_id": req["creation_spec"]["job_id"],
                "death_cause": "killed via kill()", "start_time": time.time(),
            }
            self.actors[actor_id] = rec
            self._publish_actor(actor_id, rec)
            return
        name = req.get("name") or ""
        ns = req.get("namespace") or ""
        if name:
            if (ns, name) in self.named_actors:
                existing = self.named_actors[(ns, name)]
                # existing == actor_id: a client retry of our own
                # registration after a GCS failover — idempotent, not a
                # collision.
                if existing != actor_id and self.actors.get(existing, {}).get("state") != DEAD:
                    raise ValueError(f"actor name '{name}' already taken")
            self.named_actors[(ns, name)] = actor_id
            self._persist("named", [ns, name, actor_id])
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "state": PENDING_CREATION,
            "creation_spec": req["creation_spec"],
            "name": name,
            "namespace": ns,
            "max_restarts": req.get("max_restarts", 0),
            "num_restarts": 0,
            "detached": req.get("detached", False),
            "owner_worker_id": req["creation_spec"].get("owner_worker_id"),
            "node_id": None,
            "worker_id": None,
            "addr": None,
            "job_id": req["creation_spec"]["job_id"],
            "death_cause": "",
            "start_time": time.time(),
        }
        self._persist_actor(self.actors[actor_id])
        self.pending_actor_queue.append(actor_id)

    def _pick_node(self, resources: Dict[str, float], strategy: dict) -> Optional[bytes]:
        """Hybrid placement for actors/PG bundles at the GCS level.
        node_label strategies filter candidates to hard-label matches and
        prefer soft-label matches (reference:
        raylet/scheduling/policy/node_label_scheduling_policy.cc)."""
        is_label = strategy.get("type") == "node_label"
        hard = (strategy.get("hard") or {}) if is_label else {}
        soft = (strategy.get("soft") or {}) if is_label else {}
        candidates = []
        for nid in self.alive_nodes():
            n = self.nodes[nid]
            if strategy.get("type") == "node_affinity":
                if nid != strategy["node_id"]:
                    continue
            labels = n.get("labels", {})
            if is_label and any(labels.get(k) != v for k, v in hard.items()):
                continue
            avail = n["resources_available"]
            infl = self._actor_inflight.get(nid)
            if infl:
                avail = {k: avail.get(k, 0.0) - infl.get(k, 0.0)
                         for k in set(avail) | set(infl)}
            total = n["resources_total"]
            if all(avail.get(k, 0) >= v for k, v in resources.items()) and all(
                total.get(k, 0) >= v for k, v in resources.items()
            ):
                used = sum(
                    1 - avail.get(k, 0) / total[k] for k in total if total[k] > 0
                )
                soft_ok = bool(soft) and all(
                    labels.get(k) == v for k, v in soft.items()
                )
                candidates.append((used, nid, soft_ok))
        if soft and any(c[2] for c in candidates):
            # soft-label matches exist: restrict to them (soft preference
            # outranks the load score but never makes placement infeasible)
            candidates = [c for c in candidates if c[2]]
        candidates = [(used, nid) for used, nid, _ in candidates]
        if not candidates:
            if strategy.get("type") == "node_affinity" and strategy.get("soft"):
                return self._pick_node(resources, {})
            return None
        candidates.sort(key=lambda c: (c[0], c[1]))
        if strategy.get("type") == "spread":
            return candidates[0][1]  # least utilized
        # default: pack — most utilized feasible node below threshold, else least
        packed = [c for c in candidates if c[0] <= CONFIG.scheduler_spread_threshold]
        if packed:
            return packed[-1][1]
        return candidates[0][1]

    async def _schedule_pending_actors(self):
        queue, self.pending_actor_queue = self.pending_actor_queue, []
        if not queue:
            return
        # Pick nodes up front (synchronously — one consistent view), then
        # drive creations grouped per node in batched LeaseWorkersForActors
        # RPCs. Each batch runs as its own coroutine so a burst pipelines
        # instead of paying sequential fork+register round-trips; the shared
        # semaphore bounds total in-flight creations across pumps.
        singles: list = []   # (actor_id, rec) that must go one-at-a-time
        by_node: Dict[bytes, list] = {}
        for actor_id in queue:
            rec = self.actors.get(actor_id)
            if rec is None or rec["state"] not in (PENDING_CREATION, RESTARTING):
                continue
            spec = rec["creation_spec"]
            strategy = spec.get("strategy", {})
            if strategy.get("type") == "placement_group":
                singles.append(actor_id)
                continue
            node_id = self._pick_node(spec["resources"], strategy)
            if node_id is None:
                self.pending_actor_queue.append(actor_id)
                continue
            infl = self._actor_inflight.setdefault(node_id, {})
            for k, v in spec["resources"].items():
                infl[k] = infl.get(k, 0.0) + v
            # carry the reserved resources so the release matches the
            # reservation even if the record mutates before the batch runs
            by_node.setdefault(node_id, []).append(
                (actor_id, dict(spec["resources"]))
            )
        tasks = [self._schedule_one_actor(a) for a in singles]
        batch = CONFIG.actor_creation_lease_batch
        for node_id, pairs in by_node.items():
            for i in range(0, len(pairs), batch):
                tasks.append(self._lease_actor_batch(node_id, pairs[i:i + batch]))
        if tasks:
            await asyncio.gather(*tasks)

    def _release_inflight(self, node_id: bytes, resources: Dict[str, float]):
        infl = self._actor_inflight.get(node_id)
        if infl is None:
            return
        for k, v in resources.items():
            infl[k] = infl.get(k, 0.0) - v
            if infl[k] <= 0:
                infl.pop(k, None)
        if not infl:
            self._actor_inflight.pop(node_id, None)

    async def _lease_actor_batch(self, node_id: bytes, pairs: list):
        """One LeaseWorkersForActors RPC creating a batch of actors on one
        node (each still forks its own worker raylet-side, concurrently).
        `pairs` is [(actor_id, reserved_resources)]."""
        async with self._actor_create_sem:
            items, recs = [], []
            for actor_id, reserved in pairs:
                rec = self.actors.get(actor_id)
                if rec is None or rec["state"] not in (PENDING_CREATION, RESTARTING):
                    self._release_inflight(node_id, reserved)
                    continue
                spec = rec["creation_spec"]
                items.append({
                    "actor_id": actor_id,
                    "job_id": spec["job_id"],
                    "resources": spec["resources"],
                    "strategy": spec.get("strategy", {}),
                    "runtime_env": spec.get("runtime_env", {}),
                    "spec": spec,
                })
                recs.append((actor_id, rec, reserved))
            if not items:
                return
            try:
                raylet = await self._raylet_client(node_id)
                reply = await raylet.call(
                    "LeaseWorkersForActors", {"items": items},
                    # margin over the raylet's own per-item startup wait:
                    # if one slow fork hits that limit, the raylet must get
                    # to report the siblings it DID lease, or their grants
                    # and __init__ side effects would leak/duplicate
                    timeout=CONFIG.worker_startup_timeout_s + 30.0,
                )
                results = reply["results"]
            except Exception as e:
                logger.warning("actor lease batch on %s failed: %s",
                               node_id.hex(), e)
                results = [{"granted": False}] * len(recs)
            for (actor_id, rec, reserved), res in zip(recs, results):
                self._release_inflight(node_id, reserved)
                done = await self._apply_lease_reply(actor_id, rec, node_id, res)
                if not done and self.actors.get(actor_id, {}).get("state") in (
                    PENDING_CREATION, RESTARTING,
                ):
                    self.pending_actor_queue.append(actor_id)

    async def _schedule_one_actor(self, actor_id: bytes):
        async with self._actor_create_sem:
            rec = self.actors.get(actor_id)
            if rec is None or rec["state"] not in (PENDING_CREATION, RESTARTING):
                return
            ok = await self._try_create_actor(actor_id, rec)
            if not ok and self.actors.get(actor_id, {}).get("state") in (
                PENDING_CREATION,
                RESTARTING,
            ):
                self.pending_actor_queue.append(actor_id)

    async def _try_create_actor(self, actor_id: bytes, rec: dict) -> bool:
        spec = rec["creation_spec"]
        strategy = spec.get("strategy", {})
        if strategy.get("type") == "placement_group":
            pg = self.placement_groups.get(strategy["pg_id"])
            if pg is None or pg["state"] != "CREATED":
                return False
            bundle = pg["bundles"][strategy.get("bundle_index") or 0]
            node_id = bundle["node_id"]
            # PG actors draw from bundle pools already reserved by the 2PC,
            # not from the node's free pool — no inflight tracking needed.
            return await self._create_actor_on(actor_id, rec, node_id)
        node_id = self._pick_node(spec["resources"], strategy)
        if node_id is None:
            return False
        infl = self._actor_inflight.setdefault(node_id, {})
        for k, v in spec["resources"].items():
            infl[k] = infl.get(k, 0.0) + v
        try:
            return await self._create_actor_on(actor_id, rec, node_id)
        finally:
            self._release_inflight(node_id, spec["resources"])

    async def _create_actor_on(self, actor_id: bytes, rec: dict,
                               node_id: bytes) -> bool:
        spec = rec["creation_spec"]
        strategy = spec.get("strategy", {})
        try:
            raylet = await self._raylet_client(node_id)
            reply = await raylet.call(
                "LeaseWorkerForActor",
                {
                    "actor_id": actor_id,
                    "job_id": spec["job_id"],
                    "resources": spec["resources"],
                    "strategy": strategy,
                    "runtime_env": spec.get("runtime_env", {}),
                    # Full creation spec: the raylet initializes the actor
                    # during worker boot and replies created=True, saving the
                    # GCS a per-actor connection + CreateActor round-trip.
                    "spec": spec,
                },
                timeout=CONFIG.worker_startup_timeout_s + 30.0,
            )
        except Exception as e:
            logger.warning("actor lease on %s failed: %s", node_id.hex(), e)
            return False
        return await self._apply_lease_reply(actor_id, rec, node_id, reply)

    async def _apply_lease_reply(self, actor_id: bytes, rec: dict,
                                 node_id: bytes, reply: dict) -> bool:
        """Process a (possibly batched) lease reply; True = terminal state
        reached (ALIVE or DEAD), False = retry later."""
        spec = rec["creation_spec"]
        if rec["state"] == DEAD:
            # kill() landed while the lease was in flight: don't resurrect
            # (or overwrite the kill's death_cause with a lease error) —
            # tear down any worker the raylet just granted.
            if reply.get("granted"):
                try:
                    raylet = await self._raylet_client(node_id)
                    await raylet.notify(
                        "KillWorker",
                        {"worker_id": reply["worker_id"],
                         "reason": "actor killed during creation"},
                    )
                except Exception:
                    pass
            return True
        if not reply.get("granted"):
            if reply.get("error"):
                # Deterministic failure (e.g. runtime_env setup): retrying
                # forever would hang the caller silently — kill the actor
                # with the cause instead.
                rec["state"] = DEAD
                rec["death_cause"] = reply["error"]
                self._publish_actor(actor_id, rec)
                return True
            return False
        worker_addr = tuple(reply["worker_addr"])
        worker_id = reply["worker_id"]
        if not reply.get("created"):
            # Fallback (raylet didn't create during the lease): drive
            # CreateActor over a direct connection as before.
            try:
                worker = await self.pool.get(*worker_addr)
                result = await worker.call(
                    "CreateActor", {"spec": spec, "actor_id": actor_id},
                    timeout=CONFIG.worker_startup_timeout_s,
                )
            except Exception as e:
                logger.warning("actor creation on %s failed: %s", node_id.hex(), e)
                return False
            if not result.get("ok"):
                # Creation raised in __init__: actor is DEAD with the error
                # recorded.
                rec["state"] = DEAD
                rec["death_cause"] = result.get("error", "creation failed")
                self._publish_actor(actor_id, rec)
                return True
        rec.update(
            state=ALIVE, node_id=node_id, worker_id=worker_id, addr=list(worker_addr)
        )
        self._publish_actor(actor_id, rec)
        return True

    def _publish_actor(self, actor_id: bytes, rec: dict):
        # Every state transition flows through here: persist alongside publish.
        _fr.record("actor.state", actor_id, rec["state"])
        self._persist_actor(rec)
        msg = {
            "actor_id": actor_id,
            "state": rec["state"],
            "addr": rec["addr"],
            "num_restarts": rec["num_restarts"],
            "death_cause": rec.get("death_cause", ""),
        }
        self.pubsub.publish("actor", msg)
        self.pubsub.publish(f"actor:{actor_id.hex()}", msg)

    async def _on_actor_worker_lost(self, actor_id: bytes, reason: str):
        rec = self.actors.get(actor_id)
        if rec is None or rec["state"] == DEAD:
            return
        if rec["num_restarts"] < rec["max_restarts"] or rec["max_restarts"] < 0:
            rec["num_restarts"] += 1
            rec["state"] = RESTARTING
            rec["addr"] = None
            self._publish_actor(actor_id, rec)
            self.pending_actor_queue.append(actor_id)
            asyncio.ensure_future(self._schedule_pending_actors())
        else:
            rec["state"] = DEAD
            rec["death_cause"] = reason
            rec["addr"] = None
            self._publish_actor(actor_id, rec)

    async def handle_ReportWorkerDeath(self, req):
        """Raylet tells us a worker process exited; may host an actor."""
        actor_id = req.get("actor_id")
        # Prune the dead worker's GAUGE series: a frozen instantaneous value
        # exported forever poisons aggregations. Counters/histograms stay —
        # they are cumulative totals that remain true.
        wid = req.get("worker_id")
        if wid:
            wid_short = wid.hex()[:12] if isinstance(wid, bytes) else str(wid)[:12]
            for key, rec in list(self.user_metrics.items()):
                if (
                    rec["kind"] == "gauge"
                    and rec["labels"].get("WorkerId") == wid_short
                ):
                    del self.user_metrics[key]
        _fr.record("worker.death", req.get("worker_id") or b"",
                   req.get("reason", "")[:120])
        self._worker_failures.append(
            {"worker_id": req.get("worker_id"), "node_id": req.get("node_id"),
             "time": time.time(), "reason": req.get("reason", "")}
        )
        if actor_id:
            await self._on_actor_worker_lost(actor_id, req.get("reason", "worker died"))
        await self._reap_owned_by(req.get("worker_id"))
        return {"ok": True}

    async def _reap_owned_by(self, worker_id):
        """Ownership fate-sharing (reference: gcs_actor_manager
        OnWorkerDead → destroy owned non-detached actors; PG manager
        cleans up groups whose creator died): kill actors created by the
        dead worker and remove its placement groups."""
        if not worker_id:
            return
        for aid, rec in list(self.actors.items()):
            if (rec.get("owner_worker_id") == worker_id
                    and not rec.get("detached")
                    and rec["state"] != DEAD):
                rec["max_restarts"] = rec["num_restarts"]  # no restarts
                try:
                    await self.handle_KillActor(
                        {"actor_id": aid, "no_restart": True}
                    )
                except Exception:
                    pass
                rec["death_cause"] = "owner worker died"
        for pg_id, pg in list(self.placement_groups.items()):
            if (pg.get("owner_worker_id") == worker_id
                    and pg["state"] != "REMOVED"):
                try:
                    await self.handle_RemovePlacementGroup({"pg_id": pg_id})
                except Exception:
                    pass

    async def handle_GetActorInfo(self, req):
        rec = self.actors.get(req["actor_id"])
        if rec is None:
            return {"found": False}
        out = {k: v for k, v in rec.items() if k != "creation_spec"}
        return {"found": True, "actor": out}

    async def handle_GetActorByName(self, req):
        actor_id = self.named_actors.get((req.get("namespace") or "", req["name"]))
        if actor_id is None:
            return {"found": False}
        return await self.handle_GetActorInfo({"actor_id": actor_id})

    async def handle_ListActors(self, req):
        out = []
        limit = req.get("limit") or 0
        for rec in self.actors.values():
            out.append({k: v for k, v in rec.items() if k != "creation_spec"})
            if limit and len(out) >= limit:
                break
        return {"actors": out}

    async def handle_KillActor(self, req):
        actor_id = req["actor_id"]
        rec = self.actors.get(actor_id)
        if rec is None:
            # Batched (async) registration can arrive AFTER a kill issued
            # right behind `.remote()` on another connection. Tombstone the
            # id so the late registration lands DEAD instead of leaking a
            # live, unkillable actor.
            if req.get("no_restart", True):
                self._kill_tombstones.add(actor_id)
                while len(self._kill_tombstones) > 10_000:
                    self._kill_tombstones.pop()
            return {"ok": False}
        no_restart = req.get("no_restart", True)
        if no_restart:
            rec["max_restarts"] = rec["num_restarts"]  # exhaust restarts
        if rec.get("addr"):
            try:
                worker = await self.pool.get(*rec["addr"])
                await worker.notify("KillActor", {"actor_id": actor_id})
            except Exception:
                pass
        if no_restart:
            rec["state"] = DEAD
            rec["death_cause"] = "killed via kill()"
            name = rec.get("name")
            if name:
                self.named_actors.pop((rec.get("namespace", ""), name), None)
                self._persist("named", [rec.get("namespace", ""), name, None])
            self._publish_actor(actor_id, rec)
        return {"ok": True}

    # -------------------------------------------------------- placement groups

    async def handle_CreatePlacementGroup(self, req):
        pg_id = req["pg_id"]
        self.placement_groups[pg_id] = {
            "pg_id": pg_id,
            "name": req.get("name", ""),
            "strategy": req.get("strategy", "PACK"),
            "bundles": [
                {"index": i, "resources": dict(b), "node_id": None}
                for i, b in enumerate(req["bundles"])
            ],
            "state": "PENDING",
            "job_id": req.get("job_id"),
            "owner_worker_id": req.get("owner_worker_id"),
            "ready_event": None,
        }
        pg = self.placement_groups[pg_id]
        self._persist_pg(pg)
        # Inline first attempt of THIS group only (draining the whole
        # pending queue here would serialize unrelated stuck groups into
        # every create RPC): the ubiquitous create->ready() sequence learns
        # CREATED from this reply and skips its wait round-trip. Infeasible
        # groups fall through fast (placement returns None) and go pending.
        try:
            ok = await self._try_create_pg(pg_id, pg)
        except Exception:
            logger.exception("pg %s inline creation attempt failed",
                             pg_id.hex())
            ok = False
        if not ok and pg["state"] in ("PENDING", "RESCHEDULING"):
            self.pending_pg_queue.append(pg_id)
        return {"ok": True, "state": pg["state"]}

    def _select_pg_nodes(self, pg) -> Optional[List[bytes]]:
        """Choose a node per bundle according to the PG strategy.

        Strategies per reference common.proto:939: PACK, SPREAD, STRICT_PACK,
        STRICT_SPREAD.
        """
        strategy = pg["strategy"]
        bundles = pg["bundles"]
        nodes = {
            nid: dict(self.nodes[nid]["resources_available"])
            for nid in self.alive_nodes()
        }

        def fits(avail, res):
            return all(avail.get(k, 0) >= v for k, v in res.items())

        def take(avail, res):
            for k, v in res.items():
                avail[k] = avail.get(k, 0) - v

        if strategy == "STRICT_PACK":
            for nid, avail in sorted(nodes.items()):
                trial = dict(avail)
                if all(self._fits_take(trial, b["resources"]) for b in bundles):
                    return [nid] * len(bundles)
            return None

        placement: List[Optional[bytes]] = [None] * len(bundles)
        used_nodes: List[bytes] = []
        # Order node preference: pack→most loaded first reuse; spread→rotate.
        order = sorted(nodes.keys())
        for i, b in enumerate(bundles):
            chosen = None
            if strategy in ("SPREAD", "STRICT_SPREAD"):
                pref = [n for n in order if n not in used_nodes] + (
                    [] if strategy == "STRICT_SPREAD" else [n for n in order if n in used_nodes]
                )
            else:  # PACK: prefer already-used nodes
                pref = [n for n in order if n in used_nodes] + [
                    n for n in order if n not in used_nodes
                ]
            for nid in pref:
                if fits(nodes[nid], b["resources"]):
                    chosen = nid
                    break
            if chosen is None:
                return None
            take(nodes[chosen], b["resources"])
            placement[i] = chosen
            if chosen not in used_nodes:
                used_nodes.append(chosen)
        return placement

    @staticmethod
    def _fits_take(avail, res):
        if all(avail.get(k, 0) >= v for k, v in res.items()):
            for k, v in res.items():
                avail[k] = avail.get(k, 0) - v
            return True
        return False

    async def _schedule_pending_pgs(self):
        queue, self.pending_pg_queue = self.pending_pg_queue, []
        for pg_id in queue:
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg["state"] in ("CREATED", "REMOVED"):
                continue
            try:
                ok = await self._try_create_pg(pg_id, pg)
            except Exception:
                logger.exception("pg %s creation attempt failed", pg_id.hex())
                ok = False
            if not ok and self.placement_groups.get(pg_id, {}).get("state") in (
                "PENDING",
                "RESCHEDULING",
            ):
                self.pending_pg_queue.append(pg_id)

    async def _try_create_pg(self, pg_id: bytes, pg) -> bool:
        placement = self._select_pg_nodes(pg)
        if placement is None:
            return False
        # Per-node bundle groups: one PrepareBundles + one CommitBundles RPC
        # per raylet instead of one round-trip per bundle (2PC like
        # reference gcs_placement_group_scheduler.h, batched).
        by_node: Dict[bytes, list] = {}
        for b, n in zip(pg["bundles"], placement):
            by_node.setdefault(n, []).append(b)

        # Phase 1: prepare (reserve), all nodes in parallel. A group hosted
        # entirely by one raylet commits in the same RPC (single-participant
        # 2PC degenerates to 1PC) and skips phase 2.
        one_phase = len(by_node) == 1

        async def _prepare_node(node_id, bundles):
            raylet = await self._raylet_client(node_id)
            r = await raylet.call(
                "PrepareBundles",
                {"items": [
                    {"pg_id": pg_id, "bundle_index": b["index"],
                     "resources": b["resources"]} for b in bundles
                ], "commit": one_phase},
                timeout=10,
            )
            return bool(r.get("ok"))

        node_ids = list(by_node.keys())
        results = await asyncio.gather(
            *(_prepare_node(n, by_node[n]) for n in node_ids),
            return_exceptions=True,
        )
        if not all(r is True for r in results):
            # roll back every successfully-prepared node group (a failed
            # PrepareBundles already rolled its own node back)
            async def _cancel_node(node_id, bundles):
                try:
                    raylet = await self._raylet_client(node_id)
                    for b in bundles:
                        await raylet.notify(
                            "CancelBundle",
                            {"pg_id": pg_id, "bundle_index": b["index"]},
                        )
                except Exception:
                    pass

            await asyncio.gather(*(
                _cancel_node(n, by_node[n])
                for n, r in zip(node_ids, results)
                if r is True
            ))
            return False

        if one_phase:
            for n in node_ids:
                for b in by_node[n]:
                    b["node_id"] = n
            pg["state"] = "CREATED"
            self._persist_pg(pg)
            if pg.get("ready_event") is not None:
                pg["ready_event"].set()
            self.pubsub.publish("pg", {"pg_id": pg_id, "state": "CREATED"})
            asyncio.ensure_future(self._schedule_pending_actors())
            return True

        # Phase 2: commit, in parallel. A commit failure (raylet died between
        # prepare and commit) must roll back the committed/prepared bundles
        # and report failure — NOT raise, or the whole pending queue is lost.
        async def _commit_node(node_id, bundles):
            raylet = await self._raylet_client(node_id)
            r = await raylet.call(
                "CommitBundles",
                {"items": [
                    {"pg_id": pg_id, "bundle_index": b["index"]}
                    for b in bundles
                ]},
                timeout=10,
            )
            if not r.get("ok"):
                raise RuntimeError(f"commit failed on {node_id.hex()}")
            for b in bundles:
                b["node_id"] = node_id

        commit_results = await asyncio.gather(
            *(_commit_node(n, by_node[n]) for n in node_ids),
            return_exceptions=True,
        )
        if any(isinstance(r, BaseException) for r in commit_results):
            async def _rollback(bundle, node_id):
                try:
                    raylet = await self._raylet_client(node_id)
                    # ReturnBundle releases committed state; CancelBundle
                    # covers still-only-prepared bundles. Send both —
                    # raylets treat unknown bundles as no-ops.
                    await raylet.notify(
                        "ReturnBundle",
                        {"pg_id": pg_id, "bundle_index": bundle["index"]},
                    )
                    await raylet.notify(
                        "CancelBundle",
                        {"pg_id": pg_id, "bundle_index": bundle["index"]},
                    )
                except Exception:
                    pass

            await asyncio.gather(*(
                _rollback(b, n) for b, n in zip(pg["bundles"], placement)
            ))
            for bundle in pg["bundles"]:
                bundle["node_id"] = None
            return False
        pg["state"] = "CREATED"
        self._persist_pg(pg)
        if pg.get("ready_event") is not None:
            pg["ready_event"].set()
        self.pubsub.publish("pg", {"pg_id": pg_id, "state": "CREATED"})
        # PG capacity consumed: retry pending actors that wait on it.
        asyncio.ensure_future(self._schedule_pending_actors())
        return True

    async def handle_GetPlacementGroup(self, req):
        pg = self.placement_groups.get(req["pg_id"])
        if pg is None:
            return {"found": False}
        return {"found": True, "pg": {k: v for k, v in pg.items() if k != "ready_event"}}

    async def handle_ListPlacementGroups(self, req):
        pgs = [
            {k: v for k, v in pg.items() if k != "ready_event"}
            for pg in self.placement_groups.values()
        ]
        limit = req.get("limit")
        return {"pgs": pgs[:limit] if limit else pgs}

    async def handle_WaitPlacementGroupReady(self, req):
        pg_id = req["pg_id"]
        deadline = time.time() + req.get("timeout", 60.0)
        while True:
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg["state"] == "REMOVED":
                raise ValueError("placement group removed")
            if pg["state"] == "CREATED":
                return {"ready": True}
            # PENDING / RESCHEDULING: wait for the next state transition.
            # A previous creation may have left the event set (e.g. the PG
            # went CREATED -> node died -> RESCHEDULING); arm a fresh one.
            if pg.get("ready_event") is None or pg["ready_event"].is_set():
                pg["ready_event"] = asyncio.Event()
            left = deadline - time.time()
            if left <= 0:
                return {"ready": False}
            try:
                await asyncio.wait_for(pg["ready_event"].wait(), left)
            except asyncio.TimeoutError:
                return {"ready": False}

    async def handle_RemovePlacementGroup(self, req):
        pg_id = req["pg_id"]
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return {"ok": True}
        for bundle in pg["bundles"]:
            node_id = bundle.get("node_id")
            if node_id and node_id in self.nodes:
                try:
                    raylet = await self._raylet_client(node_id)
                    await raylet.notify(
                        "ReturnBundle", {"pg_id": pg_id, "bundle_index": bundle["index"]}
                    )
                except Exception:
                    pass
        pg["state"] = "REMOVED"
        self._persist_pg(pg)
        if pg.get("ready_event") is not None:
            pg["ready_event"].set()  # wake waiters; they observe REMOVED
        self.pubsub.publish("pg", {"pg_id": pg_id, "state": "REMOVED"})
        return {"ok": True}

    # -------------------------------------------------------------- task events

    async def handle_AddTaskEvents(self, req):
        self.task_events.extend(req["events"])
        overflow = len(self.task_events) - 100_000
        if overflow > 0:
            del self.task_events[:overflow]
        return {"ok": True}

    async def handle_GetTaskEvents(self, req):
        # Filters apply server-side so a large cluster ships N matching
        # events, not the whole 100k-event log sliced client-side. Stored
        # events carry job_id as hex (materialized at flush) — normalize a
        # bytes filter to that form.
        job_id = req.get("job_id")
        if isinstance(job_id, (bytes, bytearray)):
            job_id = job_id.hex()
        trace_id = req.get("trace_id")
        out = [
            e
            for e in self.task_events
            if (job_id is None or e.get("job_id") == job_id)
            and (trace_id is None or e.get("trace_id") == trace_id)
        ]
        limit = req.get("limit", 10_000)
        return {"events": out[-limit:]}

    async def handle_ListTasks(self, req):
        """Server-side fold of the task-event log into latest-state-per-task
        rows (the state API's list_tasks shape), so clients get ``limit``
        tasks over the wire instead of the whole event log.
        ``detail=False`` keeps only the identity/state fields — the fast
        path for dashboards polling task counts."""
        job_id = req.get("job_id")
        latest: Dict[str, dict] = {}
        first_ts: Dict[str, float] = {}
        for ev in self.task_events:
            if ev.get("state") == "SPAN":
                continue  # tracing spans ride the same sink, aren't tasks
            if job_id is not None and ev.get("job_id") != job_id:
                continue
            tid = ev["task_id"]
            first_ts.setdefault(tid, ev["ts"])
            cur = latest.get(tid)
            if cur is None or ev["ts"] >= cur["ts"]:
                latest[tid] = ev
        detail = req.get("detail", True)
        tasks = []
        for ev in latest.values():
            t = {
                "task_id": ev["task_id"],
                "name": ev.get("name", ""),
                "state": ev["state"],
                "job_id": ev.get("job_id", ""),
                "creation_time": first_ts[ev["task_id"]],
                "last_update_time": ev["ts"],
            }
            if detail:
                t["actor_id"] = ev.get("actor_id", "")
                t["node_id"] = ev.get("node_id", "")
                t["worker_id"] = ev.get("worker_id", "")
                t["error_message"] = ev.get("error", "")
            tasks.append(t)
        tasks.sort(key=lambda t: t["creation_time"])
        limit = req.get("limit") or 10_000
        return {"tasks": tasks[:limit], "total": len(tasks)}

    async def handle_GetWorkerFailures(self, req):
        return {"failures": self._worker_failures[-req.get("limit", 1000):]}

    # ------------------------------------------------------------ incidents

    async def handle_ReportIncident(self, req):
        """Stall-watchdog sink: an incident is a structured hang/stall
        report (kind, detail, captured stacks, flight-recorder ring tail)
        published while the problem is still live."""
        inc = dict(req.get("incident") or {})
        inc.setdefault("id", uuid.uuid4().hex[:16])
        inc.setdefault("kind", "unknown")
        inc.setdefault("time", time.time())
        inc.setdefault("status", "open")
        self.incidents.append(inc)
        if len(self.incidents) > 500:
            del self.incidents[: len(self.incidents) - 500]
        _fr.record("incident.open", b"",
                   f"{inc['kind']}: {str(inc.get('detail', ''))[:100]}")
        logger.warning("incident %s [%s] from %s: %s",
                       inc["id"], inc["kind"], inc.get("source", "?"),
                       inc.get("detail", ""))
        self.pubsub.publish("incident", {"id": inc["id"], "kind": inc["kind"]})
        return {"ok": True, "id": inc["id"]}

    async def handle_ListIncidents(self, req):
        """detail=False (default) strips the bulky stacks/ring payloads —
        the shape `ray-tpu-torch status` and dashboards poll; `debug` passes
        detail=True for the full forensics records."""
        limit = req.get("limit") or 100
        out = self.incidents[-limit:]
        if not req.get("detail"):
            out = [
                {k: v for k, v in i.items() if k not in ("stacks", "ring")}
                for i in out
            ]
        return {
            "incidents": out,
            "open": sum(1 for i in self.incidents
                        if i.get("status") == "open"),
        }

    # ------------------------------------------------------------- metrics

    async def handle_ReportUserMetrics(self, req):
        """Workers push ray_tpu_torch.util.metrics records with their task-event
        flush; series are keyed by (name, labels) — the reporter already
        stamped worker/job labels so series never collide across workers."""
        for rec in req.get("records", []):
            key = (rec["name"], tuple(sorted(rec.get("labels", {}).items())))
            cur = self.user_metrics.get(key)
            if cur is None:
                self.user_metrics[key] = cur = {
                    "kind": rec["kind"], "name": rec["name"],
                    "help": rec.get("help", ""), "labels": rec.get("labels", {}),
                    "value": 0.0, "buckets": {}, "count": 0, "sum": 0.0,
                    "boundaries": rec.get("boundaries") or [],
                }
            if rec["kind"] == "gauge":
                cur["value"] = rec["value"]
            elif rec["kind"] == "counter":
                cur["value"] += rec["value"]
            elif rec["kind"] == "histogram":
                for b, c in rec.get("buckets", {}).items():
                    cur["buckets"][b] = cur["buckets"].get(b, 0) + c
                cur["count"] += rec.get("count", 0)
                cur["sum"] += rec.get("sum", 0.0)
        return {"ok": True}

    async def handle_GetUserMetrics(self, req):
        """Structured read of the aggregated user-metric series (the same
        records /metrics renders) so the dashboard's /api/train and
        /api/serve can summarize workload telemetry without scraping and
        re-parsing Prometheus text. Optional name-prefix filter."""
        prefix = req.get("prefix") or ""
        out = []
        for rec in self.user_metrics.values():
            if prefix and not rec["name"].startswith(prefix):
                continue
            out.append({
                "kind": rec["kind"], "name": rec["name"],
                "labels": dict(rec["labels"]), "value": rec["value"],
                "buckets": dict(rec["buckets"]), "count": rec["count"],
                "sum": rec["sum"],
                "boundaries": list(rec.get("boundaries") or []),
            })
        return {"records": out}

    def _collect_metrics(self) -> str:
        from ray_tpu_torch._private.metrics import render_prometheus

        samples = []

        def count_by_state(metric: str, rows):
            by_state: Dict[str, int] = {}
            for r in rows:
                by_state[r["state"]] = by_state.get(r["state"], 0) + 1
            for state, count in by_state.items():
                samples.append((metric, {"state": state}, count))

        count_by_state("ray_tpu_gcs_nodes", self.nodes.values())
        count_by_state("ray_tpu_gcs_actors", self.actors.values())
        count_by_state("ray_tpu_gcs_placement_groups", self.placement_groups.values())
        count_by_state("ray_tpu_gcs_jobs", self.jobs.values())
        samples.append(("ray_tpu_gcs_task_events_buffered", {}, len(self.task_events)))
        samples.append((
            "ray_tpu_gcs_incidents_open", {},
            sum(1 for i in self.incidents if i.get("status") == "open"),
        ))
        samples.append(("ray_tpu_gcs_uptime_seconds", {}, time.time() - self.start_time))
        # user metrics (util/metrics.py)
        for rec in self.user_metrics.values():
            if rec["kind"] == "histogram":
                cumulative = 0
                for b in rec.get("boundaries", []):
                    cumulative += rec["buckets"].get(str(b), 0)
                    samples.append(
                        (f"{rec['name']}_bucket", {**rec["labels"], "le": str(b)}, cumulative)
                    )
                # Prometheus requires le="+Inf" == count.
                samples.append(
                    (f"{rec['name']}_bucket", {**rec["labels"], "le": "+Inf"}, rec["count"])
                )
                samples.append((f"{rec['name']}_count", rec["labels"], rec["count"]))
                samples.append((f"{rec['name']}_sum", rec["labels"], rec["sum"]))
            else:
                samples.append((rec["name"], rec["labels"], rec["value"]))
        return render_prometheus(samples)

    async def handle_DumpFlightRecorder(self, req):
        """The control plane's own ring — `ray-tpu-torch debug dump` includes it
        so a GCS-side stall (scheduling wedged, pubsub dead) is visible in
        the same archive as the data-plane rings."""
        return {"pid": os.getpid(), "events": _fr.dump(req.get("limit") or 0)}

    async def handle_StartProfile(self, req):
        """Profiling plane: the GCS samples itself alongside the raylets —
        a control-plane bottleneck (actor-creation storm, pubsub fan-out)
        shows up in the same merged timeline as the data plane."""
        from ray_tpu_torch._private import sampling_profiler as _sp

        try:
            _sp.start_profile(
                req.get("duration", 2.0), req.get("hz", 99.0), role="gcs")
        except RuntimeError as e:
            return {"error": str(e), "pid": os.getpid()}
        return {"ok": True, "pid": os.getpid()}

    async def handle_CollectProfile(self, req):
        from ray_tpu_torch._private import sampling_profiler as _sp

        loop = asyncio.get_running_loop()
        profile = await loop.run_in_executor(None, _sp.collect_profile)
        if profile is None:
            return {"error": "no profile capture in progress",
                    "pid": os.getpid()}
        return {"profile": profile, "pid": os.getpid()}

    async def handle_Ping(self, req):
        return {
            "ok": True,
            "uptime": time.time() - self.start_time,
            "metrics_port": getattr(self, "metrics_port", 0),
        }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--session-dir", default="")
    parser.add_argument("--port-file", default="")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from ray_tpu_torch._private.proc_profile import maybe_enable_process_profile
    maybe_enable_process_profile("gcs")

    async def run():
        server = GcsServer(args.host, args.session_dir)
        port = await server.start(args.port)
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, args.port_file)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
