"""Raylet — the per-node agent: worker pool, leases, local scheduling, object plane.

Counterpart of the reference's raylet/NodeManager
(reference: src/ray/raylet/node_manager.h:119, main.cc:123). One asyncio loop
runs: the lease protocol (RequestWorkerLease/ReturnWorker — reference:
node_manager.cc:1794), placement-group bundle 2PC
(reference: placement_group_resource_manager.h), the node-to-node object
manager (pull + chunked fetch — reference: object_manager/object_manager.cc),
worker lifecycle (spawn/reap, death reports to GCS), heartbeats and resource
reports. The plasma segment for the node is created here and shared with every
worker on the host.

Scheduling is the reference's two-level design: owners cache leases per
scheduling key and push tasks worker-to-worker; the raylet only places
*leases*, locally when it can, spilling to a peer picked from the
GCS-maintained cluster view otherwise (hybrid pack-then-spread policy,
reference: raylet/scheduling/policy/hybrid_scheduling_policy.cc).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._native.plasma import PlasmaClient, PlasmaOOM
from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private import chaos as _chaos
from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private import runtime_env as renv
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.gcs.client import GcsAioClient
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.raylet.resources import ResourceSet
from ray_tpu_torch._private.raylet.worker_pool import WorkerPool
from ray_tpu_torch._private.rpc import ClientPool, OobPayload, RpcServer

import msgpack

logger = logging.getLogger("ray_tpu_torch.raylet")


class NodeManager:
    def __init__(
        self,
        node_id: NodeID,
        host: str,
        gcs_address: str,
        resources: Dict[str, float],
        labels: Dict[str, str],
        session_dir: str,
        is_head: bool = False,
        object_store_memory: Optional[int] = None,
    ):
        self.node_id = node_id
        self.host = host
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self.is_head = is_head
        self.server = RpcServer(host)
        from ray_tpu_torch._private import schema as _schema

        self.server.set_validator(_schema.make_validator(_schema.RAYLET_SCHEMAS))
        gcs_host, gcs_port = gcs_address.rsplit(":", 1)
        self.gcs = GcsAioClient(gcs_host, int(gcs_port))
        self.pool = ClientPool()

        self.total = ResourceSet(resources)
        self.available = ResourceSet(resources)
        self.labels = labels
        self._resources_dirty = True
        # Per-instance accelerator IDs (reference: scheduling_ids.h:162 —
        # GPU_0-style instances; here GPU indices). Integer-GPU leases get
        # specific cards via CUDA_VISIBLE_DEVICES (mapped through this
        # raylet's own CUDA_VISIBLE_DEVICES) so two concurrent workers never
        # see the same card; fractional and zero demands share the node's
        # view. Indices return here when the lease ends.
        self._free_gpus: List[int] = list(range(int(resources.get("GPU", 0))))

        self.plasma_name = f"/rtpu_torch_plasma_{node_id.hex()[:12]}"
        self.plasma = PlasmaClient(
            self.plasma_name,
            capacity=object_store_memory or CONFIG.object_store_memory,
            create=True,
        )

        self.worker_pool: Optional[WorkerPool] = None  # needs our port first

        # lease_id -> {"worker_id", "resources": ResourceSet, "bundle": key|None}
        self.leases: Dict[bytes, dict] = {}
        self._lease_seq = 0
        # queued lease requests waiting for local resources, FIFO. Releases
        # coalesce into one _lease_grant_pass per loop tick (no per-release
        # thundering herd); a waiter skipped lease_starvation_passes times
        # becomes a barrier later overlapping requests cannot leapfrog.
        self._lease_waiters: List[dict] = []
        self._lease_pass_scheduled = False
        self._starve_limit = max(1, CONFIG.lease_starvation_passes)
        # plasma-backed submit rings (one per attached submitter):
        # ring object id -> {consumer, backlog, idle leases, ...}
        self._rings: Dict[bytes, dict] = {}
        self._ring_event: Optional[asyncio.Event] = None
        self._ring_task = None
        # (pg_id, bundle_index) -> {"reserved": ResourceSet, "available": ResourceSet,
        #                            "committed": bool}
        self.bundles: Dict[Tuple[bytes, int], dict] = {}
        # worker_id -> actor_id for dedicated actor workers
        self._actor_workers: Dict[bytes, bytes] = {}
        self._job_sys_path_cache: Dict[bytes, list] = {}
        self._fn_blob_cache: Dict[bytes, bytes] = {}
        # cluster view: node_id -> info (from GCS)
        self.cluster_view: Dict[bytes, dict] = {}
        self._autoscaler_active = False
        # object pulls in flight: object_id bytes -> asyncio.Event
        self._pulls: Dict[bytes, asyncio.Event] = {}
        self._recv: Dict[bytes, dict] = {}  # inbound pushes mid-transfer
        # Explicit guard for the _recv landing counters: chunk sinks run on
        # reactor shard threads (ReceiveChunk is shard-safe) while aborts
        # run on the home loop — the counter read-modify-writes must not
        # rely on single-loop serialization anymore.
        import threading as _threading

        self._recv_lock = _threading.Lock()
        self._venv_locks: Dict[str, asyncio.Lock] = {}
        self._venv_jobs: Dict[str, set] = {}  # venv hash -> jobs using it
        # pinned primary copies: object_id bytes -> memoryview
        self._pinned: Dict[bytes, memoryview] = {}
        # spilled primaries: object_id bytes -> (path, size). A spilled object
        # may ALSO be in plasma (restored); then re-spilling is a free drop.
        # (reference: raylet/local_object_manager.h:41 spill/restore)
        self._spilled: Dict[bytes, Tuple[str, int]] = {}
        self._spill_dir = os.path.join(
            session_dir or ".", f"spilled_{node_id.hex()[:12]}"
        )
        self._spill_lock = asyncio.Lock()
        # worker_id -> reason, for deaths we caused (OOM kills)
        self._kill_reasons: Dict[bytes, str] = {}
        # --- memory observability plane --------------------------------
        # object_id -> ownership attribution shipped with PinObject
        # ({owner_addr, job_id, actor_id, task_id, callsite, size, t});
        # joined against _pinned/_spilled by GetMemoryReport and the leak
        # sweep, dropped with the object in FreeObjects.
        self._pin_meta: Dict[bytes, dict] = {}
        # leak detector state: first-unowned-seen time per candidate, the
        # confirmed-leak records (still present), and ids already reported
        self._leak_candidates: Dict[bytes, float] = {}
        self._leaks: Dict[bytes, dict] = {}
        self._leak_fired: set = set()
        self._last_leak_incident = 0.0
        # OOM forensics: live-grabbed memory report of a worker we are
        # about to kill (worker_id -> report), attached to its death report
        self._death_memory: Dict[bytes, dict] = {}
        self._bg = []
        try:
            import psutil

            psutil.cpu_percent(interval=None)  # prime: first call reads 0.0
        except Exception:
            pass

    # ------------------------------------------------------------- lifecycle

    async def start(self, port: int = 0) -> int:
        self.server.register_all(self)
        # Inbound push chunks stream from the socket straight into the
        # pre-created plasma buffer at their offset (zero intermediate
        # buffering) — see _receive_chunk_sink.
        self.server.set_oob_sink("ReceiveChunk", self._receive_chunk_sink)
        # Sharded-reactor dispatch contract (rpc.py docstring): handlers
        # default to the home loop so the lease/bundle/lifecycle state
        # above keeps its single-threaded invariants; only the bulk
        # data-plane methods — whose state is either read-only here or
        # guarded by the plasma store's native in-segment mutex and the
        # _recv landing counters — run directly on a connection's shard.
        self.server.set_shard_safe(
            {"Ping", "ReceiveChunk", "FetchChunk", "FetchObjectInfo"})
        port = await self.server.start(port)
        self.port = port
        self.worker_pool = WorkerPool(
            self.node_id.binary(),
            (self.host, port),
            self.gcs_address,
            self.plasma_name,
            self.session_dir,
            on_worker_death=self._on_worker_death,
        )
        # Warm the fork server immediately so the first lease forks in ~ms
        # (reference: worker_pool.h:359 PrestartWorkers).
        asyncio.ensure_future(self.worker_pool._ensure_fork_server())
        try:
            from ray_tpu_torch._private.metrics import start_metrics_http_server

            self._metrics_server, self.metrics_port = await start_metrics_http_server(
                self.host, self._collect_metrics
            )
        except Exception:
            logger.exception("metrics endpoint failed to start")
            self.metrics_port = 0
        await self._register_node()
        # Chaos plane: arm from the env plan or the one the driver
        # published to GCS KV, so this raylet replays the cluster schedule.
        try:
            if CONFIG.chaos_plan:
                _chaos.load_plan(CONFIG.chaos_plan)
            else:
                plan = await self.gcs.kv_get(b"chaos", b"plan")
                if plan:
                    _chaos.load_plan(plan)
        except Exception:
            pass
        if CONFIG.dashboard_agent:
            try:
                self._spawn_agent()
            except Exception:
                logger.exception("dashboard agent failed to start")
        self._bg.append(asyncio.ensure_future(self._heartbeat_loop()))
        self._bg.append(asyncio.ensure_future(self._reaper_loop()))
        self._bg.append(asyncio.ensure_future(self._cluster_view_loop()))
        self._bg.append(asyncio.ensure_future(self._spill_loop()))
        self._bg.append(asyncio.ensure_future(self._memory_monitor_loop()))
        if CONFIG.memory_leak_sweep_period_s > 0:
            self._bg.append(asyncio.ensure_future(self._leak_sweep_loop()))
        self._bg.append(asyncio.ensure_future(self._log_monitor_loop()))
        if CONFIG.watchdog_interval_s > 0:
            self._bg.append(asyncio.ensure_future(self._watchdog_loop()))
        if self.session_dir:
            try:
                _fr.install_exit_dump(os.path.join(
                    self.session_dir, "logs",
                    f"flight_raylet-{os.getpid()}.jsonl"))
            except Exception:
                pass
        logger.info(
            "raylet %s on %s:%s resources=%s",
            self.node_id.hex()[:12], self.host, port, self.total.to_dict(),
        )
        return port

    async def _register_node(self):
        await self.gcs.call(
            "RegisterNode",
            {
                "node_id": self.node_id.binary(),
                "ip": self.host,
                "raylet_port": self.port,
                "plasma_name": self.plasma_name,
                "resources": self.total.to_dict(),
                "labels": self.labels,
                "is_head": self.is_head,
                "metrics_port": getattr(self, "metrics_port", 0),
            },
        )

    def _collect_metrics(self) -> str:
        """Prometheus samples for this node (reference: stats/metric_defs.cc
        resource/object-store/scheduler gauges)."""
        from ray_tpu_torch._private.metrics import render_prometheus

        node = self.node_id.hex()[:12]
        samples = []
        for k, v in self.total.to_dict().items():
            samples.append(
                ("ray_tpu_node_resource_total", {"node": node, "resource": k}, v)
            )
        for k, v in self.available.to_dict().items():
            samples.append(
                ("ray_tpu_node_resource_available", {"node": node, "resource": k}, v)
            )
        idle = self.worker_pool.num_idle()
        total_workers = len(self.worker_pool.workers)
        samples.append(("ray_tpu_node_workers", {"node": node, "state": "idle"}, idle))
        samples.append(
            ("ray_tpu_node_workers", {"node": node, "state": "leased"},
             max(0, total_workers - idle))
        )
        samples.append(("ray_tpu_node_leases", {"node": node}, len(self.leases)))
        samples.append(
            ("ray_tpu_node_pg_bundles", {"node": node}, len(self.bundles))
        )
        try:
            s = self.plasma.stats()
            samples.append(("ray_tpu_object_store_used_bytes", {"node": node}, s["used_bytes"]))
            samples.append(("ray_tpu_object_store_capacity_bytes", {"node": node}, s["capacity_bytes"]))
            samples.append(("ray_tpu_object_store_num_objects", {"node": node}, s["num_objects"]))
            samples.append(("ray_tpu_object_store_evicted_bytes", {"node": node}, s["evicted_bytes"]))
        except Exception:
            pass
        samples.append(("ray_tpu_spilled_objects", {"node": node}, len(self._spilled)))
        samples.append(
            ("ray_tpu_spilled_bytes", {"node": node},
             sum(size for _, size in self._spilled.values()))
        )
        samples.append(("ray_tpu_pulls_in_flight", {"node": node}, len(self._pulls)))
        # memory observability plane (stability contract, util/metrics.py)
        samples.append(
            ("ray_tpu_object_store_pinned_bytes", {"node": node},
             sum(v.nbytes for v in self._pinned.values()))
        )
        samples.append(
            ("ray_tpu_object_store_leaked_bytes", {"node": node},
             sum(r["size"] for r in self._leaks.values()))
        )
        try:
            from ray_tpu_torch._private import memory_report as _mr

            samples.append(
                ("ray_tpu_memory_rss_bytes", {"node": node, "role": "raylet"},
                 _mr.process_rss())
            )
            samples.append(
                ("ray_tpu_memory_rss_bytes", {"node": node, "role": "worker"},
                 sum(_mr.process_rss(h.pid)
                     for h in self.worker_pool.workers.values() if h.pid))
            )
            agent_pid = getattr(getattr(self, "_agent_proc", None), "pid", None)
            if agent_pid:
                samples.append(
                    ("ray_tpu_memory_rss_bytes",
                     {"node": node, "role": "agent"},
                     _mr.process_rss(agent_pid))
                )
        except Exception:
            pass
        # per-node host stats (reference: dashboard reporter_agent.py:314
        # psutil cpu/mem/per-worker probes)
        try:
            import psutil

            samples.append(
                ("ray_tpu_node_cpu_percent", {"node": node},
                 psutil.cpu_percent(interval=None))
            )
            vm = psutil.virtual_memory()
            samples.append(
                ("ray_tpu_node_mem_used_bytes", {"node": node}, vm.used)
            )
            samples.append(
                ("ray_tpu_node_mem_total_bytes", {"node": node}, vm.total)
            )
            for h in self.worker_pool.workers.values():
                try:
                    rss = psutil.Process(h.pid).memory_info().rss
                except Exception:
                    continue
                samples.append(
                    ("ray_tpu_worker_rss_bytes",
                     {"node": node, "pid": str(h.pid)}, rss)
                )
        except Exception:
            pass
        return render_prometheus(samples)

    async def _heartbeat_loop(self):
        period = CONFIG.health_check_period_ms / 1000.0
        report_period = CONFIG.resource_report_period_ms / 1000.0
        last_report = 0.0
        last_pending: List[dict] = []
        while True:
            try:
                if _chaos.ARMED:
                    act = _chaos.hit("raylet.heartbeat",
                                     node=self.node_id.hex())
                    if act is not None:
                        if act["action"] == "delay":
                            await asyncio.sleep(act["delay_s"])
                        elif act["action"] == "drop":
                            await asyncio.sleep(period)
                            continue  # one silent beat
                beat = await self.gcs.call(
                    "Heartbeat", {"node_id": self.node_id.binary()}, timeout=10
                )
                if beat is not None:
                    self._autoscaler_active = beat.get("autoscaler_active", False)
                    if not beat.get("known", True):
                        # The GCS restarted without our registration
                        # (persistence off or state lost): re-register so
                        # the cluster resumes.
                        logger.warning("GCS lost our registration; re-registering")
                        await self._register_node()
                        self._resources_dirty = True
                now = time.time()
                pending = [dict(w["resources"]) for w in self._lease_waiters
                           if "resources" in w]
                if (
                    self._resources_dirty
                    or pending != last_pending  # incl. drain-to-empty: a
                    # stale pending report makes the autoscaler double-launch
                    or now - last_report > report_period * 4
                ):
                    last_pending = pending
                    await self.gcs.notify(
                        "ReportResources",
                        {
                            "node_id": self.node_id.binary(),
                            "available": self.available.to_dict(),
                            "total": self.total.to_dict(),
                            "pending_demands": pending,
                            "num_leases": len(self.leases),
                            "num_workers": len(self.worker_pool.workers),
                        },
                    )
                    self._resources_dirty = False
                    last_report = now
            except Exception:
                pass
            await asyncio.sleep(min(period, report_period))

    async def _refresh_cluster_view(self):
        nodes = await self.gcs.get_all_node_info()
        new_view = {n["node_id"]: n for n in nodes if n["state"] == "ALIVE"}
        grew = set(new_view) - set(self.cluster_view)
        self.cluster_view = new_view
        if grew:
            # New capacity (e.g. autoscaler launch): re-evaluate queued
            # lease requests so they can spill to it (full wake — waiters
            # must re-run spill logic, not just retry a local acquire).
            self._kick_waiters(wake_all=True)

    async def _cluster_view_loop(self):
        """Push-based cluster view (reference: RaySyncer resource broadcast,
        common/ray_syncer/ray_syncer.h:88 — bidirectional gRPC streams; here
        the GCS pubsub 'node'/'resources' channels drained with batched
        long-polls). Full refetches happen only on membership growth, GCS
        epoch change, or a slow 15s safety net — not on a fixed 500ms poll.
        """
        sub_id = b"raylet-view:" + self.node_id.binary()
        subscribed = False
        epoch = None
        last_full = 0.0
        while True:
            try:
                if not subscribed:
                    for ch in ("node", "resources"):
                        r = await self.gcs.call(
                            "Subscribe", {"sub_id": sub_id, "channel": ch},
                            timeout=10,
                        )
                        # baseline the epoch from the subscribe reply so a
                        # GCS restart before the first poll is detected
                        epoch = r.get("epoch", epoch)
                    subscribed = True
                    await self._refresh_cluster_view()
                    last_full = time.time()
                reply = await self.gcs.call(
                    "PubsubPoll", {"sub_id": sub_id, "timeout": 10.0},
                    timeout=30,
                )
                new_epoch = reply.get("epoch")
                if epoch is not None and new_epoch != epoch:
                    # GCS restarted: its subscriber table is gone
                    subscribed = False
                    epoch = new_epoch
                    continue
                epoch = new_epoch
                refresh = False
                for channel, msg in reply.get("batch", []):
                    if channel == "node":
                        if msg.get("state") == "DEAD":
                            self.cluster_view.pop(msg["node_id"], None)
                        else:
                            refresh = True  # new node: fetch its full record
                    elif channel == "resources":
                        info = self.cluster_view.get(msg["node_id"])
                        if info is not None:
                            info["resources_available"] = msg["available"]
                            info["resources_total"] = msg["total"]
                            info["num_leases"] = msg.get(
                                "num_leases", info.get("num_leases", 0))
                            info["num_workers"] = msg.get(
                                "num_workers", info.get("num_workers", 0))
                if refresh or time.time() - last_full > 15.0:
                    await self._refresh_cluster_view()
                    last_full = time.time()
            except Exception:
                subscribed = False
                await asyncio.sleep(0.5)

    async def _reaper_loop(self):
        while True:
            await asyncio.sleep(1.0)
            try:
                self.worker_pool.reap_idle()
                self.worker_pool.check_liveness()
                self._check_agent()
                _fr.flush_to_file()
            except Exception:
                logger.exception("reaper error")

    # ----------------------------------------------------- stall watchdog

    async def _watchdog_loop(self):
        """Raylet-side stall watchdog: probe every leased worker's
        live-RUNNING registry (GetCoreWorkerStats) and fire one incident
        per task that has been executing past
        ``RTPU_TORCH_watchdog_task_timeout_s`` — with the worker's stacks and
        this node's flight-recorder tail captured while the hang is live.
        Lease age alone is NOT the signal (actor workers hold their lease
        for the actor's whole life); the executing-task age is.
        watchdog.py is the driver-side counterpart — the raylet also sees
        hangs whose owner/driver is itself wedged."""
        from ray_tpu_torch._private import watchdog as _wd

        fired: set = set()  # task_ids already reported
        interval = CONFIG.watchdog_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                timeout = CONFIG.watchdog_task_timeout_s
                seen: set = set()
                for h in list(self.worker_pool.workers.values()):
                    if not (h.alive and h.leased and h.addr[1]):
                        continue
                    try:
                        client = await self.pool.get(*h.addr)
                        stats = await client.call(
                            "GetCoreWorkerStats", {}, timeout=5)
                    except Exception:
                        continue
                    for rt in stats.get("running_tasks", []):
                        task_id = rt.get("task_id", b"")
                        seen.add(task_id)
                        if rt.get("age", 0) <= timeout or task_id in fired:
                            continue
                        fired.add(task_id)
                        await self._fire_stuck_task_incident(_wd, h, rt)
                fired &= seen  # resolved tasks leave; the set stays bounded
            except Exception:
                logger.exception("raylet watchdog error")

    async def _fire_stuck_task_incident(self, _wd, handle, rt: dict):
        worker_id = handle.worker_id
        task_id = rt.get("task_id", b"")
        _fr.record("watchdog.fire", task_id, "stuck_task")
        stacks = []
        try:
            r = await self.handle_ProfileWorker(
                {"worker_id": worker_id, "duration": 0.5})
            stacks.append({
                "target": f"worker:{worker_id.hex()[:12]}",
                "folded": r.get("folded", ""),
                "error": r.get("error", ""),
            })
        except Exception as e:
            stacks.append({"target": f"worker:{worker_id.hex()[:12]}",
                           "folded": "", "error": str(e)})
        actor_id = self._actor_workers.get(worker_id)
        incident = _wd.build_incident(
            "stuck_task", "raylet",
            f"task {rt.get('name', '?')} has been RUNNING for "
            f"{rt.get('age', 0):.0f}s on worker {worker_id.hex()[:12]} "
            f"(pid {handle.pid})"
            + (f", actor {actor_id.hex()[:12]}" if actor_id else ""),
            node_id=self.node_id.hex(),
            worker_id=worker_id.hex(),
            task_id=task_id.hex() if isinstance(task_id, bytes) else "",
            task_name=rt.get("name", ""),
            stacks=stacks,
        )
        try:
            await self.gcs.call(
                "ReportIncident", {"incident": incident}, timeout=10)
        except Exception:
            pass

    # ------------------------------------------------- per-node agent child

    def _spawn_agent(self):
        """Launch the per-node dashboard agent beside this raylet
        (reference: dashboard/agent.py:25 — the raylet starts agent.py and
        the head fans node-scoped work out to it)."""
        import subprocess
        import sys as _sys

        log_dir = self.session_dir or "."
        out = open(os.path.join(
            log_dir, f"agent_{self.node_id.hex()[:12]}.log"), "ab")
        self._agent_proc = subprocess.Popen(
            [_sys.executable, "-m", "ray_tpu_torch.dashboard.agent",
             "--gcs-address", self.gcs_address,
             "--node-id", self.node_id.hex(),
             "--raylet-port", str(self.port),
             "--session-dir", self.session_dir or "",
             "--host", self.host,
             "--raylet-pid", str(os.getpid())],
            stdout=out, stderr=subprocess.STDOUT,
        )
        out.close()

    def _check_agent(self):
        """Agent death detection: report to the GCS failure log (visible in
        GetWorkerFailures / the dashboard) and restart, capped — a
        crash-looping agent must not fork forever."""
        proc = getattr(self, "_agent_proc", None)
        if proc is None or proc.poll() is None:
            return
        rc = proc.returncode
        self._agent_proc = None
        asyncio.ensure_future(self.gcs.notify(
            "ReportWorkerDeath",
            {"worker_id": b"agent-" + self.node_id.binary(),
             "node_id": self.node_id.binary(), "actor_id": None,
             "reason": f"dashboard agent exited with code {rc}"},
        ))
        self._agent_restarts = getattr(self, "_agent_restarts", 0) + 1
        if self._agent_restarts <= 3:
            logger.warning(
                "dashboard agent died (rc=%s); restart %d/3",
                rc, self._agent_restarts)
            self._spawn_agent()
        else:
            logger.error("dashboard agent died (rc=%s); restart cap hit", rc)
            asyncio.ensure_future(self._deregister_agent())

    async def _deregister_agent(self):
        """Drop the agent's KV entry so head fan-outs stop burning connect
        timeouts on a dead address."""
        try:
            await self.gcs.call(
                "KVDel", {"ns": b"agents", "key": self.node_id.hex().encode()},
                timeout=5)
        except Exception:
            pass

    async def _on_worker_death(self, handle):
        # release any leases held by this worker
        for lease_id, lease in list(self.leases.items()):
            if lease["worker_id"] == handle.worker_id:
                self._release_lease(lease_id)
        actor_id = self._actor_workers.pop(handle.worker_id, None)
        rc = handle.returncode
        kill_reason = self._kill_reasons.pop(handle.worker_id, None)
        reason = kill_reason or f"exit code {rc}"
        _fr.record("worker.death", handle.worker_id, reason[:120])
        # An UNATTRIBUTED signal death (no recorded kill reason, not a
        # pool-initiated kill, not shutdown) is a crash worth an incident:
        # chaos kills, segfaults, external OOM killers. Intentional kills —
        # ray_tpu_torch.kill, memory-monitor OOM, idle reap, scale-down — all
        # record a reason or mark the handle first, so they stay
        # incident-free and the chaos suite can assert exactly one
        # worker_crash incident per induced kill.
        if (kill_reason is None and isinstance(rc, int) and rc < 0
                and not getattr(handle, "expected_death", False)
                and not getattr(self, "_draining", False)
                and CONFIG.incident_on_worker_crash):
            asyncio.ensure_future(self._report_worker_crash(
                handle, actor_id, rc))
        # Forensics: the dead worker's flight-recorder file (incrementally
        # appended while it lived, so it exists even after SIGKILL) — its
        # tail rides the death report into death_cause / ActorDiedError, so
        # "what was it doing when it died" is IN the error the caller sees.
        tail = self._worker_flight_tail(handle.pid)
        if tail:
            reason = f"{reason}\nlast flight-recorder events of the worker:\n{tail}"
        # OOM forensics: the worker's final memory report — live-grabbed by
        # the memory monitor just before an OOM kill, else the periodic
        # on-disk snapshot (survives SIGKILL, same pattern as the flight
        # tail) — rides the death report into ActorDiedError, so "what was
        # resident when it died" is IN the error the caller sees.
        mem_tail = self._worker_memory_tail(handle)
        if mem_tail:
            reason = f"{reason}\nmemory snapshot at death (top holders):\n{mem_tail}"
        await self.gcs.notify(
            "ReportWorkerDeath",
            {
                "worker_id": handle.worker_id,
                "node_id": self.node_id.binary(),
                "actor_id": actor_id,
                "reason": reason,
            },
        )

    async def _report_worker_crash(self, handle, actor_id, rc: int):
        """Publish a worker_crash incident for an unattributed signal
        death (see _on_worker_death). Attribution: node, pid, signal,
        actor id, plus the worker's flight tail."""
        try:
            from ray_tpu_torch._private.watchdog import build_incident

            detail = f"worker pid={handle.pid} died by signal {-rc}"
            if actor_id:
                detail += f" (actor {bytes(actor_id).hex()[:12]})"
            tail = self._worker_flight_tail(handle.pid)
            if tail:
                detail += f"\nlast flight-recorder events:\n{tail}"
            inc = build_incident(
                "worker_crash", "raylet", detail,
                node_id=self.node_id.hex(),
                worker_id=bytes(handle.worker_id).hex()
                if handle.worker_id else "",
            )
            inc["pid"] = handle.pid
            await self.gcs.call("ReportIncident", {"incident": inc},
                                timeout=10)
        except Exception:
            pass

    def _worker_memory_tail(self, handle) -> str:
        from ray_tpu_torch._private import memory_report as _mr

        report = self._death_memory.pop(handle.worker_id, None)
        if report is None and handle.pid and self.session_dir:
            report = _mr.read_snapshot(self.session_dir, handle.pid)
        if not report:
            return ""
        try:
            return _mr.format_top_holders(report)[:1500]
        except Exception:
            return ""

    def _worker_flight_tail(self, pid, limit: int = 8) -> str:
        if not pid or not self.session_dir:
            return ""
        path = os.path.join(self.session_dir, "logs",
                            f"flight_worker-{pid}.jsonl")
        try:
            events = _fr.read_tail_file(path, limit=limit)
        except Exception:
            return ""
        return _fr.format_tail(events)[:1500]

    # ------------------------------------------------------ resource helpers

    def _pool_for(self, strategy: dict):
        """Returns (acquire_set, bundle_key) — PG tasks draw from their bundle."""
        if strategy.get("type") == "placement_group":
            key = (strategy["pg_id"], strategy.get("bundle_index") or 0)
            bundle = self.bundles.get(key)
            if bundle is None or not bundle["committed"]:
                return None, key
            return bundle["available"], key
        return self.available, None

    def _try_acquire(self, resources: Dict[str, float], strategy: dict):
        demand = ResourceSet(resources)
        pool, bundle_key = self._pool_for(strategy)
        if pool is None:
            return None
        if pool.acquire(demand):
            self._resources_dirty = True
            return {"demand": demand, "bundle": bundle_key}
        return None

    def _allocate_gpus(self, num_gpu: float) -> Optional[List[int]]:
        """Assign specific GPU indices to an integer-GPU lease; None when the
        demand is fractional/zero (worker then sees the node default)."""
        if num_gpu <= 0 or num_gpu != int(num_gpu):
            return None
        n = int(num_gpu)
        if len(self._free_gpus) < n:
            return None
        gpus, self._free_gpus = self._free_gpus[:n], self._free_gpus[n:]
        return gpus

    def _release_lease(self, lease_id: bytes):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        _fr.record("lease.return", lease_id, lease["worker_id"].hex()[:12])
        if lease.get("gpus"):
            self._free_gpus.extend(lease["gpus"])
            self._free_gpus.sort()
        if lease["bundle"] is not None:
            bundle = self.bundles.get(lease["bundle"])
            if bundle is not None:
                bundle["available"].release(lease["grant"]["demand"])
        else:
            self.available.release(lease["grant"]["demand"])
        self._resources_dirty = True
        self._kick_waiters()
        if self._rings and self._ring_event is not None:
            # freed capacity may unblock a ring backlog
            self._ring_event.set()

    def _kick_waiters(self, wake_all: bool = False):
        """Lease-grant batching: resource releases coalesce into ONE FIFO
        scheduling pass per loop tick (K concurrent drivers' releases cost
        one pass over the queue, not K thundering-herd wakeups that each
        re-run the whole feasibility check). ``wake_all`` keeps the legacy
        wake-everything behavior for topology changes — a new node or a
        returned/removed bundle — where waiters must re-run their full
        spill/PG logic, not just retry a local acquire."""
        if not self._lease_waiters:
            return
        if wake_all:
            waiters, self._lease_waiters = self._lease_waiters, []
            for w in waiters:
                w["event"].set()
            return
        if not self._lease_pass_scheduled:
            self._lease_pass_scheduled = True
            asyncio.get_running_loop().call_soon(self._lease_grant_pass)

    def _lease_grant_pass(self):
        """One batched scheduling pass over ``_lease_waiters`` in FIFO
        order: acquire resources for every waiter that now fits and wake
        only those. Fairness: a waiter skipped ``lease_starvation_passes``
        times becomes a barrier — no later waiter with overlapping demand
        may leapfrog it, so a large request can't be starved indefinitely
        by a stream of small ones that fit first."""
        self._lease_pass_scheduled = False
        waiters = self._lease_waiters
        if not waiters:
            return
        remaining: List[dict] = []
        barriers: List[dict] = []
        for w in waiters:
            if w["event"].is_set():
                continue  # woken elsewhere; handler will clean up
            if any(self._demands_overlap(b, w) for b in barriers):
                remaining.append(w)
                continue
            grant = self._try_acquire(w["res"], w["strat"])
            if grant is not None:
                w["grant"] = grant
                w["event"].set()
                continue
            w["skips"] += 1
            if w["skips"] >= self._starve_limit:
                barriers.append(w)
            remaining.append(w)
        self._lease_waiters = remaining

    @staticmethod
    def _demands_overlap(a: dict, b: dict) -> bool:
        """Do two queued lease demands draw from the same pool/resources?
        (the unit of the starvation barrier)"""
        a_pg = a["strat"].get("type") == "placement_group"
        b_pg = b["strat"].get("type") == "placement_group"
        if a_pg != b_pg:
            return False
        if a_pg:
            return (a["strat"]["pg_id"], a["strat"].get("bundle_index") or 0) \
                == (b["strat"]["pg_id"], b["strat"].get("bundle_index") or 0)
        return any(v > 0 and b["res"].get(k, 0) > 0
                   for k, v in a["res"].items())

    def _blocked_by_starving(self, resources: Dict[str, float],
                             strategy: dict) -> bool:
        """Fresh lease requests must not leapfrog a starving queued waiter
        with overlapping demand — they queue behind it instead."""
        if not self._lease_waiters:
            return False
        probe = {"res": resources, "strat": strategy}
        return any(w["skips"] >= self._starve_limit
                   and self._demands_overlap(w, probe)
                   for w in self._lease_waiters)

    def _waiter_abandon(self, waiter: dict):
        """A timed-out waiter leaves the queue; a grant that raced the
        timeout is returned to its pool (the client is about to retry)."""
        if waiter in self._lease_waiters:
            self._lease_waiters.remove(waiter)
        grant = waiter.pop("grant", None)
        if grant is not None:
            pool, _ = self._pool_for(waiter["strat"])
            if pool is not None:
                pool.release(grant["demand"])
            self._resources_dirty = True
            self._kick_waiters()

    def _local_feasible(self, resources: Dict[str, float], strategy: dict) -> bool:
        if strategy.get("type") == "placement_group":
            key = (strategy["pg_id"], strategy.get("bundle_index") or 0)
            bundle = self.bundles.get(key)
            return bundle is not None and bundle["committed"]
        return self.total.fits(ResourceSet(resources))

    @staticmethod
    def _labels_match(labels: Dict[str, str], selector) -> bool:
        return all(labels.get(k) == v for k, v in (selector or {}).items())

    def _pick_spill_node(
        self, resources: Dict[str, float], strategy: dict, require_available: bool
    ) -> Optional[dict]:
        """Hybrid policy over the GCS cluster view; returns peer node info or
        None. node_label strategies (reference:
        raylet/scheduling/policy/node_label_scheduling_policy.cc) restrict
        candidates to hard-label matches and prefer soft-label matches."""
        demand = ResourceSet(resources)
        is_label = strategy.get("type") == "node_label"
        hard = strategy.get("hard") if is_label else None
        soft = strategy.get("soft") if is_label else None
        best = None
        best_score = None
        for nid, info in self.cluster_view.items():
            if nid == self.node_id.binary():
                continue
            if is_label and not self._labels_match(info.get("labels", {}), hard):
                continue
            total = ResourceSet(info.get("resources_total", {}))
            avail = ResourceSet(info.get("resources_available", {}))
            if not total.fits(demand):
                continue
            if require_available and not avail.fits(demand):
                continue
            td, ad = total.to_dict(), avail.to_dict()
            used = sum(1 - ad.get(k, 0) / v for k, v in td.items() if v > 0)
            if strategy.get("type") == "spread":
                score = used  # least loaded wins
            else:
                score = -used  # pack: most loaded feasible wins
            if soft and self._labels_match(info.get("labels", {}), soft):
                score -= 100.0  # soft matches dominate the load score
            if best_score is None or score < best_score:
                best, best_score = info, score
        return best

    # ------------------------------------------------------------ worker RPC

    async def handle_RegisterWorker(self, req):
        addr = (self.host, req["port"])
        token = req.get("startup_token", -1)
        _fr.record("worker.spawn", req["worker_id"], req.get("pid", 0))
        if token >= 0:
            self.worker_pool.on_worker_registered(token, req["worker_id"], addr)
        if "actor_result" in req:
            # spawn-time actor creation result riding the registration
            self.worker_pool.on_actor_created(
                req["worker_id"], token, req.get("actor_result") or {}
            )
        return {
            "node_id": self.node_id.binary(),
            "plasma_name": self.plasma_name,
            "gcs_address": self.gcs_address,
        }

    async def handle_RequestWorkerLease(self, req):
        """Grant a local worker, tell the caller to spill, or queue."""
        resources = req.get("resources", {})
        strategy = req.get("strategy", {})
        job_id = req["job_id"]
        deadline = time.time() + CONFIG.worker_lease_timeout_ms / 1000.0

        affinity = strategy.get("type") == "node_affinity"
        if affinity and strategy.get("node_id") != self.node_id.binary():
            target = self.cluster_view.get(strategy.get("node_id"))
            if target is None:
                if strategy.get("soft"):
                    strategy = {}
                else:
                    return {"error": "affinity node not alive"}
            else:
                return {"spill": {"ip": target["ip"], "port": target["raylet_port"],
                                   "node_id": target["node_id"]}}

        if strategy.get("type") == "node_label":
            hard = strategy.get("hard") or {}
            soft = strategy.get("soft") or {}
            if not self._labels_match(self.labels, hard):
                target = self._pick_spill_node(
                    resources, strategy, require_available=False
                )
                if target is None:
                    return {"error": (
                        f"no alive node matches required labels {hard}"
                    )}
                return {"spill": {
                    "ip": target["ip"], "port": target["raylet_port"],
                    "node_id": target["node_id"],
                }}
            if soft and not self._labels_match(self.labels, soft):
                # Local node satisfies hard but not soft: prefer a peer that
                # satisfies both and has free capacity; otherwise stay local
                # (soft preference never makes placement infeasible).
                target = self._pick_spill_node(
                    resources, strategy, require_available=True
                )
                if target is not None and self._labels_match(
                    target.get("labels", {}), soft
                ):
                    return {"spill": {
                        "ip": target["ip"], "port": target["raylet_port"],
                        "node_id": target["node_id"],
                    }}

        # PG-bound tasks are routed by the owner to the raylet holding the
        # bundle; they queue on that bundle and never spill (reference:
        # local_task_manager keeps PG tasks local to the committed bundle).
        is_pg = strategy.get("type") == "placement_group"
        if is_pg:
            pg_key = (strategy["pg_id"], strategy.get("bundle_index") or 0)
            bundle = self.bundles.get(pg_key)
            if bundle is None or not bundle["committed"]:
                return {"retry_pg": True}
            if not bundle["reserved"].fits(ResourceSet(resources)):
                # Fail fast like the reference's submission-time bundle check.
                return {"error": (
                    f"task demands {resources} which can never fit in "
                    f"placement group bundle {bundle['reserved'].to_dict()}"
                )}

        try:
            env_overrides = await self._runtime_env_overrides(
                req.get("runtime_env"), req.get("job_id", b"")
            )
        except Exception as e:
            return {"error": f"runtime_env setup failed: {e}"}

        waiter = None
        while True:
            if is_pg and pg_key not in self.bundles:
                return {"error": "placement group removed"}
            grant = None
            if waiter is not None:
                # woken by the batched grant pass: it may have acquired on
                # our behalf (FIFO, starvation-bounded); a grant-less wake
                # (topology change) re-runs the full logic below
                grant = waiter.pop("grant", None)
                waiter = None
            if grant is None and not self._blocked_by_starving(resources,
                                                               strategy):
                grant = self._try_acquire(resources, strategy)
            if grant is not None:
                gpus = self._allocate_gpus(resources.get("GPU", 0))
                worker_env = dict(env_overrides or {})
                if gpus is not None:
                    worker_env.update(accelerators.visible_gpu_env(gpus))
                handle = await self.worker_pool.pop_worker(
                    job_id, worker_env or None
                )
                prestart = CONFIG.prestart_workers_min_idle
                if prestart > 0 and not gpus:
                    # Top the warm pool back up in the background so the
                    # NEXT lease pops a booted worker (reference:
                    # worker_pool.h:359 PrestartWorkers). Fired AFTER
                    # pop_worker so the observed idle count no longer
                    # includes the worker just taken — scheduling it before
                    # the pop settled the pool one below the target.
                    # GPU-bound leases are excluded — their env is
                    # per-lease.
                    asyncio.ensure_future(self.worker_pool.prestart(
                        job_id, worker_env or None,
                        target_idle=prestart))
                if handle is None:
                    # worker failed to start; release and retry
                    pool, _ = self._pool_for(strategy)
                    pool.release(grant["demand"])
                    if gpus:
                        self._free_gpus.extend(gpus)
                        self._free_gpus.sort()
                    return {"error": "worker startup failed"}
                self._lease_seq += 1
                lease_id = self._lease_seq.to_bytes(8, "little") + os.urandom(4)
                handle.lease_id = lease_id
                self.leases[lease_id] = {
                    "worker_id": handle.worker_id,
                    "grant": grant,
                    "bundle": grant["bundle"],
                    "gpus": gpus,
                    "t": time.time(),
                }
                _fr.record("lease.grant", lease_id,
                           handle.worker_id.hex()[:12])
                return {
                    "granted": True,
                    "worker_addr": list(handle.addr),
                    "worker_id": handle.worker_id,
                    "lease_id": lease_id,
                }

            if not is_pg:
                # Can't grant now. Spread tasks and locally-infeasible tasks spill.
                spill_now = self._pick_spill_node(resources, strategy, require_available=True)
                local_ok = self._local_feasible(resources, strategy)
                if strategy.get("type") == "spread" and spill_now is not None:
                    # crude spread: alternate between local queue and remote
                    return {"spill": {"ip": spill_now["ip"], "port": spill_now["raylet_port"],
                                       "node_id": spill_now["node_id"]}}
                if not local_ok:
                    if spill_now is not None:
                        return {"spill": {"ip": spill_now["ip"], "port": spill_now["raylet_port"],
                                           "node_id": spill_now["node_id"]}}
                    spill_any = self._pick_spill_node(resources, strategy, require_available=False)
                    if spill_any is None:
                        # Authoritative view refresh before declaring
                        # infeasibility: a just-registered node may not have
                        # reached our pushed view yet (rare path, one RPC).
                        try:
                            await self._refresh_cluster_view()
                        except Exception:
                            pass
                        spill_any = self._pick_spill_node(
                            resources, strategy, require_available=False
                        )
                    if spill_any is not None:
                        return {"spill": {"ip": spill_any["ip"], "port": spill_any["raylet_port"],
                                           "node_id": spill_any["node_id"]}}
                    if not self._autoscaler_active:
                        # Authoritative check (the heartbeat may not have
                        # seen a just-started autoscaler): only on this
                        # rare infeasible path.
                        try:
                            r = await self.gcs.call(
                                "GetAutoscalerActive", {}, timeout=5
                            )
                            self._autoscaler_active = bool(r.get("active"))
                        except Exception:
                            pass
                    if not self._autoscaler_active:
                        return {"error": f"infeasible resource request {resources}"}
                    # else: queue below — the recorded demand will drive an
                    # autoscaler launch, and the new node kicks the waiter.
                if spill_now is not None:
                    return {"spill": {"ip": spill_now["ip"], "port": spill_now["raylet_port"],
                                       "node_id": spill_now["node_id"]}}
            # queue locally until resources free up; the recorded shape
            # feeds the GCS load report that drives the autoscaler
            # (reference: gcs_autoscaler_state_manager.h cluster load).
            # PG-bound tasks are excluded: their bundle is already placed,
            # so a new node could never serve them — reporting them would
            # trigger pointless slice launches.
            new_waiter = {"event": asyncio.Event(), "res": dict(resources),
                          "strat": strategy, "skips": 0}
            if not is_pg:
                new_waiter["resources"] = dict(resources)
            self._lease_waiters.append(new_waiter)
            timeout = deadline - time.time()
            if timeout <= 0:
                self._waiter_abandon(new_waiter)
                return {"retry": True}
            try:
                await asyncio.wait_for(new_waiter["event"].wait(), timeout)
            except asyncio.TimeoutError:
                self._waiter_abandon(new_waiter)
                return {"retry": True}
            waiter = new_waiter

    async def handle_ReturnWorker(self, req):
        lease = self.leases.get(req["lease_id"])
        if lease is not None:
            self._release_lease(req["lease_id"])
            handle = self.worker_pool.workers.get(lease["worker_id"])
            if handle is not None:
                if req.get("kill"):
                    await self.worker_pool.kill_worker(handle)
                else:
                    self.worker_pool.push_idle(handle)
        return {"ok": True}

    # ---------------------------------------------- plasma-backed submit ring
    # (_private/submit_ring.py) A submitter memcpys serialized tiny-task
    # specs into a shared-memory ring; this raylet drains batches per loop
    # tick and dispatches them onto its own locally-leased workers, sending
    # replies back as ONE batched notify per push batch. The only hot-path
    # RPC left is the submitter's doorbell on empty→non-empty transitions.

    async def handle_AttachSubmitRing(self, req):
        from ray_tpu_torch._private.submit_ring import RingConsumer

        oid = req["object_id"]
        old = self._rings.pop(oid, None)
        if old is not None:
            self._detach_ring_state(old)
        view = self.plasma.get(oid)
        if view is None:
            return {"ok": False, "error": "ring object not in plasma"}
        try:
            consumer = RingConsumer(view)
        except Exception as e:
            try:
                view.release()
            except Exception:
                pass
            self.plasma.release(oid)
            return {"ok": False, "error": f"bad ring: {e}"}
        self._rings[oid] = {
            "oid": oid,
            "view": view,
            "consumer": consumer,
            "reply_addr": tuple(req["reply_addr"]),
            "job_id": req["job_id"],
            "backlog": deque(),
            "runners": 0,
        }
        if self._ring_event is None:
            self._ring_event = asyncio.Event()
        if self._ring_task is None:
            self._ring_task = asyncio.ensure_future(self._submit_ring_loop())
            self._bg.append(self._ring_task)
        self._ring_event.set()
        return {"ok": True}

    async def handle_SubmitRingDoorbell(self, req):
        if self._ring_event is not None:
            self._ring_event.set()
        return {"ok": True}

    async def handle_DetachSubmitRing(self, req):
        ring = self._rings.pop(req["object_id"], None)
        if ring is not None:
            self._detach_ring_state(ring)
        return {"ok": True}

    def _detach_ring_state(self, ring: dict):
        try:
            ring["view"].release()
        except Exception:
            pass
        self.plasma.release(ring["oid"])
        self.plasma.delete(ring["oid"])

    async def _submit_ring_loop(self):
        """Drain every attached ring per tick. The doorbell notify wakes
        the loop on empty→non-empty transitions; the short timeout is only
        a lost-doorbell safety net and the consumer-heartbeat cadence."""
        while True:
            try:
                await asyncio.wait_for(self._ring_event.wait(), 0.2)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                return
            self._ring_event.clear()
            now = time.time()
            for oid, ring in list(self._rings.items()):
                try:
                    self._ring_tick(oid, ring, now)
                except Exception:
                    logger.exception("submit ring tick failed; detaching")
                    self._rings.pop(oid, None)
                    self._detach_ring_state(ring)

    def _ring_tick(self, oid: bytes, ring: dict, now: float):
        c = ring["consumer"]
        c.beat(now)  # producers treat a stale beat as a dead consumer
        drained = 0
        while drained < 4096:
            entries = c.drain(max_items=256)
            if not entries:
                break
            drained += len(entries)
            for raw in entries:
                try:
                    spec = msgpack.unpackb(raw, raw=False,
                                           strict_map_key=False)
                except Exception:
                    logger.exception("undecodable submit-ring entry")
                    continue
                ring["backlog"].append(spec)
        if not c.empty():
            self._ring_event.set()  # more arrived mid-drain: next tick now
        if ring["backlog"]:
            self._ring_pump(ring)
        elif ring["runners"] == 0 and c.closed():
            # clean producer detach: reclaim the ring object
            self._rings.pop(oid, None)
            self._detach_ring_state(ring)

    def _ring_pump(self, ring: dict):
        """One runner per grantable backlog task (mirroring the driver's
        one-lease-request-per-queued-task pumping, so blocking tasks keep
        real concurrency); each runner is HANDED its first spec here so a
        bounce can never strand a spawned runner without work. When local
        resources run out, the leftover backlog bounces back to the
        submitter if a peer has free capacity (the RPC path knows how to
        spill); otherwise it queues here until a release re-kicks us."""
        while ring["backlog"]:
            spec0 = ring["backlog"][0]
            resources = dict(spec0.get("resources") or {})
            grant = self._try_acquire(resources, {})
            if grant is None:
                if self.cluster_view and self._pick_spill_node(
                        resources, {}, require_available=True) is not None:
                    bounced = list(ring["backlog"])
                    ring["backlog"].clear()
                    self._ring_post_replies(ring, [
                        (s["task_id"], {"ring_bounce": True})
                        for s in bounced])
                break
            first = ring["backlog"].popleft()
            ring["runners"] += 1
            asyncio.ensure_future(self._ring_spawn(ring, grant, first))

    async def _ring_spawn(self, ring: dict, grant: dict, first: dict):
        try:
            handle = await self.worker_pool.pop_worker(ring["job_id"], None)
        except Exception:
            logger.exception("ring worker spawn failed")
            handle = None
        if handle is None:
            self.available.release(grant["demand"])
            self._resources_dirty = True
            ring["runners"] -= 1
            self._ring_post_replies(ring, [
                (first["task_id"],
                 {"status": "error", "worker_crashed": True,
                  "error": "ring worker startup failed"})])
            return
        self._lease_seq += 1
        lease_id = self._lease_seq.to_bytes(8, "little") + os.urandom(4)
        handle.lease_id = lease_id
        self.leases[lease_id] = {
            "worker_id": handle.worker_id,
            "grant": grant,
            "bundle": None,
            "gpus": None,
            "t": time.time(),
        }
        _fr.record("lease.grant", lease_id, handle.worker_id.hex()[:12])
        await self._ring_runner(ring, handle, lease_id, first)

    async def _ring_runner(self, ring: dict, handle, lease_id: bytes,
                           first: dict):
        """Run the handed spec, then keep draining backlog batches on this
        lease until nothing is left; release the lease immediately after
        (holding it idle would starve every other lease waiter) while the
        warm worker returns to the pool for the next pump."""
        push_batch = CONFIG.task_push_max_batch
        batch = [first]
        try:
            while batch:
                try:
                    client = await self.pool.get(*handle.addr)
                    r = await client.call("PushTasks", {"specs": batch},
                                          timeout=None)
                    replies = r["replies"]
                except Exception as e:
                    # worker died mid-batch: the submitter retries through
                    # its ordinary worker-crash path (lease cleanup rides
                    # _on_worker_death)
                    self._ring_post_replies(ring, [
                        (s["task_id"],
                         {"status": "error", "worker_crashed": True,
                          "error": f"ring worker died: "
                                   f"{type(e).__name__}: {e}"})
                        for s in batch])
                    return
                self._ring_post_replies(
                    ring, [(s["task_id"], rep)
                           for s, rep in zip(batch, replies)])
                batch = []
                while ring["backlog"] and len(batch) < push_batch:
                    batch.append(ring["backlog"].popleft())
            if lease_id in self.leases:
                self._release_lease(lease_id)
                if handle.alive:
                    self.worker_pool.push_idle(handle)
        finally:
            ring["runners"] -= 1

    def _ring_post_replies(self, ring: dict, replies):
        payload = {"replies": [[tid, rep] for tid, rep in replies]}

        async def _send():
            try:
                client = await self.pool.get(*ring["reply_addr"])
                await client.notify("SubmitRingReplies", payload)
            except Exception:
                _fr.record("rpc.error", b"", "SubmitRingReplies dropped")

        asyncio.ensure_future(_send())

    async def handle_GetNodeInfo(self, req):
        return {
            "node_id": self.node_id.binary(),
            "ip": self.host,
            "port": self.port,
            "plasma_name": self.plasma_name,
            "resources_total": self.total.to_dict(),
            "resources_available": self.available.to_dict(),
            "labels": self.labels,
            "num_workers": len(self.worker_pool.workers),
            "object_store": self.plasma.stats(),
        }

    # --------------------------------------------------------------- actors

    async def handle_LeaseWorkerForActor(self, req):
        """GCS asks us to supply a dedicated worker for an actor.

        When the request carries the creation `spec`, the actor initializes
        as part of the worker's boot (spec rides the fork-server spawn
        message; the creation result rides the child's RegisterWorker
        request) — collapsing the GCS's lease-then-create two-step, and its
        per-actor TCP connection to the new worker, into this one RPC."""
        grant = self._try_acquire(req["resources"], req.get("strategy", {}))
        if grant is None:
            return {"granted": False}
        try:
            env = await self._runtime_env_overrides(
                req.get("runtime_env"), req.get("job_id", b"")
            )
        except Exception as e:
            pool, _ = self._pool_for(req.get("strategy", {}))
            pool.release(grant["demand"])
            return {"granted": False, "error": f"runtime_env setup failed: {e}"}
        gpus = self._allocate_gpus(req["resources"].get("GPU", 0))
        if gpus is not None:
            env.update(accelerators.visible_gpu_env(gpus))
        spec = req.get("spec")
        spawn_extra = {
            "node_id": self.node_id.hex(),
            "plasma_name": self.plasma_name,
        }
        sys_path = await self._job_sys_path(req["job_id"])
        if sys_path is not None:
            # None = transiently unknown: omit so the child runs its own
            # GetJob fallback instead of trusting an empty path list.
            spawn_extra["sys_path"] = sys_path
        if spec is not None:
            import base64

            actor_payload = {
                "spec_b64": base64.b64encode(
                    msgpack.packb(spec, use_bin_type=True)
                ).decode(),
            }
            fn_blob = await self._fn_blob(spec.get("fn_key"))
            if fn_blob is not None:
                actor_payload["fn_blob_b64"] = base64.b64encode(fn_blob).decode()
            spawn_extra["actor"] = actor_payload
        prestart = CONFIG.prestart_workers_min_idle
        if prestart > 0 and not gpus:
            # Warm-pool top-up: an idle hit below skips fork+boot entirely
            # (pop_worker drives CreateActor on the reused worker).
            asyncio.ensure_future(self.worker_pool.prestart(
                req["job_id"], env or None, target_idle=prestart))
        handle = await self.worker_pool.pop_worker(
            req["job_id"], env or None, spawn_extra
        )
        if handle is None:
            pool, _ = self._pool_for(req.get("strategy", {}))
            pool.release(grant["demand"])
            if gpus:
                self._free_gpus.extend(gpus)
                self._free_gpus.sort()
            return {"granted": False}
        created = False
        create_error = ""
        if spec is not None:
            if handle.actor_ready is not None:
                # spawn-time creation: result already reported by the child
                result = handle.actor_result or {}
                created = bool(result.get("ok"))
                create_error = result.get("error", "")
            else:
                # idle-worker reuse: drive CreateActor ourselves
                try:
                    client = await self.pool.get(*handle.addr)
                    result = await client.call(
                        "CreateActor",
                        {"spec": spec, "actor_id": req["actor_id"]},
                        timeout=CONFIG.worker_startup_timeout_s,
                    )
                    created = bool(result.get("ok"))
                    create_error = result.get("error", "")
                except Exception as e:
                    created, create_error = False, ""
                    logger.warning("CreateActor on reused worker failed: %s", e)
            if not created:
                # creation failed: release everything; a deterministic
                # __init__ error propagates so the GCS marks the actor DEAD
                await self.worker_pool.kill_worker(handle)
                pool, _ = self._pool_for(req.get("strategy", {}))
                pool.release(grant["demand"])
                if gpus:
                    self._free_gpus.extend(gpus)
                    self._free_gpus.sort()
                if create_error:
                    return {"granted": False, "error": create_error}
                return {"granted": False}
        self._lease_seq += 1
        lease_id = self._lease_seq.to_bytes(8, "little") + os.urandom(4)
        handle.lease_id = lease_id
        handle.actor_id = req["actor_id"]
        self.leases[lease_id] = {
            "worker_id": handle.worker_id,
            "grant": grant,
            "bundle": grant["bundle"],
            "gpus": gpus,
            "t": time.time(),
        }
        _fr.record("lease.grant", lease_id, handle.worker_id.hex()[:12])
        self._actor_workers[handle.worker_id] = req["actor_id"]
        return {
            "granted": True,
            "created": created,
            "worker_addr": list(handle.addr),
            "worker_id": handle.worker_id,
            "lease_id": lease_id,
        }

    async def handle_LeaseWorkersForActors(self, req):
        """Batched actor lease: one RPC from the GCS creates N actors on
        this node; each item forks+boots concurrently raylet-side."""
        results = await asyncio.gather(
            *(self.handle_LeaseWorkerForActor(item) for item in req["items"]),
            return_exceptions=True,
        )
        out = []
        for r in results:
            if isinstance(r, BaseException):
                logger.warning("batched actor lease item failed: %r", r)
                out.append({"granted": False})
            else:
                out.append(r)
        return {"results": out}

    async def _job_sys_path(self, job_id: bytes) -> "Optional[list]":
        """driver_sys_path for a job, fetched from the GCS once and cached —
        saves every spawned worker its own GetJob round-trip."""
        cached = self._job_sys_path_cache.get(job_id)
        if cached is not None:
            return cached
        try:
            reply = await self.gcs.call("GetJob", {"job_id": job_id})
            paths = reply.get("job", {}).get("driver_sys_path", []) or []
        except Exception:
            return None  # transient: don't cache, let the child fall back
        self._job_sys_path_cache[job_id] = paths
        return paths

    async def _fn_blob(self, fn_key) -> "Optional[bytes]":
        """Actor-class blob from the GCS function table, cached per key so a
        burst of same-class actors ships the class in the spawn message
        instead of each child fetching it."""
        if not fn_key:
            return None
        blob = self._fn_blob_cache.get(fn_key)
        if blob is None:
            try:
                r = await self.gcs.call("KVGet", {"ns": "fn", "key": fn_key})
            except Exception:
                return None
            blob = r.get("value")
            if blob is None:
                return None
            if len(self._fn_blob_cache) > 128:
                self._fn_blob_cache.clear()
            self._fn_blob_cache[fn_key] = blob
        return blob

    async def _materialize_uri(self, uri: str) -> str:
        """Fetch + extract a kv:<hash> packaged directory (idempotent)."""
        base = self.session_dir or "."
        target = renv.materialized_path(uri, base)
        if os.path.isdir(target):
            return target
        digest = uri[len(renv.URI_PREFIX):]
        r = await self.gcs.call(
            "KVGet", {"ns": renv.KV_NAMESPACE, "key": digest.encode()}
        )
        blob = r.get("value")
        if blob is None:
            raise RuntimeError(f"runtime_env package {uri} missing from GCS KV")
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, renv.extract_working_dir, uri, blob, base
        )

    async def _runtime_env_overrides(self, runtime_env,
                                     job_id: bytes = b"") -> Dict[str, str]:
        """Turn a spec's runtime_env into worker env overrides, extracting an
        uploaded working_dir / py_modules and building pip venvs on first
        use (reference: the per-node runtime-env agent,
        _private/runtime_env/agent/runtime_env_agent.py + pip.py)."""
        env: Dict[str, str] = {}
        if not runtime_env:
            return env
        for k, v in (runtime_env.get("env_vars") or {}).items():
            env[str(k)] = str(v)
        wd = runtime_env.get("working_dir")
        if wd:
            if renv.is_uploaded(wd):
                env[renv.WORKING_DIR_ENV] = await self._materialize_uri(wd)
            else:
                # Raw local path (same-machine clusters / tests).
                env[renv.WORKING_DIR_ENV] = str(wd)
        pypath: list = []
        for mod in runtime_env.get("py_modules") or []:
            if renv.is_uploaded(mod):
                pypath.append(await self._materialize_uri(mod))
            else:
                pypath.append(str(mod))
        pip = runtime_env.get("pip")
        if pip:
            pypath.append(await self._ensure_pip_env(pip, job_id))
        if pypath:
            env["RTPU_TORCH_PYPATH_PREPEND"] = os.pathsep.join(pypath)
        conda = runtime_env.get("conda")
        if conda:
            prefix = await self._ensure_conda_env(conda, job_id)
            python = os.path.join(prefix, "bin", "python")
            if not os.path.exists(python):
                raise RuntimeError(
                    f"conda env {prefix!r} has no bin/python")
            # Workers for this env spawn via the env's own interpreter
            # (worker_pool direct-exec path), like the reference's
            # conda-activated worker command (runtime_env/conda.py:260).
            env["RTPU_TORCH_SPAWN_PYTHON"] = python
            env["CONDA_PREFIX"] = prefix
            env["PATH"] = (os.path.join(prefix, "bin") + os.pathsep
                           + os.environ.get("PATH", ""))
        container = runtime_env.get("container")
        if container:
            import json as _json

            env["RTPU_TORCH_SPAWN_PREFIX"] = _json.dumps(
                self._container_argv(container))
        return env

    def _container_argv(self, container: dict) -> list:
        """`docker run` prefix wrapping the worker command (reference:
        runtime_env/image_uri.py:96 — worker-in-container). host network so
        the worker's RPC server/ports work unchanged; /dev/shm and the
        session dir shared so plasma and logs keep functioning. The engine
        binary comes from RTPU_TORCH_CONTAINER_EXE (tests install a fake docker
        on PATH, like the reference's mocked container runs)."""
        image = container.get("image")
        if not image:
            raise RuntimeError('runtime_env["container"] needs an "image"')
        exe = os.environ.get("RTPU_TORCH_CONTAINER_EXE", "docker")
        argv = [exe, "run", "--rm", "--network=host",
                "-v", "/dev/shm:/dev/shm"]
        session = os.path.abspath(self.session_dir or ".")
        argv += ["-v", f"{session}:{session}"]
        for opt in container.get("run_options", []) or []:
            argv.append(str(opt))
        argv.append(str(image))
        return argv

    async def _ensure_conda_env(self, conda, job_id: bytes) -> str:
        """Resolve or build a conda env; returns its prefix directory.

        - str that is a directory: used as a prefix as-is.
        - other str: named env, resolved via `conda env list --json`.
        - dict: an environment.yml-shaped spec, built once per spec hash
          with `conda env create -p` and cached/evicted exactly like the
          pip target dirs (reference: runtime_env/conda.py:260
          get_or_create_conda_env; same job-refcounted eviction).
        """
        import hashlib
        import json as _json
        import subprocess

        conda_exe = os.environ.get("RTPU_TORCH_CONDA_EXE", "conda")
        if isinstance(conda, str):
            if os.path.isdir(conda):
                return conda
            cache = getattr(self, "_conda_name_cache", None)
            if cache is None:
                cache = self._conda_name_cache = {}
            if conda in cache:
                return cache[conda]
            loop = asyncio.get_running_loop()

            def lookup():
                out = subprocess.run(
                    [conda_exe, "env", "list", "--json"],
                    capture_output=True, text=True, timeout=60)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"conda env list failed: {out.stderr.strip()}")
                for prefix in _json.loads(out.stdout).get("envs", []):
                    if os.path.basename(prefix) == conda:
                        return prefix
                raise RuntimeError(f"no conda env named {conda!r}")

            prefix = await loop.run_in_executor(None, lookup)
            cache[conda] = prefix  # one conda-CLI shellout per name, ever
            return prefix
        spec = _json.dumps(conda, sort_keys=True)
        h = "conda-" + hashlib.sha1(spec.encode()).hexdigest()[:16]
        base = os.path.join(self.session_dir or ".", "runtime_envs", "venvs")
        env_dir = os.path.join(base, h)
        marker = os.path.join(env_dir, ".rtpu_ready")
        if job_id:
            self._venv_jobs.setdefault(h, set()).add(job_id)
        lock = self._venv_locks.setdefault(h, asyncio.Lock())
        async with lock:
            if not os.path.exists(marker):
                loop = asyncio.get_running_loop()

                def build():
                    import shutil
                    import tempfile

                    shutil.rmtree(env_dir, ignore_errors=True)
                    os.makedirs(base, exist_ok=True)
                    with tempfile.NamedTemporaryFile(
                            "w", suffix=".yml", delete=False) as f:
                        import yaml as _yaml

                        _yaml.safe_dump(conda, f)
                        yml = f.name
                    try:
                        out = subprocess.run(
                            [conda_exe, "env", "create", "--yes",
                             "-p", env_dir, "-f", yml],
                            capture_output=True, text=True, timeout=1800)
                        if out.returncode != 0:
                            raise RuntimeError(
                                "conda env create failed:\n"
                                + out.stderr[-2000:])
                    finally:
                        os.unlink(yml)
                    with open(marker, "w") as f:
                        f.write("ok")

                await loop.run_in_executor(None, build)
        return env_dir

    async def _ensure_pip_env(self, pip: dict, job_id: bytes) -> str:
        """Per-spec-hash package dir built by `pip install --target`, shared
        by every worker that asks for the same pip spec; reference-counted
        per job and evicted when the last job using it finishes (reference:
        runtime_env/agent/runtime_env_agent.py:162 + pip.py).

        --target instead of a nested venv: the base interpreter is itself a
        venv, and `python -m venv` from inside one resolves "system site
        packages" to the ORIGINAL interpreter, hiding the baked-in stack.
        A plain target dir prepended to sys.path adds packages on top of
        the full base env — exactly the per-job-deps semantics wanted."""
        import hashlib
        import json as _json
        import shutil
        import subprocess
        import sys as _sys

        spec = _json.dumps(pip, sort_keys=True)
        h = hashlib.sha1(spec.encode()).hexdigest()[:16]
        base = os.path.join(self.session_dir or ".", "runtime_envs", "venvs")
        env_dir = os.path.join(base, h)
        marker = os.path.join(env_dir, ".rtpu_ready")
        if job_id:
            self._venv_jobs.setdefault(h, set()).add(job_id)
        lock = self._venv_locks.setdefault(h, asyncio.Lock())
        async with lock:
            if not os.path.exists(marker):
                loop = asyncio.get_running_loop()

                def build():
                    shutil.rmtree(env_dir, ignore_errors=True)  # half-built
                    os.makedirs(base, exist_ok=True)
                    cmd = [
                        _sys.executable, "-m", "pip", "install",
                        "--no-input", "--target", env_dir,
                        *pip.get("pip_install_options", []),
                        *pip["packages"],
                    ]
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    if r.returncode != 0:
                        raise RuntimeError(
                            f"pip install failed:\n{r.stdout[-2000:]}\n"
                            f"{r.stderr[-2000:]}"
                        )

                await loop.run_in_executor(None, build)
                with open(marker, "w") as f:
                    f.write(spec)
        return env_dir

    async def handle_KillWorker(self, req):
        handle = self.worker_pool.workers.get(req["worker_id"])
        if handle is not None:
            if req.get("reason"):
                self._kill_reasons[req["worker_id"]] = req["reason"]
            # death is reported once, by the fork server's reap (or the
            # liveness poll) — not here, to avoid double ReportWorkerDeath
            await self.worker_pool.kill_worker(handle)
        return {"ok": True}

    async def handle_JobFinished(self, req):
        # submit rings of the finished job's drivers/workers are garbage now
        for oid, ring in list(self._rings.items()):
            if ring["job_id"] == req["job_id"]:
                self._rings.pop(oid, None)
                self._detach_ring_state(ring)
        self.worker_pool.kill_job_workers(req["job_id"])
        # evict pip venvs no job still references (reference: runtime_env
        # agent deletes per-job URIs on job exit)
        import shutil

        job_id = req["job_id"]
        loop = asyncio.get_running_loop()
        for h, jobs in list(self._venv_jobs.items()):
            jobs.discard(job_id)
            if not jobs:
                self._venv_jobs.pop(h, None)
                self._venv_locks.pop(h, None)
                path = os.path.join(
                    self.session_dir or ".", "runtime_envs", "venvs", h
                )
                # Atomic rename FIRST: the ready marker vanishes with the
                # dir, so a new job with the same spec rebuilds instead of
                # adopting a tree that is mid-deletion; then rmtree off the
                # loop (heartbeats/leases must not stall on fs work).
                trash = f"{path}.evict.{os.getpid()}"
                try:
                    os.rename(path, trash)
                except OSError:
                    continue
                loop.run_in_executor(None, shutil.rmtree, trash, True)
                logger.info("evicting pip venv %s (last job finished)", h)

    # ------------------------------------------------------ placement groups

    async def handle_PrepareBundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        if key in self.bundles:
            return {"ok": True}
        demand = ResourceSet(req["resources"])
        if not self.available.acquire(demand):
            return {"ok": False}
        self._resources_dirty = True
        self.bundles[key] = {
            "reserved": demand,
            "available": demand.copy(),
            "committed": False,
        }
        return {"ok": True}

    async def handle_CommitBundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        bundle = self.bundles.get(key)
        if bundle is None:
            return {"ok": False}
        bundle["committed"] = True
        return {"ok": True}

    async def handle_PrepareBundles(self, req):
        """Batched 2PC prepare: every bundle this node hosts in ONE RPC
        (a 2-bundle PG on one node was 2 prepare + 2 commit round-trips).
        All-or-nothing per node: partial acquisitions roll back here.
        With `commit: true` (single-participant groups) the 2PC degenerates
        to one phase — sole-node atomicity needs no separate commit."""
        acquired = []
        for item in req["items"]:
            r = await self.handle_PrepareBundle(item)
            if not r.get("ok"):
                for done in acquired:
                    await self._return_bundle(done)
                return {"ok": False}
            acquired.append(item)
        if req.get("commit"):
            for item in req["items"]:
                await self.handle_CommitBundle(item)
        return {"ok": True}

    async def handle_CommitBundles(self, req):
        ok = True
        for item in req["items"]:
            r = await self.handle_CommitBundle(item)
            ok = ok and bool(r.get("ok"))
        return {"ok": ok}

    async def handle_CancelBundle(self, req):
        await self._return_bundle(req)

    async def handle_ReturnBundle(self, req):
        await self._return_bundle(req)

    async def _return_bundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        bundle = self.bundles.pop(key, None)
        if bundle is not None:
            self.available.release(bundle["reserved"])
            self._resources_dirty = True
            # full wake: waiters bound to this PG must observe its removal
            self._kick_waiters(wake_all=True)

    # ----------------------------------------------------- spilling / OOM

    @staticmethod
    def _write_spill_file(path: str, data):
        """data is any bytes-like — the plasma view itself is passed so the
        spill write streams shm -> page cache with no heap copy."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    async def _spill_bytes(self, needed: int) -> int:
        """Spill pinned primary copies to disk until ``needed`` bytes of
        plasma are reclaimable. Oldest pins first (insertion order ~= LRU).

        Reference: LocalObjectManager::SpillObjectsOfSize
        (src/ray/raylet/local_object_manager.h:41). The primary copy moves
        to <session>/spilled_<node>/<oid>; remote pulls are served straight
        from the file and local access restores it into plasma on demand.
        """
        async with self._spill_lock:
            victims: List[Tuple[bytes, memoryview]] = []
            planned = 0
            for oid, view in list(self._pinned.items()):
                if planned >= needed:
                    break
                victims.append((oid, view))
                planned += view.nbytes
            if not victims:
                return 0
            os.makedirs(self._spill_dir, exist_ok=True)
            loop = asyncio.get_running_loop()
            freed = 0
            for oid, view in victims:
                if oid not in self._pinned:
                    # Freed (handle_FreeObjects) while an earlier victim was
                    # being written: its view is released — don't touch it.
                    continue
                nbytes = view.nbytes  # capture before any await
                rec = self._spilled.get(oid)
                if rec is None:
                    path = os.path.join(self._spill_dir, oid.hex())
                    try:
                        # the pin (self._pinned) holds the view alive for
                        # the duration of the executor write — no bytes()
                        await loop.run_in_executor(
                            None, self._write_spill_file, path, view
                        )
                    except Exception:
                        logger.exception("spill of %s failed", oid.hex()[:12])
                        continue
                    if oid not in self._pinned:
                        # Freed during the write: don't resurrect the entry.
                        try:
                            os.remove(path)
                        except OSError:
                            pass
                        continue
                    self._spilled[oid] = (path, nbytes)
                self._pinned.pop(oid, None)
                try:
                    view.release()
                except Exception:
                    pass
                self.plasma.release(oid)
                # delete may fail if a reader still holds it; its memory
                # frees when that reader releases — still progress.
                self.plasma.delete(oid)
                freed += nbytes
                # per-object (oid, bytes) so the timeline can render each
                # spill as an instant on this node's lane
                _fr.record("obj.spill", oid, nbytes)
            if freed:
                logger.info(
                    "spilled %d objects / %d bytes to %s",
                    len(victims), freed, self._spill_dir,
                )
            return freed

    async def _restore_spilled(self, oid: bytes) -> bool:
        """Bring a spilled object back into local plasma (re-pinned)."""
        rec = self._spilled.get(oid)
        if rec is None:
            return False
        path, size = rec
        dest = None
        for attempt in range(6):
            try:
                dest = await self._plasma_create_with_room(oid, size)
                break
            except FileExistsError:
                if self.plasma.contains(oid):
                    return True  # sealed — someone beat us to it
                # Unsealed leftover of a crashed restore: reclaim and retry.
                self.plasma.abort(oid)
                continue
            except PlasmaOOM:
                # Transient: spill victims whose memory is still held by an
                # in-flight reader free up once that reader releases.
                await asyncio.sleep(0.1 * (attempt + 1))
        if dest is None:
            logger.warning("restore of %s: no room after retries", oid.hex()[:12])
            return False
        loop = asyncio.get_running_loop()

        def _read_into():
            # page cache -> plasma shm directly; no intermediate bytes
            with open(path, "rb") as f:
                if f.readinto(dest) != size:
                    raise RuntimeError(f"spill file {path} truncated")

        try:
            await loop.run_in_executor(None, _read_into)
            dest.release()
            self.plasma.seal(oid)
        except Exception:
            logger.exception("restore of %s failed", oid.hex()[:12])
            try:
                dest.release()
            except Exception:
                pass
            self.plasma.abort(oid)
            return False
        # Primary copy again: re-pin. The spill file stays so a future
        # re-spill is a free drop; FreeObjects removes it with the object.
        _fr.record("obj.restore", oid, size)
        view = self.plasma.get(oid)
        if view is not None:
            self._pinned[oid] = view
        return True

    async def _plasma_create_with_room(self, oid: bytes, size: int):
        """plasma create that makes room: evict unpinned, then spill."""
        try:
            return self.plasma.create(oid, size)
        except PlasmaOOM:
            self.plasma.evict(size)
        try:
            return self.plasma.create(oid, size)
        except PlasmaOOM:
            await self._spill_bytes(size)
        return self.plasma.create(oid, size)

    async def handle_SpillObjects(self, req):
        """A worker hit plasma OOM: free up ``bytes`` by spilling primaries."""
        freed = await self._spill_bytes(req["bytes"])
        return {"freed": freed}

    async def _spill_loop(self):
        """Watermark spilling: keep plasma below the high threshold so task
        returns never stall on a store packed with pinned primaries."""
        period = CONFIG.object_spilling_check_period_ms / 1000.0
        high = CONFIG.object_spilling_threshold
        while True:
            await asyncio.sleep(period)
            try:
                # reclaim unsealed inbound-push buffers whose pusher died
                for oid, rec in list(self._recv.items()):
                    if time.time() - rec["t"] > 120:
                        logger.warning(
                            "aborting stale inbound push %s", oid.hex()[:12]
                        )
                        self._abort_recv(oid)
                if not self._pinned:
                    continue
                s = self.plasma.stats()
                cap = s["capacity_bytes"]
                if cap and s["used_bytes"] > high * cap:
                    target = max(0.0, (high - 0.1)) * cap
                    await self._spill_bytes(int(s["used_bytes"] - target))
            except Exception:
                logger.exception("spill loop error")

    # -- OOM monitor (reference: src/ray/common/memory_monitor.h:52 +
    #    raylet/worker_killing_policy_group_by_owner.h) -------------------

    @staticmethod
    def _memory_usage_fraction() -> Optional[float]:
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    parts = line.split()
                    if parts[0] in ("MemTotal:", "MemAvailable:"):
                        info[parts[0]] = int(parts[1])
            total = info.get("MemTotal:")
            avail = info.get("MemAvailable:")
            if not total or avail is None:
                return None
            return 1.0 - avail / total
        except Exception:
            return None

    def _pick_oom_victim(self):
        """Kill-priority: leased task workers (their tasks retry) before
        actor workers (restart costs state), newest first within a class."""
        candidates = [
            h
            for h in self.worker_pool.workers.values()
            if h.alive and h.leased and h.pid
        ]
        if not candidates:
            return None
        candidates.sort(
            key=lambda h: (
                h.worker_id in self._actor_workers,  # tasks first
                -h.startup_token,  # newest first
            )
        )
        return candidates[0]

    async def _memory_monitor_loop(self):
        period = CONFIG.memory_monitor_refresh_ms / 1000.0
        threshold = CONFIG.memory_usage_threshold
        if period <= 0:
            return
        while True:
            await asyncio.sleep(period)
            try:
                frac = self._memory_usage_fraction()
                if frac is None or frac < threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                reason = (
                    f"worker killed by the memory monitor: node memory usage "
                    f"{frac:.2f} exceeded threshold {threshold:.2f} (OOM "
                    f"prevention; task will be retried if retriable)"
                )
                logger.warning("%s (pid=%d)", reason, victim.pid)
                _fr.record("worker.oom_kill", victim.worker_id,
                           f"pid {victim.pid} frac {frac:.2f}")
                self._kill_reasons[victim.worker_id] = reason
                # OOM forensics: grab the victim's final memory report
                # while it still breathes — _on_worker_death attaches it
                # (or the on-disk snapshot fallback) to the death report.
                try:
                    client = await self.pool.get(*victim.addr)
                    r = await client.call(
                        "GetMemoryReport", {"limit": 10}, timeout=2)
                    if r.get("report"):
                        self._death_memory[victim.worker_id] = r["report"]
                except Exception:
                    pass
                await self.worker_pool.kill_worker(victim)
            except Exception:
                logger.exception("memory monitor error")

    # ------------------------------------- memory plane: ledger + leaks

    async def _leak_sweep_loop(self):
        """Leak detector: a pinned/spilled primary whose owner's ledger
        holds no live reference — in two consecutive sweeps — is leaked
        (one sweep alone can race an in-flight free/borrow handoff). Fires
        one ``object_leak`` incident per batch of newly confirmed leaks
        through the watchdog's incident path, cooldown-limited, each object
        reported at most once."""
        period = CONFIG.memory_leak_sweep_period_s
        while True:
            await asyncio.sleep(period)
            try:
                await self._leak_sweep_once()
            except Exception:
                logger.exception("leak sweep error")

    async def _leak_sweep_once(self):
        now = time.time()
        min_age = CONFIG.memory_leak_min_age_s
        # 1. group this node's primaries by owner address
        by_owner: Dict[tuple, List[bytes]] = {}
        for oid in set(self._pinned) | set(self._spilled):
            meta = self._pin_meta.get(oid)
            if not meta or not meta.get("owner_addr"):
                continue  # no attribution: nothing to cross-check against
            if now - meta.get("t", now) < min_age:
                continue  # too young — likely still being wired up
            by_owner.setdefault(tuple(meta["owner_addr"]), []).append(oid)
        # 2. ask each owner which ids its ledger still holds
        unowned: List[bytes] = []
        for owner, ids in by_owner.items():
            try:
                client = await self.pool.get(owner[0], owner[1])
                reply = await client.call("CheckRefs", {"ids": ids},
                                          timeout=10)
                owned = reply.get("owned", [])
                unowned.extend(
                    oid for oid, ok in zip(ids, owned) if not ok)
            except Exception:
                # unreachable owner (died without the raylet learning, or
                # network partition): every primary it pinned is suspect
                unowned.extend(ids)
        # 3. two-sweep cross-check: confirmed = unowned now AND last sweep
        confirmed = [oid for oid in unowned if oid in self._leak_candidates]
        self._leak_candidates = {
            oid: self._leak_candidates.get(oid, now) for oid in unowned}
        self._leaks = {
            oid: self._leak_record(oid) for oid in confirmed}
        # 4. publish newly confirmed leaks (once per object, cooldown gap)
        new = [oid for oid in confirmed if oid not in self._leak_fired]
        if not new:
            return
        cooldown = CONFIG.memory_leak_cooldown_s
        if now - self._last_leak_incident < cooldown:
            return  # they stay in _leaks/_leak_candidates; next window
        self._last_leak_incident = now
        self._leak_fired.update(new)
        records = [self._leaks[oid] for oid in new]
        for rec in records:
            _fr.record("obj.leak", bytes.fromhex(rec["object_id"]),
                       rec["size"])
        await self._fire_leak_incident(records)

    def _leak_record(self, oid: bytes) -> dict:
        meta = self._pin_meta.get(oid, {})
        view = self._pinned.get(oid)
        size = view.nbytes if view is not None else (
            self._spilled.get(oid, (None, meta.get("size", 0)))[1])

        def _hex(v):
            return v.hex() if isinstance(v, (bytes, bytearray)) else (v or "")

        return {
            "object_id": oid.hex(),
            "size": size,
            "node_id": self.node_id.hex(),
            "job_id": _hex(meta.get("job_id")),
            "actor_id": _hex(meta.get("actor_id")),
            "task_id": _hex(meta.get("task_id")),
            "callsite": meta.get("callsite", ""),
            "owner_addr": list(meta.get("owner_addr") or []),
            "spilled": oid in self._spilled and oid not in self._pinned,
            "first_unowned": self._leak_candidates.get(oid, 0.0),
        }

    async def _fire_leak_incident(self, records: List[dict]):
        from ray_tpu_torch._private import watchdog as _wd

        total = sum(r["size"] for r in records)
        top = max(records, key=lambda r: r["size"])
        where = f" @ {top['callsite']}" if top.get("callsite") else ""
        incident = _wd.build_incident(
            "object_leak", "raylet",
            f"{len(records)} leaked object(s) / {total} bytes in plasma on "
            f"node {self.node_id.hex()[:12]}: no live reference in any "
            f"owner's ledger across two sweeps — largest "
            f"{top['object_id'][:12]} ({top['size']} bytes, job "
            f"{top['job_id'][:12] or '?'}"
            + (f", actor {top['actor_id'][:12]}" if top["actor_id"] else "")
            + f"){where}",
            node_id=self.node_id.hex(),
        )
        incident["leaks"] = records
        try:
            await self.gcs.call(
                "ReportIncident", {"incident": incident}, timeout=10)
        except Exception:
            pass

    async def handle_GetMemoryReport(self, req):
        """Memory plane fan-in: this node's plasma + spill + pin tables
        joined with every live worker's ownership ledger and per-role RSS
        in one reply (util.state aggregates the cluster view).
        ``sweep=True`` forces a leak sweep first (`ray-tpu-torch memory --leaks`
        wants current truth, not the last cadence's)."""
        from ray_tpu_torch._private import memory_report as _mr

        if req.get("sweep"):
            try:
                await self._leak_sweep_once()
            except Exception:
                logger.exception("forced leak sweep failed")
        limit = req.get("limit") or CONFIG.memory_report_top_n
        try:
            plasma_stats = self.plasma.stats()
        except Exception:
            plasma_stats = {}
        pinned_bytes = sum(v.nbytes for v in self._pinned.values())
        spilled_bytes = sum(size for _, size in self._spilled.values())

        def _meta_out(oid):
            meta = self._pin_meta.get(oid, {})
            return {
                "job_id": meta.get("job_id") or b"",
                "actor_id": meta.get("actor_id") or b"",
                "task_id": meta.get("task_id") or b"",
                "callsite": meta.get("callsite", ""),
                "owner_addr": list(meta.get("owner_addr") or []),
            }

        objects = []
        seen = set()
        for oid in self.plasma.list_object_ids():
            b = oid.binary()
            seen.add(b)
            size = None
            view = self.plasma.get(b)
            if view is not None:
                size = view.nbytes
                view.release()
                self.plasma.release(b)
            objects.append({
                "object_id": b, "size": size,
                "pinned": b in self._pinned, "spilled": b in self._spilled,
                **_meta_out(b),
            })
        for oid, (_path, size) in self._spilled.items():
            if oid not in seen:
                objects.append({
                    "object_id": oid, "size": size,
                    "pinned": False, "spilled": True, **_meta_out(oid),
                })
        out = {
            "node_id": self.node_id.binary(),
            "time": time.time(),
            "plasma": plasma_stats,
            "pinned_count": len(self._pinned),
            "pinned_bytes": pinned_bytes,
            "spilled_count": len(self._spilled),
            "spilled_bytes": spilled_bytes,
            "objects": objects,
            "leaks": list(self._leaks.values()),
            "leak_candidates": len(self._leak_candidates),
            "raylet_rss": _mr.process_rss(),
            "agent_rss": _mr.process_rss(
                getattr(getattr(self, "_agent_proc", None), "pid", None)),
            "workers": [],
        }
        if req.get("include_workers", True):
            async def _one(h):
                try:
                    client = await self.pool.get(*h.addr)
                    r = await client.call(
                        "GetMemoryReport", {"limit": limit}, timeout=10)
                    return r.get("report")
                except Exception:
                    return None

            live = [h for h in self.worker_pool.workers.values()
                    if h.alive and h.addr[1]]
            replies = await asyncio.gather(*(_one(h) for h in live))
            out["workers"] = [r for r in replies if r]
        return out

    # ------------------------------------------------------------ log monitor

    async def _log_monitor_loop(self):
        """Tail this node's worker logs and publish new lines over GCS
        pubsub to the owning job's driver (reference:
        python/ray/_private/log_monitor.py:103 — per-node monitor feeding
        the driver's log stream)."""
        tracked: Dict[str, dict] = {}  # path -> {off,job,pid,err,last_growth}

        async def _publish(t, lines) -> bool:
            try:
                await self.gcs.call(
                    "Publish",
                    {
                        "channel": f"logs:{t['job'].hex()}",
                        "message": {
                            "pid": t["pid"],
                            "ip": self.host,
                            "is_err": t["err"],
                            "lines": lines,
                        },
                    },
                    timeout=10,
                )
                return True
            except Exception:
                return False

        while True:
            # Adaptive cadence: each pass stats every tracked file, so at
            # many-worker scale a fixed 250 ms tick becomes thousands of
            # stat()s per second of pure overhead.
            await asyncio.sleep(0.25 if len(tracked) < 400 else 1.0)
            try:
                now = time.time()
                live_paths = set()
                for h in list(self.worker_pool.workers.values()):
                    if not h.log_prefix:
                        continue
                    for suffix, is_err in ((".out", False), (".err", True)):
                        path = h.log_prefix + suffix
                        live_paths.add(path)
                        tracked.setdefault(
                            path,
                            {"off": 0, "job": h.job_id, "pid": h.pid,
                             "err": is_err, "last_growth": now},
                        )
                for path, t in list(tracked.items()):
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    if size <= t["off"]:
                        # Drop only files of DEPARTED workers once drained —
                        # a live worker's entry must persist or its path
                        # would be re-registered at off=0 and replayed.
                        if path not in live_paths and now - t["last_growth"] > 10.0:
                            tracked.pop(path, None)
                        continue
                    with open(path, "rb") as f:
                        f.seek(t["off"])
                        data = f.read(min(size - t["off"], 1 << 20))
                    # Hold back a trailing partial line (mid-print or the
                    # 1 MiB cap landing mid-line) until its newline arrives;
                    # flush it anyway once the worker is gone.
                    cut = data.rfind(b"\n")
                    if cut < 0:
                        if path in live_paths:
                            continue
                        cut = len(data) - 1
                    data = data[: cut + 1]
                    lines = [
                        ln.decode("utf-8", "replace")
                        for ln in data.splitlines()
                    ]
                    # Advance the offset only after a successful publish so
                    # lines produced around a GCS outage are retried, not
                    # silently dropped.
                    if not lines or await _publish(t, lines):
                        t["off"] += len(data)
                        t["last_growth"] = now
            except Exception:
                logger.exception("log monitor error")

    # --------------------------------------------------------- object plane

    async def handle_PinObject(self, req):
        """Hold the primary copy of an owned object against LRU eviction."""
        oid = req["object_id"]
        if oid not in self._pinned:
            view = self.plasma.get(oid)
            if view is not None:
                self._pinned[oid] = view
        # Ownership attribution for the memory plane: who to ask (leak
        # sweep) and who to blame (reports) for this primary.
        meta = dict(req.get("meta") or {})
        meta["owner_addr"] = req.get("owner_addr")
        meta.setdefault("t", time.time())
        self._pin_meta[oid] = meta

    async def handle_FreeObjects(self, req):
        for oid in req["ids"]:
            view = self._pinned.pop(oid, None)
            if view is not None:
                try:
                    view.release()
                except Exception:
                    pass
                self.plasma.release(oid)
            self.plasma.delete(oid)
            spilled = self._spilled.pop(oid, None)
            if spilled is not None:
                try:
                    os.remove(spilled[0])
                except OSError:
                    pass
            # freed is not leaked: drop the object's memory-plane state
            self._pin_meta.pop(oid, None)
            self._leak_candidates.pop(oid, None)
            self._leaks.pop(oid, None)
            self._leak_fired.discard(oid)

    async def handle_FetchObjectInfo(self, req):
        oid = req["object_id"]
        view = self.plasma.get(oid)
        if view is None:
            # Spilled here: remote pulls are served straight from disk
            # (reference: spilled-object chunk reader, object_manager/
            # spilled_object_reader.h) — no plasma round-trip.
            spilled = self._spilled.get(oid)
            if spilled is not None:
                return {"found": True, "size": spilled[1]}
            return {"found": False}
        size = view.nbytes
        view.release()
        self.plasma.release(oid)
        return {"found": True, "size": size}

    async def handle_FetchChunk(self, req):
        oid = req["object_id"]
        off, size = req["offset"], req["size"]
        view = self.plasma.get(oid)
        if view is None:
            spilled = self._spilled.get(oid)
            if spilled is not None:
                loop = asyncio.get_running_loop()

                def _read():
                    with open(spilled[0], "rb") as f:
                        f.seek(off)
                        return f.read(size)

                try:
                    data = await loop.run_in_executor(None, _read)
                except OSError:
                    return {"found": False}
                # raw after the header — no msgpack encode of the bulk
                return OobPayload({"found": True}, data)
            return {"found": False}

        def _release(v=view, o=oid):
            try:
                v.release()
            except Exception:
                pass
            self.plasma.release(o)

        # the plasma view slice itself goes on the wire (no bytes() copy);
        # the pin drops once the frame is handed to the transport
        return OobPayload({"found": True}, view[off:off + size], release=_release)

    # ------------------------------------------------- push path (outbound)

    async def handle_PushObject(self, req):
        """Push a locally-held object to a target raylet (reference:
        ObjectManager::Push, object_manager/object_manager.cc:339 +
        push_manager.h). The owner (or the broadcast helper) hints the
        destination; chunks stream holder->target so the target never has
        to discover a source."""
        oid = req["object_id"]
        target = req["target"]  # node_id bytes
        owner_addr = req.get("owner_addr")
        info = self.cluster_view.get(target)
        if info is None:
            return {"ok": False, "error": "unknown target node"}
        view = self.plasma.get(oid)
        size = None
        if view is None:
            spilled = self._spilled.get(oid)
            if spilled is None:
                return {"ok": False, "error": "object not local"}
            size = spilled[1]
        else:
            size = view.nbytes
        try:
            peer = await self.pool.get(info["ip"], info["raylet_port"])
            begin = await peer.call(
                "ReceiveBegin",
                {"object_id": oid, "size": size,
                 "owner_addr": list(owner_addr) if owner_addr else None},
                timeout=30,
            )
            if begin.get("already"):
                return {"ok": True, "already": True}
            if not begin.get("ok"):
                return {"ok": False, "error": begin.get("error", "begin failed")}
            chunk = CONFIG.object_manager_chunk_size
            # chunks are offset-addressed, so pipeline them (windowed
            # gather) instead of paying one RTT per 4 MiB — same treatment
            # the pull path's striped fetch got
            sem = asyncio.Semaphore(8)
            loop = asyncio.get_running_loop()

            async def send_one(offset):
                n = min(chunk, size - offset)
                async with sem:
                    if view is not None:
                        # zero-copy: the plasma view slice rides raw after
                        # the out-of-band frame header — never bytes()'d,
                        # never msgpack-encoded
                        r = await peer.call(
                            "ReceiveChunk",
                            {"object_id": oid, "offset": offset},
                            timeout=60,
                            oob=view[offset:offset + n],
                        )
                    else:
                        spilled = self._spilled.get(oid)
                        if spilled is None:
                            # restored or freed mid-transfer: the spill
                            # file is gone — fail THIS push cleanly; the
                            # outer handler turns it into {"ok": False}
                            raise RuntimeError(
                                f"source for {oid.hex()[:12]} vanished "
                                "mid-push (spilled copy restored or freed)"
                            )
                        # one copy (page cache -> buf), then raw send; the
                        # window bounds memory to 8 chunks
                        buf = bytearray(n)

                        def _read(path=spilled[0], off=offset, b=buf):
                            with open(path, "rb") as f:
                                f.seek(off)
                                if f.readinto(b) != len(b):
                                    raise RuntimeError(
                                        "spill file truncated mid-push"
                                    )

                        await loop.run_in_executor(None, _read)
                        r = await peer.call(
                            "ReceiveChunk",
                            {"object_id": oid, "offset": offset},
                            timeout=60,
                            oob=buf,
                        )
                return bool(r.get("ok"))

            oks = await asyncio.gather(
                *(send_one(off) for off in range(0, size, chunk))
            )
            if not all(oks):
                _fr.record("obj.push", oid, "target aborted")
                return {"ok": False, "error": "target aborted"}
            r = await peer.call("ReceiveEnd", {"object_id": oid}, timeout=30)
            _fr.record("obj.push", oid, "ok" if r.get("ok") else "end failed")
            return {"ok": bool(r.get("ok"))}
        except Exception as e:
            _fr.record("rpc.error", oid, f"PushObject: {type(e).__name__}")
            return {"ok": False, "error": str(e)}
        finally:
            if view is not None:
                view.release()
                self.plasma.release(oid)

    # ------------------------------------------------- push path (inbound)

    def _abort_recv(self, oid: bytes):
        rec = self._recv.pop(oid, None)
        if rec is None:
            return
        with self._recv_lock:
            if rec.get("landing", 0) > 0:
                # a chunk is streaming into the buffer right now (oob sink,
                # possibly on a reactor shard thread) — defer the plasma
                # abort until the last lander finishes so the store can't
                # hand this memory to a new object mid-write
                rec["abort_pending"] = True
                return
        self._finish_abort_recv(oid, rec)

    def _finish_abort_recv(self, oid: bytes, rec: dict):
        try:
            rec["view"].release()
        except Exception:
            pass
        try:
            self.plasma.abort(oid)
        except Exception:
            pass

    def _receive_chunk_sink(self, payload, nbytes: int):
        """RpcServer oob sink: hand back the pre-created plasma buffer slice
        at the chunk's offset so the raw payload streams from the socket
        straight into shared memory — no intermediate chunk buffer."""
        rec = self._recv.get(payload.get("object_id"))
        if rec is None:
            return None
        off = payload.get("offset")
        if not isinstance(off, int) or off < 0 or off + nbytes > rec["size"]:
            return None
        with self._recv_lock:
            rec["landing"] = rec.get("landing", 0) + 1
        rec["t"] = time.time()

        def done(ok, oid=payload["object_id"], rec=rec):
            with self._recv_lock:
                rec["landing"] -= 1
                rec["t"] = time.time()
                finish = rec.get("abort_pending") and rec["landing"] <= 0
            if finish:
                self._finish_abort_recv(oid, rec)

        return rec["view"][off:off + nbytes], done

    async def handle_ReceiveBegin(self, req):
        oid = req["object_id"]
        if self.plasma.contains(oid):
            return {"ok": True, "already": True}
        if oid in self._pulls:
            # a pull is mid-transfer for the same object; "already" would be
            # a lie (the copy isn't here yet) — pushers retry or move on
            return {"ok": False, "error": "pull already in progress"}
        rec = self._recv.get(oid)
        if rec is not None:
            # A dead pusher must not wedge this object forever: reclaim the
            # unsealed buffer once the transfer has gone idle, otherwise
            # report busy (NOT success — the object is not here yet).
            if time.time() - rec["t"] > 60:
                self._abort_recv(oid)
            else:
                return {"ok": False, "error": "push already in progress"}
        try:
            dest = await self._plasma_create_with_room(oid, req["size"])
        except FileExistsError:
            # an unsealed buffer we don't own (e.g. a pull that registered
            # after our check): sealed means done, unsealed means busy
            if self.plasma.contains(oid):
                return {"ok": True, "already": True}
            return {"ok": False, "error": "object mid-transfer"}
        except PlasmaOOM:
            return {"ok": False, "error": "no plasma room"}
        self._recv[oid] = {
            "view": dest, "size": req["size"],
            "owner_addr": req.get("owner_addr"), "t": time.time(),
        }
        return {"ok": True}

    async def handle_ReceiveChunk(self, req):
        rec = self._recv.get(req["object_id"])
        if rec is None:
            return {"ok": False}
        oob = req.get("_oob")
        if isinstance(oob, int):
            # the oob sink already streamed the chunk into the plasma
            # buffer at its offset — nothing left to copy
            return {"ok": True}
        data = oob if oob is not None else req.get("data")
        if data is None:
            return {"ok": False, "error": "no chunk payload"}
        off = req["offset"]
        if off < 0 or off + len(data) > rec["size"]:
            return {"ok": False, "error": "chunk out of bounds"}
        rec["view"][off:off + len(data)] = data
        rec["t"] = time.time()
        return {"ok": True}

    async def handle_ReceiveEnd(self, req):
        oid = req["object_id"]
        rec = self._recv.pop(oid, None)
        if rec is None:
            return {"ok": False}
        rec["view"].release()
        self.plasma.seal(oid)
        owner_addr = rec.get("owner_addr")
        if owner_addr:
            try:
                owner = await self.pool.get(owner_addr[0], owner_addr[1])
                await owner.notify(
                    "AddObjectLocation",
                    {"object_id": oid, "node_id": self.node_id.binary()},
                )
            except Exception:
                pass
        return {"ok": True}

    async def handle_PullObject(self, req):
        """Make the object local; replies once it is sealed in local plasma.

        Pull-based like the reference's PullManager (reference:
        object_manager/pull_manager.h:92); chunked fetch from one holder.
        """
        oid = req["object_id"]
        if self.plasma.contains(oid):
            return {"ok": True}
        inflight = self._pulls.get(oid)
        if inflight is not None:
            await inflight.wait()
            return {"ok": self.plasma.contains(oid)}
        event = asyncio.Event()
        self._pulls[oid] = event
        try:
            if oid in self._spilled:
                # Spilled on this node: restore from disk, deduplicated by
                # the same in-flight event as remote pulls so concurrent
                # getters never observe a half-restored (unsealed) object.
                ok = await self._restore_spilled(oid)
            else:
                ok = await self._do_pull(oid, req.get("owner_addr"))
            _fr.record("obj.pull", oid, "ok" if ok else "fail")
            return {"ok": ok}
        finally:
            event.set()
            self._pulls.pop(oid, None)

    async def _do_pull(self, oid: bytes, owner_addr) -> bool:
        # 1. locations from the owner (owner-based directory, reference:
        #    ownership_based_object_directory.h)
        locations: List[bytes] = []
        if owner_addr:
            try:
                owner = await self.pool.get(owner_addr[0], owner_addr[1])
                status = await owner.call(
                    "GetObjectStatus", {"object_id": oid, "wait": True}, timeout=30
                )
                locations = list(status.get("plasma", {}).get("locations", []))
                if not locations:
                    logger.warning(
                        "pull %s: owner reports no plasma locations (status=%s)",
                        oid.hex()[:12], status.get("status"),
                    )
            except Exception as e:
                logger.warning("pull %s: owner unreachable: %s", oid.hex()[:12], e)
                return False
        # Broadcast-friendly source selection: shuffle so concurrent pullers
        # of a hot object spread over ALL registered holders instead of all
        # hammering the primary (new copies register with the owner as they
        # complete, so the source set grows as a broadcast fans out —
        # reference: push_manager.h + ownership_based_object_directory.h).
        import random as _random

        locations = [l for l in locations if l != self.node_id.binary()]
        _random.shuffle(locations)
        peers = []
        size = None
        for loc in locations:
            info = self.cluster_view.get(loc)
            if info is None:
                continue
            try:
                peer = await self.pool.get(info["ip"], info["raylet_port"])
                meta = await peer.call(
                    "FetchObjectInfo", {"object_id": oid}, timeout=30
                )
                if meta.get("found"):
                    size = meta["size"]
                    peers.append(peer)
                    if len(peers) >= 4:
                        break
            except Exception as e:
                logger.warning(
                    "pull %s: holder %s unusable: %s",
                    oid.hex()[:12], loc.hex()[:12], e,
                )
        if not peers:
            return False
        try:
            dest = await self._plasma_create_with_room(oid, size)
        except FileExistsError:
            # A buffer already exists: a SEALED copy is success, but an
            # inbound push mid-transfer is not — wait for it to seal
            # instead of handing the caller a half-written object.
            deadline = time.time() + 120
            while time.time() < deadline:
                if self.plasma.contains(oid):
                    return True
                if oid not in self._recv:
                    # transfer vanished (aborted): one shot at a clean redo
                    try:
                        dest = await self._plasma_create_with_room(oid, size)
                        break
                    except FileExistsError:
                        return self.plasma.contains(oid)
                    except PlasmaOOM:
                        return False
                await asyncio.sleep(0.1)
            else:
                return False
        except PlasmaOOM:
            logger.warning("pull %s: no room even after spilling", oid.hex()[:12])
            return False
        # Chunks fetch CONCURRENTLY, striped across every viable holder
        # (reference: object_buffer_pool chunked transfer) — a large object
        # rides multiple source NICs instead of one.
        chunk = CONFIG.object_manager_chunk_size
        offsets = list(range(0, size, chunk))
        sem = asyncio.Semaphore(8)

        async def fetch_one(i, off):
            n = min(chunk, size - off)
            order = peers[i % len(peers):] + peers[:i % len(peers)]
            async with sem:
                for peer in order:
                    try:
                        # oob_dest: the holder's out-of-band response frame
                        # streams from the socket straight into OUR plasma
                        # buffer at this chunk's offset — no staging buffer.
                        # (A timed-out call unregisters the dest; a response
                        # landing from a retried peer writes the same bytes.)
                        r = await peer.call(
                            "FetchChunk",
                            {"object_id": oid, "offset": off, "size": n},
                            timeout=60,
                            oob_dest=dest[off:off + n],
                        )
                    except Exception:
                        continue
                    if r.get("found"):
                        oob = r.get("_oob")
                        if oob == n:
                            return True  # landed in place
                        data = oob if oob is not None else r.get("data")
                        if data is None or len(data) != n:
                            continue
                        dest[off:off + n] = data
                        return True
                return False

        results = await asyncio.gather(
            *(fetch_one(i, off) for i, off in enumerate(offsets))
        )
        if not all(results):
            dest.release()
            self.plasma.abort(oid)
            return False
        dest.release()
        self.plasma.seal(oid)
        # register the new copy with the owner
        if owner_addr:
            try:
                owner = await self.pool.get(owner_addr[0], owner_addr[1])
                await owner.notify(
                    "AddObjectLocation",
                    {"object_id": oid, "node_id": self.node_id.binary()},
                )
            except Exception:
                pass
        return True

    async def handle_GetLocalObjectInfo(self, req):
        """State-API source: this node's plasma + spilled objects."""
        objects = []
        seen = set()
        for oid in self.plasma.list_object_ids():
            b = oid.binary()
            seen.add(b)
            size = None
            view = self.plasma.get(b)
            if view is not None:
                size = view.nbytes
                view.release()
                self.plasma.release(b)
            objects.append(
                {
                    "object_id": b,
                    "size": size,
                    "pinned": b in self._pinned,
                    "spilled": b in self._spilled,
                }
            )
        for oid, (path, size) in self._spilled.items():
            if oid not in seen:
                objects.append(
                    {"object_id": oid, "size": size, "pinned": False, "spilled": True}
                )
        return {"objects": objects}

    async def handle_GetLocalWorkerInfo(self, req):
        """State-API source: live worker processes on this node."""
        workers = []
        for h in self.worker_pool.workers.values():
            workers.append(
                {
                    "worker_id": h.worker_id,
                    "pid": h.pid,
                    "job_id": h.job_id,
                    "leased": h.leased,
                    "actor_id": self._actor_workers.get(h.worker_id, b""),
                    "alive": h.alive,
                }
            )
        return {"workers": workers}

    async def handle_ProfileWorker(self, req):
        """Proxy an on-demand profile request to one of this node's
        workers, addressed by worker_id or pid (reference: dashboard
        reporter agent routing, reporter_agent.py:314)."""
        target = None
        for h in self.worker_pool.workers.values():
            if (req.get("worker_id") and h.worker_id == req["worker_id"]) or (
                req.get("pid") and h.pid == req["pid"]
            ):
                target = h
                break
        if target is None or not target.addr[1]:
            return {"error": "no such worker on this node"}
        client = await self.pool.get(*target.addr)
        r = await client.call(
            "Profile",
            {"duration": req.get("duration", 2.0), "hz": req.get("hz", 100.0)},
            timeout=float(req.get("duration", 2.0)) + 30,
        )
        return r

    async def handle_StartProfile(self, req):
        """Profiling-plane fan-out: start a synchronized capture window in
        this raylet AND (include_workers, default True) every live local
        worker. CollectProfile fans the sample sets back in — together the
        pair gives the driver one RPC round per node for a cluster-wide
        profile."""
        from ray_tpu_torch._private import sampling_profiler as _sp

        duration = req.get("duration", 2.0)
        hz = req.get("hz", 99.0)
        started = 0
        try:
            _sp.start_profile(duration, hz, role="raylet")
            started += 1
        except RuntimeError:
            pass  # a capture is already running here; collect returns it
        errors = []
        if req.get("include_workers", True):
            async def _one(h):
                try:
                    client = await self.pool.get(*h.addr)
                    r = await client.call(
                        "StartProfile", {"duration": duration, "hz": hz},
                        timeout=10)
                    return r.get("error")
                except Exception as e:
                    return str(e)

            live = [h for h in self.worker_pool.workers.values()
                    if h.alive and h.addr[1]]
            replies = await asyncio.gather(*(_one(h) for h in live))
            for h, err in zip(live, replies):
                if err:
                    errors.append(f"pid {h.pid}: {err}")
                else:
                    started += 1
        return {"ok": True, "started": started, "errors": errors}

    async def handle_CollectProfile(self, req):
        """Fan-in half: joins this raylet's capture (off-loop) and every
        live worker's, returning one profile list for the node."""
        from ray_tpu_torch._private import sampling_profiler as _sp

        loop = asyncio.get_running_loop()
        profiles = []

        async def _collect_self():
            p = await loop.run_in_executor(None, _sp.collect_profile)
            if p is not None:
                return p
            return None

        async def _one(h):
            try:
                client = await self.pool.get(*h.addr)
                r = await client.call("CollectProfile", {}, timeout=150)
                return r.get("profile")
            except Exception:
                return None

        live = [h for h in self.worker_pool.workers.values()
                if h.alive and h.addr[1]]
        results = await asyncio.gather(
            _collect_self(), *(_one(h) for h in live))
        for p in results:
            if p:
                profiles.append(p)
        return {"node_id": self.node_id.binary(), "profiles": profiles}

    async def handle_DumpFlightRecorder(self, req):
        """Forensics fan-in: this raylet's ring plus every live local
        worker's ring in one reply (`ray-tpu-torch debug dump` calls this once
        per node)."""
        limit = req.get("limit") or 0
        out = {
            "node_id": self.node_id.binary(),
            "pid": os.getpid(),
            "events": _fr.dump(limit),
            "workers": [],
        }
        if req.get("include_workers", True):
            async def _one(h):
                try:
                    client = await self.pool.get(*h.addr)
                    return await client.call(
                        "DumpFlightRecorder", {"limit": limit}, timeout=5)
                except Exception:
                    return None

            live = [h for h in self.worker_pool.workers.values()
                    if h.alive and h.addr[1]]
            replies = await asyncio.gather(*(_one(h) for h in live))
            out["workers"] = [r for r in replies if r]
        return out

    async def handle_Ping(self, req):
        return {"ok": True}

    async def shutdown(self):
        # Worker deaths during teardown are expected, never incidents.
        self._draining = True
        _fr.flush_now()
        for t in self._bg:
            t.cancel()
        proc = getattr(self, "_agent_proc", None)
        if proc is not None:
            self._agent_proc = None
            try:
                proc.kill()
            except Exception:
                pass
            try:
                await asyncio.wait_for(self._deregister_agent(), timeout=5)
            except Exception:
                pass
        self.worker_pool.shutdown()
        await self.server.stop()
        self.plasma.close()
        PlasmaClient.unlink(self.plasma_name)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", default="")
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--is-head", action="store_true")
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--port-file", default="")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from ray_tpu_torch._private.proc_profile import maybe_enable_process_profile
    maybe_enable_process_profile("raylet")

    import json

    node_id = NodeID.from_hex(args.node_id) if args.node_id else NodeID.from_random()
    resources = json.loads(args.resources)
    labels = json.loads(args.labels)
    if "CPU" not in resources:
        resources["CPU"] = float(os.cpu_count() or 1)
    auto_res, auto_labels = accelerators.node_resources_and_labels()
    for k, v in auto_res.items():
        resources.setdefault(k, v)
    for k, v in auto_labels.items():
        labels.setdefault(k, v)

    async def run():
        nm = NodeManager(
            node_id, args.host, args.gcs_address, resources, labels,
            args.session_dir, is_head=args.is_head,
            object_store_memory=args.object_store_memory or None,
        )
        port = await nm.start(args.port)
        # SIGTERM (a node's shutdown) ends the raylet as it always has, once
        # the store's segment is unlinked: its name and pages would outlive
        # the node in /dev/shm (a segment a raylet, each holding its objects)
        import signal

        def _on_term():
            PlasmaClient.unlink(nm.plasma_name)
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, _on_term)
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, args.port_file)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
