"""Per-node dashboard agent: host stats, metrics, profiling and log serving
off the raylet's event loop.

Counterpart of the reference's per-node agent process
(reference: python/ray/dashboard/agent.py:25 DashboardAgent,
dashboard/modules/reporter/reporter_agent.py:314 ReporterAgent — the
reference's raylet launches agent.py beside itself and the dashboard head
fans node-scoped queries out to the agents instead of doing the work
centrally). Here:

- The raylet spawns `python -m ray_tpu_torch.dashboard.agent` at startup, watches
  the child from its reaper loop, reports a death to the GCS worker-failure
  log and restarts it (capped).
- The agent registers `{host, port, pid}` under the GCS KV namespace
  ``agents`` keyed by node-id hex; the dashboard head resolves agents from
  there to serve /api/node_stats and route /api/profile.
- Handlers: NodeStats (psutil host + per-worker RSS), Metrics (Prometheus
  text), ProfileWorker (proxied to the target worker's in-process stack
  sampler, like the reference's reporter-agent -> worker routing), ListLogs
  and ReadLog (this node's session logs).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
import time

logger = logging.getLogger("ray_tpu_torch.agent")


class DashboardAgent:
    def __init__(self, gcs_address: str, node_id_hex: str, raylet_port: int,
                 session_dir: str, host: str = "127.0.0.1"):
        from ray_tpu_torch._private.gcs.client import GcsAioClient
        from ray_tpu_torch._private.rpc import ClientPool, RpcServer

        self.node_id_hex = node_id_hex
        self.host = host
        self.raylet_port = raylet_port
        self.session_dir = session_dir
        gcs_host, gcs_port = gcs_address.rsplit(":", 1)
        self.gcs = GcsAioClient(gcs_host, int(gcs_port))
        self.pool = ClientPool()
        self.server = RpcServer(host)
        self.port = 0
        self.started = time.time()

    async def start(self, port: int = 0) -> int:
        self.server.register_all(self)
        self.port = await self.server.start(port)
        await self.gcs.kv_put(
            b"agents", self.node_id_hex.encode(),
            json.dumps({
                "host": self.host, "port": self.port, "pid": os.getpid(),
            }).encode(),
        )
        logger.info("agent for node %s on %s:%s",
                    self.node_id_hex[:12], self.host, self.port)
        return self.port

    # ------------------------------------------------------------- handlers

    async def _raylet(self):
        return await self.pool.get(self.host, self.raylet_port)

    async def handle_Ping(self, req):
        return {"ok": True, "node_id": self.node_id_hex,
                "uptime_s": time.time() - self.started}

    async def handle_NodeStats(self, req):
        """Host stats + per-worker RSS (reference: reporter_agent.py:314
        _get_all_stats — cpu/mem/disk/net + worker processes)."""
        import psutil

        stats = {
            "node_id": self.node_id_hex,
            "cpu_percent": psutil.cpu_percent(interval=None),
            "cpu_count": psutil.cpu_count(),
            "load_avg": list(os.getloadavg()),
        }
        vm = psutil.virtual_memory()
        stats["mem"] = {"total": vm.total, "used": vm.used,
                        "available": vm.available, "percent": vm.percent}
        try:
            du = psutil.disk_usage(self.session_dir or "/")
            stats["disk"] = {"total": du.total, "used": du.used,
                             "percent": du.percent}
        except Exception:
            stats["disk"] = {}
        try:
            nio = psutil.net_io_counters()
            stats["net"] = {"sent": nio.bytes_sent, "recv": nio.bytes_recv}
        except Exception:
            stats["net"] = {}
        workers = []
        try:
            raylet = await self._raylet()
            info = await raylet.call("GetLocalWorkerInfo", {}, timeout=5)
            procs = getattr(self, "_procs", None)
            if procs is None:
                procs = self._procs = {}
            for w in info.get("workers", []):
                rec = {"pid": w["pid"], "worker_id": w["worker_id"],
                       "leased": w.get("leased"), "alive": w.get("alive")}
                try:
                    # Cache Process objects across samples: cpu_percent on a
                    # fresh instance always reads 0.0 (reference:
                    # reporter_agent.py keeps its psutil handles).
                    p = procs.get(w["pid"])
                    if p is None:
                        p = procs[w["pid"]] = psutil.Process(w["pid"])
                        p.cpu_percent(interval=None)  # prime
                    rec["rss"] = p.memory_info().rss
                    rec["cpu_percent"] = p.cpu_percent(interval=None)
                except Exception:
                    procs.pop(w["pid"], None)
                workers.append(rec)
            live = {w["pid"] for w in info.get("workers", [])}
            for pid in list(procs):
                if pid not in live:
                    del procs[pid]
        except Exception as e:
            stats["workers_error"] = str(e)
        stats["workers"] = workers
        return stats

    async def handle_Metrics(self, req):
        """Prometheus text of this node's host metrics (the raylet's
        /metrics keeps the scheduler/object-plane series; the agent owns
        the host-level series, like the reference's reporter agent)."""
        from ray_tpu_torch._private.metrics import render_prometheus

        stats = await self.handle_NodeStats({})
        node = self.node_id_hex[:12]
        samples = [
            ("ray_tpu_agent_cpu_percent", {"node": node},
             stats["cpu_percent"]),
            ("ray_tpu_agent_mem_used_bytes", {"node": node},
             stats["mem"]["used"]),
            ("ray_tpu_agent_mem_total_bytes", {"node": node},
             stats["mem"]["total"]),
            ("ray_tpu_agent_uptime_seconds", {"node": node},
             time.time() - self.started),
        ]
        if stats.get("disk"):
            samples.append(("ray_tpu_agent_disk_used_bytes", {"node": node},
                            stats["disk"]["used"]))
        for w in stats["workers"]:
            if "rss" in w:
                samples.append(
                    ("ray_tpu_agent_worker_rss_bytes",
                     {"node": node, "pid": str(w["pid"])}, w["rss"]))
        return {"text": render_prometheus(samples)}

    async def handle_ProfileWorker(self, req):
        """Stack-sample one of this node's workers (addressed by pid or
        worker_id): resolve via the raylet's worker table, then call the
        worker's in-process Profile handler."""
        raylet = await self._raylet()
        info = await raylet.call("GetLocalWorkerInfo", {}, timeout=5)
        target = None
        for w in info.get("workers", []):
            if ((req.get("pid") and w["pid"] == req["pid"])
                    or (req.get("worker_id")
                        and w["worker_id"] == req["worker_id"])):
                target = w
                break
        if target is None:
            return {"error": "no such worker on this node"}
        # The raylet proxies because it knows worker RPC addresses; reuse it.
        return await raylet.call("ProfileWorker", dict(req), timeout=60)

    async def handle_ListLogs(self, req):
        base = self.session_dir
        if not base or not os.path.isdir(base):
            return {"files": []}
        files = []
        for root, _dirs, names in os.walk(base):
            for name in names:
                if name.endswith((".log", ".out", ".err")):
                    p = os.path.join(root, name)
                    try:
                        files.append({
                            "path": os.path.relpath(p, base),
                            "size": os.path.getsize(p),
                        })
                    except OSError:
                        pass
        return {"files": files}

    async def handle_ReadLog(self, req):
        base = self.session_dir
        rel = req.get("path", "")
        path = os.path.normpath(os.path.join(base, rel))
        if not path.startswith(os.path.normpath(base) + os.sep):
            return {"error": "path escapes session dir"}
        try:
            size = os.path.getsize(path)
            tail = int(req.get("tail_bytes", 64 * 1024))
            with open(path, "rb") as f:
                if size > tail:
                    f.seek(size - tail)
                data = f.read(tail)
            return {"data": data, "size": size}
        except OSError as e:
            return {"error": str(e)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--session-dir", default="")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--raylet-pid", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    async def run():
        agent = DashboardAgent(args.gcs_address, args.node_id,
                               args.raylet_port, args.session_dir, args.host)
        await agent.start(0)
        # Fate-share with the spawning raylet: when it dies (even SIGKILL,
        # where its async shutdown never runs) this agent must exit instead
        # of lingering as an orphan whose GCS client burns CPU reconnect-
        # looping (reference: the agent<->raylet fate-sharing contract in
        # dashboard/agent.py). The raylet's pid comes via argv — a ppid
        # snapshot would race (raylet killed before we sample -> we'd
        # capture init's pid and never notice).
        raylet_pid = args.raylet_pid or os.getppid()
        while True:
            await asyncio.sleep(2.0)
            try:
                os.kill(raylet_pid, 0)
            except ProcessLookupError:
                logger.info("raylet (pid %s) gone; agent exiting", raylet_pid)
                return
            except PermissionError:
                pass  # alive, different uid

    asyncio.run(run())


if __name__ == "__main__":
    main()
