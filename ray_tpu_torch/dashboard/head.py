"""Dashboard head of the port: JSON/REST API over cluster state + job
submission (a copy of ``ray_tpu/dashboard/head.py``; its page counts GPUs
where the JAX head counts TPU chips).

Counterpart of the reference's dashboard head server
(reference: python/ray/dashboard/head.py:79 — aiohttp app aggregating
state + the job module's REST endpoints
dashboard/modules/job/job_head.py). Dependency-free asyncio HTTP/1.1 here;
the React client is out of scope, but a plain HTML summary is served at /
so the endpoint is human-checkable.

Routes:
  GET  /api/cluster                cluster resource summary
  GET  /api/nodes|actors|tasks|objects|workers|placement_groups|jobs
  GET  /api/profile                cluster-wide CPU capture (merged trace;
                                   ?format=flame folded, ?latest=1 registry,
                                   ?pid=/?worker_id= one-worker folded)
  GET  /api/memory                 cluster memory report (plasma + RSS +
                                   HBM rollups, ownership ledgers;
                                   ?group_by=job|actor|node, ?leaks=1
                                   runs the leak detector)
  GET  /api/perf                   perf-gate ledger + latest delta report
                                   (?metric= one metric's trajectory,
                                   ?limit=N history depth)
  GET  /api/jobs/                  submitted jobs (job_submission API)
  POST /api/jobs/                  submit {entrypoint, runtime_env?, ...}
  GET  /api/jobs/<id>              job info
  GET  /api/jobs/<id>/logs         {"logs": "..."}
  POST /api/jobs/<id>/stop         {"stopped": bool}
  GET  /api/version
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.dashboard")


class DashboardHead:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1"):
        # Loopback by default: /api/jobs executes arbitrary entrypoints, so
        # exposing it beyond the host must be an explicit operator choice
        # (reference: the dashboard binds localhost unless configured).
        self.gcs_address = gcs_address
        self.host = host
        self._server: Optional[asyncio.AbstractServer] = None
        self.port = 0
        self._gcs = None
        self._mgr = None

    # --------------------------------------------------------- data access

    def _state(self):
        from ray_tpu_torch.util import state

        return state

    def _gcs_client(self):
        if self._gcs is None:
            from ray_tpu_torch._private.gcs.client import GcsClient

            self._gcs = GcsClient.from_address(self.gcs_address)
        return self._gcs

    def _job_manager(self):
        if self._mgr is None:
            from ray_tpu_torch.job_submission import JobManager

            self._mgr = JobManager(self._gcs_client())
        return self._mgr

    def _collect(self, path: str, method: str, body: Optional[dict], query=None):
        """Blocking handler (run in executor): returns (status, payload)."""
        state = self._state()
        addr = self.gcs_address
        if path == "/api/cluster":
            return 200, {
                "cluster": self._gcs_client().get_cluster_resources(),
                "nodes": len(state.list_nodes(addr)),
            }
        if path == "/api/nodes":
            return 200, {"nodes": state.list_nodes(addr)}
        if path == "/api/actors":
            return 200, {"actors": state.list_actors(addr)}
        if path == "/api/tasks":
            return 200, {"tasks": state.list_tasks(addr)}
        if path == "/api/objects":
            return 200, {"objects": state.list_objects(addr)}
        if path == "/api/workers":
            return 200, {"workers": state.list_workers(addr)}
        if path == "/api/placement_groups":
            return 200, {"placement_groups": state.list_placement_groups(addr)}
        if path == "/api/version":
            from ray_tpu_torch._version import version

            return 200, {"version": version}
        if path.startswith("/api/logs"):
            return self._logs_api(path, query or {})
        if path.startswith("/api/profile"):
            return self._profile_api(query or {})
        if path == "/api/perf":
            return self._perf_api(query or {})
        if path == "/api/memory":
            return self._memory_api(query or {})
        if path == "/api/node_stats":
            return self._node_stats_api(query or {})
        if path == "/api/agent_metrics":
            return self._agent_metrics_api()
        if path == "/api/train":
            return self._train_api()
        if path == "/api/serve":
            return self._serve_api()
        if path == "/api/grafana_dashboard":
            from ray_tpu_torch.dashboard.grafana import generate_dashboard

            return 200, generate_dashboard()
        if path.startswith("/api/jobs"):
            return self._jobs_api(path, method, body, query or {})
        if path == "/" or path == "/index.html":
            return 200, None  # HTML handled by caller
        return 404, {"error": f"no route {path}"}

    def _jobs_api(self, path: str, method: str, body: Optional[dict], query):
        mgr = self._job_manager()
        parts = [p for p in path.split("/") if p]  # ["api","jobs",...]
        if len(parts) == 2:
            if method == "POST":
                body = body or {}
                if not body.get("entrypoint"):
                    return 400, {"error": "entrypoint is required"}
                sid = mgr.submit_job(
                    entrypoint=body["entrypoint"],
                    submission_id=body.get("submission_id"),
                    runtime_env=body.get("runtime_env"),
                    metadata=body.get("metadata"),
                )
                return 200, {"submission_id": sid}
            return 200, {"jobs": mgr.list_jobs()}
        sid = parts[2]
        try:
            if len(parts) == 3 and method == "GET":
                return 200, mgr.get_job_info(sid)
            if len(parts) == 4 and parts[3] == "logs":
                offset = int(query.get("offset", 0) or 0)
                return 200, {"logs": mgr.get_job_logs(sid, offset)}
            if len(parts) == 4 and parts[3] == "stop" and method == "POST":
                return 200, {"stopped": mgr.stop_job(sid)}
        except ValueError as e:
            return 404, {"error": str(e)}
        return 404, {"error": f"no route {path}"}

    def _profile_api(self, query):
        """GET /api/profile: the profiling plane over HTTP.

        With ``?pid=N`` / ``?worker_id=hex``: on-demand stack sampling of
        one worker process, flamegraph-folded output (reference: dashboard
        reporter profile_manager.py:78 — py-spy-shaped capability without
        the binary dependency). Optional ``node_id``/``duration``/``hz``.

        Without either: a cluster-wide synchronized capture
        (StartProfile/CollectProfile fan-out) returned as one
        Perfetto-loadable merged trace — ``?format=flame`` returns the
        aggregated folded stacks instead; ``?latest=1`` lists registered
        captures without sampling anything."""
        pid = query.get("pid")
        worker_id = query.get("worker_id")
        try:
            duration = float(query.get("duration", 2.0) or 2.0)
            hz = float(query.get("hz", 99.0) or 99.0)
            pid = int(pid) if pid else None
            wid = bytes.fromhex(worker_id) if worker_id else None
        except ValueError as e:
            return 400, {"error": f"bad query value: {e}"}
        if not pid and not wid:
            return self._cluster_profile_api(query, duration, hz)
        # Prefer the node's agent (keeps sampling fan-out off the raylet
        # loop); fall back to the raylet proxy when no agent is registered.
        node_id = query.get("node_id")
        if node_id:
            rec = self._agents().get(node_id)
            if rec is not None:
                try:
                    r = self._ask_agent(
                        rec, "ProfileWorker",
                        {"pid": pid, "worker_id": wid, "duration": duration,
                         "hz": hz},
                        timeout=duration + 30,
                    )
                    return (200, r) if "error" not in r else (404, r)
                except Exception:
                    pass  # agent gone mid-query: raylet path still works
        from ray_tpu_torch._private.profiling import profile_via_raylets

        return profile_via_raylets(
            self._gcs_client().get_all_node_info(),
            pid=pid, worker_id=wid, node_filter=query.get("node_id"),
            duration=duration, hz=hz,
        )

    def _cluster_profile_api(self, query, duration, hz):
        from ray_tpu_torch._private import profiling

        gcs = self._gcs_client()
        if query.get("latest"):
            return 200, {
                "captures": profiling.list_registered(gcs, "capture"),
                "device_traces": profiling.list_registered(
                    gcs, "device_trace"),
            }
        # Bound what one HTTP call can cost the cluster.
        duration = min(duration, 30.0)
        bundle = profiling.capture_cluster_profile(
            gcs.get_all_node_info(), gcs,
            duration=duration, hz=hz, node_filter=query.get("node_id"),
        )
        if query.get("format") == "flame":
            folded = profiling.fold_bundle(bundle)
            text = "\n".join(
                f"{s} {c}"
                for s, c in sorted(folded.items(), key=lambda kv: -kv[1]))
            return 200, {"folded": text,
                         "samples": sum(folded.values()),
                         "errors": bundle["errors"]}
        from ray_tpu_torch._private.timeline import merged_profile_trace

        try:
            task_events = gcs.call(
                "GetTaskEvents", {"limit": 100_000})["events"]
        except Exception:
            task_events = []
        device = profiling.list_registered(gcs, "device_trace")
        return 200, merged_profile_trace(bundle, task_events, device)

    def _memory_api(self, query):
        """GET /api/memory: the memory observability plane over HTTP —
        the cluster memory report (per-node plasma/pin/spill state joined
        with worker ownership ledgers) plus a rollup.
        ``?group_by=job|actor|node`` picks the rollup key (default job);
        ``?leaks=1`` forces a leak sweep and returns the findings;
        ``?objects=0`` drops the per-object listings (cheap summary)."""
        state = self._state()
        addr = self.gcs_address
        group_by = query.get("group_by") or "job"
        if group_by not in ("job", "actor", "node"):
            return 400, {"error": f"bad group_by {group_by!r}"}
        try:
            if query.get("leaks"):
                return 200, {
                    "leaks": state.find_memory_leaks(addr, sweep=True)}
            include_objects = query.get("objects", "1") not in ("0", "false")
            report = state.memory_report(
                addr, include_objects=include_objects)
            report["rollup"] = {
                "group_by": group_by,
                "rows": state.memory_rollup(report, group_by=group_by),
            }
            return 200, report
        except Exception as e:
            return 500, {"error": str(e)}

    def _perf_api(self, query):
        """GET /api/perf: the perf regression plane over HTTP — the ledger
        trajectory (the port's ledger via _private/perf_gate.py), the delta
        report between the two newest entries, and the newest incident that
        carries an auto-analysis ("why was that step slow"). Read-only: this
        endpoint never runs a bench."""
        from ray_tpu_torch._private import perf_analysis, perf_gate as pg

        try:
            limit = int(query.get("limit", 20) or 20)
        except ValueError:
            return 400, {"error": "limit must be an integer"}
        entries = pg.load_history(limit=limit)
        out = {"path": pg.history_path(),
               "history": [
                   {k: e.get(k) for k in
                    ("time", "iso", "git", "reps", "quick", "note",
                     "metrics")}
                   for e in entries
               ]}
        if len(entries) >= 2:
            base, cur = entries[-2], entries[-1]
            out["delta"] = pg.compare(
                base["metrics"], cur["metrics"],
                base_reps=base.get("reps", 1), cur_reps=cur.get("reps", 1))
        metric = query.get("metric")
        if metric:
            out["series"] = [
                {"time": e.get("time"), "git": e.get("git", ""),
                 "value": e["metrics"].get(metric)}
                for e in entries
            ]
        try:
            analysis = perf_analysis.latest_incident_analysis(
                self._gcs_client())
        except Exception:
            analysis = None  # ledger output stays useful without a GCS
        if analysis:
            out["latest_incident_analysis"] = analysis
        return 200, out

    # ------------------------------------------------- workload telemetry

    def _user_metrics(self, prefix: str) -> list:
        try:
            return self._gcs_client().call(
                "GetUserMetrics", {"prefix": prefix}
            ).get("records", [])
        except Exception:
            return []

    @staticmethod
    def _merge_hist(acc: dict, rec: dict):
        """Merge one histogram record into an accumulator (buckets sum)."""
        acc["count"] += rec.get("count", 0)
        acc["sum"] += rec.get("sum", 0.0)
        if not acc["boundaries"]:
            acc["boundaries"] = list(rec.get("boundaries") or [])
        for b, c in (rec.get("buckets") or {}).items():
            acc["buckets"][b] = acc["buckets"].get(b, 0) + c

    @staticmethod
    def _hist_summary(acc: dict) -> dict:
        """count/mean/p50/p90/p99 from merged Prometheus-style buckets.
        Quantiles resolve to the bucket upper bound — coarse but monotone,
        the same estimate Grafana's histogram_quantile gives."""
        count = acc["count"]
        out = {"count": count}
        if not count:
            return out
        out["mean"] = acc["sum"] / count
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            target = q * count
            cum = 0
            val = None
            for b in acc["boundaries"]:
                cum += acc["buckets"].get(str(b), 0)
                if cum >= target:
                    val = b
                    break
            out[key] = val  # None == above the largest finite bucket
        return out

    def _train_api(self):
        """GET /api/train: per-job training telemetry summary aggregated
        from the ray_tpu_train_* series (train/_telemetry.py). Throughput
        sums across workers; MFU/goodput average; step-time quantiles come
        from the merged step histogram."""
        jobs: dict = {}

        def job(rec):
            jid = rec["labels"].get("JobId", "")
            return jobs.setdefault(jid, {
                "steps": 0, "tokens_per_second": 0.0,
                "examples_per_second": 0.0, "workers": set(),
                "_mfu": [], "_goodput": [], "compile_seconds": 0.0,
                "hbm_bytes_in_use": 0.0,
                "_hist": {"count": 0, "sum": 0.0, "buckets": {},
                          "boundaries": []},
            })

        for rec in self._user_metrics("ray_tpu_train_"):
            j = job(rec)
            j["workers"].add(rec["labels"].get("WorkerId", ""))
            name = rec["name"]
            if name == "ray_tpu_train_steps_total":
                j["steps"] += int(rec["value"])
            elif name == "ray_tpu_train_tokens_per_second":
                j["tokens_per_second"] += rec["value"]
            elif name == "ray_tpu_train_examples_per_second":
                j["examples_per_second"] += rec["value"]
            elif name == "ray_tpu_train_mfu_ratio":
                j["_mfu"].append(rec["value"])
            elif name == "ray_tpu_train_goodput_ratio":
                j["_goodput"].append(rec["value"])
            elif name == "ray_tpu_train_compile_seconds":
                j["compile_seconds"] = max(j["compile_seconds"], rec["value"])
            elif name == "ray_tpu_train_hbm_bytes_in_use":
                j["hbm_bytes_in_use"] += rec["value"]
            elif name == "ray_tpu_train_step_seconds":
                self._merge_hist(j["_hist"], rec)
        out = {}
        for jid, j in jobs.items():
            mfu = j.pop("_mfu")
            goodput = j.pop("_goodput")
            hist = j.pop("_hist")
            j["workers"] = len(j["workers"] - {""}) or len(j["workers"])
            if mfu:
                j["mfu"] = sum(mfu) / len(mfu)
            if goodput:
                j["goodput"] = sum(goodput) / len(goodput)
            j["step_seconds"] = self._hist_summary(hist)
            out[jid or "unknown"] = j
        return 200, {"jobs": out}

    def _serve_api(self):
        """GET /api/serve: per-deployment request/latency summary from the
        ray_tpu_serve_* series (replica- and handle-side)."""
        deps: dict = {}

        def dep(rec):
            name = rec["labels"].get("deployment", "")
            return deps.setdefault(name, {
                "requests_total": 0, "errors_total": 0,
                "inflight": 0.0, "queue_depth": 0.0, "replicas": set(),
                "_lat": {"count": 0, "sum": 0.0, "buckets": {},
                         "boundaries": []},
                "_handle_lat": {"count": 0, "sum": 0.0, "buckets": {},
                                "boundaries": []},
            })

        for rec in self._user_metrics("ray_tpu_serve_"):
            d = dep(rec)
            name = rec["name"]
            replica = rec["labels"].get("replica", "")
            if replica:
                d["replicas"].add(replica)
            if name == "ray_tpu_serve_requests_total":
                d["requests_total"] += int(rec["value"])
            elif name == "ray_tpu_serve_handle_requests_total":
                d["handle_requests_total"] = (
                    d.get("handle_requests_total", 0) + int(rec["value"]))
            elif name == "ray_tpu_serve_request_errors_total":
                d["errors_total"] += int(rec["value"])
            elif name == "ray_tpu_serve_inflight_requests":
                d["inflight"] += rec["value"]
            elif name == "ray_tpu_serve_queue_depth":
                d["queue_depth"] += rec["value"]
            elif name == "ray_tpu_serve_request_latency_seconds":
                self._merge_hist(d["_lat"], rec)
            elif name == "ray_tpu_serve_handle_latency_seconds":
                self._merge_hist(d["_handle_lat"], rec)
        out = {}
        for name, d in deps.items():
            d["replicas"] = len(d["replicas"])
            d["latency_seconds"] = self._hist_summary(d.pop("_lat"))
            d["handle_latency_seconds"] = self._hist_summary(
                d.pop("_handle_lat"))
            out[name or "unknown"] = d
        return 200, {"deployments": out}

    def _agents(self) -> dict:
        """node_id_hex -> {host, port, pid} from the GCS agent registry
        (reference: the head discovers per-node agents and fans node-scoped
        queries out to them, dashboard/head.py + reporter_head.py)."""
        out = {}
        try:
            gcs = self._gcs_client()
            for key in gcs.kv_keys(b"agents"):
                raw = gcs.kv_get(b"agents", key)
                if raw:
                    out[key.decode()] = json.loads(raw)
        except Exception:
            pass
        return out

    @staticmethod
    async def _call_agent(rec: dict, method: str, payload: dict, timeout):
        from ray_tpu_torch._private.rpc import RpcClient

        client = RpcClient(rec["host"], rec["port"])
        await client.connect()
        try:
            return await client.call(method, payload, timeout=timeout)
        finally:
            await client.close()

    def _ask_agent(self, rec: dict, method: str, payload: dict, timeout=5.0):
        from ray_tpu_torch._private.rpc import IoThread

        return IoThread.current().run(
            self._call_agent(rec, method, payload, timeout),
            timeout=timeout + 5)

    def _ask_agents(self, agents: dict, method: str, timeout=5.0):
        """Concurrent fan-out: one io-thread round, latency = slowest agent
        (a dead agent must not serialize with the healthy ones)."""
        from ray_tpu_torch._private.rpc import IoThread

        items = list(agents.items())

        async def _gather():
            results = await asyncio.gather(
                *(self._call_agent(rec, method, {}, timeout)
                  for _hexid, rec in items),
                return_exceptions=True)
            return results

        results = IoThread.current().run(_gather(), timeout=timeout + 10)
        ok, errors = [], {}
        for (hexid, _rec), r in zip(items, results):
            if isinstance(r, Exception):
                errors[hexid] = str(r)
            else:
                ok.append((hexid, r))
        return ok, errors

    def _node_stats_api(self, query):
        """GET /api/node_stats[?node_id=hex]: per-node host stats served by
        the node's agent (fan-out when no node_id given)."""
        agents = self._agents()
        node_id = query.get("node_id")
        if node_id:
            rec = agents.get(node_id)
            if rec is None:
                return 404, {"error": f"no agent for node {node_id}"}
            try:
                return 200, self._ask_agent(rec, "NodeStats", {})
            except Exception as e:
                return 502, {"error": f"agent unreachable: {e}"}
        ok, errors = self._ask_agents(agents, "NodeStats")
        return 200, {"nodes": [r for _h, r in ok], "errors": errors,
                     "agent_count": len(agents)}

    def _agent_metrics_api(self):
        """GET /api/agent_metrics: concatenated Prometheus text from every
        node agent (host-level series; raylet /metrics keeps the
        scheduler/object series)."""
        ok, errors = self._ask_agents(self._agents(), "Metrics")
        chunks = [r["text"] for _h, r in ok]
        chunks += [f"# agent {h} unreachable\n" for h in errors]
        return 200, {"text": "".join(chunks)}

    def _session_dir(self) -> str:
        """Cluster session dir from the GCS, cached (it never changes);
        same fallback as JobManager._session_dir on a transient GCS error."""
        if getattr(self, "_session_dir_cache", None):
            return self._session_dir_cache
        try:
            info = self._gcs_client().call("GetInternalConfig", {})
            self._session_dir_cache = info.get("session_dir") or ""
        except Exception:
            return ""
        return self._session_dir_cache

    def _logs_api(self, path: str, query):
        """Session log files (reference: dashboard log module —
        dashboard/modules/log/ serves per-process logs over HTTP).

        GET /api/logs            list {name, size_bytes}
        GET /api/logs/<name>     {"lines": [...]} — ?tail=N (default 200)
        """
        import os
        from collections import deque

        log_dir = os.path.join(self._session_dir(), "logs")
        if not os.path.isdir(log_dir):
            return 404, {"error": "no session log directory"}
        parts = [p for p in path.split("/") if p]  # ["api","logs",...]
        if len(parts) == 2:
            files = sorted(os.listdir(log_dir))
            return 200, {"logs": [
                {"name": n,
                 "size_bytes": os.path.getsize(os.path.join(log_dir, n))}
                for n in files
            ]}
        name = parts[2]
        # the filename comes off the URL: never let it traverse out
        target = os.path.realpath(os.path.join(log_dir, name))
        if (os.path.dirname(target) != os.path.realpath(log_dir)
                or not os.path.isfile(target)):
            return 404, {"error": f"no log file {name!r}"}
        try:
            tail = int(query.get("tail", "") or 200)
        except ValueError:
            return 400, {"error": "tail must be an integer"}
        tail = max(0, min(tail, 100_000))
        # bounded tail: never materialize a multi-GB log in memory
        with open(target, "r", errors="replace") as f:
            lines = deque(f, maxlen=tail)
        return 200, {"name": name,
                     "lines": [ln.rstrip("\n") for ln in lines]}

    def _index_html(self) -> bytes:
        """Single-page live dashboard: vanilla JS polling the /api routes
        (reference: dashboard/client/ — a React app; same information
        surface, no build step)."""
        return _INDEX_HTML.replace(
            b"__GCS__", self.gcs_address.encode()
        )

    # ---------------------------------------------------------------- http

    async def _handle(self, reader, writer):
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10)
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2:
                return
            raw_path = parts[1]
            method, path = parts[0], raw_path.split("?")[0]
            query = {}
            if "?" in raw_path:
                for kv in raw_path.split("?", 1)[1].split("&"):
                    k, _, v = kv.partition("=")
                    query[k] = v
            headers = {}
            while True:
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = None
            length = int(headers.get("content-length", 0) or 0)
            if length:
                raw = await reader.readexactly(length)
                try:
                    body = json.loads(raw)
                except Exception:
                    body = None
            loop = asyncio.get_running_loop()
            try:
                status, payload = await loop.run_in_executor(
                    None, self._collect, path, method, body, query
                )
            except Exception as e:
                logger.exception("dashboard handler failed")
                status, payload = 500, {"error": str(e)}
            if payload is None and status == 200:
                out = await loop.run_in_executor(None, self._index_html)
                ctype = "text/html; charset=utf-8"
            else:
                out = json.dumps(payload, default=str).encode()
                ctype = "application/json"
            reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                      500: "Internal Server Error"}.get(status, "OK")
            writer.write(
                f"HTTP/1.1 {status} {reason}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(out)}\r\nConnection: close\r\n\r\n".encode()
                + out
            )
            await writer.drain()
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def start(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("dashboard on http://%s:%d", self.host, self.port)
        return self.port


def start_dashboard(gcs_address: str, port: int = 0) -> Tuple[DashboardHead, int]:
    """Start a dashboard in this process (on the shared IO thread)."""
    from ray_tpu_torch._private.rpc import IoThread

    head = DashboardHead(gcs_address)
    actual = IoThread.current().run(head.start(port))
    return head, actual


def main(argv=None):
    import argparse
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--port", type=int, default=8265)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address; 0.0.0.0 exposes job execution "
                             "to the network — opt in deliberately")
    parser.add_argument("--port-file", default="")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    async def run():
        head = DashboardHead(args.gcs_address, host=args.host)
        port = await head.start(args.port)
        if args.port_file:
            import os

            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, args.port_file)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()


_INDEX_HTML = b"""<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a1d21}
 header{background:#1a1d21;color:#fff;padding:10px 20px;display:flex;align-items:baseline;gap:14px}
 header h1{font-size:16px;margin:0} header span{color:#9aa3ad;font-size:12px}
 .tiles{display:flex;gap:12px;padding:16px 20px;flex-wrap:wrap}
 .tile{background:#fff;border:1px solid #e2e5e9;border-radius:8px;padding:12px 18px;min-width:110px}
 .tile .v{font-size:22px;font-weight:600} .tile .k{font-size:11px;color:#6b7380;text-transform:uppercase}
 section{margin:6px 20px 18px} h2{font-size:13px;color:#6b7380;text-transform:uppercase;margin:14px 0 6px}
 table{border-collapse:collapse;width:100%;background:#fff;border:1px solid #e2e5e9;border-radius:8px;overflow:hidden}
 th,td{font-size:12.5px;text-align:left;padding:6px 10px;border-bottom:1px solid #eef0f3;font-variant-numeric:tabular-nums}
 th{background:#fafbfc;color:#6b7380;font-weight:600}
 .ALIVE,.RUNNING,.SUCCEEDED,.CREATED{color:#0a7d33;font-weight:600}
 .DEAD,.FAILED,.ERRORED{color:#b3261e;font-weight:600}
 .PENDING_CREATION,.PENDING,.RESTARTING,.RESCHEDULING{color:#9a6b00;font-weight:600}
 code{background:#eef0f3;border-radius:4px;padding:1px 5px}
</style></head><body>
<header><h1>ray_tpu_torch</h1><span>cluster @ __GCS__</span>
<span id=err style="color:#ff8a80"></span></header>
<div class=tiles id=tiles></div>
<section><h2>Nodes</h2><table id=nodes></table></section>
<section><h2>Actors</h2><table id=actors></table></section>
<section><h2>Jobs</h2><table id=jobs></table></section>
<section><h2>Placement groups</h2><table id=pgs></table></section>
<section style="color:#6b7380;font-size:12px">JSON API under <code>/api/*</code>
&middot; refreshes every 2s</section>
<script>
async function j(p){const r=await fetch(p);return r.json()}
function esc(s){return String(s).replace(/[&<>"']/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function row(cells,h){return '<tr>'+cells.map(c=>(h?'<th>':'<td>')+c+(h?'</th>':'</td>')).join('')+'</tr>'}
function st(s){return '<span class="'+esc(s)+'">'+esc(s)+'</span>'}
function fmtRes(r){return Object.entries(r||{}).map(([k,v])=>k+':'+(typeof v=='number'?Math.round(v*10)/10:v)).join(' ')}
async function tick(){
 try{
  const [clusterR,nodesR,actorsR,jobsR,pgsR]=await Promise.all([
    j('/api/cluster'),j('/api/nodes'),j('/api/actors'),j('/api/jobs'),j('/api/placement_groups')]);
  const nodes=nodesR.nodes||[],actors=actorsR.actors||[],
        jobs=jobsR.jobs||[],pgs=pgsR.placement_groups||[];
  const alive=nodes.filter(n=>n.state=='ALIVE');
  const total=(clusterR.cluster||{}).total||{},avail=(clusterR.cluster||{}).available||{};
  document.getElementById('tiles').innerHTML=
   [['nodes',alive.length],['actors',actors.filter(a=>a.state=='ALIVE').length],
    ['jobs',jobs.length],['CPU',Math.round(((total.CPU||0)-(avail.CPU||0))*10)/10+' / '+(total.CPU||0)],
    ['GPU',Math.round(((total.GPU||0)-(avail.GPU||0))*10)/10+' / '+(total.GPU||0)]]
   .map(([k,v])=>'<div class=tile><div class=v>'+v+'</div><div class=k>'+k+'</div></div>').join('');
  document.getElementById('nodes').innerHTML=row(['node','state','ip','total','available'],1)+
   nodes.map(n=>row([esc(n.node_id.slice(0,12)),st(n.state),esc(n.node_ip),esc(fmtRes(n.resources_total)),esc(fmtRes(n.resources_available))])).join('');
  document.getElementById('actors').innerHTML=row(['actor','class','name','state','node','restarts'],1)+
   actors.slice(0,200).map(a=>row([esc(a.actor_id.slice(0,12)),esc(a.class_name||''),esc(a.name||''),st(a.state),esc((a.node_id||'').slice(0,12)),a.num_restarts||0])).join('');
  document.getElementById('jobs').innerHTML=row(['job','entrypoint','status','start'],1)+
   jobs.map(x=>row([esc(x.job_id||x.submission_id||''),esc((x.entrypoint||'').slice(0,80)),st(x.status||x.state||''),x.start_time?new Date(x.start_time*1000).toLocaleTimeString():''])).join('');
  document.getElementById('pgs').innerHTML=row(['pg','name','strategy','state','bundles'],1)+
   pgs.map(p=>row([esc(p.placement_group_id.slice(0,12)),esc(p.name||''),esc(p.strategy),st(p.state),p.bundles.length])).join('');
  document.getElementById('err').textContent='';
 }catch(e){document.getElementById('err').textContent='api error: '+e}
}
tick();setInterval(tick,2000);
</script></body></html>
"""
