"""State API: live introspection of cluster entities.

Counterpart of ``ray.util.state``
(reference: python/ray/util/state/api.py — list_actors :781, list_nodes
:873, list_tasks :1008, summarize_tasks :1365; aggregation
dashboard/state_aggregator.py:138). The GCS is the source of truth for
actors/nodes/jobs/placement groups/tasks (task events); object listings are
aggregated live from every raylet's plasma + spill tables.

All functions accept an optional ``address`` ("host:port" of the GCS);
default is the connected driver's cluster.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.gcs.client import GcsClient


def _gcs(address: Optional[str]) -> GcsClient:
    if address:
        return GcsClient.from_address(address)
    from ray_tpu_torch._private import worker as worker_mod

    if worker_mod.global_worker is None:
        raise RuntimeError("ray_tpu_torch is not initialized and no address given")
    return worker_mod.global_worker.gcs


def _hex(b) -> str:
    return b.hex() if isinstance(b, (bytes, bytearray)) else str(b)


def _server_limit(filters, limit: int) -> dict:
    """Limit applied GCS-side — but only when no client-side filters will
    run afterwards (limiting before filtering would change results)."""
    return {} if filters else {"limit": limit}


def list_nodes(address: Optional[str] = None, *, filters=None, limit: int = 10_000) -> List[dict]:
    nodes = _gcs(address).call(
        "GetAllNodeInfo", _server_limit(filters, limit))["nodes"]
    out = [
        {
            "node_id": _hex(n["node_id"]),
            "state": n["state"],
            "node_ip": n["ip"],
            "raylet_port": n["raylet_port"],
            "metrics_port": n.get("metrics_port", 0),
            "is_head_node": bool(n.get("is_head")),
            "resources_total": n.get("resources_total", {}),
            "resources_available": n.get("resources_available", {}),
            "labels": n.get("labels", {}),
            "start_time": n.get("start_time"),
            "end_time": n.get("end_time"),
        }
        for n in nodes
    ]
    return _filtered(out, filters)[:limit]


def list_actors(address: Optional[str] = None, *, filters=None, limit: int = 10_000) -> List[dict]:
    actors = _gcs(address).call(
        "ListActors", _server_limit(filters, limit))["actors"]
    out = [
        {
            "actor_id": _hex(a["actor_id"]),
            "state": a["state"],
            "name": a.get("name", ""),
            "ray_namespace": a.get("namespace", ""),
            "job_id": _hex(a.get("job_id", b"")),
            "node_id": _hex(a["node_id"]) if a.get("node_id") else None,
            "pid": None,
            "class_name": a.get("class_name", ""),
            "num_restarts": a.get("num_restarts", 0),
            "death_cause": a.get("death_cause", ""),
            "start_time": a.get("start_time"),
        }
        for a in actors
    ]
    return _filtered(out, filters)[:limit]


def list_jobs(address: Optional[str] = None, *, filters=None, limit: int = 10_000) -> List[dict]:
    jobs = _gcs(address).call(
        "GetAllJobInfo", _server_limit(filters, limit))["jobs"]
    out = [
        {
            "job_id": _hex(j["job_id"]),
            "status": j.get("state", ""),
            "entrypoint": j.get("entrypoint", ""),
            "start_time": j.get("start_time"),
            "end_time": j.get("end_time"),
            "metadata": j.get("metadata", {}),
        }
        for j in jobs
    ]
    return _filtered(out, filters)[:limit]


def list_placement_groups(
    address: Optional[str] = None, *, filters=None, limit: int = 10_000
) -> List[dict]:
    pgs = _gcs(address).call(
        "ListPlacementGroups", _server_limit(filters, limit))["pgs"]
    out = [
        {
            "placement_group_id": _hex(p["pg_id"]),
            "name": p.get("name", ""),
            "state": p["state"],
            "strategy": p.get("strategy", ""),
            "bundles": [
                {
                    "bundle_index": b["index"],
                    "resources": b["resources"],
                    "node_id": _hex(b["node_id"]) if b.get("node_id") else None,
                }
                for b in p.get("bundles", [])
            ],
        }
        for p in pgs
    ]
    return _filtered(out, filters)[:limit]


def list_tasks(
    address: Optional[str] = None, *, filters=None, limit: int = 10_000,
    detail: bool = True,
) -> List[dict]:
    """Latest known state per task, folded GCS-side (``ListTasks``): the
    server folds its task-event log into one row per task and applies
    ``limit`` before anything crosses the wire — the old path shipped the
    whole 100k-event log and sliced client-side. ``detail=False`` is the
    fast path for count/state polling: rows carry only identity + state
    (no error messages / node / worker attribution)."""
    req = {"detail": detail}
    if not filters:
        req["limit"] = limit
    rows = _gcs(address).call("ListTasks", req)["tasks"]
    out = [
        {
            "task_id": t["task_id"],
            "name": t.get("name", ""),
            "state": t["state"],
            "job_id": t.get("job_id", ""),
            "creation_time": t.get("creation_time"),
            "last_update_time": t.get("last_update_time"),
            **(
                {
                    "actor_id": t.get("actor_id", "") or None,
                    "node_id": t.get("node_id", ""),
                    "worker_id": t.get("worker_id", ""),
                    "error_message": t.get("error_message", ""),
                }
                if detail
                else {}
            ),
        }
        for t in rows
    ]
    return _filtered(out, filters)[:limit]


def summarize_tasks(address: Optional[str] = None) -> dict:
    """Counts by (name, state) — reference: util/state/api.py:1365."""
    tasks = list_tasks(address)
    summary: Dict[str, Dict[str, int]] = {}
    for t in tasks:
        by_state = summary.setdefault(t["name"], {})
        by_state[t["state"]] = by_state.get(t["state"], 0) + 1
    return {
        "total_tasks": len(tasks),
        "summary": summary,
    }


def list_incidents(
    address: Optional[str] = None, *, limit: int = 100, detail: bool = False
) -> List[dict]:
    """Stall-watchdog incident records from the GCS (newest last).
    ``detail=True`` includes captured stacks and flight-recorder rings."""
    return _gcs(address).call(
        "ListIncidents", {"limit": limit, "detail": detail}
    )["incidents"]


def count_open_incidents(address: Optional[str] = None) -> int:
    return _gcs(address).call("ListIncidents", {"limit": 1}).get("open", 0)


def _fanout_raylets(address: Optional[str], method: str, timeout: float = 10.0,
                    payload: Optional[dict] = None):
    """Call every alive raylet concurrently; yields (node, reply) pairs."""
    import asyncio

    from ray_tpu_torch._private.rpc import IoThread, RpcClient

    nodes = [
        n
        for n in _gcs(address).call("GetAllNodeInfo", {})["nodes"]
        if n["state"] == "ALIVE"
    ]

    async def _one(n):
        client = RpcClient(n["ip"], n["raylet_port"])
        try:
            await client.connect()
            return n, await client.call(method, payload or {}, timeout=timeout)
        finally:
            await client.close()

    async def _all():
        return await asyncio.gather(
            *(_one(n) for n in nodes), return_exceptions=True
        )

    results = IoThread.current().run(_all(), timeout=timeout + 10)
    return [r for r in results if not isinstance(r, BaseException)]


def list_objects(
    address: Optional[str] = None, *, filters=None, limit: int = 10_000
) -> List[dict]:
    """Aggregate plasma + spilled objects from every alive raylet."""
    out: List[dict] = []
    for n, r in _fanout_raylets(address, "GetLocalObjectInfo"):
        for o in r.get("objects", []):
            out.append(
                {
                    "object_id": _hex(o["object_id"]),
                    "node_id": _hex(n["node_id"]),
                    "size_bytes": o.get("size"),
                    "pinned": o.get("pinned", False),
                    "spilled": o.get("spilled", False),
                }
            )
    return _filtered(out, filters)[:limit]


def list_workers(
    address: Optional[str] = None, *, filters=None, limit: int = 10_000
) -> List[dict]:
    """Live worker processes (from every raylet) + recent worker failures."""
    out: List[dict] = []
    for n, r in _fanout_raylets(address, "GetLocalWorkerInfo"):
        for w in r.get("workers", []):
            out.append(
                {
                    "worker_id": _hex(w.get("worker_id", b"")),
                    "node_id": _hex(n["node_id"]),
                    "pid": w.get("pid"),
                    "job_id": _hex(w.get("job_id", b"")),
                    "is_alive": bool(w.get("alive", True)),
                    "leased": bool(w.get("leased")),
                    "actor_id": _hex(w["actor_id"]) if w.get("actor_id") else None,
                    "exit_detail": "",
                    "end_time": None,
                }
            )
    failures = _gcs(address).call("GetWorkerFailures", {"limit": limit})["failures"]
    out.extend(
        {
            "worker_id": _hex(f.get("worker_id", b"")),
            "node_id": _hex(f.get("node_id", b"")),
            "pid": None,
            "job_id": "",
            "is_alive": False,
            "leased": False,
            "actor_id": None,
            "exit_detail": f.get("reason", ""),
            "end_time": f.get("time"),
        }
        for f in failures
    )
    return _filtered(out, filters)[:limit]


# ------------------------------------------------- memory observability


def _hexify_worker_report(w: dict) -> dict:
    out = dict(w)
    for k in ("worker_id", "actor_id", "job_id"):
        out[k] = _hex(out.get(k, b"") or b"")
    out["ledger"] = [
        {**row,
         "object_id": _hex(row.get("object_id", b"")),
         "task_id": _hex(row.get("task_id", b"") or b"")}
        for row in (w.get("ledger") or [])
    ]
    return out


def _driver_memory_reports(address: Optional[str], limit: int) -> List[dict]:
    """Drivers own most long-lived refs but live in no raylet's worker
    pool — ask each RUNNING job's driver directly (same pattern as the
    profiling plane's driver fan-out)."""
    import asyncio

    from ray_tpu_torch._private.rpc import IoThread, RpcClient

    addrs = []
    try:
        for j in _gcs(address).call("GetAllJobInfo", {}, timeout=10)["jobs"]:
            addr = j.get("driver_addr")
            if j.get("state") == "RUNNING" and addr and addr[1]:
                addrs.append((addr[0], int(addr[1])))
    except Exception:
        return []

    async def _one(a):
        client = RpcClient(*a)
        try:
            await client.connect()
            r = await client.call("GetMemoryReport", {"limit": limit},
                                  timeout=10)
            return r.get("report")
        finally:
            await client.close()

    async def _all():
        return await asyncio.gather(*(_one(a) for a in addrs),
                                    return_exceptions=True)

    results = IoThread.current().run(_all(), timeout=30)
    return [_hexify_worker_report(r) for r in results
            if r and not isinstance(r, BaseException)]


def memory_report(
    address: Optional[str] = None, *, include_objects: bool = True,
    include_drivers: bool = True, sweep: bool = False,
    limit: int = 0,
) -> dict:
    """Cluster-wide memory report: every raylet's plasma/spill/pin tables
    joined with its workers' object ownership ledgers (``GetMemoryReport``
    fan-in), running jobs' driver ledgers, and the per-device HBM gauges
    the train telemetry already exports — one structure that answers "who
    is holding this memory". ``sweep=True`` forces a leak sweep on every
    node first."""
    import time as _time

    from ray_tpu_torch._private.config import CONFIG

    limit = limit or CONFIG.memory_report_top_n
    payload = {"include_workers": True, "limit": limit}
    if sweep:
        payload["sweep"] = True
    nodes_out = []
    for n, r in _fanout_raylets(
        address, "GetMemoryReport", timeout=60, payload=payload
    ):
        node = {
            "node_id": _hex(r.get("node_id", n["node_id"])),
            "node_ip": n["ip"],
            "plasma": r.get("plasma", {}),
            "pinned_count": r.get("pinned_count", 0),
            "pinned_bytes": r.get("pinned_bytes", 0),
            "spilled_count": r.get("spilled_count", 0),
            "spilled_bytes": r.get("spilled_bytes", 0),
            "raylet_rss": r.get("raylet_rss", 0),
            "agent_rss": r.get("agent_rss", 0),
            "leaks": r.get("leaks", []),
            "leak_candidates": r.get("leak_candidates", 0),
            "workers": [_hexify_worker_report(w)
                        for w in r.get("workers", [])],
        }
        if include_objects:
            node["objects"] = [
                {**o,
                 "object_id": _hex(o.get("object_id", b"")),
                 "job_id": _hex(o.get("job_id", b"") or b""),
                 "actor_id": _hex(o.get("actor_id", b"") or b""),
                 "task_id": _hex(o.get("task_id", b"") or b"")}
                for o in r.get("objects", [])
            ]
        else:
            node["objects"] = []
        nodes_out.append(node)
    drivers = (_driver_memory_reports(address, limit)
               if include_drivers else [])
    try:
        hbm = _gcs(address).call(
            "GetUserMetrics",
            {"prefix": "ray_tpu_train_hbm_bytes_in_use"})["records"]
    except Exception:
        hbm = []
    return {"time": _time.time(), "nodes": nodes_out, "drivers": drivers,
            "hbm": hbm}


def memory_rollup(report: dict, group_by: str = "job") -> Dict[str, dict]:
    """Fold a ``memory_report`` into per-job / per-actor / per-node rows
    unifying plasma residency (raylet tables, pin-meta attribution), worker
    RSS + owned-ledger bytes, per-device HBM, and leaked bytes."""
    if group_by not in ("job", "actor", "node"):
        raise ValueError(f"group_by must be job|actor|node, not {group_by!r}")
    rows: Dict[str, dict] = {}

    def row(key: str) -> dict:
        return rows.setdefault(key or "?", {
            "plasma_bytes": 0, "objects": 0, "spilled_bytes": 0,
            "rss_bytes": 0, "owned_bytes": 0, "hbm_bytes": 0,
            "leaked_bytes": 0, "workers": 0,
        })

    # WorkerId metric labels are 12-hex prefixes (worker.py stamps them)
    wid_map: Dict[str, str] = {}
    # object_id -> (job, actor) from every owner ledger: attributes copies
    # that carry no pin meta (e.g. secondaries pulled to another node)
    oid_attr: Dict[str, tuple] = {}
    for node in report.get("nodes", []):
        for w in node.get("workers", []):
            wid = (w.get("worker_id") or "")[:12]
            if group_by == "node":
                wid_map[wid] = node["node_id"]
            elif group_by == "actor":
                wid_map[wid] = w.get("actor_id") or "-"
            else:
                wid_map[wid] = w.get("job_id") or "?"
            for entry in w.get("ledger") or []:
                oid_attr[entry.get("object_id", "")] = (
                    w.get("job_id") or "", w.get("actor_id") or "")
    for w in report.get("drivers", []):
        wid_map[(w.get("worker_id") or "")[:12]] = (
            "(driver)" if group_by in ("node", "actor")
            else w.get("job_id") or "?")
        for entry in w.get("ledger") or []:
            oid_attr[entry.get("object_id", "")] = (
                w.get("job_id") or "", w.get("actor_id") or "")

    def _obj_key(node: dict, o: dict) -> str:
        if group_by == "node":
            return node["node_id"]
        attr = oid_attr.get(o.get("object_id", ""), ("", ""))
        if group_by == "actor":
            return o.get("actor_id") or attr[1] or "-"
        return o.get("job_id") or attr[0] or "?"

    for node in report.get("nodes", []):
        for o in node.get("objects", []):
            r = row(_obj_key(node, o))
            r["objects"] += 1
            size = o.get("size") or 0
            if o.get("spilled") and not o.get("pinned"):
                r["spilled_bytes"] += size
            else:
                r["plasma_bytes"] += size
        for leak in node.get("leaks", []):
            r = row(_obj_key(node, leak))
            r["leaked_bytes"] += leak.get("size") or 0
        for w in node.get("workers", []):
            if group_by == "node":
                key = node["node_id"]
            elif group_by == "actor":
                key = w.get("actor_id") or "-"
            else:
                key = w.get("job_id") or "?"
            r = row(key)
            r["rss_bytes"] += w.get("rss_bytes") or 0
            r["owned_bytes"] += w.get("owned_bytes") or 0
            r["workers"] += 1
    for w in report.get("drivers", []):
        if group_by == "job":
            key = w.get("job_id") or "?"
        else:
            key = "(driver)"
        r = row(key)
        r["rss_bytes"] += w.get("rss_bytes") or 0
        r["owned_bytes"] += w.get("owned_bytes") or 0
        r["workers"] += 1
    for rec in report.get("hbm", []):
        labels = rec.get("labels", {})
        if group_by == "job":
            key = labels.get("JobId") or "?"
        else:
            key = wid_map.get(labels.get("WorkerId", ""), "?")
        row(key)["hbm_bytes"] += rec.get("value") or 0
    return rows


def find_memory_leaks(
    address: Optional[str] = None, *, sweep: bool = True,
    confirm_pause_s: float = 1.0,
) -> List[dict]:
    """Leaked plasma primaries across the cluster, with attribution.

    With ``sweep=True`` every raylet runs a leak sweep on demand — twice,
    ``confirm_pause_s`` apart, because confirmation needs two sweeps (the
    in-flight-handoff guard). Without it, returns whatever the background
    cadence last confirmed."""
    payload = {"include_workers": False}
    if sweep:
        payload["sweep"] = True
        import time as _time

        _fanout_raylets(address, "GetMemoryReport", timeout=60,
                        payload=payload)
        _time.sleep(max(0.0, confirm_pause_s))
    leaks: List[dict] = []
    for _n, r in _fanout_raylets(
        address, "GetMemoryReport", timeout=60, payload=payload
    ):
        leaks.extend(r.get("leaks", []))
    leaks.sort(key=lambda l: -(l.get("size") or 0))
    return leaks


def _filtered(rows: List[dict], filters) -> List[dict]:
    """filters: iterable of (key, predicate '=' or '!=', value) tuples."""
    if not filters:
        return rows
    for key, op, value in filters:
        if op == "=":
            rows = [r for r in rows if r.get(key) == value]
        elif op == "!=":
            rows = [r for r in rows if r.get(key) != value]
        else:
            raise ValueError(f"unsupported filter predicate {op!r}")
    return rows
