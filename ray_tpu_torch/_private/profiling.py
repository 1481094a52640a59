"""In-process stack sampling for on-demand profiling.

Reference: the dashboard's py-spy/memray integration
(dashboard/modules/reporter/profile_manager.py:78/:189). The same
capability without the binary dependency: any worker can sample its own
threads' stacks via sys._current_frames at a fixed rate and return
flamegraph-compatible folded lines ("a;b;c 42"). The dashboard asks the
raylet, the raylet asks the worker (both plain RPCs), so profiling any
process in the cluster is one HTTP call.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter
from typing import Dict


def _frame_label(frame) -> str:
    from ray_tpu_torch._private.sampling_profiler import frame_label

    return frame_label(frame)


def sample_stacks(duration_s: float = 2.0, hz: float = 100.0,
                  include_idle: bool = False) -> Dict[str, int]:
    """Sample all threads for duration_s; returns {folded_stack: count}.

    Runs in the CALLING thread — callers dispatch it to a sampler thread
    (the worker RPC handler does) so the sampled threads keep running.
    """
    duration_s = min(float(duration_s), 60.0)
    hz = min(max(1.0, float(hz)), 500.0)
    period = 1.0 / hz
    me = threading.get_ident()
    names = {t.ident: t.name for t in threading.enumerate()}
    counts: Counter = Counter()
    end = time.monotonic() + duration_s
    while time.monotonic() < end:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            name = names.get(tid) or str(tid)
            if not include_idle and (
                name.startswith("rtpu-io")
                or name.endswith("-watchdog")
            ):
                # the io loop is ~always parked in epoll; skip unless asked
                continue
            stack = []
            f = frame
            depth = 0
            while f is not None and depth < 128:
                stack.append(_frame_label(f))
                f = f.f_back
                depth += 1
            stack.reverse()
            counts[f"{name};" + ";".join(stack)] += 1
        time.sleep(period)
        names = {t.ident: t.name for t in threading.enumerate()}
    return dict(counts)


def folded_text(counts: Dict[str, int]) -> str:
    """flamegraph.pl-compatible folded output, heaviest first."""
    return "\n".join(
        f"{stack} {n}"
        for stack, n in sorted(counts.items(), key=lambda kv: -kv[1])
    )


def profile_via_raylets(nodes, *, pid=None, worker_id=None,
                        node_filter=None, duration=2.0, hz=100.0):
    """Shared fan-out used by the dashboard endpoint AND the CLI: resolve
    the target worker across alive raylets and run a ProfileWorker RPC.

    Returns (status, payload) with HTTP-shaped statuses: 200 + result,
    400 on cross-node pid ambiguity (pids are only unique per host),
    404 when no node has the worker, 502 when raylets were unreachable.
    """
    from ray_tpu_torch._private.rpc import IoThread, RpcClient

    io = IoThread.current()
    req = {"duration": duration, "hz": hz}
    if pid is not None:
        req["pid"] = int(pid)
    if worker_id is not None:
        req["worker_id"] = worker_id
    nodes = [
        n for n in nodes
        if n.get("state", "ALIVE") == "ALIVE"
        and (not node_filter or n["node_id"].hex().startswith(node_filter))
    ]

    async def ask(n, method, payload, timeout):
        client = RpcClient(n["ip"], n["raylet_port"])
        await client.connect()
        try:
            return await client.call(method, payload, timeout=timeout)
        finally:
            await client.close()

    if pid is not None and not node_filter and len(nodes) > 1:
        holders = []
        for n in nodes:
            try:
                # short probe timeout: this runs sequentially in a sync
                # HTTP/CLI path, and an unreachable raylet must not add
                # tens of seconds before profiling starts
                info = io.run(
                    ask(n, "GetLocalWorkerInfo", {}, 4), timeout=6
                )
            except Exception:
                continue
            if any(w["pid"] == req["pid"] for w in info.get("workers", [])):
                holders.append(n)
        if len(holders) > 1:
            return 400, {
                "error": f"pid {pid} exists on {len(holders)} nodes; "
                "disambiguate with node_id",
            }
        if holders:
            nodes = holders

    transport_err = None
    worker_err = None
    for n in nodes:
        try:
            r = io.run(
                ask(n, "ProfileWorker", req, duration + 40),
                timeout=duration + 60,
            )
        except Exception as e:
            transport_err = str(e)
            continue
        if not r.get("error"):
            return 200, r
        worker_err = r["error"]
    if transport_err:
        return 502, {"error": f"some raylets unreachable: {transport_err}"}
    return 404, {"error": worker_err or "no such worker on any alive node"}


# --------------------------------------------------- cluster-wide capture
# The profiling-plane tentpole: one synchronized sampling window across
# every process in the cluster. StartProfile fans out first (raylets fan to
# their live workers), so all nodes sample the SAME wall-clock window; the
# CollectProfile pass then blocks server-side until each window closes and
# fans the per-process sample sets back in. The caller merges them with the
# task/span timeline (_private/timeline.merged_profile_trace).


def capture_cluster_profile(nodes, gcs=None, *, duration: float = 5.0,
                            hz: float = 99.0, node_filter=None,
                            include_gcs: bool = True,
                            include_drivers: bool = True) -> dict:
    """Returns a profile *bundle*:

    {"t0", "duration", "hz",
     "nodes": [{"node_id": hex, "profiles": [per-process result dicts]}],
     "drivers": [per-process result dicts],
     "gcs": per-process result dict | None,
     "errors": ["<node hex>: <why>", ...]}

    Drivers aren't in any raylet's worker pool (they register with the GCS
    through AddJob), yet the input pipeline and submission loop — prime
    slow-step suspects — run there, so running jobs' driver addresses get
    the same Start/Collect pair directly.
    """
    import asyncio
    import time

    from ray_tpu_torch._private.rpc import IoThread, RpcClient

    duration = min(max(0.05, float(duration)), 120.0)
    hz = min(max(1.0, float(hz)), 500.0)
    nodes = [
        n for n in nodes
        if n.get("state", "ALIVE") == "ALIVE"
        and (not node_filter or n["node_id"].hex().startswith(node_filter))
    ]
    bundle = {"t0": time.time(), "duration": duration, "hz": hz,
              "nodes": [], "drivers": [], "gcs": None, "errors": []}

    driver_addrs = []
    if include_drivers and gcs is not None:
        try:
            for j in gcs.call("GetAllJobInfo", {}, timeout=10)["jobs"]:
                addr = j.get("driver_addr")
                if j.get("state") == "RUNNING" and addr and addr[1]:
                    driver_addrs.append((addr[0], int(addr[1])))
        except Exception:
            pass

    async def _capture_node(n):
        client = RpcClient(n["ip"], n["raylet_port"])
        await client.connect()
        try:
            await client.call(
                "StartProfile",
                {"duration": duration, "hz": hz, "include_workers": True},
                timeout=15,
            )
            r = await client.call(
                "CollectProfile", {}, timeout=duration + 40)
            return {"node_id": n["node_id"].hex(),
                    "profiles": r.get("profiles", [])}
        finally:
            await client.close()

    async def _capture_gcs():
        # gcs is the sync GcsClient wrapper; inside this io-thread
        # coroutine only its .aio half is usable (io.run would deadlock)
        if gcs is None or not include_gcs:
            return None
        await gcs.aio.call("StartProfile", {"duration": duration, "hz": hz},
                           timeout=15)
        r = await gcs.aio.call("CollectProfile", {}, timeout=duration + 40)
        return r.get("profile")

    async def _capture_driver(addr):
        client = RpcClient(*addr)
        await client.connect()
        try:
            await client.call(
                "StartProfile", {"duration": duration, "hz": hz}, timeout=15)
            r = await client.call("CollectProfile", {}, timeout=duration + 40)
            return r.get("profile")
        finally:
            await client.close()

    async def _all():
        tasks = [_capture_node(n) for n in nodes]
        tasks += [_capture_driver(a) for a in driver_addrs]
        tasks.append(_capture_gcs())
        return await asyncio.gather(*tasks, return_exceptions=True)

    results = IoThread.current().run(_all(), timeout=duration + 60)
    gcs_result = results[-1]
    node_results = results[:len(nodes)]
    driver_results = results[len(nodes):-1]
    for n, r in zip(nodes, node_results):
        if isinstance(r, BaseException):
            bundle["errors"].append(f"{n['node_id'].hex()[:12]}: {r}")
        else:
            bundle["nodes"].append(r)
    for a, r in zip(driver_addrs, driver_results):
        if isinstance(r, BaseException):
            bundle["errors"].append(f"driver {a[0]}:{a[1]}: {r}")
        elif r:
            bundle["drivers"].append(r)
    if isinstance(gcs_result, BaseException):
        bundle["errors"].append(f"gcs: {gcs_result}")
    else:
        bundle["gcs"] = gcs_result
    return bundle


def fold_bundle(bundle: dict) -> Dict[str, int]:
    """Aggregate a whole bundle into one folded-stack counter; lines are
    prefixed ``node:<id8>;<role>:<pid>;<thread>;frame;...`` so a cluster
    flamegraph keeps per-process attribution."""
    from ray_tpu_torch._private.sampling_profiler import fold_samples

    out: Dict[str, int] = {}

    def _merge(profile, node_hex):
        role = profile.get("role") or "proc"
        prefix = f"node:{node_hex[:8]};{role}:{profile.get('pid', 0)};"
        for stack, c in fold_samples(profile).items():
            key = prefix + stack
            out[key] = out.get(key, 0) + c

    for node in bundle.get("nodes", []):
        for p in node.get("profiles", []):
            _merge(p, node.get("node_id", ""))
    for p in bundle.get("drivers", []):
        _merge(p, "driver")
    if bundle.get("gcs"):
        _merge(bundle["gcs"], "gcs")
    return out


# ------------------------------------------------------- capture registry
# Triggered and on-demand captures register their output path in the GCS
# KV so `ray-tpu-torch debug dump` and the dashboard can find "the latest
# captures" without a filesystem convention shared across hosts.

_CAPTURE_NS = b"profiling"


def register_capture(gcs, path: str, *, reason: str, extra=None) -> None:
    import json
    import time

    rec = {"path": path, "reason": reason, "host": _hostname(),
           "time": time.time(), **(extra or {})}
    try:
        gcs.kv_put(_CAPTURE_NS, f"capture:{rec['time']:.6f}".encode(),
                   json.dumps(rec).encode())
    except Exception:
        pass


def register_device_trace(gcs, path: str, *, steps: int) -> None:
    import json
    import time

    rec = {"path": path, "steps": steps, "host": _hostname(),
           "time": time.time()}
    try:
        gcs.kv_put(_CAPTURE_NS, f"device_trace:{rec['time']:.6f}".encode(),
                   json.dumps(rec).encode())
    except Exception:
        pass


def list_registered(gcs, kind: str = "capture", limit: int = 20) -> list:
    """Newest-last registered records of one kind ('capture' or
    'device_trace')."""
    import json

    try:
        keys = sorted(gcs.kv_keys(_CAPTURE_NS, f"{kind}:".encode()))
    except Exception:
        return []
    out = []
    for key in keys[-limit:]:
        try:
            raw = gcs.kv_get(_CAPTURE_NS, key)
            if raw:
                out.append(json.loads(raw))
        except Exception:
            continue
    return out


def _hostname() -> str:
    import socket

    try:
        return socket.gethostname()
    except Exception:
        return ""
