"""Operator CLI of the port: ``ray-tpu-torch <command>``, or
``python -m ray_tpu_torch.scripts <command>`` (a copy of
``ray_tpu/scripts.py``; its cluster state file, its perf gate and its lint
are the port's own).

Counterpart of the reference's ``ray`` CLI
(reference: python/ray/scripts/scripts.py — start :571, stop, status,
memory, timeline, logs, plus the job CLI dashboard/modules/job/cli.py).

Commands:
  start --head [--port P] [--resources JSON] [--dashboard-port P]
  start --address HOST:PORT [--resources JSON]     (worker node)
  stop
  status   [--address]
  nodes    [--address]
  actors   [--address]
  memory   [--address] [--group-by job|actor|node] [--leaks]
           [--sort-by size|plasma|rss|objects]
                                 cluster memory report: per-node object
                                 store, rollups unifying plasma/RSS/HBM,
                                 top owned objects w/ callsites; --leaks
                                 runs the leak detector w/ attribution
  timeline [--address] [--job HEX] [--trace-id ID] -o FILE
                                 Chrome-trace dump (filters server-side;
                                 spill/restore/leak instants fanned in
                                 from raylet flight rings)
  profile  [--address] [--duration S] [--hz N] [--node HEX] [-o FILE]
                                 cluster-wide CPU capture merged with the
                                 task timeline (Perfetto JSON); --flame for
                                 folded stacks, --pid N for one worker
  grafana  [-o FILE]             generated Grafana dashboard JSON
  perf check   [--only SUBSTR] [--quick] [--history FILE] [--update]
               [--strict]        run microbench metrics and gate them
                                 against the port's ledger head
                                 (PERF_HISTORY_TORCH.jsonl)
                                 (exit 1 on regression beyond noise band;
                                 advisory on 1-core boxes unless --strict)
  perf compare BASE HEAD [-o FILE] [--skip-noisy]
                                 gate two microbench --json result files
                                 (the A/B path)
  perf history [--metric M] [--limit N]
                                 print the perf ledger trajectory
  lint [PATHS...] [--baseline F] [--update-baseline] [--json] [--verbose]
                                 invariant lint plane: stability-contract
                                 cross-check (flags/metrics/events/chaos
                                 sites), shard-safety/thread-ownership
                                 analysis, blocking-call-in-coroutine
                                 detection; exit 1 on findings not in the
                                 committed baseline (CI gate)
  job submit  --address ADDR -- ENTRYPOINT...
  job status  --address ADDR SUBMISSION_ID
  job logs    --address ADDR SUBMISSION_ID
  job stop    --address ADDR SUBMISSION_ID
  job list    --address ADDR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Overridable so a launcher driving several logical nodes on one machine
# (fake multi-node e2e) can keep per-node state files.
_STATE_FILE = os.environ.get("RTPU_TORCH_STATE_FILE") or os.path.join(
    os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "cli_cluster.json"
)


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or os.environ.get("RTPU_TORCH_ADDRESS")
    if not addr and os.path.exists(_STATE_FILE):
        with open(_STATE_FILE) as f:
            addr = json.load(f).get("gcs_address")
    if not addr:
        sys.exit("no cluster address: pass --address or set RTPU_TORCH_ADDRESS")
    return addr


def cmd_start(args):
    from ray_tpu_torch._private.node import Node

    resources = json.loads(args.resources) if args.resources else None
    if args.head:
        node = Node(head=True, resources=resources, host=args.host,
                    gcs_port=args.port)
        info = {
            "gcs_address": node.gcs_address,
            "session_dir": node.session_dir,
            "pids": [p.pid for p in node.processes.values()],
        }
        if args.dashboard_port >= 0:
            import subprocess

            port_file = os.path.join(node.session_dir, "dashboard_port")
            env = dict(os.environ)
            from ray_tpu_torch._private import repo_root

            env["PYTHONPATH"] = (
                repo_root() + os.pathsep + env.get("PYTHONPATH", "")
            )
            dash_out = open(
                os.path.join(node.session_dir, "logs", "dashboard.out"), "ab"
            )
            dash_err = open(
                os.path.join(node.session_dir, "logs", "dashboard.err"), "ab"
            )
            dash = subprocess.Popen(
                [
                    sys.executable, "-m", "ray_tpu_torch.dashboard.head",
                    f"--gcs-address={node.gcs_address}",
                    f"--port={args.dashboard_port}",
                    f"--port-file={port_file}",
                ],
                env=env,
                stdout=dash_out,
                stderr=dash_err,
                start_new_session=True,
            )
            info["pids"].append(dash.pid)
            from ray_tpu_torch._private.node import _wait_port_file

            info["dashboard_port"] = _wait_port_file(port_file, dash)
            print(f"dashboard: http://127.0.0.1:{info['dashboard_port']}")
        info["role"] = "head"
        _record_node(info, replace=True)
        print(f"head started; GCS at {node.gcs_address}")
        print(f"connect with: ray_tpu_torch.init(address='{node.gcs_address}')")
        # The supervising Node object must stay alive for the GCS monitor;
        # detach by keeping this process around unless --block=false-like
        # behavior is wanted. The processes themselves are daemons of no
        # one (start_new_session), so exiting here is safe: monitoring
        # simply stops.
        node._gcs_monitor = None
    else:
        addr = _resolve_address(args)
        node = Node(head=False, gcs_address=addr, resources=resources,
                    host=args.host)
        # Appended (never replacing) so head+worker on one machine — or
        # several workers — all stay stoppable by `ray-tpu-torch stop`.
        _record_node({
            "role": "worker",
            "gcs_address": addr,
            "session_dir": node.session_dir,
            "pids": [p.pid for p in node.processes.values()],
        }, replace=False)
        print(f"worker node started; raylet on port {node.raylet_port}")


def _record_node(entry: dict, *, replace: bool):
    """State file holds EVERY node started on this machine:
    {"gcs_address": ..., "nodes": [{role, session_dir, pids}, ...]} —
    `stop` tears all of them down. A head start replaces the record (new
    cluster); workers append."""
    os.makedirs(os.path.dirname(_STATE_FILE), exist_ok=True)
    state = {"nodes": []}
    if not replace and os.path.exists(_STATE_FILE):
        try:
            with open(_STATE_FILE) as f:
                state = json.load(f)
        except (json.JSONDecodeError, OSError):
            state = {"nodes": []}
        if "nodes" not in state:  # legacy single-entry format
            state = {"gcs_address": state.get("gcs_address", ""),
                     "nodes": [state]}
    state.setdefault("nodes", [])
    state["nodes"].append(entry)
    if entry.get("gcs_address"):
        state["gcs_address"] = entry["gcs_address"]
    if "dashboard_port" in entry:
        state["dashboard_port"] = entry["dashboard_port"]
    with open(_STATE_FILE, "w") as f:
        json.dump(state, f)


def cmd_stop(args):
    import signal

    if not os.path.exists(_STATE_FILE):
        sys.exit("no recorded cluster (started with this CLI?)")
    with open(_STATE_FILE) as f:
        state = json.load(f)
    nodes = state.get("nodes")
    if nodes is None:  # legacy single-entry format
        nodes = [state]
    for entry in nodes:
        for pid in entry.get("pids", []):
            try:
                os.kill(pid, signal.SIGTERM)
                print(f"stopped pid {pid}")
            except ProcessLookupError:
                pass
    os.remove(_STATE_FILE)


def cmd_up(args):
    from ray_tpu_torch.autoscaler.launcher import up

    up(args.config)


def cmd_down(args):
    from ray_tpu_torch.autoscaler.launcher import down

    down(args.config)


def cmd_status(args):
    from ray_tpu_torch._private.gcs.client import GcsClient

    addr = _resolve_address(args)
    gcs = GcsClient.from_address(addr)
    res = gcs.get_cluster_resources()
    nodes = gcs.get_all_node_info()
    alive = [n for n in nodes if n["state"] == "ALIVE"]
    print(f"cluster at {addr}: {len(alive)} alive / {len(nodes)} total nodes")
    print("resources:")
    for k in sorted(res["total"]):
        print(f"  {res['available'].get(k, 0):.1f}/{res['total'][k]:.1f} {k}")
    # Memory visibility without running `memory`: per-node object-store
    # utilization + the top-consuming job, from the same aggregation path.
    try:
        from ray_tpu_torch.util import state as _state

        report = _state.memory_report(addr, include_objects=True,
                                      include_drivers=False)
        print("object store:")
        for node in report["nodes"]:
            s = node.get("plasma", {})
            cap = s.get("capacity_bytes") or 0
            used = s.get("used_bytes") or 0
            pct = f" ({100.0 * used / cap:.0f}%)" if cap else ""
            print(f"  {node['node_id'][:12]}: {_fmt_bytes(used)}/"
                  f"{_fmt_bytes(cap)}{pct} used, "
                  f"{_fmt_bytes(node['pinned_bytes'])} pinned"
                  + (f", {len(node['leaks'])} leaked objects"
                     if node.get("leaks") else ""))
        rollup = _state.memory_rollup(report, group_by="job")
        rollup.pop("?", None)
        if rollup:
            top_job, r = max(
                rollup.items(),
                key=lambda kv: kv[1]["plasma_bytes"] + kv[1]["rss_bytes"])
            print(f"  top job: {top_job[:12]} — "
                  f"{_fmt_bytes(r['plasma_bytes'])} plasma, "
                  f"{_fmt_bytes(r['rss_bytes'])} rss, "
                  f"{r['objects']} objects")
    except Exception:
        print("object store: unavailable")
    # Stall visibility without running `debug`: the watchdogs publish
    # incidents to the GCS; a non-zero count here is the first hint.
    try:
        open_count = gcs.call("ListIncidents", {"limit": 1}).get("open", 0)
    except Exception:
        open_count = None
    if open_count is None:
        print("incidents: unavailable")
    else:
        print(f"incidents: {open_count} open"
              + (" (run `ray-tpu-torch debug incidents`)" if open_count else ""))


def cmd_nodes(args):
    from ray_tpu_torch.util import state

    for n in state.list_nodes(_resolve_address(args)):
        print(
            f"{n['node_id'][:12]} {n['state']:<6} {n['node_ip']}:"
            f"{n['raylet_port']} head={n['is_head_node']} {n['resources_total']}"
        )


def cmd_actors(args):
    from ray_tpu_torch.util import state

    for a in state.list_actors(_resolve_address(args)):
        name = a["name"] or "-"
        print(f"{a['actor_id'][:12]} {a['state']:<8} name={name}")


def _fmt_bytes(n) -> str:
    from ray_tpu_torch._private.memory_report import _fmt_bytes as f

    return f(n)


def cmd_memory(args):
    """Memory observability plane: per-node object-store state, per-group
    rollups (job/actor/node) unifying plasma + RSS + HBM, the largest
    owned objects with creation callsites, and (--leaks) the leak
    detector's findings with attribution."""
    from ray_tpu_torch.util import state

    addr = _resolve_address(args)
    group_by = getattr(args, "group_by", "job") or "job"
    sort_by = getattr(args, "sort_by", "size") or "size"

    if getattr(args, "leaks", False):
        leaks = state.find_memory_leaks(addr, sweep=True)
        if not leaks:
            print("no leaked objects detected "
                  "(pinned primaries all have live owner references)")
            return
        print(f"{len(leaks)} leaked object(s), "
              f"{_fmt_bytes(sum(l.get('size') or 0 for l in leaks))} total:")
        for l in leaks:
            where = f" @ {l['callsite']}" if l.get("callsite") else ""
            owner = (f" actor={l['actor_id'][:12]}" if l.get("actor_id")
                     else "")
            print(f"  {l['object_id'][:12]} {_fmt_bytes(l.get('size'))} "
                  f"node={l['node_id'][:12]} job={l['job_id'][:12] or '?'}"
                  f"{owner}{where}"
                  + (" [spilled]" if l.get("spilled") else ""))
        print("details: `ray-tpu-torch debug incidents` (kind=object_leak)")
        return

    report = state.memory_report(addr)
    for node in report["nodes"]:
        s = node.get("plasma", {})
        cap = s.get("capacity_bytes") or 0
        used = s.get("used_bytes") or 0
        pct = f" ({100.0 * used / cap:.0f}%)" if cap else ""
        leak_note = (f", {len(node['leaks'])} LEAKED"
                     if node.get("leaks") else "")
        print(f"node {node['node_id'][:12]}: object store "
              f"{_fmt_bytes(used)}/{_fmt_bytes(cap)}{pct}, "
              f"{node['pinned_count']} pinned "
              f"({_fmt_bytes(node['pinned_bytes'])}), "
              f"{node['spilled_count']} spilled "
              f"({_fmt_bytes(node['spilled_bytes'])}), "
              f"raylet rss {_fmt_bytes(node['raylet_rss'])}{leak_note}")
    rollup = state.memory_rollup(report, group_by=group_by)
    sort_key = {
        "size": lambda kv: -(kv[1]["plasma_bytes"] + kv[1]["rss_bytes"]),
        "plasma": lambda kv: -kv[1]["plasma_bytes"],
        "rss": lambda kv: -kv[1]["rss_bytes"],
        "objects": lambda kv: -kv[1]["objects"],
    }.get(sort_by, lambda kv: -(kv[1]["plasma_bytes"] + kv[1]["rss_bytes"]))
    if rollup:
        print(f"\nby {group_by}:")
        hdr = (f"  {'key':<14} {'plasma':>10} {'objects':>8} "
               f"{'spilled':>10} {'rss':>10} {'hbm':>10} {'leaked':>10}")
        print(hdr)
        for key, r in sorted(rollup.items(), key=sort_key):
            print(f"  {key[:14]:<14} {_fmt_bytes(r['plasma_bytes']):>10} "
                  f"{r['objects']:>8} {_fmt_bytes(r['spilled_bytes']):>10} "
                  f"{_fmt_bytes(r['rss_bytes']):>10} "
                  f"{_fmt_bytes(r['hbm_bytes']):>10} "
                  f"{_fmt_bytes(r['leaked_bytes']):>10}")
    # top holders across every ledger, largest first
    holders = []
    for node in report["nodes"]:
        for w in node["workers"]:
            for row in w.get("ledger", []):
                holders.append((row, w))
    for w in report.get("drivers", []):
        for row in w.get("ledger", []):
            holders.append((row, w))
    holders.sort(key=lambda t: -(t[0].get("size") or 0))
    shown = [h for h in holders[:10] if (h[0].get("size") or 0) > 0]
    if shown:
        print("\ntop owned objects:")
        for row, w in shown:
            owner = (f"actor {w['actor_id'][:12]}" if w.get("actor_id")
                     else w.get("mode", "worker"))
            where = row.get("callsite") or "?"
            print(f"  {row['object_id'][:12]} {_fmt_bytes(row['size']):>10} "
                  f"age={row.get('age_s', 0):.0f}s "
                  f"{'plasma ' if row.get('plasma') else ''}"
                  f"owner={owner} @ {where}")
    if not report["nodes"]:
        print("no alive nodes")


def cmd_profile(args):
    """Profiling plane, two modes:

    With ``--pid``: on-demand stack sampling of ONE worker (reference:
    `ray`'s dashboard py-spy integration), flamegraph-folded output —
    shares the dashboard endpoint's fan-out, ambiguity guard and errors.

    Without ``--pid``: a CLUSTER-WIDE capture — every raylet, its live
    workers and the GCS sample one synchronized window
    (StartProfile/CollectProfile fan-out) and the samples merge with
    task/span events and registered device traces into one
    Perfetto-loadable JSON (``-o``, default profile.json). ``--flame``
    emits the aggregated folded stacks instead (flamegraph.pl/speedscope
    input)."""
    from ray_tpu_torch._private.gcs.client import GcsClient
    from ray_tpu_torch._private.profiling import profile_via_raylets

    gcs = GcsClient.from_address(_resolve_address(args))
    if args.pid is None:
        return _cluster_profile(args, gcs)
    status, payload = profile_via_raylets(
        gcs.get_all_node_info(), pid=args.pid,
        node_filter=args.node_id, duration=args.duration, hz=args.hz,
    )
    if status != 200:
        print(f"error ({status}): {payload.get('error')}", file=sys.stderr)
        sys.exit(1)
    out = payload["folded"]
    if args.output:
        with open(args.output, "w") as f:
            f.write(out + "\n")
        print(f"wrote {payload['samples']} samples to {args.output}")
    else:
        print(out)


def _cluster_profile(args, gcs):
    from ray_tpu_torch._private import profiling
    from ray_tpu_torch._private.timeline import merged_profile_trace

    bundle = profiling.capture_cluster_profile(
        gcs.get_all_node_info(), gcs,
        duration=args.duration, hz=args.hz, node_filter=args.node_id,
    )
    all_profiles = (
        [p for n in bundle["nodes"] for p in n["profiles"]]
        + bundle.get("drivers", [])
        + ([bundle["gcs"]] if bundle.get("gcs") else [])
    )
    n_profiles = len(all_profiles)
    n_samples = sum(len(p["samples"]) for p in all_profiles)
    for err in bundle["errors"]:
        print(f"warning: {err}", file=sys.stderr)
    if args.flame:
        folded = profiling.fold_bundle(bundle)
        text = "\n".join(
            f"{stack} {c}"
            for stack, c in sorted(folded.items(), key=lambda kv: -kv[1])
        )
        if args.output:
            with open(args.output, "w") as f:
                f.write(text + "\n")
            print(f"wrote {n_samples} samples from {n_profiles} processes "
                  f"to {args.output}")
        else:
            print(text)
        return
    try:
        task_events = gcs.call("GetTaskEvents", {"limit": 100_000})["events"]
    except Exception:
        task_events = []
    device = profiling.list_registered(gcs, "device_trace")
    trace = merged_profile_trace(bundle, task_events, device)
    out = args.output or "profile.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    profiling.register_capture(gcs, os.path.abspath(out), reason="cli")
    print(f"wrote {len(trace['traceEvents'])} events "
          f"({n_samples} CPU samples from {n_profiles} processes) to {out}")
    print("open in https://ui.perfetto.dev or chrome://tracing")


def cmd_grafana(args):
    """Dump the generated Grafana dashboard JSON (reference:
    grafana_dashboard_factory.py)."""
    from ray_tpu_torch.dashboard.grafana import dashboard_json

    if args.output:
        with open(args.output, "w") as f:
            f.write(dashboard_json())
        print(f"wrote dashboard to {args.output}")
    else:
        print(dashboard_json())


def cmd_timeline(args):
    from ray_tpu_torch._private.gcs.client import GcsClient
    from ray_tpu_torch._private.timeline import (
        chrome_trace_events, flight_instant_events)

    addr = _resolve_address(args)
    gcs = GcsClient.from_address(addr)
    req = {"limit": 100_000}
    if getattr(args, "job", None):
        req["job_id"] = args.job
    if getattr(args, "trace_id", None):
        req["trace_id"] = args.trace_id
    events = chrome_trace_events(gcs.call("GetTaskEvents", req)["events"])
    # Object-plane instants (spill/restore/leak) live in the raylets'
    # flight-recorder rings, not the GCS task-event log — fan them in so
    # "the step stalled while the store was spilling" is one view.
    if not getattr(args, "no_object_events", False):
        from ray_tpu_torch.util import state

        try:
            for n, reply in state._fanout_raylets(
                addr, "DumpFlightRecorder", timeout=15,
                payload={"include_workers": False},
            ):
                events.extend(flight_instant_events(
                    n["node_id"].hex(), reply.get("events", [])))
        except Exception as e:
            print(f"warning: object-event fan-in failed: {e}",
                  file=sys.stderr)
        events.sort(key=lambda e: e["ts"])
    with open(args.output, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {args.output}")


def collect_debug_dump(address: str, *, ring_limit: int = 1000,
                       stack_duration: float = 0.3) -> dict:
    """Gather the whole cluster's forensics into {archive_name: text}.

    One pass over the live cluster: state-API listings, the GCS incident
    table (full detail), every raylet's flight-recorder ring fanned in with
    its live workers' rings, per-node object-store stats, and a stack
    sample of every live worker. This is the "why did step 4017 never
    finish" bundle — callable from tests; `ray-tpu-torch debug dump` zips it.
    """
    from ray_tpu_torch._private.gcs.client import GcsClient
    from ray_tpu_torch.util import state

    gcs = GcsClient.from_address(address)
    files: dict = {}

    def put_json(name, obj):
        files[name] = json.dumps(obj, indent=2, default=repr)

    # 1. state-API listings
    listings = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "jobs": state.list_jobs,
        "placement_groups": state.list_placement_groups,
        "tasks": state.list_tasks,
        "workers": state.list_workers,
        "objects": state.list_objects,
    }
    for name, fn in listings.items():
        try:
            put_json(f"state/{name}.json", fn(address))
        except Exception as e:
            files[f"state/{name}.json"] = json.dumps({"error": str(e)})
    # 2. incidents (full detail: stacks + rings)
    try:
        put_json("incidents.json",
                 state.list_incidents(address, limit=500, detail=True))
    except Exception as e:
        files["incidents.json"] = json.dumps({"error": str(e)})
    # 3. profiling plane: the capture registry (triggered + on-demand
    #    cluster profiles, device-trace dirs) and the latest capture files
    #    themselves when they're readable from this host
    try:
        from ray_tpu_torch._private import profiling as _prof

        caps = _prof.list_registered(gcs, "capture")
        put_json("profiles/index.json", {
            "captures": caps,
            "device_traces": _prof.list_registered(gcs, "device_trace"),
        })
        for rec in caps[-3:]:
            path = rec.get("path", "")
            try:
                if (path and os.path.isfile(path)
                        and os.path.getsize(path) <= 64 * 1024 * 1024):
                    with open(path) as f:
                        files[f"profiles/{os.path.basename(path)}"] = f.read()
            except OSError:
                continue
    except Exception as e:
        files["profiles/index.json"] = json.dumps({"error": str(e)})
    # 4. cluster config snapshot + the GCS's own ring (a control-plane
    #    stall is as diagnosable as a data-plane one)
    try:
        put_json("config.json", gcs.call("GetInternalConfig", {}))
    except Exception:
        pass
    try:
        put_json("flight/gcs.json",
                 gcs.call("DumpFlightRecorder", {"limit": ring_limit}))
    except Exception:
        pass
    # 5. per-node: flight rings (raylet + its live workers), object-store
    #    stats, and all-worker stacks
    for n, reply in state._fanout_raylets(
        address, "DumpFlightRecorder", timeout=30,
        payload={"limit": ring_limit, "include_workers": True},
    ):
        node = n["node_id"].hex()[:12]
        put_json(f"flight/node_{node}.json", {
            "node_id": n["node_id"].hex(),
            "raylet_events": reply.get("events", []),
            "workers": [
                {"worker_id": w.get("worker_id", b"").hex()
                 if isinstance(w.get("worker_id"), bytes)
                 else str(w.get("worker_id")),
                 "pid": w.get("pid"),
                 "events": w.get("events", [])}
                for w in reply.get("workers", [])
            ],
        })
    for n, reply in state._fanout_raylets(address, "GetNodeInfo", timeout=15):
        node = n["node_id"].hex()[:12]
        put_json(f"nodes/node_{node}.json", reply)
    # 5b. memory plane: per-node memory reports (plasma/pin/spill tables
    #     joined with worker ownership ledgers) + the cluster rollup —
    #     the "who was holding what" half of a hang/OOM post-mortem
    try:
        report = state.memory_report(address)
        for node in report["nodes"]:
            put_json(f"memory/node_{node['node_id'][:12]}.json", node)
        put_json("memory/rollup.json", {
            gb: state.memory_rollup(report, group_by=gb)
            for gb in ("job", "actor", "node")
        })
        put_json("memory/drivers.json", report.get("drivers", []))
    except Exception as e:
        files["memory/rollup.json"] = json.dumps({"error": str(e)})
    for n, reply in state._fanout_raylets(
        address, "GetLocalWorkerInfo", timeout=15
    ):
        node = n["node_id"].hex()[:12]
        sections = []
        for w in reply.get("workers", []):
            if not w.get("alive"):
                continue
            try:
                from ray_tpu_torch._private.profiling import profile_via_raylets

                status, payload = profile_via_raylets(
                    [n], worker_id=w["worker_id"],
                    duration=stack_duration, hz=100.0,
                )
            except Exception as e:
                status, payload = 500, {"error": str(e)}
            head = (f"== worker {w['worker_id'].hex()[:12]} pid={w.get('pid')}"
                    f" leased={w.get('leased')} ==")
            body = (payload.get("folded", "") if status == 200
                    else f"<error: {payload.get('error')}>")
            sections.append(f"{head}\n{body}\n")
        files[f"stacks/node_{node}.txt"] = "\n".join(sections) or "<no live workers>\n"
    return files


def cmd_debug(args):
    """Hang/crash forensics: `debug dump` writes one archive with the
    cluster's full debugging state; `debug incidents` lists watchdog
    incidents."""
    addr = _resolve_address(args)
    if args.debug_cmd == "incidents":
        from ray_tpu_torch.util import state

        incidents = state.list_incidents(addr, limit=args.limit)
        if not incidents:
            print("no incidents")
            return
        for i in incidents:
            import datetime

            t = datetime.datetime.fromtimestamp(i.get("time", 0))
            print(f"{i.get('id', '?')}  {t:%H:%M:%S}  "
                  f"{i.get('kind', '?'):<12} [{i.get('source', '?')}] "
                  f"{i.get('detail', '')}")
        return
    # dump
    import time as _time
    import zipfile

    out = args.output or f"ray_tpu_debug_{int(_time.time())}.zip"
    files = collect_debug_dump(addr, ring_limit=args.ring_limit)
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for name, text in sorted(files.items()):
            z.writestr(name, text)
    print(f"wrote {len(files)} files to {out}")


def cmd_perf(args):
    """Perf regression plane (no cluster address needed — the bench boots
    its own): `check` measures now and gates against the ledger head,
    `compare` gates two saved measurements (CI), `history` prints the
    ledger. Exit code 1 = regression beyond the noise band."""
    from ray_tpu_torch._private import perf_gate as pg

    if args.perf_cmd == "check":
        report, _result = pg.check(
            only=args.only, quick=args.quick, history=args.history,
            update=args.update, note=args.note)
        exit_fail = report["status"] == "fail"
        if exit_fail and pg.is_noisy_runner() and not args.strict:
            # Cross-TIME comparison on a single-core box: co-tenant load is
            # indistinguishable from a code regression (the CI A/B measures
            # base and head back-to-back instead, so it stays strict).
            report["advisory"] = True
            exit_fail = False
        if exit_fail and report.get("host_mismatch") and not args.strict:
            # Baseline and current ran on different core counts: the
            # multi-process rows measure the box, not the code.
            report["advisory"] = True
            exit_fail = False
        if args.as_json:
            print(json.dumps(report))
        else:
            print(pg.render_report(report))
            if report.get("host_mismatch"):
                hm = report["host_mismatch"]
                print(f"warning: baseline measured on "
                      f"{hm['baseline_cpus']} cpus, this run on "
                      f"{hm['current_cpus']} — cross-core-count deltas on "
                      "the multi-process rows track the runner, not the "
                      "code")
            if report.get("advisory"):
                print("warning: regression(s) measured on a single-core box "
                      "or across different core counts are ADVISORY — pass "
                      "--strict to fail anyway, A/B the suspect metric "
                      "back-to-back on one box, or re-baseline with "
                      "--update")
        if args.output:
            with open(args.output, "w") as f:
                json.dump(report, f, indent=2)
        if exit_fail:
            sys.exit(1)
        return

    if args.perf_cmd == "compare":
        base = pg.load_result_entry(args.base)
        head = pg.load_result_entry(args.head)
        cpus_differ = (base["cpus"] and head["cpus"]
                       and base["cpus"] != head["cpus"])
        if args.skip_noisy and pg.is_noisy_runner():
            report = {"status": "skipped",
                      "reason": "single-core runner: multi-process metrics "
                                "measure the OS scheduler, not the framework",
                      "metrics": {}}
            print("perf gate skipped: " + report["reason"])
        elif args.skip_noisy and cpus_differ:
            report = {"status": "skipped",
                      "reason": f"core-count mismatch (base "
                                f"{base['cpus']} vs head {head['cpus']} "
                                "cpus): the multi-process rows scale with "
                                "the core count — this comparison gates "
                                "the runner, not the code",
                      "metrics": {}}
            print("perf gate skipped: " + report["reason"])
        else:
            report = pg.compare(base["metrics"], head["metrics"],
                                base_reps=base["reps"],
                                cur_reps=head["reps"])
            if cpus_differ:
                report["host_mismatch"] = {"baseline_cpus": base["cpus"],
                                           "current_cpus": head["cpus"]}
            print(pg.render_report(report))
            if cpus_differ:
                print(f"warning: base measured on {base['cpus']} cpus, "
                      f"head on {head['cpus']} — deltas on the "
                      "multi-process rows track the runner, not the code "
                      "(pass --skip-noisy to skip such comparisons)")
        if args.output:
            with open(args.output, "w") as f:
                json.dump(report, f, indent=2)
        if report["status"] == "fail":
            sys.exit(1)
        return

    # history
    entries = pg.load_history(args.history, limit=args.limit)
    if not entries:
        print(f"no perf history at {pg.history_path(args.history)}")
        return
    if args.metric:
        for e in entries:
            v = e["metrics"].get(args.metric)
            if v is not None:
                print(f"{e.get('iso', e.get('time')):<25} "
                      f"{e.get('git', ''):<12} reps={e.get('reps', 1)} "
                      f"{args.metric}={v}")
        return
    for e in entries:
        print(f"{e.get('iso', e.get('time')):<25} {e.get('git', ''):<12} "
              f"reps={e.get('reps', 1)} {len(e['metrics'])} metrics"
              + (f"  [{e['note']}]" if e.get("note") else ""))


def cmd_job(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    if args.job_cmd == "submit":
        import shlex

        entrypoint = [a for a in args.entrypoint if a != "--"]
        sid = client.submit_job(
            entrypoint=" ".join(shlex.quote(a) for a in entrypoint)
        )
        print(sid)
        if args.wait:
            for chunk in client.tail_job_logs(sid):
                sys.stdout.write(chunk)
            print(f"status: {client.get_job_status(sid)}")
    elif args.job_cmd == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_cmd == "logs":
        sys.stdout.write(client.get_job_logs(args.submission_id))
    elif args.job_cmd == "stop":
        print("stopped" if client.stop_job(args.submission_id) else "not running")
    elif args.job_cmd == "list":
        for j in client.list_jobs():
            print(f"{j['submission_id']}  {j['status']:<10} {j['entrypoint']}")


def cmd_lint(args):
    from ray_tpu_torch._private import lint as lint_mod

    root = args.root or lint_mod.find_repo_root()
    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline:
        cand = os.path.join(root, lint_mod.DEFAULT_BASELINE)
        if os.path.exists(cand):
            baseline_path = cand
    baseline = (
        lint_mod.load_baseline(baseline_path) if baseline_path else None
    )
    result = lint_mod.run_lint(
        paths=args.paths or None, root=root,
        baseline=None if args.update_baseline else baseline,
    )
    if args.update_baseline:
        path = baseline_path or os.path.join(root, lint_mod.DEFAULT_BASELINE)
        n = lint_mod.save_baseline(path, result.findings)
        print(f"wrote {n} accepted finding(s) to {path}")
        return
    if args.json:
        json.dump(result.to_json(), sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        print(lint_mod.render_report(result, verbose=args.verbose))
    if not result.ok:
        sys.exit(1)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None)
    p.add_argument("--resources", default=None)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (use the node's reachable IP for "
                        "multi-host clusters)")
    p.add_argument("--port", type=int, default=0,
                   help="fixed GCS port for the head (0 = auto)")
    p.add_argument("--dashboard-port", type=int, default=-1,
                   help=">=0 to start the dashboard (0 = auto port)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("up", help="provision + bootstrap a cluster from YAML")
    p.add_argument("config")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="stop + terminate a YAML-defined cluster")
    p.add_argument("config")
    p.set_defaults(fn=cmd_down)

    for name, fn in (("status", cmd_status), ("nodes", cmd_nodes),
                     ("actors", cmd_actors)):
        p = sub.add_parser(name)
        p.add_argument("--address", default=None)
        p.set_defaults(fn=fn)

    p = sub.add_parser(
        "memory",
        help="cluster memory report: object-store state per node, "
             "job/actor/node rollups (plasma+RSS+HBM), top owned objects "
             "with callsites; --leaks runs the leak detector")
    p.add_argument("--address", default=None)
    p.add_argument("--group-by", dest="group_by", default="job",
                   choices=("job", "actor", "node"))
    p.add_argument("--sort-by", dest="sort_by", default="size",
                   choices=("size", "plasma", "rss", "objects"))
    p.add_argument("--leaks", action="store_true",
                   help="force a leak sweep on every node and list "
                        "pinned/spilled primaries with no live owner "
                        "reference (with job/actor/callsite attribution)")
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("timeline")
    p.add_argument("--address", default=None)
    p.add_argument("--job", default=None,
                   help="only this job's events (hex id, server-side)")
    p.add_argument("--trace-id", dest="trace_id", default=None,
                   help="only this trace's spans (server-side)")
    p.add_argument("--no-object-events", dest="no_object_events",
                   action="store_true",
                   help="skip the spill/restore/leak instants fanned in "
                        "from the raylets' flight recorders")
    p.add_argument("-o", "--output", default="timeline.json")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "profile",
        help="cluster-wide CPU profile merged with the task timeline; "
             "--pid samples one worker")
    p.add_argument("--address", default=None)
    p.add_argument("--pid", type=int, default=None,
                   help="sample ONE worker (folded output); omit for a "
                        "cluster-wide capture")
    p.add_argument("--node", "--node-id", dest="node_id", default=None,
                   help="restrict to nodes whose id starts with this hex "
                        "prefix")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--hz", type=float, default=99.0)
    p.add_argument("--flame", action="store_true",
                   help="folded-stack (flamegraph/speedscope) output "
                        "instead of the merged Perfetto trace")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("grafana")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_grafana)

    p = sub.add_parser(
        "perf", help="perf regression gate: microbench A/B vs the "
                     "port's ledger with per-metric noise bands")
    psub = p.add_subparsers(dest="perf_cmd", required=True)
    c = psub.add_parser("check", help="measure now, gate vs the ledger head")
    c.add_argument("--only", default=None,
                   help="comma-separated metric-name substrings "
                        "(microbench --only)")
    c.add_argument("--quick", action="store_true",
                   help="single-rep reduced-duration pass (wider noise band)")
    c.add_argument("--history", default=None,
                   help="ledger path (default: RTPU_TORCH_perf_history_path, "
                        "PERF_HISTORY_TORCH.jsonl at the repo root)")
    c.add_argument("--update", action="store_true",
                   help="append this measurement to the ledger")
    c.add_argument("--note", default="", help="ledger entry note")
    c.add_argument("--strict", action="store_true",
                   help="fail on regression even on a single-core box "
                        "(default: advisory there — co-tenant load is "
                        "indistinguishable from a code regression)")
    c.add_argument("--json", dest="as_json", action="store_true",
                   help="print the structured delta report instead of the "
                        "table")
    c.add_argument("-o", "--output", default=None,
                   help="also write the delta report JSON to FILE")
    c.set_defaults(fn=cmd_perf)
    c = psub.add_parser(
        "compare", help="gate two microbench --json result files (CI A/B)")
    c.add_argument("base", help="baseline microbench --json output file")
    c.add_argument("head", help="candidate microbench --json output file")
    c.add_argument("--skip-noisy", action="store_true",
                   help="exit 0 with a skipped report on a single-core "
                        "runner (the A/B would measure the scheduler)")
    c.add_argument("-o", "--output", default=None,
                   help="write the delta report JSON to FILE (CI artifact)")
    c.set_defaults(fn=cmd_perf)
    c = psub.add_parser("history", help="print the perf ledger")
    c.add_argument("--history", default=None, help="ledger path override")
    c.add_argument("--metric", default=None,
                   help="print one metric's trajectory")
    c.add_argument("--limit", type=int, default=0)
    c.set_defaults(fn=cmd_perf)

    p = sub.add_parser(
        "lint",
        help="invariant lint plane: contract cross-check, shard-safety, "
             "event-loop blocking-call detection (rule reference: "
             "ray_tpu_torch/_private/lint/__init__.py)")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the ray_tpu_torch package)")
    p.add_argument("--baseline", default=None,
                   help="accepted-findings file (default: "
                        "ray_tpu_torch/.lint-baseline.json if present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report every finding")
    p.add_argument("--update-baseline", action="store_true",
                   help="triage mode: write ALL current findings to the "
                        "baseline and exit 0")
    p.add_argument("--json", action="store_true",
                   help="machine-readable ray_tpu_torch.lint.v1 report (CI "
                        "artifact mode)")
    p.add_argument("--verbose", action="store_true",
                   help="also print baseline-accepted findings")
    p.add_argument("--root", default=None,
                   help="repo root override (contracts + baseline resolve "
                        "against it)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser(
        "debug", help="hang/crash forensics: dump archive, list incidents")
    p.add_argument("--address", default=None)
    dsub = p.add_subparsers(dest="debug_cmd", required=True)
    d = dsub.add_parser("dump", help="one archive: state listings, "
                        "all-worker stacks, per-node flight-recorder "
                        "rings, object-store stats, incidents")
    d.add_argument("-o", "--output", default=None)
    d.add_argument("--ring-limit", type=int, default=1000,
                   help="max flight-recorder events per process")
    i = dsub.add_parser("incidents", help="list stall-watchdog incidents")
    i.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_debug)

    p = sub.add_parser("job")
    p.add_argument("--address", default=None)
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--wait", action="store_true")
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("submission_id")
    jsub.add_parser("list")
    p.set_defaults(fn=cmd_job)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
