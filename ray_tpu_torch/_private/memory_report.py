"""Memory observability plane: shared helpers for building, persisting and
rendering per-process memory reports.

The ledger itself lives in ``reference_counter.ReferenceCounter`` (per owned
ref: size, owner task, creation callsite, pin state, age); this module holds
everything around it that more than one process role needs:

  - ``callsite()``       cheap creation-callsite capture for ``ray.put``-
                         shaped paths (first frame outside ray_tpu_torch);
  - ``process_rss()``    this process's resident set size, no psutil needed;
  - ``build_worker_report()``  one worker/driver's full memory report — the
                         payload of the worker-side ``GetMemoryReport`` RPC
                         and of the periodic on-disk snapshot that survives
                         SIGKILL (OOM forensics);
  - ``write_snapshot()`` / ``read_snapshot()``  the snapshot file protocol
                         (``<session>/logs/memory_worker-<pid>.json``),
                         mirroring the flight-recorder tail files;
  - ``format_top_holders()``  compact text rendering attached to a dead
                         worker's death report → ``ActorDiedError``.

Everything here is pull-only: nothing is computed until a report is asked
for, and the hot-path cost of the plane is limited to the fields
``reference_counter`` already writes plus one frame-walk per ``ray.put``
(disable with ``RTPU_TORCH_memory_ledger_callsite=0``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def callsite(depth: int = 12) -> str:
    """``file.py:lineno`` of the first stack frame outside the ray_tpu_torch
    package — the user line that created the object. Bounded frame walk,
    no traceback objects, ~1 µs; returns "" when everything is internal
    (framework-internal puts) or capture is disabled."""
    from ray_tpu_torch._private.config import CONFIG

    if not CONFIG.memory_ledger_callsite:
        return ""
    try:
        f = sys._getframe(2)
    except ValueError:
        return ""
    for _ in range(depth):
        if f is None:
            return ""
        fname = f.f_code.co_filename
        if not fname.startswith(_PKG_DIR):
            return f"{os.path.basename(fname)}:{f.f_lineno}"
        f = f.f_back
    return ""


def process_rss(pid: Optional[int] = None) -> int:
    """Resident set size in bytes via /proc (zero-dependency; psutil is the
    raylet's fallback for processes it doesn't own)."""
    path = f"/proc/{pid}/statm" if pid else "/proc/self/statm"
    try:
        with open(path) as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def build_worker_report(core, limit: int = 0) -> dict:
    """One process's memory report: identity + RSS + ownership ledger.

    ``core`` is a CoreWorker; ``limit`` > 0 keeps the top holders by size
    (the RPC default comes from ``RTPU_TORCH_memory_report_top_n``).
    """
    total, plasma = core.refs.owned_bytes()
    stats = core.refs.stats()
    return {
        "worker_id": core.worker_id.binary(),
        "pid": os.getpid(),
        "mode": core.mode,
        "actor_id": core.actor_id or b"",
        "job_id": core.job_id.binary(),
        "rss_bytes": process_rss(),
        "owned_refs": stats["owned"],
        "borrowed_refs": stats["borrowed"],
        "owned_bytes": total,
        "owned_plasma_bytes": plasma,
        "memory_store_entries": core.memory_store.size(),
        "time": time.time(),
        "ledger": core.refs.ledger(limit=limit),
    }


# --------------------------------------------------------- snapshot files


def snapshot_path(session_dir: str, pid: int) -> str:
    return os.path.join(session_dir, "logs", f"memory_worker-{pid}.json")


def write_snapshot(core, top_n: int = 10) -> bool:
    """Persist a compact report for this worker so the raylet can attach
    the last-known memory state to an OOM/SIGKILL death report (the same
    no-exit-handler-needed pattern as the flight-recorder tail files).
    Atomic replace: the raylet may read concurrently with a kill."""
    if not core.session_dir:
        return False
    report = build_worker_report(core, limit=top_n)
    path = snapshot_path(core.session_dir, os.getpid())
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(_jsonable(report), f)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


def read_snapshot(session_dir: str, pid: int, max_age_s: float = 0) -> Optional[dict]:
    path = snapshot_path(session_dir, pid)
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return None
    if max_age_s and time.time() - float(snap.get("time", 0)) > max_age_s:
        return None
    return snap


def _jsonable(obj):
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj).hex()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


# ------------------------------------------------------------- rendering


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def format_top_holders(report: dict, limit: int = 5) -> str:
    """Compact multi-line rendering of a worker report for death reports —
    what an OOM-killed actor's ActorDiedError shows as its final memory
    state."""
    rss = report.get("rss_bytes", 0)
    lines = [
        f"  rss={_fmt_bytes(rss)} owned={report.get('owned_refs', 0)} refs"
        f"/{_fmt_bytes(report.get('owned_bytes', 0))}"
        f" (plasma {_fmt_bytes(report.get('owned_plasma_bytes', 0))})"
    ]
    for row in (report.get("ledger") or [])[:limit]:
        oid = row.get("object_id", "")
        oid_hex = oid if isinstance(oid, str) else bytes(oid).hex()
        where = row.get("callsite") or "?"
        lines.append(
            f"  {oid_hex[:12]} {_fmt_bytes(row.get('size', 0))}"
            f" age={row.get('age_s', 0):.0f}s"
            f"{' plasma' if row.get('plasma') else ''} @ {where}"
        )
    return "\n".join(lines)
