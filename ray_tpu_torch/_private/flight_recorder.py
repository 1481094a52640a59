"""Per-process flight recorder: a fixed-size ring of cheap structured events.

A copy of ``ray_tpu/_private/flight_recorder.py`` (the port imports nothing
of the JAX package) that reads the port's flags: ``RTPU_TORCH_flight_recorder``
(0 gives the no-op recorder) and ``RTPU_TORCH_flight_recorder_size``. Every
process of the port's runtime (driver, worker, raylet, GCS), the LLM engine
and the train recorder append structured events to a bounded in-memory ring
on their hot paths; nothing is formatted or serialized until someone asks
for a dump (reference analogues: the reference's task-event buffer and the
"flight recorder" pattern, arxiv 2011.03641 §5 straggler diagnosis). The
ring answers "what were the last things this process did before it stalled
or died", which Prometheus gauges cannot.

Hot-path discipline: ``record()`` is ONE ``deque.append`` of a small tuple
(seq, ts, event, a, b) — no dict build, no hex/str conversion, no lock
(deque.append is atomic under the GIL; the seq counter is an atomic
``itertools.count``). Formatting happens only in ``dump()`` /
``flush_to_file()``.

Surfacing:

  - ``DumpFlightRecorder`` RPC on raylets (fans out to live workers) and
    workers;
  - workers append new events to ``<session>/logs/flight_worker-<pid>.jsonl``
    on the task-event flush cadence and on exit, so the raylet can attach a
    SIGKILLed worker's last events to its death report (→ ActorDiedError);
  - the stall watchdog (_private/watchdog.py) snapshots the ring into every
    incident it publishes to the GCS;
  - ``install_exit_dump`` arranges a last flush to a file of the caller's
    choosing on normal exit and SIGTERM.

EVENT-NAME STABILITY CONTRACT
-----------------------------
The event names are the JAX package's, a public debugging surface: the
``flight_*.jsonl`` session files and incident records carry them, and
operators grep for them. Renaming or repurposing one is a breaking change —
add new names instead. ``a``/``b`` hold the event's subject (ids as raw
bytes, hex-encoded at dump time) and a short detail string/number.

  task.pending / task.submitted / task.running / task.finished /
  task.failed / task.retry       task state transitions (mirrors the GCS
                                 task-event states, lowercased)
  obj.put                        plasma/inline store of an owned object
  obj.spill / obj.restore        raylet spill-to-disk and restore, one
                                 event per object: (oid, bytes) — the
                                 timeline renders these as instants on
                                 the owning node's lane
  obj.leak                       the leak detector confirmed a primary
                                 with no live owner reference (oid, bytes)
  obj.pull / obj.push            node-to-node object transfer attempts
  rpc.error                      a transport-level RPC failure at a
                                 recorded call site (lease push, reply
                                 flush, transfer)
  lease.grant / lease.return     raylet worker-lease lifecycle
  worker.spawn / worker.death    raylet worker-pool lifecycle
  worker.oom_kill                memory-monitor kill
  actor.state                    actor lifecycle transition (GCS + owner)
  node.dead                      GCS marked a node dead
  chan.up / chan.down            direct call channel lifecycle
  collective.enter / collective.exit   gloo-style CPU collective ops
  train.step                     one (multi-)step call recorded by the
                                 train telemetry layer: "<n>x <s>s
                                 [compile]", or without telemetry
                                 "dispatch" / "trace+compile" /
                                 "multi_step x<n>"
  serve.request                  one replica-side serve request finished
  llm.admit / llm.preempt / llm.finish   serve/llm engine sequence
                                 lifecycle (admit carries the prompt
                                 length + prefix-hit token count)
  llm.prefix_hit                 a prefix-cache hit at admission:
                                 "<seq> hit=<tokens>/<context>"
  llm.spec_verify                one speculative verify round:
                                 "batch=<B> k=<proposed> accepted=<n>"
  chaos.inject                   the chaos plane fired a fault:
                                 "<site> <action> rule=<i> <attrs>" —
                                 tests join these against the incident
                                 table to assert exactly-one attributed
                                 incident per induced fault
  serve.failover                 a serve.llm stream resubmitted its
                                 remaining generation to a surviving
                                 replica after its pinned replica died:
                                 "<app> <old>-><new> tokens=<n>
                                 attempt=<k>"
  incident.open                  the GCS accepted an incident record
  watchdog.fire                  a stall watchdog tripped locally

The port records all but collective.*, serve.request, serve.failover and
obj.pull / obj.push so far: their modules (util/collective, the serve
deployment, multi-node transfer) come to it later and keep these names.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = [
    "FlightRecorder", "enabled", "get_recorder", "record", "dump",
    "set_dump_path", "flush_to_file", "install_exit_dump",
]


def _fmt(v):
    """Dump-time formatting of a recorded arg: bytes ids become hex."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).hex()
    if isinstance(v, float):
        return round(v, 6)
    return v


class FlightRecorder:
    """Bounded ring of (seq, ts, event, a, b) tuples.

    ``record`` is safe from any thread; overflow silently drops the oldest
    events (that is the point of a flight recorder — the tail survives).
    """

    def __init__(self, size: int = 4096):
        self._ring: deque = deque(maxlen=max(16, int(size)))
        self._seq = itertools.count(1)
        self._next = self._seq.__next__
        self._flush_cursor = 0  # last seq written by flush_to_file
        self._flush_lock = threading.Lock()
        self.dump_path: Optional[str] = None

    # ------------------------------------------------------------ hot path

    def record(self, event: str, a=b"", b=""):
        self._ring.append((self._next(), time.time(), event, a, b))

    # ------------------------------------------------------------ readouts

    def snapshot(self) -> list:
        """Raw tuples, oldest first (cheap; no formatting)."""
        return list(self._ring)

    def dump(self, limit: int = 0) -> List[dict]:
        """Formatted events, oldest first. ``limit`` > 0 keeps the tail."""
        events = self.snapshot()
        if limit and len(events) > limit:
            events = events[-limit:]
        return [
            {"seq": seq, "ts": round(ts, 6), "event": ev,
             "a": _fmt(a), "b": _fmt(b)}
            for seq, ts, ev, a, b in events
        ]

    # ----------------------------------------------------------- file sink

    def flush_to_file(self, path: Optional[str] = None) -> int:
        """Append events recorded since the last flush to ``path`` (JSONL).

        Incremental and idempotent, so the periodic call from the worker's
        flush loop keeps the on-disk tail current — which is what makes the
        forensics work even for SIGKILLed workers (no exit handler runs,
        but the file already holds everything up to the last cadence).
        Returns the number of events written.
        """
        path = path or self.dump_path
        if not path:
            return 0
        with self._flush_lock:
            fresh = [t for t in self.snapshot() if t[0] > self._flush_cursor]
            if not fresh:
                return 0
            try:
                with open(path, "a") as f:
                    for seq, ts, ev, a, b in fresh:
                        f.write(json.dumps(
                            {"seq": seq, "ts": round(ts, 6), "event": ev,
                             "a": _fmt(a), "b": _fmt(b)}) + "\n")
            except OSError:
                return 0
            self._flush_cursor = fresh[-1][0]
            return len(fresh)


class _NullRecorder:
    """RTPU_TORCH_flight_recorder=0: every entry point is a no-op."""

    dump_path = None

    def record(self, event, a=b"", b=""):
        pass

    def snapshot(self):
        return []

    def dump(self, limit=0):
        return []

    def flush_to_file(self, path=None):
        return 0


_recorder = None
_rec_lock = threading.Lock()


def enabled() -> bool:
    from ray_tpu_torch._private.config import CONFIG

    return bool(CONFIG.flight_recorder)


def get_recorder() -> FlightRecorder:
    """Process-global recorder (lazy; config read once at creation)."""
    global _recorder
    rec = _recorder
    if rec is None:
        with _rec_lock:
            rec = _recorder
            if rec is None:
                from ray_tpu_torch._private.config import CONFIG

                if CONFIG.flight_recorder:
                    rec = FlightRecorder(CONFIG.flight_recorder_size)
                else:
                    rec = _NullRecorder()
                _recorder = rec
    return rec


def record(event: str, a=b"", b=""):
    """Module-level hot-path entry: one attribute walk + deque append."""
    get_recorder().record(event, a, b)


def dump(limit: int = 0) -> List[dict]:
    return get_recorder().dump(limit)


def set_dump_path(path: str):
    get_recorder().dump_path = path


def flush_to_file(path: Optional[str] = None) -> int:
    return get_recorder().flush_to_file(path)


def flush_now():
    """Best-effort final flush for os._exit paths (Exit/KillActor RPCs,
    raylet-death suicide) where atexit never runs."""
    try:
        get_recorder().flush_to_file()
    except Exception:
        pass


def install_exit_dump(path: str):
    """Arrange for the ring to reach ``path`` on normal exit and SIGTERM.

    SIGKILL cannot be caught — the periodic flush_to_file cadence is the
    real safety net; this just tightens the tail for graceful deaths.
    """
    import atexit
    import signal

    set_dump_path(path)
    atexit.register(flush_now)
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            flush_now()
            if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                prev(signum, frame)
            else:
                os._exit(143)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # not the main thread / restricted env: atexit still covers us


def read_tail_file(path: str, limit: int = 8) -> List[dict]:
    """Read the last ``limit`` events of a flight JSONL file (raylet side:
    attach a dead worker's final events to its death report)."""
    try:
        with open(path, "rb") as f:
            try:
                f.seek(-64 * 1024, os.SEEK_END)
            except OSError:
                pass
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return []
    out = []
    for line in lines[-limit:]:
        try:
            out.append(json.loads(line))
        except (json.JSONDecodeError, ValueError):
            continue
    return out


def format_tail(events: List[dict]) -> str:
    """One-line-per-event rendering for error messages."""
    return "\n".join(
        f"  [{e.get('ts', 0):.3f}] {e.get('event', '?')}"
        f" {e.get('a', '')} {e.get('b', '')}".rstrip()
        for e in events
    )
