"""CoreWorker: the runtime inside every worker and driver process.

Counterpart of the reference's CoreWorker
(reference: src/ray/core_worker/core_worker.h:295 — SubmitTask
core_worker.cc:2166, Get :1552, HandlePushTask :3483) plus the
NormalTaskSubmitter lease/push pipeline
(reference: transport/normal_task_submitter.cc:24,:299,:547) and the
ActorTaskSubmitter ordered queues (reference: transport/actor_task_submitter.h:73).

Threading model: one background asyncio IO loop per process runs every RPC
(client and server). Synchronous user threads (driver API, task execution
threads) post coroutines to it and block on futures. Serialization and plasma
reads/writes happen on user threads to keep the IO loop responsive.
"""

from __future__ import annotations

import asyncio
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import msgpack

from ray_tpu_torch._native.plasma import PlasmaClient, PlasmaOOM
from ray_tpu_torch._private import chaos as _chaos
from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private import runtime_env as renv, serialization, task_spec as ts
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.executor import Executor
from ray_tpu_torch._private.function_manager import FunctionManager
from ray_tpu_torch._private.gcs.client import GcsAioClient, GcsClient
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.memory_report import callsite as _mem_callsite
from ray_tpu_torch._private.memory_store import InPlasma, MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef, set_worker_hooks
from ray_tpu_torch._private.reference_counter import ReferenceCounter
from ray_tpu_torch._private.rpc import ClientPool, ConnectionLost, IoThread, RemoteError, RpcClient, RpcServer
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    OwnerDiedError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"

_INLINE = "inline"
_ERR = "err"

# Task-state -> flight-recorder event names, precomputed so the hot path
# pays one dict lookup instead of a str.lower() allocation per transition.
_FR_TASK_STATES = {
    "PENDING": "task.pending",
    "SUBMITTED": "task.submitted",
    "RUNNING": "task.running",
    "FINISHED": "task.finished",
    "FAILED": "task.failed",
    "RETRY": "task.retry",
}


def _pinned_buffer(mv: memoryview, handle: "_PinHandle"):
    """Out-of-band buffer tying a plasma pin to value lifetime.

    Arrays deserialized zero-copy from plasma keep a reference to their
    buffer; when the last buffer of an object dies, the shared handle
    releases the plasma pin so the store may reclaim the memory (matches
    the reference plasma client's buffer refcounting, plasma/client.cc).

    The finalizer must sit on an object the deserialized value actually
    RETAINS. numpy does NOT keep the pickle.PickleBuffer it is handed — it
    re-exports the underlying buffer, so the deep base chain is
    ndarray -> memoryview -> <root exporter>, and a finalizer on the
    PickleBuffer fires as soon as unpickling returns, dropping the pin
    while the value still aliases store memory (under store churn the
    region gets reused and the value silently corrupts). A ctypes array
    created with from_buffer(mv) IS the root exporter of everything built
    on top of it — the retained memoryview's .obj — so a finalizer on it
    fires exactly when the last aliasing view dies. pickle.PickleBuffer
    wraps it for the unpickler (C-level buffer protocol on every supported
    Python; a pure-Python __buffer__ wrapper needs PEP 688, 3.12+).
    """
    import ctypes
    import pickle
    import weakref

    carr = (ctypes.c_char * mv.nbytes).from_buffer(mv)
    handle.count += 1
    weakref.finalize(carr, handle.dec)
    return pickle.PickleBuffer(carr)


class _PinHandle:
    __slots__ = ("count", "_release")

    def __init__(self, release):
        self.count = 0
        self._release = release

    def dec(self):
        self.count -= 1
        if self.count <= 0 and self._release is not None:
            release, self._release = self._release, None
            try:
                release()
            except Exception:
                pass


class TaskEventBuffer:
    """Buffered task state transitions flushed to the GCS task-event sink
    (reference: src/ray/core_worker/task_event_buffer.h:206)."""

    def __init__(self, core):
        self.core = core
        self._events: List[dict] = []
        self._lock = threading.Lock()
        # record() runs twice per task on the hot path — snapshot what never
        # changes for this worker's lifetime
        self._max_buffer = CONFIG.task_events_max_buffer
        self._worker_hex = core.worker_id.hex()
        self._node_hex = ""

    def record(self, spec: dict, state: str, error: str = ""):
        # Hot path (2+ calls per task): capture only the small id fields in
        # a tuple (holding the whole spec would pin its inline args until
        # the next drain) and defer the dict build + hex conversions to
        # drain() — the flush loop runs once a second, the submit path runs
        # thousands of times a second.
        fr_event = _FR_TASK_STATES.get(state)
        if fr_event is not None:
            _fr.record(fr_event, spec["task_id"], spec.get("name", ""))
        if state == "RUNNING":
            # live-RUNNING registry: the raylet's stall watchdog probes it
            # via GetCoreWorkerStats to find tasks stuck in execution
            self.core.running_tasks[spec["task_id"]] = (
                spec.get("name", ""), time.time())
        elif state in ("FINISHED", "FAILED"):
            self.core.running_tasks.pop(spec["task_id"], None)
        ev = (
            spec["task_id"], spec.get("name", ""), spec.get("job_id", b""),
            spec.get("actor_id"), state, time.time(), error,
        )
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._max_buffer:
                del self._events[: len(self._events) // 2]

    def _materialize(self, ev) -> dict:
        if isinstance(ev, dict):  # span records are pre-built
            return ev
        task_id, name, job_id, actor_id, state, ts, error = ev
        if not self._node_hex and self.core.node_id:
            self._node_hex = self.core.node_id.hex()
        return {
            "task_id": task_id.hex() if isinstance(task_id, bytes) else task_id,
            "name": name,
            "job_id": job_id.hex() if isinstance(job_id, bytes) else "",
            "state": state,
            "ts": ts,
            "node_id": self._node_hex,
            "worker_id": self._worker_hex,
            "error": error,
            "actor_id": actor_id.hex() if actor_id else "",
        }

    def record_span(
        self, name: str, start: float, end: float, ctx: dict,
        attributes: dict, error: str = "",
    ):
        """User/tracing span (ray_tpu_torch.util.tracing) — rides the same buffer
        and GCS sink as task state events; rendered by timeline()."""
        ev = {
            "task_id": ctx.get("span_id", ""),
            "name": name,
            "job_id": self.core.job_id.hex() if self.core.job_id else "",
            "state": "SPAN",
            "ts": start,
            "dur": end - start,
            "node_id": self.core.node_id.hex() if self.core.node_id else "",
            "worker_id": self.core.worker_id.hex(),
            "error": error,
            "actor_id": "",
            "trace_id": ctx.get("trace_id", ""),
            "parent_span_id": ctx.get("parent_span_id", ""),
            "attributes": {str(k): str(v) for k, v in attributes.items()},
        }
        with self._lock:
            self._events.append(ev)
            if len(self._events) > CONFIG.task_events_max_buffer:
                del self._events[: len(self._events) // 2]

    def drain(self) -> List[dict]:
        with self._lock:
            out, self._events = self._events, []
        return [self._materialize(ev) for ev in out]


class _LeaseState:
    __slots__ = ("idle", "queue", "requests_in_flight", "all_leases")

    def __init__(self):
        self.idle: deque = deque()   # lease dicts ready for reuse
        self.queue: deque = deque()  # task specs waiting for a lease
        self.requests_in_flight = 0
        self.all_leases: set = set()


class _ActorSubmitter:
    __slots__ = (
        "actor_id", "state", "addr", "seq", "buffer", "inflight", "watched",
        "death_cause", "creation_refs", "push_queue", "pushing", "epoch",
        "direct_pending_switch", "state_key",
    )

    def __init__(self, actor_id: bytes):
        self.actor_id = actor_id
        self.direct_pending_switch = False
        self.state = "UNKNOWN"
        self.addr: Optional[Tuple[str, int]] = None
        self.seq = 0
        self.buffer: deque = deque()  # specs waiting for ALIVE
        self.push_queue: deque = deque()  # specs ready to push (actor ALIVE)
        self.pushing = 0  # in-flight push batches awaiting their replies
        self.epoch = 0  # bumped on restart; stale batch accounting ignores
        self.inflight: Dict[bytes, dict] = {}  # task_id -> spec
        self.watched = False
        self.death_cause = ""
        # (num_restarts, 1 if ALIVE else 0) of the newest state applied: the
        # GCS reply to a state refresh and a pubsub message reach the io
        # loop on different connections, so an older state can land after
        # a newer one and must not undo it
        self.state_key = (-1, -1)


class CoreWorker:
    def __init__(
        self,
        mode: str,
        gcs_address: str,
        raylet_addr: Tuple[str, int],
        job_id: JobID,
        startup_token: int = -1,
        session_dir: str = "",
        host: str = "127.0.0.1",
        driver_sys_path: Optional[List[str]] = None,
        node_id_hex: str = "",
        plasma_name: str = "",
        pre_register=None,
    ):
        self.mode = mode
        # None = unknown (fetch via GetJob at connect); a list (possibly
        # empty) = the raylet already resolved it into the spawn message.
        self._driver_sys_path = driver_sys_path
        # Node identity/plasma handed through the spawn message: the worker
        # can attach the object store and run `pre_register` (spawn-time
        # actor creation) BEFORE the RegisterWorker round-trip, letting the
        # creation result ride the registration request itself.
        self._node_id_hint = node_id_hex
        self._plasma_name_hint = plasma_name
        self._pre_register = pre_register
        self.job_id = job_id
        self.worker_id = WorkerID.from_random()
        self.host = host
        self.session_dir = session_dir
        self.io = IoThread.current()
        self.inline_threshold = CONFIG.max_direct_call_object_size
        # hot-path config snapshot (each CONFIG read is an os.environ
        # probe, ~12 µs — these are read multiple times per task)
        self._cfg_push_batch = CONFIG.task_push_max_batch
        self._cfg_lease_inflight = CONFIG.max_lease_requests_in_flight
        self._cfg_actor_inflight = CONFIG.actor_push_max_inflight
        self._cfg_direct = CONFIG.direct_channels

        self.server = RpcServer(host)
        from ray_tpu_torch._private import schema as _schema

        self.server.set_validator(_schema.make_validator(_schema.WORKER_SCHEMAS))
        self.pool = ClientPool()
        self.gcs_address = gcs_address
        gcs_host, gcs_port = gcs_address.rsplit(":", 1)
        self.gcs_aio = GcsAioClient(gcs_host, int(gcs_port))
        self.gcs = GcsClient(gcs_host, int(gcs_port), self.io)
        self.functions = FunctionManager(self.gcs.kv_put, self.gcs.kv_get)

        self.memory_store = MemoryStore()
        # Dependency-gated dispatch (reference: raylet task_dependency_
        # manager): a normal task whose OWNED arg refs are still pending
        # parks here instead of occupying a lease while blocked on its
        # upstream — without this, pipelines deeper than the CPU count can
        # deadlock (every lease held by a task waiting on a task that can't
        # get a lease). oid bytes -> [specs waiting on it].
        self._arg_waiting: Dict[bytes, List[dict]] = {}
        self.memory_store.on_ready = self._on_object_ready
        self.refs = ReferenceCounter(self._on_ref_zero)
        self.executor = Executor(self)
        self.task_events = TaskEventBuffer(self)

        self.node_id: Optional[NodeID] = None
        self.plasma: Optional[PlasmaClient] = None
        self.raylet: Optional[RpcClient] = None
        self._raylet_addr = raylet_addr
        self._startup_token = startup_token

        # plasma-backed submit ring (_private/submit_ring.py): eligible
        # tiny-task specs bypass the RPC submit path via shared memory.
        # All state IO-loop only; the ring is attached lazily on the first
        # eligible submit and every failure falls back to RPC.
        self._ring = None
        self._ring_oid: Optional[bytes] = None
        self._ring_dead = False
        self._ring_attach_state = 0  # 0 = never tried, 1 = tried/attaching
        self._ring_attach_t = 0.0
        self._ring_pending: Dict[bytes, dict] = {}  # task_id -> spec
        self._ring_submitted = 0  # counter for tests/introspection
        self._cfg_ring_slots = CONFIG.submit_ring_slots
        self._cfg_ring_dead_s = CONFIG.submit_ring_dead_s

        # ownership / submission state (IO-loop only)
        self._leases: Dict[tuple, _LeaseState] = {}
        self._pending_tasks: Dict[bytes, dict] = {}  # task_id -> record
        self._actor_submitters: Dict[bytes, _ActorSubmitter] = {}
        self._subscribed_channels: set = set()
        self._pubsub_task = None  # started lazily on first subscription
        self._working_dir_uris: Dict[tuple, str] = {}  # (path, signature) -> kv uri
        self._running_async: Dict[bytes, Any] = {}  # task_id -> cancellable future
        self._object_locations: Dict[bytes, set] = {}  # owned plasma obj -> node ids
        self._node_cache: Dict[bytes, dict] = {}
        self._node_cache_time = 0.0
        self._pg_node_cache: Dict[tuple, bytes] = {}  # (pg_id, idx) -> node_id
        self._lineage: Dict[bytes, dict] = {}  # task_id -> spec (for reconstruction)
        self._lineage_bytes = 0

        # Batched thread->loop handoff: submits/frees/notifies append here
        # and wake the io loop once per burst (a call_soon_threadsafe each
        # costs ~0.1 ms of self-pipe + GIL churn; per-task wakeups capped
        # submission at ~3k tasks/s — reference analogue: the Cython layer
        # posts into the asio io_service without a per-call thread switch).
        self._loop_work: deque = deque()
        # Re-entrant: a garbage collection inside either locked region can
        # run ObjectRef.__del__ -> remove_local_ref -> _on_ref_zero ->
        # _post_batched on the same thread; a plain Lock deadlocks the io
        # loop there (and every caller waiting on it).
        self._loop_work_lock = threading.RLock()
        self._loop_work_scheduled = False
        # executor-side reply streaming for batched actor-task pushes
        self._reply_bufs: Dict[tuple, list] = {}
        self._reply_flush_scheduled: set = set()

        # task context for the executing thread
        self._ctx = threading.local()
        self._put_index_lock = threading.Lock()
        self._put_index = 0
        self._driver_task_id = TaskID.for_task(job_id)

        self.actor_id: Optional[bytes] = None
        self._actor_spec: Optional[dict] = None
        self.is_shutdown = False
        # Monotonic completion counter for the stall watchdog: incremented
        # on every task reply; "work pending but this hasn't moved" is the
        # cheap no-progress signal (watchdog.py).
        self.tasks_completed = 0
        self._watchdog = None
        # task_id -> (name, start wall time) while executing here
        # (maintained by TaskEventBuffer.record on RUNNING/terminal)
        self.running_tasks: Dict[bytes, tuple] = {}
        # memory observability: periodic on-disk ledger snapshot throttle
        self._mem_snapshot_period = CONFIG.memory_snapshot_period_s
        self._last_mem_snapshot = 0.0

        # Direct call channels (direct_channel.py): caller-side manager +
        # the actor-worker-side server behind a connection upgrade.
        from ray_tpu_torch._private import direct_channel as _dc

        self._direct = _dc.DirectManager(self) if self._cfg_direct else None
        self._direct_server = _dc.WorkerDirectServer(self)
        self.server.set_upgrade_hook(
            _dc.HANDSHAKE_METHOD, self._direct_upgrade)

        set_worker_hooks(self)
        # Publish as the global worker BEFORE the RPC server can receive a
        # task: the raylet may lease this worker the instant registration
        # lands, and the pushed task's user code calls get_global_worker()
        # — assigning the global only after __init__ returned (as every
        # construction site does) was a startup race. Any post-connect
        # setup below widens that window, so close it here.
        set_global_worker(self)
        # Connect (blocking): start server, register with raylet, attach plasma.
        try:
            self._finish_init()
        except BaseException:
            set_global_worker(None)
            set_worker_hooks(None)
            raise

    def _finish_init(self):
        self.io.run(self._connect())
        # Chaos plane: drivers publish their env plan to GCS KV so the
        # whole cluster replays one schedule; workers arm from the env or
        # the published plan when they join.
        try:
            _chaos.sync_with_gcs(self.gcs, publish=(self.mode == MODE_DRIVER))
        except Exception:
            pass
        if self.session_dir:
            # Flight-recorder forensics file: incrementally appended by the
            # flush loop so the tail survives SIGKILL; the raylet attaches
            # it to this worker's death report (keyed by pid). Drivers get
            # the file + atexit flush but keep their SIGTERM disposition.
            try:
                path = os.path.join(
                    self.session_dir, "logs",
                    f"flight_{self.mode}-{os.getpid()}.jsonl")
                if self.mode == MODE_WORKER:
                    _fr.install_exit_dump(path)
                else:
                    import atexit

                    _fr.set_dump_path(path)
                    atexit.register(_fr.flush_now)
            except Exception:
                pass
        if CONFIG.watchdog_interval_s > 0:
            # Drivers watch their own submitted tasks; workers additionally
            # carry the train-step-stall check (the StepRecorder lives in
            # the train worker process, not the driver).
            from ray_tpu_torch._private.watchdog import StallWatchdog

            self._watchdog = StallWatchdog(self)
            self._watchdog.start()

    # ------------------------------------------------------------- connect

    async def _connect(self):
        self.server.register_all(self)
        self.port = await self.server.start(0)
        if self.mode == MODE_WORKER:
            # Adopt the driver's sys.path BEFORE the raylet can hand us a
            # task: by-reference-pickled functions live in modules the driver
            # can import, and fork-server children don't inherit the driver's
            # path (reference: job_config code-search-path propagation).
            # The raylet resolves it once per job and passes it through the
            # spawn message; only fall back to GetJob when it didn't.
            paths = self._driver_sys_path
            if paths is None:
                try:
                    reply = await self.gcs_aio.call(
                        "GetJob", {"job_id": self.job_id.binary()}
                    )
                    paths = reply.get("job", {}).get("driver_sys_path", [])
                except Exception:
                    paths = []
            import sys as _sys

            for p in paths:
                if p not in _sys.path:
                    _sys.path.append(p)
        self.raylet = RpcClient(*self._raylet_addr)
        await self.raylet.connect()
        self.address = (self.host, self.port)
        register_req = {
            "worker_id": self.worker_id.binary(),
            "port": self.port,
            "pid": os.getpid(),
            "startup_token": self._startup_token,
            "job_id": self.job_id.binary(),
        }
        if self._node_id_hint and self._plasma_name_hint:
            # Spawn message already identified the node: attach plasma now so
            # spawn-time actor creation can resolve plasma args, and fold the
            # creation result into the registration round-trip.
            self.node_id = NodeID.from_hex(self._node_id_hint)
            self.plasma = PlasmaClient(self._plasma_name_hint)
            if self._pre_register is not None:
                register_req["actor_result"] = await self._pre_register(self)
                # single-use: drop the closure (it pins the spec + b64 class
                # blob for the worker's whole lifetime otherwise)
                self._pre_register = None
            reply = await self.raylet.call("RegisterWorker", register_req)
        else:
            reply = await self.raylet.call("RegisterWorker", register_req)
            self.node_id = NodeID(reply["node_id"])
            self.plasma = PlasmaClient(reply["plasma_name"])
        self._flush_task = asyncio.ensure_future(self._task_event_flush_loop())
        if self.mode == MODE_WORKER:
            asyncio.ensure_future(self._watch_raylet())

    async def _watch_raylet(self):
        """Workers die with their raylet (reference: worker <-> raylet
        socket). 2s cadence: at 1000-worker scale every idle per-worker
        timer is a process wakeup stealing the core from real work."""
        while True:
            await asyncio.sleep(2.0)
            if not self.raylet.is_connected():
                _fr.record("worker.death", self.worker_id.binary(),
                           "raylet connection lost")
                _fr.flush_now()
                os._exit(1)
            if os.getppid() == 1:
                _fr.record("worker.death", self.worker_id.binary(),
                           "orphaned (parent died)")
                _fr.flush_now()
                os._exit(1)

    async def _task_event_flush_loop(self):
        period = CONFIG.task_events_flush_period_ms / 1000.0
        # Metrics ride this loop but on their own contract cadence
        # (RTPU_TORCH_metrics_report_period_ms): a busy worker flushing task
        # events every second must not also re-push every gauge that often.
        metrics_period = CONFIG.metrics_report_period_ms / 1000.0
        last_metrics_flush = 0.0
        idle_period = period
        while True:
            await asyncio.sleep(idle_period)
            if self.is_shutdown:
                # A worker outliving its cluster (init/shutdown cycles in
                # one process — the io loop is a process singleton) must
                # not keep draining the PROCESS-GLOBAL util.metrics
                # records: its push would fail against the dead GCS and
                # restore_records would re-merge, racing the live
                # worker's flush for the same deltas — metrics then only
                # export when the live worker happens to win the race.
                return
            events = self.task_events.drain()
            if events:
                idle_period = period
                try:
                    await self.gcs_aio.notify("AddTaskEvents", {"events": events})
                except Exception:
                    pass
            else:
                # Idle worker: back off (cap 8x) — a fleet of parked actors
                # shouldn't generate a constant wakeup storm.
                idle_period = min(idle_period * 2, period * 8)
            now = time.time()
            if now - last_metrics_flush >= metrics_period:
                last_metrics_flush = now
                self._flush_user_metrics()
            # Keep the on-disk flight tail current (incremental append):
            # this is what lets the raylet read a SIGKILLed worker's last
            # events — no exit handler ever runs for SIGKILL.
            _fr.flush_to_file()
            # Same SIGKILL-safety for memory state: a compact ledger
            # snapshot on disk is what OOM forensics attaches to this
            # worker's death report if it dies without warning.
            self._maybe_write_memory_snapshot()

    def _maybe_write_memory_snapshot(self):
        period = self._mem_snapshot_period
        if period <= 0 or self.mode != MODE_WORKER or not self.session_dir:
            return
        now = time.time()
        if now - self._last_mem_snapshot < period:
            return
        self._last_mem_snapshot = now
        try:
            from ray_tpu_torch._private import memory_report as _mr

            _mr.write_snapshot(self)
        except Exception:
            pass

    def _drain_stamped_user_metrics(self):
        """Drain ray_tpu_torch.util.metrics records (if that module is in use),
        stamped with worker/job labels so series from different workers
        never collide. Returns (module, records)."""
        import sys as _sys

        mod = _sys.modules.get("ray_tpu_torch.util.metrics")
        if mod is None:
            return None, []
        try:
            records = mod.drain_records()
        except Exception:
            return mod, []
        if not records:
            return mod, []
        wid = self.worker_id.hex()[:12]
        jid = self.job_id.hex()
        for rec in records:
            rec["labels"] = {**rec["labels"], "WorkerId": wid, "JobId": jid}
        return mod, records

    def flush_user_metrics_sync(self, timeout: float = 5.0):
        """Blocking metrics + task-event flush for end-of-workload barriers
        (a train worker's final step deltas and step SPAN events must not
        race the worker-group kill)."""
        try:
            events = self.task_events.drain()
            if events:
                self.gcs.call("AddTaskEvents", {"events": events},
                              timeout=timeout)
        except Exception:
            pass
        mod, records = self._drain_stamped_user_metrics()
        if not records:
            return
        try:
            self.gcs.call("ReportUserMetrics", {"records": records},
                          timeout=timeout)
        except Exception:
            try:
                mod.restore_records(records)
            except Exception:
                pass

    def _flush_user_metrics(self):
        """Push ray_tpu_torch.util.metrics records to the GCS aggregator (async,
        from the task-event flush loop)."""
        mod, records = self._drain_stamped_user_metrics()
        if not records:
            return

        async def _push():
            try:
                await self.gcs_aio.call(
                    "ReportUserMetrics", {"records": records}, timeout=10
                )
            except Exception:
                # Re-merge the drained deltas: a GCS blip must not lose
                # counter increments.
                try:
                    mod.restore_records(records)
                except Exception:
                    pass

        asyncio.ensure_future(_push())

    # ------------------------------------------------ ObjectRef hooks (sync)

    def add_local_ref(self, ref: ObjectRef):
        oid = ref.object_id()
        if self.refs.owns(oid):
            self.refs.add_local_ref(oid)
        else:
            first = self.refs.add_borrowed_ref(oid, ref.owner_address)
            if first and ref.owner_address and tuple(ref.owner_address) != self.address:
                self._post_owner_notify(
                    ref.owner_address,
                    "AddBorrowerRef",
                    {"object_id": oid.binary(), "borrower": list(self.address)},
                )

    def remove_local_ref(self, ref: ObjectRef):
        if self.is_shutdown:
            return
        oid = ref.object_id()
        if self.refs.owns(oid):
            self.refs.remove_local_ref(oid)
        else:
            owner = self.refs.remove_borrowed_ref(oid)
            if owner and tuple(owner) != self.address:
                self._post_owner_notify(
                    owner,
                    "RemoveBorrowerRef",
                    {"object_id": oid.binary(), "borrower": list(self.address)},
                )

    def _post_batched(self, kind: str, item):
        """Queue loop-side work from a foreign thread with one io-loop
        wakeup per burst instead of one run_coroutine_threadsafe per call."""
        with self._loop_work_lock:
            self._loop_work.append((kind, item))
            if self._loop_work_scheduled:
                return
            self._loop_work_scheduled = True
        try:
            self.io.loop.call_soon_threadsafe(self._drain_loop_work)
        except RuntimeError:
            pass  # loop closed (shutdown)

    def _drain_loop_work(self):
        """Runs on the io loop: route every queued item, then kick each
        touched pump exactly once."""
        with self._loop_work_lock:
            work = self._loop_work
            self._loop_work = deque()
            self._loop_work_scheduled = False
        normal_states: Dict[tuple, _LeaseState] = {}
        actor_subs: Dict[bytes, _ActorSubmitter] = {}
        frees: list = []
        actor_regs: list = []
        for kind, item in work:
            if kind == "normal":
                blocker = self._unready_owned_arg(item)
                if blocker is not None:
                    self._arg_waiting.setdefault(blocker, []).append(item)
                    continue
                if self._ring_submit(item):
                    continue  # rode the shared-memory submit ring
                key = ts.scheduling_key(item)
                state = self._leases.setdefault(key, _LeaseState())
                state.queue.append(item)
                normal_states[key] = state
            elif kind == "register_actor":
                actor_regs.append(item)
            elif kind == "actor":
                actor_id, spec = item
                sub = self._route_actor_spec(actor_id, spec)
                if sub is not None:
                    actor_subs[actor_id] = sub
            elif kind == "free":
                frees.append(item)
            elif kind == "direct_switch":
                if self._direct is not None:
                    self._direct.on_switch_request(item)
            elif kind == "direct_replies":
                if self._direct is not None:
                    self._direct.process_replies(item)
            elif kind == "direct_down":
                if self._direct is not None:
                    self._direct.on_channel_down(item[0], item[1])
            else:  # notify
                owner_addr, method, payload = item
                asyncio.ensure_future(
                    self._notify_owner(owner_addr, method, payload)
                )
        for key, state in normal_states.items():
            asyncio.ensure_future(self._pump_leases(key, state))
        for sub in actor_subs.values():
            self._pump_actor(sub)
        if frees:
            asyncio.ensure_future(self._free_refs_batch(frees))
        if actor_regs:
            asyncio.ensure_future(self._register_actors_batch(actor_regs))

    def _unready_owned_arg(self, spec: dict):
        """First arg ref owned by US that is still pending, else None.
        Borrowed refs (other owners) are not gated — the executing worker
        awaits them as before (the owner will have applied its own gating
        to the producing task)."""
        for _kind, _key, wire in spec["args"]:
            ref = wire.get("ref") if isinstance(wire, dict) else None
            if not ref:
                continue
            id_bytes, owner = ref
            if owner and tuple(owner) == self.address and \
                    self.memory_store.is_pending(ObjectID(id_bytes)):
                return id_bytes
        return None

    def _on_object_ready(self, oid: ObjectID):
        """io-loop: an owned object resolved — re-dispatch tasks parked on
        it (each re-checks its remaining args and may park again)."""
        waiters = self._arg_waiting.pop(oid.binary(), None)
        if not waiters:
            return
        states: Dict[tuple, _LeaseState] = {}
        for spec in waiters:
            blocker = self._unready_owned_arg(spec)
            if blocker is not None:
                self._arg_waiting.setdefault(blocker, []).append(spec)
                continue
            if self._ring_submit(spec):
                continue
            key = ts.scheduling_key(spec)
            state = self._leases.setdefault(key, _LeaseState())
            state.queue.append(spec)
            states[key] = state
        for key, state in states.items():
            asyncio.ensure_future(self._pump_leases(key, state))

    async def _register_actors_batch(self, items):
        """One SubscribeMany + one RegisterActors round-trip for a burst of
        anonymous actor creations. Subscribing first closes the
        missed-publish window without a per-actor state refresh."""
        channels = []
        for actor_id, _payload in items:
            ch = f"actor:{actor_id.hex()}"
            self._subscribed_channels.add(ch)
            channels.append(ch)
        self._ensure_pubsub()
        # Retry: registration is server-side idempotent, so a dropped reply
        # or GCS failover must not double-jeopardize actors the GCS already
        # registered (persisted + scheduled) by declaring them DEAD here.
        last_err = None
        for attempt in range(3):
            if attempt:
                await asyncio.sleep(1.0 * attempt)
            try:
                await self.gcs_aio.call(
                    "SubscribeMany",
                    {"sub_id": self.worker_id.binary(), "channels": channels},
                )
                await self.gcs_aio.call(
                    "RegisterActors", {"items": [p for _, p in items]}
                )
                return
            except Exception as e:
                last_err = e
        for actor_id, _payload in items:
            sub = self._actor_submitters.get(actor_id)
            if sub is not None:
                rec = {"state": "DEAD", "addr": None,
                       "death_cause": f"actor registration failed: {last_err}"}
                await self._apply_actor_state(sub, rec)

    async def _notify_owner(self, owner_addr, method, payload):
        try:
            client = await self.pool.get(owner_addr[0], owner_addr[1])
            await client.notify(method, payload)
        except Exception:
            pass

    def _post_owner_notify(self, owner_addr, method, payload):
        self._post_batched("notify", (owner_addr, method, payload))

    def as_future(self, ref: ObjectRef):
        import concurrent.futures

        out: concurrent.futures.Future = concurrent.futures.Future()

        def done(task):
            try:
                out.set_result(self.get([ref], timeout=None)[0])
            except Exception as e:
                out.set_exception(e)

        f = self.io.post(self._async_resolve(ref, None))
        f.add_done_callback(done)
        return out

    async def await_ref(self, ref: ObjectRef):
        res = await self._async_resolve(ref, None)
        value = self._materialize(ref.object_id(), res)
        if isinstance(value, Exception):
            raise value
        return value

    def _on_ref_zero(self, oid: ObjectID):
        """Owned object's refcount hit zero: free it everywhere."""
        if self._direct is not None:
            self._direct.discard_object(oid.binary())
        self._post_batched("free", oid)

    async def _free_refs_batch(self, oids):
        """Free a burst of dead objects: local stores synchronously, then
        one FreeObjects notify per holding node for the whole batch."""
        by_node: Dict[bytes, list] = {}
        for oid in oids:
            entry = self.memory_store.get_if_exists(oid)
            self.memory_store.free(oid)
            locations = self._object_locations.pop(oid.binary(), set())
            if isinstance(entry, InPlasma):
                locations |= entry.locations
            for node_id in locations:
                by_node.setdefault(node_id, []).append(oid.binary())
        for node_id, ids in by_node.items():
            info = await self._node_info(node_id)
            if info is None:
                continue
            try:
                client = await self.pool.get(info["ip"], info["raylet_port"])
                await client.notify("FreeObjects", {"ids": ids})
            except Exception:
                pass

    async def _node_info(self, node_id: bytes) -> Optional[dict]:
        now = time.time()
        if node_id not in self._node_cache or now - self._node_cache_time > 5.0:
            try:
                nodes = await self.gcs_aio.get_all_node_info()
                self._node_cache = {n["node_id"]: n for n in nodes}
                self._node_cache_time = now
            except Exception:
                pass
        return self._node_cache.get(node_id)

    # ------------------------------------------------------------ put / get

    def _next_put_id(self) -> ObjectID:
        with self._put_index_lock:
            self._put_index += 1
            idx = self._put_index
        return ObjectID.for_put(self.current_task_id(), idx)

    def current_task_id(self) -> TaskID:
        spec = getattr(self._ctx, "spec", None)
        if spec is not None:
            return TaskID(spec["task_id"])
        return self._driver_task_id

    def put(self, value: Any, _owner_hint=None) -> ObjectRef:
        """Store a value, return an owned ref (reference: worker.py:2691 ray.put).

        Plasma-bound values keep the RAW protocol-5 buffer views from
        serialize() all the way into write_blob, which streams them straight
        into the mapped shm destination — one copy total. Only the inline
        path (small values that ride msgpack frames) materializes bytes.
        """
        oid = self._next_put_id()
        p, bufs, _refs = serialization.serialize(value)
        size = len(p) + serialization.buffers_nbytes(bufs)
        self.refs.add_owned(
            oid, size=size, callsite=_mem_callsite(),
            task_id=self.current_task_id().binary())
        if size <= self.inline_threshold:
            payload = serialization.inline_payload(p, bufs)
            self.io.run(self._store_inline(oid, payload))
        else:
            nbytes = self._plasma_put_payload(oid, p, bufs)
            self.io.run(self._register_plasma_primary(oid, nbytes))
        _fr.record("obj.put", oid.binary(), size)
        return ObjectRef(oid, self.address)

    async def _store_inline(self, oid: ObjectID, payload):
        self.memory_store.put(oid, (_INLINE, payload, None))

    def _plasma_put_payload(self, oid: ObjectID, pickle_bytes: bytes,
                            buffers: list) -> int:
        """Serialize straight into the shared-memory buffer: one copy total
        (reference plasma clients do the same via Create+mutable buffer,
        plasma/client.cc). `buffers` are the raw out-of-band views from
        serialize() — never pre-materialized bytes. Returns the object's
        byte size."""
        if _chaos.ARMED:
            act = _chaos.hit("plasma.write")
            if act is not None:
                if act["action"] == "delay":
                    time.sleep(act["delay_s"])
                elif act["action"] in ("error", "fail"):
                    raise OSError("chaos: plasma write failed (injected)")
        size = serialization.blob_size(pickle_bytes, buffers)
        try:
            dest = self.plasma.create(oid, size)
        except FileExistsError:
            if self.plasma.contains(oid):
                return size  # already sealed by an earlier attempt
            # Unsealed leftover from a crashed/failed writer: readers would
            # block on it forever. Reclaim and rewrite.
            self.plasma.abort(oid)
            dest = self.plasma.create(oid, size)
        except PlasmaOOM:
            # Make room: evict unpinned secondaries, then ask the raylet to
            # spill pinned primaries to disk (reference: CreateRequestQueue
            # retries + LocalObjectManager spilling). Spilled memory may free
            # only after concurrent readers release their views, so retry
            # with backoff before giving up.
            dest = None
            for attempt in range(6):
                self.plasma.evict(size)
                try:
                    dest = self.plasma.create(oid, size)
                    break
                except PlasmaOOM:
                    try:
                        self.io.run(
                            self.raylet.call(
                                "SpillObjects", {"bytes": size}, timeout=60
                            )
                        )
                    except Exception:
                        pass
                    time.sleep(0.1 * (attempt + 1))
            if dest is None:
                dest = self.plasma.create(oid, size)  # raise the real OOM
        try:
            serialization.write_blob(dest, pickle_bytes, buffers)
            dest.release()
            self.plasma.seal(oid)
        except BaseException:
            # Never leave a created-but-unsealed object behind.
            try:
                dest.release()
            except Exception:
                pass
            self.plasma.abort(oid)
            raise
        return size

    async def _register_plasma_primary(self, oid: ObjectID, size: int):
        node = self.node_id.binary()
        self.memory_store.put(oid, InPlasma(size, {node}))
        self._object_locations.setdefault(oid.binary(), set()).add(node)
        self.refs.note_size(oid, size, plasma=True)
        try:
            # Synchronous: until the pin lands, a concurrent put's evict()
            # could reclaim this primary and lose the object.
            await self.raylet.call(
                "PinObject",
                {"object_id": oid.binary(), "owner_addr": list(self.address),
                 "meta": self._pin_meta(oid, size)},
                timeout=30,
            )
        except Exception:
            pass

    def _pin_meta(self, oid: ObjectID, size: int, spec: Optional[dict] = None) -> dict:
        """Ownership attribution shipped with a PinObject so the raylet's
        leak detector and OOM forensics can name the holder even after the
        owner's ledger entry (or the owner itself) is gone."""
        if spec is not None:
            return {
                "job_id": spec.get("job_id", b"") or b"",
                "actor_id": spec.get("actor_id") or b"",
                "task_id": spec.get("task_id", b"") or b"",
                "callsite": "task:" + spec.get("name", ""),
                "size": size,
            }
        with self.refs._lock:
            ref = self.refs._owned.get(oid)
            callsite = ref.callsite if ref else ""
            task_id = (ref.task_id if ref else None) or b""
        return {
            "job_id": self.job_id.binary(),
            "actor_id": self.actor_id or b"",
            "task_id": task_id,
            "callsite": callsite,
            "size": size,
        }

    # -- get ---------------------------------------------------------------

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        if self._direct is not None and self._direct.can_serve(refs):
            # Blocking resolve in THIS thread against the direct-channel
            # staging store — zero io-loop round trips (direct_channel.py).
            # The slow-get hint is post-hoc here (no timer on the fast
            # path; two clock reads are noise next to the socket wait).
            t0 = time.time()
            out = self._direct.fast_get(refs, timeout)
            if out is not self._direct._FALLBACK:
                self._warn_slow_get(len(refs), time.time() - t0)
                return out
        deadline = None if timeout is None else time.time() + timeout
        resolutions = self._run_get_with_warning(
            self._async_resolve_many(refs, deadline), len(refs), timeout)
        out = []
        for ref, res in zip(refs, resolutions):
            value = self._materialize(ref.object_id(), res)
            if isinstance(value, ObjectLostError) and res[0] == "plasma_local":
                # Spilled between resolution and read: resolve again (the
                # raylet restores it from disk).
                res = self.io.run(self._async_resolve(ref, deadline))
                value = self._materialize(ref.object_id(), res)
            if isinstance(value, Exception):
                raise value
            out.append(value)
        return out

    @staticmethod
    def _warn_slow_get(n_refs: int, elapsed_s: float):
        """Post-hoc arm of the slow-get hint (direct-channel fast path)."""
        import sys as _sys

        warn_s = CONFIG.get_timeout_warning_s
        if warn_s > 0 and elapsed_s >= warn_s:
            print(
                f"[ray_tpu_torch] ray_tpu_torch.get of {n_refs} ref(s) was blocked "
                f"for {elapsed_s:.0f}s — the producing actor call may be "
                "queued behind earlier calls or stalled (see "
                "`ray-tpu-torch debug incidents` / `ray-tpu-torch timeline`)",
                file=_sys.stderr, flush=True,
            )

    def _run_get_with_warning(self, coro, n_refs: int, timeout):
        """Blocking wait on the io loop with the reference's slow-get
        warning (RTPU_TORCH_get_timeout_warning_s): a get blocked past the
        threshold prints ONE hint naming the count so a driver stuck on a
        never-produced ref is diagnosable before the stall watchdog fires.
        0 disables; a caller timeout shorter than the threshold wins."""
        import concurrent.futures as _cf
        import sys as _sys

        fut = self.io.post(coro)
        warn_s = CONFIG.get_timeout_warning_s
        if warn_s <= 0 or (timeout is not None and timeout <= warn_s):
            return fut.result()
        try:
            return fut.result(warn_s)
        except _cf.TimeoutError:
            print(
                f"[ray_tpu_torch] ray_tpu_torch.get of {n_refs} ref(s) has been "
                f"blocked for {warn_s:.0f}s — the producing task may be "
                "queued, failed without a reply, or stalled (see "
                "`ray-tpu-torch debug incidents` / `ray-tpu-torch timeline`)",
                file=_sys.stderr, flush=True,
            )
            return fut.result()

    async def async_get_one(self, ref: ObjectRef):
        """IO-loop get used by the executor for dependency resolution."""
        res = await self._async_resolve(ref, None)
        loop = asyncio.get_running_loop()
        value = await loop.run_in_executor(None, self._materialize, ref.object_id(), res)
        if isinstance(value, ObjectLostError) and res[0] == "plasma_local":
            res = await self._async_resolve(ref, None)
            value = await loop.run_in_executor(
                None, self._materialize, ref.object_id(), res
            )
        if isinstance(value, Exception):
            raise value
        return value

    async def _async_resolve_many(self, refs, deadline):
        # One batch event covers every owned-pending ref (per-ref
        # gather+wait_for costs a Task + timer + Event each, ~150 µs/ref on
        # a 1000-ref get); only stragglers (borrowed, plasma, errors) take
        # the per-ref coroutine path.
        if len(refs) > 1:
            pending = [
                r.object_id() for r in refs
                if self.memory_store.is_pending(r.object_id())
            ]
            if pending:
                timeout = None if deadline is None else max(0.0, deadline - time.time())
                await self.memory_store.wait_ready_many(pending, timeout)
        results = [None] * len(refs)
        slow = []
        for i, r in enumerate(refs):
            oid = r.object_id()
            entry = self.memory_store.get_if_exists(oid)
            if entry is not None and not isinstance(entry, InPlasma):
                results[i] = (
                    entry[:2] if entry[0] in (_INLINE, _ERR) else ("value", entry)
                )
            else:
                slow.append(i)
        if slow:
            resolved = await asyncio.gather(
                *(self._async_resolve(refs[i], deadline) for i in slow)
            )
            for i, res in zip(slow, resolved):
                results[i] = res
        return results

    async def _async_resolve(self, ref: ObjectRef, deadline) -> tuple:
        """Resolve a ref to ('inline'|'err', payload) | ('plasma_local', oid) on IO loop."""
        oid = ref.object_id()
        attempt = 0
        while True:
            attempt += 1
            if self.refs.owns(oid) or self.memory_store.contains(oid) or self.memory_store.is_pending(oid):
                res = await self._resolve_owned(oid, deadline)
            else:
                res = await self._resolve_borrowed(ref, deadline)
            if res[0] != "plasma_remote_lost":
                return res
            # All copies lost: try lineage reconstruction
            # (reference: object_recovery_manager.h:41).
            if attempt > 2 or not await self._try_reconstruct(oid):
                return ("err_obj", ObjectLostError(f"object {oid.hex()} lost (all copies gone)"))

    async def _resolve_owned(self, oid: ObjectID, deadline) -> tuple:
        timeout = None if deadline is None else max(0.0, deadline - time.time())
        ready = await self.memory_store.wait_ready(oid, timeout)
        if not ready:
            return ("err_obj", GetTimeoutError(f"get() timed out on {oid.hex()}"))
        entry = self.memory_store.get_if_exists(oid)
        if entry is None:
            return ("err_obj", ObjectLostError(f"object {oid.hex()} was freed"))
        if isinstance(entry, InPlasma):
            return await self._resolve_plasma(oid, entry.locations, None, deadline)
        return entry[:2] if entry[0] in (_INLINE, _ERR) else ("value", entry)

    async def _resolve_borrowed(self, ref: ObjectRef, deadline) -> tuple:
        oid = ref.object_id()
        owner = ref.owner_address
        if owner is None:
            return ("err_obj", OwnerDiedError(f"no owner known for {oid.hex()}"))
        while True:
            timeout = 25.0
            if deadline is not None:
                timeout = min(timeout, deadline - time.time())
                if timeout <= 0:
                    return ("err_obj", GetTimeoutError(f"get() timed out on {oid.hex()}"))
            try:
                client = await self.pool.get(owner[0], owner[1])
                status = await client.call(
                    "GetObjectStatus",
                    {"object_id": oid.binary(), "wait": True, "timeout": timeout},
                    timeout=timeout + 5,
                )
            except (ConnectionLost, OSError, asyncio.TimeoutError):
                return ("err_obj", OwnerDiedError(f"owner of {oid.hex()} is unreachable"))
            st = status.get("status")
            if st == "pending":
                continue
            if st == "freed":
                return ("err_obj", ObjectLostError(f"object {oid.hex()} was freed by owner"))
            if "inline" in status:
                return (_INLINE, status["inline"])
            if "err" in status:
                return (_ERR, status["err"])
            if "plasma" in status:
                return await self._resolve_plasma(
                    oid, set(status["plasma"]["locations"]), owner, deadline
                )

    async def _resolve_plasma(self, oid: ObjectID, locations, owner, deadline) -> tuple:
        if self.plasma.contains(oid):
            return ("plasma_local", oid)
        owner_addr = list(owner) if owner else list(self.address)
        # A pull can fail transiently (restore-from-spill racing store
        # pressure, holder mid-eviction): retry before declaring the copy
        # lost — put objects have no lineage to fall back on.
        for attempt in range(3):
            try:
                timeout = None if deadline is None else max(0.1, deadline - time.time())
                reply = await self.raylet.call(
                    "PullObject",
                    {"object_id": oid.binary(), "owner_addr": owner_addr},
                    timeout=timeout,
                )
            except asyncio.TimeoutError:
                return ("err_obj", GetTimeoutError(f"get() timed out pulling {oid.hex()}"))
            if reply.get("ok") and self.plasma.contains(oid):
                return ("plasma_local", oid)
            if deadline is not None and time.time() >= deadline:
                break
            await asyncio.sleep(0.2 * (attempt + 1))
        return ("plasma_remote_lost", oid)

    def _materialize(self, oid: ObjectID, res: tuple):
        """User-thread side: turn a resolution into a Python value (may raise)."""
        kind = res[0]
        if kind == "value":
            return res[1]
        if kind == "err_obj":
            return res[1]
        if kind == _INLINE:
            value, _refs = serialization.deserialize_inline(res[1])
            return value
        if kind == _ERR:
            exc, _refs = serialization.deserialize_inline(res[1])
            if isinstance(exc, RayTpuError) and not isinstance(exc, TaskError):
                # System failures (worker crash, OOM kill, actor death...)
                # surface as their own type; only user exceptions wrap in
                # TaskError (reference: RayTaskError vs RaySystemError).
                return exc
            if isinstance(exc, Exception):
                return TaskError(exc, getattr(exc, "_rtpu_tb", str(exc)))
            return TaskError(Exception(str(exc)), str(exc))
        if kind == "plasma_local":
            return self._read_plasma_value(oid)
        raise RuntimeError(f"bad resolution {res}")

    def _read_plasma_value(self, oid: ObjectID):
        """Deserialize a sealed plasma object zero-copy. Parsing is
        serialization.read_blob — one parser, one place that knows the store
        format; the buffer_wrapper ties the plasma pin to buffer lifetime."""
        view = self.plasma.get(oid)
        if view is None:
            return ObjectLostError(f"object {oid.hex()} evicted before read")

        def release():
            try:
                view.release()
            except Exception:
                pass
            self.plasma.release(oid)

        handle = _PinHandle(release)
        try:
            value, _refs = serialization.read_blob(
                view, buffer_wrapper=lambda mv: _pinned_buffer(mv, handle)
            )
        except BaseException:
            if handle.count == 0:
                release()
            raise
        if handle.count == 0:
            # no out-of-band buffers alias the store — drop the pin now
            release()
        return value

    # ------------------------------------------------------------ wait

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        deadline = None if timeout is None else time.time() + timeout
        return self.io.run(self._async_wait(refs, num_returns, deadline, fetch_local))

    async def _async_wait(self, refs, num_returns, deadline, fetch_local):
        """Event-driven wait: one waiter per pending ref. Owned refs ride the
        memory-store per-object event; borrowed refs long-poll their owner
        with wait=True (the owner's GetObjectStatus blocks server-side until
        the object resolves) — no fixed-interval polling in either path
        (reference: core_worker Wait is a callback on object availability,
        src/ray/core_worker/core_worker.cc Wait)."""
        ready: List[ObjectRef] = []
        pending: List[ObjectRef] = []
        for ref in refs:
            if await self._is_ready(ref):
                ready.append(ref)
            else:
                pending.append(ref)
        if len(ready) >= num_returns or not pending:
            # cap at num_returns (reference semantics); surplus ready refs
            # stay in pending, still in input order
            surplus = ready[num_returns:]
            ready = ready[:num_returns]
            if surplus:
                keep = set(surplus) | set(pending)
                pending = [r for r in refs if r in keep]
            return ready, pending
        waiters = {
            asyncio.ensure_future(self._wait_one(ref)): ref
            for ref in pending
        }
        try:
            while len(ready) < num_returns and waiters:
                timeout = (
                    None if deadline is None
                    else max(0.0, deadline - time.time())
                )
                done, _ = await asyncio.wait(
                    waiters.keys(), timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done:
                    break  # deadline
                for t in done:
                    ready.append(waiters.pop(t))
        finally:
            for t in waiters:
                t.cancel()
        # Never return MORE than num_returns ready refs (reference
        # semantics: len(ready) <= num_returns) — several waiters can
        # complete in one asyncio.wait round; the surplus goes back to
        # pending so callers looping wait(num_returns=1) see every ref.
        ready_set = set(ready)
        ordered_ready = [r for r in refs if r in ready_set]
        ready = ordered_ready[:num_returns]
        ready_set = set(ready)
        pending = [r for r in refs if r not in ready_set]
        return ready, pending

    async def _wait_one(self, ref: ObjectRef) -> None:
        """Resolves when the ref is ready (value, plasma copy, or error)."""
        oid = ref.object_id()
        while True:
            if await self._is_ready(ref):
                return
            if self.memory_store.is_pending(oid):
                await self.memory_store.wait_ready(oid, None)
                continue
            if self.refs.owns(oid):
                # owned but not yet registered as pending (submit in flight)
                await asyncio.sleep(0.01)
                continue
            owner = ref.owner_address
            if owner is None:
                await asyncio.sleep(0.01)
                continue
            try:
                client = await self.pool.get(owner[0], owner[1])
                status = await client.call(
                    "GetObjectStatus",
                    {"object_id": oid.binary(), "wait": True, "timeout": 30},
                    timeout=35,
                )
                if status.get("status") != "pending":
                    return  # ready / freed / error — all count as resolved
            except Exception:
                await asyncio.sleep(0.1)

    async def _is_ready(self, ref: ObjectRef) -> bool:
        oid = ref.object_id()
        if self.memory_store.contains(oid):
            return True
        if self.memory_store.is_pending(oid):
            return False
        if self.plasma.contains(oid):
            return True
        if self.refs.owns(oid):
            return False
        owner = ref.owner_address
        if owner is None:
            return False
        try:
            client = await self.pool.get(owner[0], owner[1])
            status = await client.call(
                "GetObjectStatus", {"object_id": oid.binary(), "wait": False}, timeout=10
            )
            return status.get("status") == "ready" or "inline" in status or "plasma" in status or "err" in status
        except Exception:
            return False

    # ----------------------------------------------------- normal task submit

    def submit_task(
        self,
        fn,
        args,
        kwargs,
        *,
        name: str,
        num_returns: int = 1,
        resources: Dict[str, float],
        max_retries: int = 0,
        retry_exceptions: bool = False,
        scheduling_strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
    ) -> List[ObjectRef]:
        fn_key = self.functions.export(fn)
        runtime_env = self.prepare_runtime_env(runtime_env)
        wire, refs, large = ts.serialize_args(args, kwargs, self.inline_threshold)
        big_refs = self._replace_large_args(wire, large)
        refs.extend(big_refs)
        task_id = TaskID.for_task(self.job_id)
        from ray_tpu_torch.util import tracing as _tracing

        trace_ctx = _tracing.context_for_spec()
        spec = ts.build_task_spec(
            task_id=task_id,
            job_id=self.job_id,
            name=name,
            fn_key=fn_key,
            wire_args=wire,
            num_returns=num_returns,
            resources=resources,
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            scheduling_strategy=scheduling_strategy,
            caller_id=self.worker_id.binary(),
            runtime_env=runtime_env,
        )
        if trace_ctx is not None:
            spec["trace_ctx"] = trace_ctx
        return_refs = self._register_pending(spec, refs)
        self._post_batched("normal", spec)
        return return_refs

    def prepare_runtime_env(self, runtime_env: Optional[dict]) -> Optional[dict]:
        """Validate and materialize a runtime_env for shipping in a spec.

        A local working_dir path is zipped and uploaded to the GCS KV once
        per content hash (reference: runtime_env/packaging.py); the spec
        carries the kv:<hash> URI so any node can extract it.
        """
        runtime_env = ts.validate_runtime_env(runtime_env)
        if not runtime_env:
            return runtime_env

        def upload_dir(path: str, arc_prefix: str = "") -> str:
            # Cache by content signature, not path: edits to the directory
            # between submits must produce a fresh upload.
            cache_key = (
                os.path.abspath(path), renv.dir_signature(path), arc_prefix
            )
            uri = self._working_dir_uris.get(cache_key)
            if uri is None:
                uri = renv.upload_working_dir(self.gcs, path, arc_prefix)
                self._working_dir_uris[cache_key] = uri
            return uri

        wd = runtime_env.get("working_dir")
        if wd and not renv.is_uploaded(wd):
            runtime_env = {**runtime_env, "working_dir": upload_dir(wd)}
        pm = runtime_env.get("py_modules")
        if pm:
            # py_modules ride the working_dir packaging machinery, nested
            # under the module dir's basename so `import <basename>` works
            # from the extracted root (reference: py_modules contract,
            # runtime_env packaging.py)
            runtime_env = {**runtime_env, "py_modules": [
                p if renv.is_uploaded(p)
                else upload_dir(p, os.path.basename(os.path.abspath(p)))
                for p in pm
            ]}
        return runtime_env

    def put_serialized(self, pickle_bytes: bytes, buffers: list) -> ObjectRef:
        """put() for an already-serialized value: the raw buffer views go
        straight into plasma with no re-pickle and no bytes() copy."""
        oid = self._next_put_id()
        self.refs.add_owned(
            oid, callsite=_mem_callsite(),
            task_id=self.current_task_id().binary())
        nbytes = self._plasma_put_payload(oid, pickle_bytes, buffers)
        self.io.run(self._register_plasma_primary(oid, nbytes))
        return ObjectRef(oid, self.address)

    def _replace_large_args(self, wire, large) -> List[ObjectRef]:
        """Oversized inline args are stored first and passed by ref
        (reference: dependency_resolver.h inlining threshold). serialize_args
        already serialized them — reuse its raw (pickle, buffers) pair."""
        big_refs = []
        if not large:
            return big_refs
        by_key = {}
        for pos_key, (p, bufs) in large:
            ref = self.put_serialized(p, bufs)
            big_refs.append(ref)
            by_key[pos_key] = ref
        for entry in wire:
            w = entry[2]
            if "big" in w:
                key = tuple(w["big"])
                ref = by_key[(key[0], key[1] if key[0] == "k" else int(key[1]))]
                entry[2] = {"ref": [ref.object_id().binary(), list(ref.owner_address)]}
        return big_refs

    def _register_pending(self, spec: dict, arg_refs: List[ObjectRef]) -> List[ObjectRef]:
        return_ids = ts.return_object_ids(spec)
        out = []
        # ledger attribution for task returns: the submitting task owns
        # them; the "callsite" is the task name (cheap — no frame walk on
        # the submit hot path).
        ret_callsite = "task:" + spec.get("name", "")
        for oid in return_ids:
            self.refs.add_owned(oid, lineage_task_id=spec["task_id"],
                                callsite=ret_callsite,
                                task_id=spec["task_id"])
        # Direct call, not io.run: a cross-thread round-trip here costs ~1 ms
        # per .remote() and caps submission at <1k tasks/s. put_pending only
        # creates dict entries + an (unbound) asyncio.Event — safe under the
        # GIL; the result cannot arrive before the spec is posted below.
        for oid in return_ids:
            self.memory_store.put_pending(oid)
        for oid in return_ids:
            out.append(ObjectRef(oid, self.address))
        for ref in arg_refs:
            if self.refs.owns(ref.object_id()):
                self.refs.add_submitted_task_ref(ref.object_id())
        self._pending_tasks[spec["task_id"]] = {
            "spec": spec,
            "retries": spec.get("max_retries", 0),
            "arg_refs": list(arg_refs),
            "return_ids": return_ids,
            # submit wall time: the watchdog's stuck-task age source
            "t_submit": time.time(),
        }
        self.task_events.record(spec, "PENDING")
        return out

    async def _submit_normal(self, spec: dict):
        if self._ring_submit(spec):
            return
        await self._submit_via_rpc(spec)

    async def _submit_via_rpc(self, spec: dict):
        """The classic lease-and-push submit path (also the explicit
        fallback for specs the submit ring bounced back)."""
        key = ts.scheduling_key(spec)
        state = self._leases.setdefault(key, _LeaseState())
        state.queue.append(spec)
        await self._pump_leases(key, state)

    # ------------------------------------------- plasma-backed submit ring

    _RING_RESOURCES = {"CPU": 1.0}

    def _ring_eligible(self, spec: dict) -> bool:
        """The ring is a fast path for the overwhelmingly common tiny-task
        shape only: default strategy, no runtime_env, exactly the default
        {CPU: 1} demand (ring leases are reused across specs, so demands
        must be homogeneous). Everything else rides the RPC path."""
        return (not spec.get("strategy")
                and not spec.get("runtime_env")
                and spec.get("resources") == self._RING_RESOURCES)

    def _ring_submit(self, spec: dict) -> bool:
        """Try the shared-memory submit path; False means the caller must
        use the RPC path (ring disabled, full, dead, or spec ineligible)."""
        if self._ring_dead or self._cfg_ring_slots <= 0 \
                or not self._ring_eligible(spec):
            return False
        if self._ring is None:
            if self._ring_attach_state == 0 and self.plasma is not None:
                self._ring_attach_state = 1
                asyncio.ensure_future(self._attach_submit_ring())
            return False
        try:
            payload = msgpack.packb(spec, use_bin_type=True)
        except Exception:
            return False  # unpackable spec (shouldn't happen): RPC path
        pushed = self._ring.try_push(payload)
        if pushed is None:
            return False  # ring full: clean fallback to RPC
        self._ring_pending[spec["task_id"]] = spec
        self._ring_submitted += 1
        self.task_events.record(spec, "SUBMITTED")
        if pushed:
            # empty→non-empty transition: the raylet's drain loop is (or is
            # about to go) asleep — the one RPC left on this path
            asyncio.ensure_future(self._ring_doorbell())
        return True

    async def _attach_submit_ring(self):
        from ray_tpu_torch._private import submit_ring as _sr

        try:
            # exactly _OBJECT_ID_SIZE (20) bytes: the store reads a fixed
            # 20-byte key, so a short id would carry undefined tail bytes
            oid = (b"\xf1RNG" + self.worker_id.binary()).ljust(20, b"\0")[:20]
            size = _sr.ring_bytes(self._cfg_ring_slots)
            try:
                view = self.plasma.create(oid, size)
            except FileExistsError:
                self.plasma.delete(oid)
                view = self.plasma.create(oid, size)
            try:
                _sr.RingProducer(view, init=True)
            finally:
                view.release()
            # seal publishes the region (and drops the creator pin);
            # re-pin with get() for the producer's lifetime — the mapping
            # is read-write, the ring is a shared mailbox, not a value
            self.plasma.seal(oid)
            pinned = self.plasma.get(oid)
            if pinned is None:
                raise RuntimeError("ring object evicted before pin")
            producer = _sr.RingProducer(pinned)
            r = await self.raylet.call("AttachSubmitRing", {
                "object_id": oid,
                "reply_addr": list(self.address),
                "job_id": self.job_id.binary(),
            }, timeout=10)
            if not r.get("ok"):
                raise RuntimeError(r.get("error", "attach refused"))
            self._ring = producer
            self._ring_oid = oid
            self._ring_attach_t = time.time()
            asyncio.ensure_future(self._ring_liveness_loop())
        except Exception as e:
            _fr.record("rpc.error", b"", f"submit ring attach failed: {e}")
            # stay unattached; _ring_attach_state == 1 prevents retries

    async def _ring_doorbell(self):
        try:
            await self.raylet.notify(
                "SubmitRingDoorbell", {"object_id": self._ring_oid})
        except Exception:
            self._ring_mark_dead("doorbell failed (raylet connection lost)")

    async def _ring_liveness_loop(self):
        """Dead-consumer detection: the raylet heartbeats the ring header
        every drain tick; a stale beat (raylet restarted/wedged) or a lost
        raylet connection fails pending ring specs over to the RPC path."""
        while not self._ring_dead and not self.is_shutdown:
            await asyncio.sleep(1.0)
            if not self._ring_pending:
                continue
            if not self.raylet.is_connected():
                self._ring_mark_dead("raylet connection lost")
                return
            beat = self._ring.consumer_beat()
            ref = beat if beat else self._ring_attach_t
            if time.time() - ref > self._cfg_ring_dead_s:
                self._ring_mark_dead(
                    f"consumer heartbeat stale (> {self._cfg_ring_dead_s}s)")
                return

    def _ring_mark_dead(self, reason: str):
        """The drain side is gone: every not-yet-replied ring spec is
        resubmitted via RPC. The dead raylet took its undispatched backlog
        (and the local workers) with it, so this cannot double-execute an
        undispatched task; a dispatched-but-unreplied one retries under
        the same at-least-once contract as any worker crash."""
        if self._ring_dead:
            return
        self._ring_dead = True
        _fr.record("rpc.error", b"", f"submit ring dead: {reason}")
        pending, self._ring_pending = list(self._ring_pending.values()), {}
        for spec in pending:
            asyncio.ensure_future(self._submit_normal(spec))

    def _ring_close(self):
        """Clean detach at shutdown: flag the header (the raylet reclaims
        the ring object at its next tick) and drop our pin."""
        ring, self._ring = self._ring, None
        if ring is None:
            return
        try:
            ring.close()
        except Exception:
            pass
        try:
            self.plasma.release(self._ring_oid)
        except Exception:
            pass

    async def handle_SubmitRingReplies(self, req):
        """Batched task replies for ring-submitted specs, forwarded by the
        raylet (one notify per dispatched push batch)."""
        for task_id, reply in req["replies"]:
            spec = self._ring_pending.pop(task_id, None)
            if spec is None:
                record = self._pending_tasks.get(task_id)
                spec = record["spec"] if record else None
                if spec is None:
                    continue
            if reply.get("ring_bounce"):
                # local node saturated while a peer had room: re-route via
                # the RPC lease path, which knows how to spill
                await self._submit_via_rpc(spec)
            elif reply.get("worker_crashed"):
                await self._handle_worker_crash(
                    spec, RuntimeError(reply.get("error",
                                                 "ring worker died")))
            else:
                await self._process_task_reply(spec, reply)

    async def _pump_leases(self, key, state: _LeaseState):
        while state.queue and state.idle:
            lease = state.idle.popleft()
            spec = state.queue.popleft()
            asyncio.ensure_future(self._push_on_lease(key, state, lease, spec))
        # Bound in-flight lease requests: beyond a handful they only pile up
        # in the raylet's waiter queue while costing an RPC each.
        need = min(
            len(state.queue) - state.requests_in_flight,
            self._cfg_lease_inflight - state.requests_in_flight,
        )
        for _ in range(need):
            state.requests_in_flight += 1
            asyncio.ensure_future(self._request_lease(key, state))

    async def _request_lease(self, key, state: _LeaseState, raylet_client=None, hops=0):
        try:
            if not state.queue:
                return
            sample = state.queue[0]
            client = raylet_client
            if client is None and sample["strategy"].get("type") == "placement_group":
                # PG tasks lease directly from the raylet holding the bundle
                # (the local raylet has no view of remote bundle placement).
                client = await self._pg_raylet(sample["strategy"])
                if client is None:
                    err = RuntimeError(
                        "placement group not found or never became ready"
                    )
                    while state.queue:
                        self._fail_task(state.queue.popleft(), err)
                    return
            if client is None:
                client = self.raylet
            try:
                reply = await client.call(
                    "RequestWorkerLease",
                    {
                        "resources": sample["resources"],
                        "strategy": sample["strategy"],
                        "job_id": sample["job_id"],
                        "runtime_env": sample.get("runtime_env") or {},
                    },
                    timeout=CONFIG.worker_lease_timeout_ms / 1000.0 + 10,
                )
            except (ConnectionLost, OSError, asyncio.TimeoutError):
                if raylet_client is not None:
                    # spill target died; go back to local raylet
                    state.requests_in_flight += 1
                    asyncio.ensure_future(self._request_lease(key, state))
                return
            if reply.get("granted"):
                lease = {
                    "worker_addr": tuple(reply["worker_addr"]),
                    "worker_id": reply["worker_id"],
                    "lease_id": reply["lease_id"],
                    "raylet": client,
                }
                state.all_leases.add(reply["lease_id"])
                if state.queue:
                    spec = state.queue.popleft()
                    asyncio.ensure_future(self._push_on_lease(key, state, lease, spec))
                else:
                    await self._return_lease(state, lease)
            elif reply.get("spill"):
                target = reply["spill"]
                peer = await self.pool.get(target["ip"], target["port"])
                state.requests_in_flight += 1
                if hops < 4:
                    asyncio.ensure_future(self._request_lease(key, state, peer, hops + 1))
                else:
                    asyncio.ensure_future(self._request_lease(key, state))
            elif reply.get("retry"):
                state.requests_in_flight += 1
                asyncio.ensure_future(self._request_lease(key, state))
            elif reply.get("retry_pg"):
                # Bundle not (yet) committed on the raylet we picked: drop the
                # cached placement and re-resolve from GCS — bounded, so a
                # commit that never lands fails the task instead of spinning.
                deadline = sample.setdefault(
                    "_pg_retry_deadline",
                    time.time() + CONFIG.placement_group_ready_timeout_s,
                )
                if time.time() > deadline:
                    err = RuntimeError(
                        "placement group bundle never became available"
                    )
                    while state.queue:
                        self._fail_task(state.queue.popleft(), err)
                    return
                pg_key = (sample["strategy"]["pg_id"],
                          sample["strategy"].get("bundle_index") or 0)
                self._pg_node_cache.pop(pg_key, None)
                await asyncio.sleep(0.2)
                state.requests_in_flight += 1
                asyncio.ensure_future(self._request_lease(key, state))
            elif reply.get("error"):
                err = RuntimeError(reply["error"])
                while state.queue:
                    spec = state.queue.popleft()
                    self._fail_task(spec, err)
        finally:
            state.requests_in_flight -= 1

    async def _pg_raylet(self, strategy: dict):
        """Resolve the raylet hosting this task's PG bundle, waiting for the
        group to finish its 2PC if needed. Returns None if the PG is gone."""
        pg_key = (strategy["pg_id"], strategy.get("bundle_index") or 0)
        node_id = self._pg_node_cache.get(pg_key)
        if node_id is None:
            # Event-driven: the GCS blocks this call until the 2PC finishes
            # (WaitPlacementGroupReady arms a server-side event) — no
            # client-side polling interval. Transient RPC failures (GCS
            # restart) retry until the ready deadline; only an authoritative
            # "removed"/timeout answer fails the tasks.
            deadline = time.time() + CONFIG.placement_group_ready_timeout_s
            while True:
                left = deadline - time.time()
                if left <= 0:
                    return None
                try:
                    reply = await self.gcs_aio.call(
                        "WaitPlacementGroupReady",
                        {"pg_id": pg_key[0], "timeout": left},
                        timeout=left + 10,
                    )
                except RemoteError:
                    return None  # GCS answered: the PG is removed
                except Exception:
                    await asyncio.sleep(0.5)  # transient; GCS may be restarting
                    continue
                if not reply.get("ready"):
                    return None
                break
            info = await self.gcs_aio.call(
                "GetPlacementGroup", {"pg_id": pg_key[0]}
            )
            if not info.get("found") or info["pg"]["state"] != "CREATED":
                return None
            node_id = info["pg"]["bundles"][pg_key[1]]["node_id"]
            self._pg_node_cache[pg_key] = node_id
        info = await self._node_info(node_id)
        if info is None:
            self._pg_node_cache.pop(pg_key, None)
            return None
        return await self.pool.get(info["ip"], info["raylet_port"])

    async def _push_on_lease(self, key, state: _LeaseState, lease, spec: dict):
        # Adaptive batching: when the queue is deep relative to the number of
        # leased workers, ship several tasks per RPC — the Python control
        # plane is message-count-bound (~0.25 ms/message), so tiny-task
        # throughput scales with batch size. A shallow queue keeps batch=1 so
        # sparse/long tasks keep per-task latency and full parallelism.
        batch = [spec]
        # Divide the queue by workers we have OR expect (outstanding lease
        # requests), so early grants don't hoard the queue and starve the
        # leases that are about to arrive.
        expected_workers = max(
            1, len(state.all_leases) + state.requests_in_flight
        )
        extra = min(
            len(state.queue) // expected_workers,
            self._cfg_push_batch - 1,
        )
        for _ in range(extra):
            if not state.queue:
                break
            batch.append(state.queue.popleft())
        try:
            client = await self.pool.get(*lease["worker_addr"])
            for s in batch:
                self._pending_tasks.get(s["task_id"], {})["lease"] = lease
                self.task_events.record(s, "SUBMITTED")
            if len(batch) == 1:
                replies = [await client.call(
                    "PushTask", {"spec": spec}, timeout=None
                )]
            else:
                r = await client.call(
                    "PushTasks", {"specs": batch}, timeout=None
                )
                replies = r["replies"]
        except (ConnectionLost, OSError) as e:
            _fr.record("rpc.error", lease["worker_id"],
                       f"PushTask: {type(e).__name__}")
            state.all_leases.discard(lease["lease_id"])
            for s in batch:
                await self._handle_worker_crash(s, e)
            await self._pump_leases(key, state)
            return
        for s, rep in zip(batch, replies):
            await self._process_task_reply(s, rep)
        # reuse the lease for queued work, else return it
        if state.queue:
            next_spec = state.queue.popleft()
            asyncio.ensure_future(self._push_on_lease(key, state, lease, next_spec))
        else:
            await self._return_lease(state, lease)

    async def _return_lease(self, state: _LeaseState, lease):
        state.all_leases.discard(lease["lease_id"])
        try:
            await lease["raylet"].notify(
                "ReturnWorker", {"worker_id": lease["worker_id"], "lease_id": lease["lease_id"]}
            )
        except Exception:
            pass

    async def _handle_worker_crash(self, spec: dict, err):
        record = self._pending_tasks.get(spec["task_id"])
        if record and record["retries"] > 0:
            record["retries"] -= 1
            self.task_events.record(spec, "RETRY")
            await self._submit_normal(spec)
        else:
            error: Exception = WorkerCrashedError(
                f"worker died executing {spec['name']}: {err}"
            )
            # If the raylet's memory monitor killed the worker, surface the
            # real cause (reference: OOM deaths raise ray.exceptions.
            # OutOfMemoryError, task_manager failure-cause plumbing).
            lease = (record or {}).get("lease")
            if lease:
                try:
                    await asyncio.sleep(0.3)  # let the death report land
                    r = await self.gcs_aio.call(
                        "GetWorkerFailures", {"limit": 200}, timeout=5
                    )
                    for f in reversed(r.get("failures", [])):
                        if f.get("worker_id") == lease["worker_id"]:
                            if "memory monitor" in f.get("reason", ""):
                                error = OutOfMemoryError(
                                    f"task {spec['name']} failed: {f['reason']}"
                                )
                            break
                except Exception:
                    pass
            self._fail_task(spec, error)

    def _fail_task(self, spec: dict, error: Exception):
        record = self._pending_tasks.pop(spec["task_id"], None)
        self.tasks_completed += 1  # failed is resolved, not stuck
        payload, _ = serialization.serialize_inline(error)
        for oid in ts.return_object_ids(spec):
            self.memory_store.put(oid, (_ERR, payload, None))
        self.task_events.record(spec, "FAILED", error=str(error)[:500])
        if record:
            self._release_task_arg_refs(record)
        if self._direct is not None:
            self._direct.notify_store()

    def _release_task_arg_refs(self, record):
        for ref in record.get("arg_refs", []):
            if self.refs.owns(ref.object_id()):
                self.refs.remove_submitted_task_ref(ref.object_id())
        record["arg_refs"] = []

    def _process_task_reply_sync(self, spec: dict, reply: dict,
                                 notify: bool = True) -> bool:
        """Synchronous fast path for the overwhelmingly common ok-inline
        reply: no awaits, no coroutine. Returns False when the reply needs
        the full async path (errors that may retry, plasma returns).
        notify=False lets batch callers coalesce the fast-get wakeup."""
        if reply.get("status") != "ok":
            return False
        results = reply["results"]
        for result in results:
            if "inline" not in result:
                return False
        record = self._pending_tasks.pop(spec["task_id"], None)
        for oid, result in zip(ts.return_object_ids(spec), results):
            # Skip oids the reference counter no longer tracks: if the
            # user-thread fast_get consumed the staged value and the ref
            # already hit zero (free ran), this deferred bookkeeping would
            # re-insert an entry for a freed object that nothing removes.
            if self.refs.owns(oid):
                self.memory_store.put(oid, (_INLINE, result["inline"], None))
        self.tasks_completed += 1
        if record:
            self._release_task_arg_refs(record)
        if notify and self._direct is not None:
            self._direct.notify_store()
        return True

    async def _process_task_reply(self, spec: dict, reply: dict):
        if self._process_task_reply_sync(spec, reply):
            return
        record = self._pending_tasks.get(spec["task_id"])
        if reply.get("status") == "error":
            if reply.get("app_error") and spec.get("retry_exceptions") and record and record["retries"] > 0:
                record["retries"] -= 1
                await self._submit_normal(spec)
                return
            if reply.get("cancelled"):
                err_payload, _ = serialization.serialize_inline(TaskCancelledError())
            elif "exception" in reply:
                err_payload = reply["exception"]
            else:
                err_payload, _ = serialization.serialize_inline(RuntimeError(reply.get("error", "task failed")))
            for oid in ts.return_object_ids(spec):
                if self.refs.owns(oid):
                    self.memory_store.put(oid, (_ERR, err_payload, None))
            self.task_events.record(spec, "FAILED", error=str(reply.get("error", ""))[:300])
        else:
            return_ids = ts.return_object_ids(spec)
            any_plasma = False
            for oid, result in zip(return_ids, reply["results"]):
                if not self.refs.owns(oid):
                    continue  # freed while in flight: don't re-insert
                if "inline" in result:
                    self.memory_store.put(oid, (_INLINE, result["inline"], None))
                elif "plasma" in result:
                    meta = result["plasma"]
                    any_plasma = True
                    self.memory_store.put(oid, InPlasma(meta["size"], {meta["node_id"]}))
                    self._object_locations.setdefault(oid.binary(), set()).add(meta["node_id"])
                    self.refs.note_size(oid, meta["size"], plasma=True)
            if any_plasma:
                self._store_lineage(spec)
        self._pending_tasks.pop(spec["task_id"], None)
        self.tasks_completed += 1
        if record:
            self._release_task_arg_refs(record)
        if self._direct is not None:
            self._direct.notify_store()

    def _store_lineage(self, spec: dict):
        """Keep specs that can recreate lost plasma returns
        (reference: task_manager.h:208 lineage, :215 max_lineage_bytes)."""
        est = 256 + sum(len(str(a)) for a in spec.get("args", []))
        if self._lineage_bytes + est > CONFIG.max_lineage_bytes:
            return
        self._lineage[spec["task_id"]] = spec
        self._lineage_bytes += est

    async def _try_reconstruct(self, oid: ObjectID) -> bool:
        task_id = oid.task_id().binary()
        spec = self._lineage.get(task_id)
        if spec is None:
            return False
        self.memory_store.free(oid)
        for rid in ts.return_object_ids(spec):
            self.memory_store.put_pending(rid)
        self._pending_tasks[spec["task_id"]] = {
            "spec": spec, "retries": 0, "arg_refs": [], "return_ids": ts.return_object_ids(spec),
        }
        await self._submit_normal(spec)
        return True

    # ----------------------------------------------------------- actor submit

    def create_actor(
        self,
        cls,
        args,
        kwargs,
        *,
        name: str = "",
        namespace: str = "",
        num_returns: int = 0,
        resources: Dict[str, float],
        max_restarts: int = 0,
        max_concurrency: int = 1,
        lifetime: str = "",
        scheduling_strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
    ) -> bytes:
        actor_id = ActorID.of(self.job_id)
        fn_key = self.functions.export(cls)
        runtime_env = self.prepare_runtime_env(runtime_env)
        wire, refs, large = ts.serialize_args(args, kwargs, self.inline_threshold)
        big_refs = self._replace_large_args(wire, large)
        refs.extend(big_refs)
        task_id = TaskID.for_actor_creation(actor_id)
        spec = ts.build_task_spec(
            task_id=task_id,
            job_id=self.job_id,
            name=f"{name or getattr(cls, '__name__', 'Actor')}.__init__",
            fn_key=fn_key,
            wire_args=wire,
            num_returns=0,
            resources=resources,
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            scheduling_strategy=scheduling_strategy,
            task_type=ts.TASK_ACTOR_CREATION,
            actor_id=actor_id,
            max_concurrency=max_concurrency,
            max_restarts=max_restarts,
            caller_id=self.worker_id.binary(),
            runtime_env=runtime_env,
        )
        # Hold arg refs until creation completes (GCS drives creation).
        sub = _ActorSubmitter(actor_id.binary())
        sub.state = "PENDING_CREATION"
        self._actor_submitters[actor_id.binary()] = sub
        # keep creation arg refs alive until ALIVE (bound to submitter)
        sub.creation_refs = refs  # type: ignore[attr-defined]
        payload = {
            "actor_id": actor_id.binary(),
            "creation_spec": spec,
            "name": name,
            "namespace": namespace,
            "max_restarts": max_restarts,
            "detached": lifetime == "detached",
        }
        if name:
            # Named actors keep the synchronous round-trip: a name collision
            # must raise ValueError at .remote() time (reference:
            # actor.py _remote raising on duplicate detached names).
            try:
                self.gcs.call("RegisterActor", payload)
            except Exception as e:
                if "already taken" in str(e):
                    raise ValueError(
                        f"actor name {name!r} already taken"
                    ) from None
                raise
            self.io.post(self._watch_actor(actor_id.binary()))
            return actor_id.binary()
        # Anonymous actors register asynchronously and BATCHED: a burst of
        # .remote() calls becomes one SubscribeMany + one RegisterActors
        # round-trip instead of 3 per actor (subscribe-before-register makes
        # the state watch race-free without a refresh read).
        sub.watched = True
        self._post_batched("register_actor", (actor_id.binary(), payload))
        return actor_id.binary()

    def submit_actor_task(
        self, actor_id: bytes, method_name: str, args, kwargs, *, num_returns=1, name=""
    ) -> List[ObjectRef]:
        wire, refs, large = ts.serialize_args(args, kwargs, self.inline_threshold)
        big_refs = self._replace_large_args(wire, large)
        refs.extend(big_refs)
        task_id = TaskID.for_task(self.job_id)
        spec = ts.build_task_spec(
            task_id=task_id,
            job_id=self.job_id,
            name=name or method_name,
            fn_key=b"",
            wire_args=wire,
            num_returns=num_returns,
            resources={},
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            task_type=ts.TASK_ACTOR,
            actor_id=ActorID(actor_id),
            method_name=method_name,
            caller_id=self.worker_id.binary(),
        )
        from ray_tpu_torch.util import tracing as _tracing

        trace_ctx = _tracing.context_for_spec()
        if trace_ctx is not None:
            spec["trace_ctx"] = trace_ctx
        return_refs = self._register_pending(spec, refs)
        if self._direct is not None:
            # Fast path: once this actor's direct channel is active, the
            # spec rides it straight from this (user) thread — the io loop
            # never sees the task (direct_channel.py).
            sub = self._actor_submitters.setdefault(
                actor_id, _ActorSubmitter(actor_id))
            if self._direct.try_submit(sub, spec):
                return return_refs
        self._post_batched("actor", (actor_id, spec))
        return return_refs

    def _route_actor_spec(self, actor_id: bytes, spec: dict):
        """Assign the per-actor sequence number and stage the spec for
        pushing. Returns the submitter iff it needs a pump kick (runs on
        the io loop, called from the batched drain)."""
        sub = self._actor_submitters.setdefault(actor_id, _ActorSubmitter(actor_id))
        if self._direct is not None and self._direct.loop_routed(sub, spec):
            return None  # forwarded onto the active direct channel
        sub.seq += 1
        spec["seq_no"] = sub.seq
        if not sub.watched:
            sub.watched = True
            asyncio.ensure_future(self._watch_actor(actor_id))
        if sub.state == "ALIVE" and sub.addr:
            sub.push_queue.append(spec)
            return sub
        if sub.state == "DEAD":
            self._fail_task(spec, ActorDiedError(actor_id, sub.death_cause or "actor is dead"))
            return None
        sub.buffer.append(spec)
        if sub.state == "UNKNOWN":
            asyncio.ensure_future(self._refresh_actor_state(sub))
        return None

    def _pump_actor(self, sub: _ActorSubmitter):
        """Push staged specs as pipelined batch RPCs (reference:
        actor_task_submitter.h pushes without waiting for prior replies;
        the receiver's seq_no reorder buffer restores order). A shallow
        queue ships single specs immediately; a burst coalesces into
        PushActorTasks batches, which is what lifts small-call throughput —
        the control plane is message-count-bound."""
        if sub.state != "ALIVE" or not sub.addr:
            return
        max_batch = self._cfg_push_batch
        while sub.push_queue and sub.pushing < self._cfg_actor_inflight:
            batch = []
            while sub.push_queue and len(batch) < max_batch:
                batch.append(sub.push_queue.popleft())
            sub.pushing += 1
            asyncio.ensure_future(self._push_actor_batch(sub, batch, sub.addr))

    async def _push_actor_batch(self, sub: _ActorSubmitter, batch: list,
                                addr: Tuple[str, int]):
        # ``addr`` is the one the batch was taken for: a state update may
        # clear ``sub.addr`` before this coroutine first runs.
        # A restart resets sub.pushing to 0 and bumps the epoch; any stale
        # decrement from this coroutine would drive it negative and void
        # the in-flight cap, so every decrement checks the epoch it started
        # under.
        epoch0 = sub.epoch

        def release_push_slot():
            if sub.epoch == epoch0:
                sub.pushing -= 1

        for spec in batch:
            sub.inflight[spec["task_id"]] = spec
        try:
            client = await self.pool.get(*addr)
        except (ConnectionLost, OSError):
            # Connection never established: the tasks provably did not
            # execute, so it is safe to buffer them for the restarted
            # actor. Several pipelined batches can land here in any
            # order — rebuild the buffer sorted by seq so the restarted
            # executor's reorder window starts from the lowest seq.
            release_push_slot()
            for spec in batch:
                sub.inflight.pop(spec["task_id"], None)
            sub.buffer = deque(
                sorted(
                    list(batch) + list(sub.buffer),
                    key=lambda s: s.get("seq_no", 0),
                )
            )
            sub.state = "RESTARTING?"
            asyncio.ensure_future(self._refresh_actor_state(sub))
            return
        for spec in batch:
            self.task_events.record(spec, "SUBMITTED")
        if len(batch) == 1:
            # single-task fast path: reply rides the RPC response
            spec = batch[0]
            try:
                reply = await client.call(
                    "PushActorTask", {"spec": spec}, timeout=None
                )
            except (ConnectionLost, OSError):
                # Actor worker died with this task dispatched. It may have
                # already executed (e.g. it IS the task that killed the
                # actor), so replaying after restart would double-execute —
                # fail it instead, matching the reference's
                # actor_task_submitter semantics (max_task_retries
                # defaults to 0).
                release_push_slot()
                sub.inflight.pop(spec["task_id"], None)
                sub.state = "RESTARTING?"
                self._fail_task(
                    spec,
                    ActorDiedError(
                        sub.actor_id, "actor died while this task was in flight"
                    ),
                )
                asyncio.ensure_future(self._refresh_actor_state(sub))
                return
            release_push_slot()
            sub.inflight.pop(spec["task_id"], None)
            await self._process_task_reply(spec, reply)
            self._pump_actor(sub)
            if self._direct is not None and sub.direct_pending_switch:
                self._direct.maybe_activate(sub)
            return
        # Batched push: the receiver acks immediately and streams each
        # task's reply back as it resolves (handle_ActorTaskReplies), so a
        # slow task never holds a finished peer's reply. `pushing` stays
        # held until every reply in the batch lands — that is the flow
        # control bounding unreplied tasks per actor.
        batch_state = {"remaining": len(batch), "sub": sub,
                       "epoch": sub.epoch}
        for spec in batch:
            record = self._pending_tasks.get(spec["task_id"])
            if record is not None:
                record["push_batch"] = batch_state
        try:
            await client.call(
                "PushActorTasks",
                {"specs": batch, "reply_addr": list(self.address)},
                timeout=None,
            )
        except (ConnectionLost, OSError):
            sub.state = "RESTARTING?"
            release_push_slot()
            batch_state["epoch"] = -1  # stale: late replies must not double-count
            for spec in batch:
                sub.inflight.pop(spec["task_id"], None)
                record = self._pending_tasks.get(spec["task_id"])
                if record is not None:
                    record.pop("push_batch", None)
                self._fail_task(
                    spec,
                    ActorDiedError(
                        sub.actor_id, "actor died while this task was in flight"
                    ),
                )
            asyncio.ensure_future(self._refresh_actor_state(sub))

    async def _refresh_actor_state(self, sub: _ActorSubmitter):
        try:
            info = await self.gcs_aio.call("GetActorInfo", {"actor_id": sub.actor_id})
        except Exception:
            return
        if not info.get("found"):
            return
        await self._apply_actor_state(sub, info["actor"])

    async def _apply_actor_state(self, sub: _ActorSubmitter, rec: dict):
        state = rec["state"]
        if state != "DEAD":
            key = (rec.get("num_restarts", 0), 1 if state == "ALIVE" else 0)
            if key < sub.state_key:
                return  # older than what was applied (see state_key)
            sub.state_key = key
        _fr.record("actor.state", sub.actor_id, state)
        if state == "ALIVE" and rec.get("addr"):
            new_addr = tuple(rec["addr"])
            restarted = sub.addr is not None and new_addr != sub.addr
            sub.addr = new_addr
            sub.state = "ALIVE"
            if restarted:
                # seq keeps increasing; the fresh receiver reorders from the
                # first seq it sees. Outstanding batch accounting belongs to
                # the dead incarnation: invalidate it so late replies don't
                # double-decrement.
                sub.epoch += 1
                sub.pushing = 0
            if hasattr(sub, "creation_refs"):
                del sub.creation_refs
            if sub.buffer:
                # Rebuffered (lower-seq) specs must precede anything staged
                # while ALIVE: the fresh receiver's reorder window starts at
                # the first seq it sees, so out-of-order delivery strands
                # the lower seqs forever.
                merged = sorted(
                    list(sub.buffer) + list(sub.push_queue),
                    key=lambda s: s.get("seq_no", 0),
                )
                sub.buffer.clear()
                sub.push_queue = deque(merged)
            self._pump_actor(sub)
        elif state == "DEAD":
            sub.state = "DEAD"
            sub.death_cause = rec.get("death_cause", "")
            sub.epoch += 1
            sub.pushing = 0
            if self._direct is not None:
                self._direct.forget_actor(sub.actor_id)
            err = ActorDiedError(sub.actor_id, f"actor died: {sub.death_cause}")
            while sub.buffer:
                self._fail_task(sub.buffer.popleft(), err)
            while sub.push_queue:
                self._fail_task(sub.push_queue.popleft(), err)
            for spec in list(sub.inflight.values()):
                record = self._pending_tasks.get(spec["task_id"])
                if record is not None:
                    record.pop("push_batch", None)
                self._fail_task(spec, err)
            sub.inflight.clear()
        elif state in ("RESTARTING", "PENDING_CREATION"):
            sub.state = state
            sub.addr = None

    @staticmethod
    def _print_worker_log(msg: dict):
        """Driver-side sink of the per-node log monitors (reference:
        worker.py print_to_stdstream — '(pid=, ip=)'-prefixed relay)."""
        import sys as _sys

        stream = _sys.stderr if msg.get("is_err") else _sys.stdout
        prefix = f"(pid={msg.get('pid')}, ip={msg.get('ip')})"
        for line in msg.get("lines", []):
            print(f"{prefix} {line}", file=stream)

    def _ensure_pubsub(self):
        """Start the long-poll loop on first subscription. Workers that never
        subscribe (the common short-lived task/actor worker) keep zero
        standing GCS poll traffic — at many-worker scale the idle polls were
        a measurable share of control-plane messages."""
        if self._pubsub_task is None:
            self._pubsub_task = asyncio.ensure_future(self._pubsub_loop())

    def enable_log_to_driver(self):
        """Stream worker stdout/stderr of this job to the driver."""
        channel = f"logs:{self.job_id.binary().hex()}"
        self._subscribed_channels.add(channel)

        async def _sub():
            self._ensure_pubsub()
            await self.gcs_aio.call(
                "Subscribe",
                {"sub_id": self.worker_id.binary(), "channel": channel},
            )

        self.io.run(_sub())

    async def _watch_actor(self, actor_id: bytes):
        sub = self._actor_submitters.setdefault(actor_id, _ActorSubmitter(actor_id))
        channel = f"actor:{actor_id.hex()}"
        self._subscribed_channels.add(channel)
        self._ensure_pubsub()
        await self.gcs_aio.call(
            "Subscribe", {"sub_id": self.worker_id.binary(), "channel": channel}
        )
        await self._refresh_actor_state(sub)

    async def _resubscribe_after_gcs_restart(self) -> bool:
        """The GCS restarted (new epoch): its subscriber table is gone.

        Re-subscribe every channel we were watching and re-read actor states
        we may have missed while the GCS was down. Returns False if any
        re-subscribe failed (a flapping GCS) so the caller keeps the old
        epoch and retries on the next poll.
        """
        ok = True
        for channel in list(self._subscribed_channels):
            try:
                await self.gcs_aio.call(
                    "Subscribe",
                    {"sub_id": self.worker_id.binary(), "channel": channel},
                )
            except Exception:
                ok = False
        for sub in list(self._actor_submitters.values()):
            if sub.state != "DEAD":
                asyncio.ensure_future(self._refresh_actor_state(sub))
        return ok

    async def _pubsub_loop(self):
        """Single long-poll loop draining every GCS channel we subscribe to."""
        epoch = None
        while True:
            try:
                reply = await self.gcs_aio.call(
                    "PubsubPoll",
                    {"sub_id": self.worker_id.binary(), "timeout": 20.0},
                    timeout=40.0,
                )
            except Exception:
                await asyncio.sleep(1.0)
                continue
            new_epoch = reply.get("epoch")
            if epoch is None or new_epoch == epoch:
                epoch = new_epoch
            elif await self._resubscribe_after_gcs_restart():
                epoch = new_epoch
            for channel, msg in reply.get("batch", []):
                if channel.startswith("logs:"):
                    self._print_worker_log(msg)
                elif channel.startswith("actor:"):
                    actor_id = msg["actor_id"]
                    sub = self._actor_submitters.get(actor_id)
                    if sub is not None:
                        rec = {
                            "state": msg["state"],
                            "addr": msg.get("addr"),
                            "death_cause": msg.get("death_cause", ""),
                        }
                        await self._apply_actor_state(sub, rec)

    def kill_actor(self, actor_id: bytes, no_restart=True):
        self.gcs.call("KillActor", {"actor_id": actor_id, "no_restart": no_restart})

    def cancel_task(self, ref: ObjectRef, force=False, recursive=True):
        async def go():
            task_id = ref.object_id().task_id().binary()
            record = self._pending_tasks.get(task_id)
            if record is None:
                return
            lease = record.get("lease")
            addr = None
            if lease:
                addr = lease["worker_addr"]
            else:
                spec = record["spec"]
                if spec.get("actor_id"):
                    sub = self._actor_submitters.get(spec["actor_id"])
                    if sub and sub.addr:
                        addr = sub.addr
            if addr:
                try:
                    client = await self.pool.get(*addr)
                    await client.notify("CancelTask", {"task_id": task_id})
                except Exception:
                    pass

        self.io.run(go())

    # ----------------------------------------------------- executor services

    def _direct_upgrade(self, payload):
        """Connection-upgrade hook for the direct call channel handshake
        (runs synchronously on the io loop inside RpcServer). Only serial
        sync actors accept — everything else keeps the loop path."""
        if not self._cfg_direct:
            return {"ok": False, "reason": "direct channels disabled"}, None
        if not self._direct_server.eligible():
            return {"ok": False, "reason": "not a serial sync actor"}, None
        caller = payload.get("caller_id", b"")
        return {"ok": True}, (
            lambda sock: self._direct_server.adopt(sock, caller))

    def on_became_actor(self, actor_id: bytes, spec: dict):
        self.actor_id = actor_id
        self._actor_spec = spec

    def register_running_task(self, task_id: bytes, fut):
        self._running_async[task_id] = fut

    def unregister_running_task(self, task_id: bytes):
        self._running_async.pop(task_id, None)

    def try_cancel_running(self, task_id: bytes):
        fut = self._running_async.get(task_id)
        if fut is not None:
            fut.cancel()

    def push_task_context(self, spec: dict):
        old = getattr(self._ctx, "spec", None)
        self._ctx.spec = spec
        return old

    def pop_task_context(self, old):
        self._ctx.spec = old

    def current_task_spec(self):
        return getattr(self._ctx, "spec", None)

    async def put_return_to_plasma(self, oid: ObjectID, payload, spec) -> dict:
        """Store a large task return into local plasma; owner is the caller.
        `payload` is the executor's raw (pickle_bytes, buffers) pair — the
        buffers stream straight into shm, never materialized as bytes."""
        pickle_bytes, buffers = payload
        loop = asyncio.get_running_loop()
        size = await loop.run_in_executor(
            None, self._plasma_put_payload, oid, pickle_bytes, buffers
        )
        try:
            await self.raylet.call(
                "PinObject",
                {"object_id": oid.binary(), "owner_addr": list(spec["owner_addr"]),
                 "meta": self._pin_meta(oid, size, spec=spec)},
                timeout=30,
            )
        except Exception:
            pass
        return {"size": size, "node_id": self.node_id.binary()}

    # -------------------------------------------------------------- handlers

    async def handle_PushTask(self, req):
        return await self.executor.execute_normal(req["spec"])

    async def handle_PushTasks(self, req):
        """Batched push: one pooled thread executes the batch back-to-back,
        spilling to thread-per-task only if a task blocks (executor
        .execute_batch) — tasks that synchronize with a batch-mate still
        behave as if they'd been granted separate leases, without paying a
        threadpool round-trip per tiny task."""
        return {"replies": await self.executor.execute_batch(req["specs"])}

    async def handle_CreateActor(self, req):
        return await self.executor.create_actor(req["spec"], req["actor_id"])

    async def handle_PushActorTask(self, req):
        return await self.executor.push_actor_task(req["spec"])

    async def handle_PushActorTasks(self, req):
        """Batched actor-task push: ack immediately, stream each task's
        reply back to the owner as it resolves (batched notify frames).
        One slow task in a batch never delays a finished peer's reply
        (reference: per-call replies in core_worker.proto PushTask)."""
        specs = req["specs"]
        reply_addr = tuple(req["reply_addr"])
        futs = self.executor.enqueue_actor_tasks(specs)
        for spec, fut in zip(specs, futs):
            task_id = spec["task_id"]
            fut.add_done_callback(
                lambda f, tid=task_id: self._queue_task_reply(
                    reply_addr, tid, f
                )
            )
        return {"accepted": len(specs)}

    def _queue_task_reply(self, addr, task_id: bytes, fut):
        """Buffer a resolved task reply for its owner; one in-flight flush
        per destination burst (scheduled-drain, like _post_batched)."""
        try:
            reply = fut.result()
        except Exception as e:  # executor-level failure
            reply = {"status": "error", "error": str(e), "app_error": False}
        buf = self._reply_bufs.setdefault(addr, [])
        buf.append([task_id, reply])
        if addr not in self._reply_flush_scheduled:
            self._reply_flush_scheduled.add(addr)
            asyncio.ensure_future(self._flush_task_replies(addr))

    async def _flush_task_replies(self, addr):
        try:
            while True:
                batch = self._reply_bufs.get(addr)
                if not batch:
                    return
                self._reply_bufs[addr] = []
                # A lost reply permanently hangs the owner's get() AND
                # wedges its per-actor push window, so transient connect
                # failures must retry; only an owner unreachable for ~15 s
                # (presumed dead — nobody left to consume) drops them.
                for attempt in range(6):
                    try:
                        client = await self.pool.get(addr[0], addr[1])
                        await client.notify(
                            "ActorTaskReplies", {"replies": batch}
                        )
                        break
                    except Exception as e:
                        _fr.record("rpc.error", b"",
                                   f"ActorTaskReplies retry {attempt}: "
                                   f"{type(e).__name__}")
                        await asyncio.sleep(0.2 * (2 ** attempt))
                else:
                    _fr.record("rpc.error", b"",
                               "ActorTaskReplies dropped (owner unreachable)")
                    self._reply_bufs.pop(addr, None)
                    return
        finally:
            self._reply_flush_scheduled.discard(addr)

    async def handle_ActorTaskReplies(self, req):
        """Owner side: per-task replies streaming back from a batched
        actor-task push."""
        for task_id, reply in req["replies"]:
            record = self._pending_tasks.get(task_id)
            if record is None:
                continue
            spec = record["spec"]
            batch_state = record.pop("push_batch", None)
            await self._process_task_reply(spec, reply)
            if batch_state is not None:
                sub = batch_state["sub"]
                sub.inflight.pop(task_id, None)
                if batch_state["epoch"] == sub.epoch:
                    batch_state["remaining"] -= 1
                    if batch_state["remaining"] <= 0:
                        sub.pushing -= 1
                        self._pump_actor(sub)
                        if (self._direct is not None
                                and sub.direct_pending_switch):
                            self._direct.maybe_activate(sub)

    async def handle_GetObjectStatus(self, req):
        oid = ObjectID(req["object_id"])
        if req.get("wait"):
            timeout = min(req.get("timeout", 25.0), 25.0)
            ready = await self.memory_store.wait_ready(oid, timeout)
            if not ready:
                return {"status": "pending"}
        entry = self.memory_store.get_if_exists(oid)
        if entry is None:
            if self.memory_store.is_pending(oid):
                return {"status": "pending"}
            if self.refs.owns(oid):
                return {"status": "pending"}
            return {"status": "freed"}
        if isinstance(entry, InPlasma):
            return {
                "status": "ready",
                "plasma": {"size": entry.size, "locations": list(entry.locations)},
            }
        kind, payload = entry[0], entry[1]
        if kind == _ERR:
            return {"status": "ready", "err": payload}
        return {"status": "ready", "inline": payload}

    async def handle_AddBorrowerRef(self, req):
        self.refs.add_borrower(ObjectID(req["object_id"]), tuple(req["borrower"]))

    async def handle_RemoveBorrowerRef(self, req):
        self.refs.remove_borrower(ObjectID(req["object_id"]), tuple(req["borrower"]))

    async def handle_AddObjectLocation(self, req):
        oid = ObjectID(req["object_id"])
        self._object_locations.setdefault(oid.binary(), set()).add(req["node_id"])
        entry = self.memory_store.get_if_exists(oid)
        if isinstance(entry, InPlasma):
            entry.locations.add(req["node_id"])

    async def handle_RemoveObjectLocation(self, req):
        oid = ObjectID(req["object_id"])
        self._object_locations.get(oid.binary(), set()).discard(req["node_id"])
        entry = self.memory_store.get_if_exists(oid)
        if isinstance(entry, InPlasma):
            entry.locations.discard(req["node_id"])

    async def handle_Profile(self, req):
        """On-demand stack sampling of THIS process (reference: dashboard
        reporter profile_manager.py:78 py-spy; see _private/profiling.py)."""
        from ray_tpu_torch._private import profiling

        loop = asyncio.get_running_loop()
        counts = await loop.run_in_executor(
            None, profiling.sample_stacks,
            req.get("duration", 2.0), req.get("hz", 100.0),
        )
        return {"folded": profiling.folded_text(counts),
                "samples": sum(counts.values()), "pid": os.getpid()}

    async def handle_StartProfile(self, req):
        """Profiling plane: kick off a timed background capture of this
        process (timestamped samples, _private/sampling_profiler.py). The
        raylet fans this out so a whole node — then the whole cluster —
        samples one synchronized window; CollectProfile fans the results
        back in."""
        from ray_tpu_torch._private import sampling_profiler as _sp

        try:
            _sp.start_profile(
                req.get("duration", 2.0), req.get("hz", 99.0),
                role=self.mode)
        except RuntimeError as e:
            return {"error": str(e), "pid": os.getpid()}
        return {"ok": True, "pid": os.getpid()}

    async def handle_CollectProfile(self, req):
        """Blocks until the capture window started by StartProfile closes,
        then returns the sample set (off-loop: the join must not stall the
        worker's RPC loop)."""
        from ray_tpu_torch._private import sampling_profiler as _sp

        loop = asyncio.get_running_loop()
        profile = await loop.run_in_executor(None, _sp.collect_profile)
        if profile is None:
            return {"error": "no profile capture in progress",
                    "pid": os.getpid()}
        profile["worker_id"] = self.worker_id.hex()
        return {"profile": profile, "pid": os.getpid()}

    async def handle_CancelTask(self, req):
        self.executor.cancel(req["task_id"])

    async def handle_KillActor(self, req):
        _fr.record("actor.state", self.actor_id or b"", "KILLED")
        _fr.flush_now()
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return {"ok": True}

    async def handle_Exit(self, req):
        _fr.record("worker.death", self.worker_id.binary(), "Exit RPC")
        _fr.flush_now()
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return {"ok": True}

    async def handle_DumpFlightRecorder(self, req):
        """Forensics: this process's flight-recorder ring, formatted
        (raylet fans this out for `ray-tpu-torch debug dump`)."""
        return {
            "worker_id": self.worker_id.binary(),
            "pid": os.getpid(),
            "events": _fr.dump(req.get("limit") or 0),
        }

    async def handle_Ping(self, req):
        return {"ok": True, "worker_id": self.worker_id.binary()}

    async def handle_GetCoreWorkerStats(self, req):
        now = time.time()
        return {
            "worker_id": self.worker_id.binary(),
            "mode": self.mode,
            "actor_id": self.actor_id,
            "refs": self.refs.stats(),
            "memory_store_size": self.memory_store.size(),
            "pending_tasks": len(self._pending_tasks),
            "running_tasks": [
                {"task_id": tid, "name": name, "age": now - t0}
                for tid, (name, t0) in list(self.running_tasks.items())
            ],
        }

    async def handle_GetMemoryReport(self, req):
        """Memory observability plane: this process's object ownership
        ledger + RSS. Pull-only — the ledger snapshot is built here, on
        demand, from fields the hot paths already maintain (the raylet
        fans this out per node; util.state aggregates the cluster)."""
        from ray_tpu_torch._private import memory_report as _mr

        limit = req.get("limit") or CONFIG.memory_report_top_n
        return {"report": _mr.build_worker_report(self, limit=limit)}

    async def handle_CheckRefs(self, req):
        """Leak-detector probe: which of ``ids`` does this process still
        own (a live entry in its reference counter)? A pinned plasma
        primary whose owner answers False here — twice — is a leak."""
        ids = [ObjectID(b) for b in req.get("ids", [])]
        return {"owned": self.refs.owns_many(ids)}

    # ------------------------------------------------------------- shutdown

    def shutdown(self):
        if self.is_shutdown:
            return
        self.is_shutdown = True
        set_worker_hooks(None)
        # Stop the flush loop deterministically (the is_shutdown guard is
        # the backstop) — see the zombie-drain note in the loop body.
        flush_task = getattr(self, "_flush_task", None)
        if flush_task is not None:
            try:
                self.io.loop.call_soon_threadsafe(flush_task.cancel)
            except Exception:
                pass
        if self._watchdog is not None:
            self._watchdog.stop()
        _fr.flush_now()
        try:
            if self._direct is not None:
                self._direct.close_all()
            self._direct_server.close_all()
        except Exception:
            pass
        try:
            self._ring_close()
        except Exception:
            pass
        try:
            self.io.run(self.server.stop(), timeout=5)
        except Exception:
            pass
        self.executor.shutdown()
        try:
            if self.plasma:
                self.plasma.close()
        except Exception:
            pass


# ---------------------------------------------------------------- globals

global_worker: Optional[CoreWorker] = None


def get_global_worker() -> CoreWorker:
    if global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return global_worker


def set_global_worker(worker: Optional[CoreWorker]):
    global global_worker
    global_worker = worker
