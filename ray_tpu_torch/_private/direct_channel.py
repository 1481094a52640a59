"""Direct call channel: a GIL-lean blocking-socket fast path for actor tasks.

Why this exists: the default actor-call path routes every submit and every
reply through two asyncio event loops (driver io loop + worker io loop). A
profile of the 1:1 sync pattern (`get(a.m.remote())` in a loop) shows ~10
io-loop iterations, 2+ self-pipe wakeups and ~6 cross-thread handoffs per
call — on a single-core box that caps sync calls at ~700/s while the
reference's C++ core worker does 2,050/s (BASELINE.md). The reference gets
its speed from a dedicated gRPC completion-queue thread ping-ponging with
the caller (reference: src/ray/core_worker/transport/direct_actor_transport.cc,
normal_task_submitter.cc) — this module is the Python-shaped analogue:

- One extra *blocking* socket per (caller worker, actor worker) pair,
  established by upgrading a fresh RPC connection (`__direct_channel__`
  handshake) off the worker's existing advertised port.
- The caller's USER thread serializes the task spec and sends it straight
  from `.remote()` — the driver io loop never sees the task.
- The actor worker reads frames on a dedicated reader thread which runs the
  serial-actor pump INLINE (executor claims the pump in the reader thread):
  recv -> execute -> reply happens on one thread with zero loop hops.
- Replies land on the caller's reader thread, which resolves blocked
  `get()`s via a threading.Condition (the "staging store") and posts the
  authoritative ownership bookkeeping to the io loop in coalesced batches
  (the loop's memory store stays the single source of truth; staging is a
  read-through cache in front of it).

Ordering: a channel only ACTIVATES when the io loop confirms the actor
submitter is quiescent (no in-flight pushes, empty queues); from then on
EVERY task for that actor rides the channel, so per-caller order is just
socket FIFO — there is no cross-channel interleave to re-order. The
`posted_unrouted` counter closes the activation race: a user thread only
direct-sends once every spec it previously posted to the loop has been
routed (and loop-forwarded onto the channel under the same order lock).

Failure semantics mirror the in-flight push path (worker.py
_push_actor_batch ConnectionLost): tasks sent on a channel that breaks MAY
have executed, so they fail with ActorDiedError; tasks still in the unsent
out-queue provably did not execute and are re-routed through the loop path.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from typing import Any, Dict, Optional

import msgpack

_LEN = struct.Struct("<I")

# Frame types on an upgraded channel (disjoint from rpc.py's MSG_* range).
MSG_DIRECT_TASK = 4  # [MSG_DIRECT_TASK, spec]
MSG_DIRECT_REPLY = 5  # [MSG_DIRECT_REPLY, task_id, reply]

HANDSHAKE_METHOD = "__direct_channel__"

_INLINE = "inline"
_ERR = "err"


def pack_frame(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return _LEN.pack(len(body)) + body


class FrameReader:
    """Incremental length-prefixed msgpack frame parser over a blocking
    socket. recv() is called with the GIL released, so a blocked reader
    thread costs nothing."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()

    def read_frames(self):
        """Blocks for at least one frame; returns every complete frame
        buffered so far (natural batch under load)."""
        while True:
            frames = []
            while True:
                if len(self._buf) < _LEN.size:
                    break
                (length,) = _LEN.unpack_from(self._buf, 0)
                if len(self._buf) < _LEN.size + length:
                    break
                body = bytes(self._buf[_LEN.size:_LEN.size + length])
                del self._buf[:_LEN.size + length]
                frames.append(msgpack.unpackb(body, raw=False,
                                              strict_map_key=False))
            if frames:
                return frames
            chunk = self._sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("direct channel closed")
            self._buf.extend(chunk)


class SendPipe:
    """Serialized, coalescing writer shared by user threads, the io loop and
    reader threads. append+try-flush: whoever holds flush_lock drains the
    out-deque with one sendall per accumulated batch; appenders that lose
    the race are guaranteed their frame is flushed by the current holder
    (the holder re-checks after every drain). The io loop uses try_flush
    nonblocking so it can never park on a full socket buffer."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.order_lock = threading.Lock()  # also guards channel counters
        self._flush_lock = threading.Lock()
        self._out: deque = deque()
        self.dead = False

    def append_locked(self, frame: bytes):
        """Caller must hold order_lock."""
        self._out.append(frame)

    def send(self, frame: bytes, blocking=True):
        with self.order_lock:
            if self.dead:
                raise ConnectionError("direct channel closed")
            self._out.append(frame)
        self.flush(blocking=blocking)

    def flush(self, blocking=True):
        """Drain the out-deque. Safe against the append-between-last-check-
        and-release race: the holder re-checks after releasing and retries.
        Socket errors mark the pipe dead (the reader thread's EOF runs the
        authoritative death path) and are not raised here."""
        while True:
            if not self._flush_lock.acquire(blocking=blocking):
                return
            try:
                while True:
                    with self.order_lock:
                        if not self._out or self.dead:
                            break
                        batch = b"".join(self._out)
                        self._out.clear()
                    try:
                        self.sock.sendall(batch)
                    except OSError:
                        with self.order_lock:
                            self.dead = True
                        return
            finally:
                self._flush_lock.release()
            with self.order_lock:
                if not self._out or self.dead:
                    return
            # Raced: frames were appended by a thread that saw the flush
            # lock held just as we were exiting — go around again.

    def pending_unsent(self) -> list:
        """Drain the unsent out-queue (on channel death). Frames return as
        raw bytes; the caller re-decodes what it needs."""
        with self.order_lock:
            self.dead = True
            out = list(self._out)
            self._out.clear()
        return out

    def close(self):
        with self.order_lock:
            self.dead = True
        try:
            self.sock.close()
        except Exception:
            pass


def _unpack_frame_bytes(frame: bytes):
    return msgpack.unpackb(frame[_LEN.size:], raw=False, strict_map_key=False)


# --------------------------------------------------------------- caller side


class DirectChannel:
    """Caller-side state for one actor's direct channel."""

    __slots__ = (
        "actor_id", "pipe", "active", "posted_unrouted", "reader", "addr",
        "closed",
    )

    def __init__(self, actor_id: bytes, sock: socket.socket, addr):
        self.actor_id = actor_id
        self.pipe = SendPipe(sock)
        self.addr = addr
        # Both guarded by pipe.order_lock:
        self.active = False  # loop confirmed quiescence; all tasks ride here
        self.posted_unrouted = 0  # specs posted to the loop, not yet routed
        self.reader: Optional[threading.Thread] = None
        self.closed = False


class DirectManager:
    """Caller-side registry: channels, the reply staging store, and the
    fast blocking-get path. One per CoreWorker."""

    _FALLBACK = object()

    def __init__(self, core):
        self.core = core
        self.cond = threading.Condition()
        # oid bytes -> memory-store-shaped entry, kept until the io loop's
        # deferred bookkeeping lands the value in the authoritative store.
        self.staged: Dict[bytes, tuple] = {}
        # oid bytes -> task_id for replies still in flight on a channel
        self.pending_oids: Dict[bytes, bytes] = {}
        # task_id -> spec for everything sent on a channel
        self.pending_tasks: Dict[bytes, dict] = {}
        self.channels: Dict[bytes, DirectChannel] = {}
        self.unavailable: set = set()  # actor_ids that rejected the handshake
        # actor_id -> monotonic deadline before which connects won't retry;
        # a dead/partitioned node otherwise costs a blocking 5s connect
        # timeout inside EVERY .remote() while the GCS still says ALIVE.
        self._connect_backoff: Dict[bytes, float] = {}
        # actor_id -> submits seen pre-channel (channels open on the 2nd)
        self._call_counts: Dict[bytes, int] = {}
        self.stats = {"direct_sent": 0, "fast_get_hits": 0,
                      "fast_get_fallbacks": 0, "switches": 0,
                      "channel_deaths": 0}

    # ------------------------------------------------------------ submit path

    def try_submit(self, sub, spec: dict) -> bool:
        """Called from .remote() in the user thread, after _register_pending.
        True = the spec rode the channel (or its out-queue); False = caller
        must use the loop path. Also kicks off establishment/switching."""
        actor_id = sub.actor_id
        ch = self.channels.get(actor_id)
        if ch is None:
            # Don't pay connect+handshake+reader-thread for an actor that
            # may only ever see one call (actor-creation storms ping each
            # actor once — 200 channels would cost ~1s of driver CPU for
            # nothing). The SECOND submit reveals a calling pattern.
            calls = self._call_counts.get(actor_id, 0) + 1
            self._call_counts[actor_id] = calls
            if calls < 2:
                return False
            import time as _time

            if (actor_id not in self.unavailable and sub.state == "ALIVE"
                    and sub.addr
                    and _time.monotonic()
                    >= self._connect_backoff.get(actor_id, 0.0)):
                ch = self._establish(sub)
            if ch is None:
                return False
        with ch.pipe.order_lock:
            if ch.closed or ch.pipe.dead:
                return False
            if not ch.active or ch.posted_unrouted > 0:
                # Not switched yet (or earlier specs still queued loop-side):
                # keep loop order, count it so activation waits for it.
                ch.posted_unrouted += 1
                return False
            self._track_locked(spec)
            ch.pipe.append_locked(pack_frame([MSG_DIRECT_TASK, spec]))
            self.stats["direct_sent"] += 1
        ch.pipe.flush()
        return True

    def loop_routed(self, sub, spec: dict) -> bool:
        """Called on the io loop when routing a posted spec. Returns True if
        the spec was forwarded onto the (active) channel — the loop path
        must then skip its own push. Runs under the order lock so forwarded
        frames keep their posted order relative to direct sends."""
        ch = self.channels.get(sub.actor_id)
        if ch is None:
            return False
        with ch.pipe.order_lock:
            if ch.posted_unrouted > 0:
                ch.posted_unrouted -= 1
            if not ch.active or ch.closed or ch.pipe.dead:
                return False
            self._track_locked(spec)
            ch.pipe.append_locked(pack_frame([MSG_DIRECT_TASK, spec]))
            self.stats["direct_sent"] += 1
        # Never touch the socket from the io loop — even a "nonblocking"
        # flush can park in sendall on a full buffer. A pool thread pays.
        import asyncio

        asyncio.get_running_loop().run_in_executor(None, ch.pipe.flush)
        return True

    def _track_locked(self, spec: dict):
        from ray_tpu_torch._private import task_spec as ts

        with self.cond:
            self.pending_tasks[spec["task_id"]] = spec
            for oid in ts.return_object_ids(spec):
                self.pending_oids[oid.binary()] = spec["task_id"]

    def _establish(self, sub) -> Optional[DirectChannel]:
        """Blocking connect + handshake from the user thread (once per
        actor incarnation). On success, posts the switch request to the
        loop; the channel activates when the loop confirms quiescence."""
        actor_id = sub.actor_id
        addr = sub.addr
        try:
            sock = socket.create_connection((addr[0], addr[1]), timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(pack_frame(
                [0, 0, HANDSHAKE_METHOD,  # MSG_REQUEST
                 {"caller_id": self.core.worker_id.binary(),
                  "actor_id": actor_id}]))
            reader = FrameReader(sock)
            sock.settimeout(5.0)
            frames = reader.read_frames()
            mtype, _seq, _x, payload = frames[0]
            if mtype != 1 or not payload.get("ok"):  # MSG_RESPONSE
                sock.close()
                self.unavailable.add(actor_id)
                return None
            sock.settimeout(None)
        except Exception:
            # Connection refused/timeout: back off (not a permanent
            # blacklist — the worker may be mid-boot or mid-restart, but a
            # partitioned node must not cost 5s inside every .remote()).
            import time as _time

            self._connect_backoff[actor_id] = _time.monotonic() + 10.0
            try:
                sock.close()
            except Exception:
                pass
            return None
        self._connect_backoff.pop(actor_id, None)
        ch = DirectChannel(actor_id, sock, addr)
        existing = self.channels.setdefault(actor_id, ch)
        if existing is not ch:  # lost a racing establish
            ch.pipe.close()
            return existing
        from ray_tpu_torch._private import flight_recorder as _fr

        _fr.record("chan.up", actor_id, f"{addr[0]}:{addr[1]}")
        t = threading.Thread(
            target=self._reader_loop, args=(ch, reader),
            name=f"rtpu-direct-{actor_id.hex()[:8]}", daemon=True)
        ch.reader = t
        t.start()
        # Ask the loop to flip `active` once the submitter is quiescent.
        self.core._post_batched("direct_switch", actor_id)
        return ch

    # --------------------------------------------------------- io-loop hooks

    def on_switch_request(self, actor_id: bytes):
        """io loop: arm the pending switch and try to flip immediately."""
        sub = self.core._actor_submitters.get(actor_id)
        ch = self.channels.get(actor_id)
        if sub is None or ch is None:
            return
        sub.direct_pending_switch = True
        self.maybe_activate(sub)

    def maybe_activate(self, sub):
        """io loop: flip the channel active when nothing is in flight on the
        loop path. Called at switch request and whenever loop-path work for
        this submitter drains to zero."""
        if not getattr(sub, "direct_pending_switch", False):
            return
        ch = self.channels.get(sub.actor_id)
        if ch is None:
            return
        if (sub.state == "ALIVE" and not sub.inflight and not sub.push_queue
                and not sub.buffer and sub.pushing == 0):
            with ch.pipe.order_lock:
                if (not ch.closed and not ch.pipe.dead
                        and ch.posted_unrouted == 0):
                    ch.active = True
                    sub.direct_pending_switch = False
                    self.stats["switches"] += 1

    def on_channel_down(self, actor_id: bytes, unsent_frames: list):
        """io loop: the reader died. Fail every sent-but-unreplied task with
        the in-flight semantics; re-route unsent frames through the loop
        path (they provably never reached the worker)."""
        from ray_tpu_torch.exceptions import ActorDiedError

        from ray_tpu_torch._private import flight_recorder as _fr

        _fr.record("chan.down", actor_id, f"{len(unsent_frames)} unsent")
        ch = self.channels.pop(actor_id, None)
        sub = self.core._actor_submitters.get(actor_id)
        if sub is not None:
            sub.direct_pending_switch = False
        self.stats["channel_deaths"] += 1
        unsent_task_ids = set()
        respecs = []
        for raw in unsent_frames:
            try:
                msg = _unpack_frame_bytes(raw)
            except Exception:
                continue
            if msg and msg[0] == MSG_DIRECT_TASK:
                unsent_task_ids.add(msg[1]["task_id"])
                respecs.append(msg[1])
        with self.cond:
            pending = [
                (tid, spec) for tid, spec in self.pending_tasks.items()
                if spec.get("actor_id") == actor_id  # other channels live on
            ]
        for task_id, spec in pending:
            if task_id in unsent_task_ids:
                continue
            self._discard_task(spec)
            self.core._fail_task(
                spec,
                ActorDiedError(
                    actor_id, "actor died while this task was in flight"),
            )
        if sub is not None and respecs:
            kick = None
            for spec in respecs:
                self._discard_task(spec)
                kick = self.core._route_actor_spec(sub.actor_id, spec) or kick
            if kick is not None:
                self.core._pump_actor(kick)
        # Wake blocked fast-gets only after every task is either staged as
        # an error (sent) or discarded+re-routed (unsent): a waiter that
        # wakes mid-cleanup would still see the unsent oid as
        # direct-pending and go back to sleep with no further notify.
        with self.cond:
            self.cond.notify_all()
        if sub is not None:
            import asyncio

            asyncio.ensure_future(self.core._refresh_actor_state(sub))

    def process_replies(self, items: list):
        """io loop: authoritative bookkeeping for a batch of direct replies,
        then retire the staging entries (the memory store now serves
        reads). The common ok-inline case runs synchronously right here —
        no coroutine per reply batch."""
        import asyncio

        slow = []
        retire = []
        for spec, reply in items:
            if self.core._process_task_reply_sync(spec, reply, notify=False):
                retire.extend(_return_oid_bytes(spec))
            else:
                slow.append((spec, reply))
        if retire:
            with self.cond:
                for oid in retire:
                    self.staged.pop(oid, None)
                self.cond.notify_all()
        if not slow:
            return

        async def _run():
            for spec, reply in slow:
                try:
                    await self.core._process_task_reply(spec, reply)
                finally:
                    with self.cond:
                        for oid in _return_oid_bytes(spec):
                            self.staged.pop(oid, None)

        asyncio.ensure_future(_run())

    def _discard_task(self, spec: dict):
        with self.cond:
            self.pending_tasks.pop(spec["task_id"], None)
            for oid in _return_oid_bytes(spec):
                self.pending_oids.pop(oid, None)

    # ------------------------------------------------------------ reader side

    def _reader_loop(self, ch: DirectChannel, reader: FrameReader):
        core = self.core
        try:
            while True:
                frames = reader.read_frames()
                batch = []
                with self.cond:
                    for msg in frames:
                        if msg[0] != MSG_DIRECT_REPLY:
                            continue
                        task_id, reply = msg[1], msg[2]
                        spec = self.pending_tasks.pop(task_id, None)
                        if spec is None:
                            continue
                        self._stage_locked(spec, reply)
                        batch.append((spec, reply))
                    if batch:
                        self.cond.notify_all()
                if batch:
                    core._post_batched("direct_replies", batch)
        except Exception:
            if ch.closed or core.is_shutdown:
                return
            ch.closed = True
            unsent = ch.pipe.pending_unsent()
            unsent_ids = set()
            for raw in unsent:
                try:
                    msg = _unpack_frame_bytes(raw)
                    if msg and msg[0] == MSG_DIRECT_TASK:
                        unsent_ids.add(msg[1]["task_id"])
                except Exception:
                    pass
            # Stage errors under the cond so blocked fast-gets wake with a
            # resolution instead of timing out — but NOT for unsent tasks:
            # those provably never reached the worker and will be re-routed
            # through the loop path by on_channel_down; a staged
            # ActorDiedError would shadow their successful re-execution.
            self._stage_channel_error(ch, skip_task_ids=unsent_ids)
            core._post_batched("direct_down", (ch.actor_id, unsent))

    def _stage_locked(self, spec: dict, reply: dict):
        """Reader thread, under self.cond: make the reply's results readable
        by the fast-get path. Anything not ok-inline falls back to the loop
        (the deferred bookkeeping resolves it there)."""
        from ray_tpu_torch._private import serialization

        oids = _return_oid_bytes(spec)
        if reply.get("status") == "ok":
            results = reply.get("results", [])
            for oid, result in zip(oids, results):
                self.pending_oids.pop(oid, None)
                if "inline" in result:
                    self.staged[oid] = (_INLINE, result["inline"], None)
                # plasma results: leave unstaged; fast-get falls back and the
                # loop-side _process_task_reply lands the InPlasma entry.
        else:
            if reply.get("cancelled"):
                from ray_tpu_torch.exceptions import TaskCancelledError

                payload, _ = serialization.serialize_inline(
                    TaskCancelledError())
            elif "exception" in reply:
                payload = reply["exception"]
            else:
                payload, _ = serialization.serialize_inline(
                    RuntimeError(reply.get("error", "task failed")))
            for oid in oids:
                self.pending_oids.pop(oid, None)
                self.staged[oid] = (_ERR, payload, None)

    def _stage_channel_error(self, ch: DirectChannel, skip_task_ids=()):
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.exceptions import ActorDiedError

        err = ActorDiedError(
            ch.actor_id, "actor died while this task was in flight")
        payload, _ = serialization.serialize_inline(err)
        with self.cond:
            for task_id, spec in list(self.pending_tasks.items()):
                if spec.get("actor_id") != ch.actor_id:
                    continue  # a different actor's channel — untouched
                if task_id in skip_task_ids:
                    continue  # unsent: will be re-routed, not failed
                for oid in _return_oid_bytes(spec):
                    if oid in self.pending_oids:
                        self.pending_oids.pop(oid, None)
                        self.staged[oid] = (_ERR, payload, None)
            self.cond.notify_all()

    # --------------------------------------------------------------- get path

    def fast_get(self, refs, timeout: Optional[float]):
        """User thread. Returns a value list, raises like get(), or returns
        _FALLBACK when any ref can't be served from staging/pending/store.
        Never touches the io loop."""
        import time as _time

        core = self.core
        store = core.memory_store
        deadline = None if timeout is None else _time.monotonic() + timeout
        oids = [r.object_id() for r in refs]
        keys = [o.binary() for o in oids]
        pending_tasks = core._pending_tasks
        with self.cond:
            # Incremental wait: only re-check still-missing refs per wake —
            # a 1000-ref get otherwise rescans all 1000 keys on every
            # condition wake (O(N^2) across the batch).
            unresolved = list(zip(oids, keys))
            first_pass = True
            while True:
                still = []
                for oid, k in unresolved:
                    if k in self.staged:
                        continue
                    if k in self.pending_oids:
                        still.append((oid, k))
                        continue
                    entry = store.get_if_exists(oid)
                    if (isinstance(entry, tuple)
                            and entry[0] in (_INLINE, _ERR)):
                        continue
                    if entry is None and oid.task_id().binary() in pending_tasks:
                        # Loop-path task still awaiting its reply: the loop
                        # notifies this condition when it lands the result.
                        still.append((oid, k))
                        continue
                    self.stats["fast_get_fallbacks"] += 1
                    return self._FALLBACK
                if not still:
                    break
                if first_pass and len(still) > 1024:
                    # Huge pending batch: the loop's wait_ready_many blocks
                    # on ONE event for the whole set, while this condition
                    # wakes per reply batch and re-scans the remainder —
                    # O(sum of remaining) work that measurably regressed a
                    # 50k-ref drain. Let the io.run path handle bulk gets.
                    self.stats["fast_get_fallbacks"] += 1
                    return self._FALLBACK
                first_pass = False
                unresolved = still
                if deadline is None:
                    self.cond.wait()
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0 or not self.cond.wait(remaining):
                        from ray_tpu_torch.exceptions import GetTimeoutError

                        raise GetTimeoutError(
                            "get() timed out on direct-pending objects")
            entries = []
            for oid, k in zip(oids, keys):
                e = self.staged.get(k)
                if e is None:
                    e = store.get_if_exists(oid)
                entries.append(e)
        out = []
        for oid, entry in zip(oids, entries):
            if not (isinstance(entry, tuple) and entry[0] in (_INLINE, _ERR)):
                self.stats["fast_get_fallbacks"] += 1
                return self._FALLBACK  # migrated/freed mid-read: rare
            value = core._materialize(oid, entry[:2])
            if isinstance(value, Exception):
                raise value
            out.append(value)
        self.stats["fast_get_hits"] += 1
        return out

    def can_serve(self, refs) -> bool:
        """Cheap pre-check without taking the condition (racy-negative ok).
        Also true when every ref is already an inline/err entry in the
        memory store — those gets skip the io-loop round trip entirely even
        when the value arrived via the loop path."""
        store = self.core.memory_store
        pending_tasks = self.core._pending_tasks
        for r in refs:
            oid = r.object_id()
            k = oid.binary()
            if k in self.staged or k in self.pending_oids:
                continue
            entry = store.get_if_exists(oid)
            if isinstance(entry, tuple) and entry[0] in (_INLINE, _ERR):
                continue
            if entry is None and oid.task_id().binary() in pending_tasks:
                continue
            return False
        return True

    def forget_actor(self, actor_id: bytes):
        """io loop, on terminal actor death: drop per-actor bookkeeping so
        a driver churning short-lived actors doesn't grow these maps
        forever, and run the FULL channel-down path for any live channel.

        A silent close here would strand every in-flight direct task: the
        reader thread's exception handler early-returns once ch.closed is
        set (it assumes the closer staged the errors), so gets would hang
        into GetTimeoutError instead of raising ActorDiedError, and the
        dead channel would stay in self.channels blocking a restarted
        actor's fast path."""
        self._call_counts.pop(actor_id, None)
        self._connect_backoff.pop(actor_id, None)
        self.unavailable.discard(actor_id)
        ch = self.channels.get(actor_id)
        if ch is None:
            return
        already_closed = ch.closed
        ch.closed = True
        # Drain BEFORE closing the socket: pending_unsent marks the pipe
        # dead, so no new frame can slip in between drain and close.
        unsent = ch.pipe.pending_unsent()
        ch.pipe.close()
        if already_closed:
            # reader (or a prior call) already ran the death path
            self.channels.pop(actor_id, None)
            return
        unsent_ids = set()
        for raw in unsent:
            try:
                msg = _unpack_frame_bytes(raw)
                if msg and msg[0] == MSG_DIRECT_TASK:
                    unsent_ids.add(msg[1]["task_id"])
            except Exception:
                pass
        # Same sequence as the reader-death path: stage ActorDiedError for
        # sent tasks so blocked fast-gets wake with a resolution (unsent
        # tasks are re-routed, not failed), then the authoritative loop
        # cleanup pops the channel, fails sent tasks in the memory store
        # and re-routes the unsent specs.
        self._stage_channel_error(ch, skip_task_ids=unsent_ids)
        self.on_channel_down(actor_id, unsent)

    def notify_store(self):
        """io loop, after landing a task reply (any path) in the memory
        store: wake blocked fast-gets. This is what lets fast_get serve
        LOOP-delivered results too — get() on a plain task blocks on this
        condition instead of paying an io.run round trip per call."""
        with self.cond:
            self.cond.notify_all()

    def discard_object(self, oid_bytes: bytes):
        """io loop (ref count hit zero): drop any staged copy."""
        with self.cond:
            self.staged.pop(oid_bytes, None)

    def close_all(self):
        for ch in list(self.channels.values()):
            ch.closed = True
            ch.pipe.close()
        self.channels.clear()


def _return_oid_bytes(spec: dict):
    from ray_tpu_torch._private import task_spec as ts

    return [o.binary() for o in ts.return_object_ids(spec)]


# --------------------------------------------------------------- worker side


class WorkerDirectServer:
    """Actor-worker side: owns upgraded sockets. One reader thread per
    channel feeds the executor's serial pump directly (claiming the pump
    into the reader thread when it is idle); replies are written back on the
    same socket by whichever thread finished the task."""

    def __init__(self, core):
        self.core = core
        self.pipes: list = []

    def eligible(self) -> bool:
        ex = self.core.executor
        return (ex.actor_instance is not None and not ex.actor_is_async
                and ex._serial)

    def adopt(self, sock: socket.socket, caller_id: bytes):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        pipe = SendPipe(sock)
        self.pipes.append(pipe)
        t = threading.Thread(
            target=self._reader_loop, args=(sock, pipe),
            name=f"rtpu-direct-srv-{caller_id.hex()[:8]}", daemon=True)
        t.start()

    def _reader_loop(self, sock: socket.socket, pipe: SendPipe):
        reader = FrameReader(sock)
        executor = self.core.executor
        # Keep the typed wire contracts honest on this path too: direct
        # frames carry the same spec shape as PushActorTask.
        validator = self.core.server._validator

        def reply_cb(spec, reply):
            try:
                pipe.send(pack_frame(
                    [MSG_DIRECT_REPLY, spec["task_id"], reply]))
            except Exception:
                pass  # caller gone; its side fails the task

        try:
            while True:
                frames = reader.read_frames()
                specs = [m[1] for m in frames if m[0] == MSG_DIRECT_TASK]
                if specs:
                    if validator is not None:
                        for spec in specs:
                            validator("PushActorTask", {"spec": spec})
                    executor.intake_direct(specs, reply_cb)
        except Exception:
            pipe.close()
            try:
                self.pipes.remove(pipe)
            except ValueError:
                pass

    def close_all(self):
        for pipe in list(self.pipes):
            pipe.close()
        self.pipes.clear()
