"""Task execution inside a worker: normal tasks, actor creation, actor tasks.

Counterpart of the reference's TaskReceiver + scheduling queues
(reference: src/ray/core_worker/transport/task_receiver.cc:36,
actor_scheduling_queue.h, out_of_order_actor_scheduling_queue.h, fiber.h):

- Normal tasks run one-at-a-time on a dedicated thread (the raylet leases this
  worker exclusively, so there is never more than one in flight).
- Actor tasks are totally ordered *per caller* via sequence numbers with a
  reorder buffer, then dispatched to either a thread pool of size
  ``max_concurrency`` (sync actors) or a private asyncio loop (async actors —
  the reference uses fibers; an event loop is the Python-native equivalent).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import TASK_ACTOR, return_object_ids
from ray_tpu_torch.exceptions import TaskCancelledError, format_exception


class _AsyncActorLoop:
    """Private event loop thread for async actors."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        t = threading.Thread(target=self._run, name="rtpu-async-actor", daemon=True)
        t.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()


class Executor:
    def __init__(self, core):
        self.core = core  # CoreWorker
        self._normal_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rtpu-exec")
        # Persistent elastic pool for batched pushes: ThreadPoolExecutor
        # only spawns a new thread when no idle one exists, so this reuses
        # threads across batches instead of paying thread creation per RPC,
        # while still giving each in-flight task its own thread (tasks in a
        # batch may synchronize with each other).
        from ray_tpu_torch._private.config import CONFIG

        self._batch_pool = ThreadPoolExecutor(
            max_workers=CONFIG.batch_exec_max_threads,
            thread_name_prefix="rtpu-batch",
        )
        self._batch_inflight = 0  # grows the pool cap, see handle_PushTasks
        # actor state
        self.actor_instance = None
        self.actor_id: Optional[bytes] = None
        self.actor_is_async = False
        self._actor_pool: Optional[ThreadPoolExecutor] = None
        self._actor_loop: Optional[_AsyncActorLoop] = None
        self._actor_sem: Optional[asyncio.Semaphore] = None
        # per-caller ordering: caller_id -> {"expected": int|None, "buffer": {seq: (spec, fut)}}
        self._callers: Dict[bytes, dict] = {}
        self._cancelled: set = set()
        self._current_task_name = ""
        # serial-actor pump (max_concurrency == 1, the default): one
        # long-lived consumer in the actor thread executes queued tasks
        # back-to-back and delivers replies in batches, instead of paying a
        # threadpool submit + future chain + loop wakeup per call
        self._serial = False
        self._run_q: deque = deque()
        self._pump_lock = threading.Lock()
        self._pump_running = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # reply delivery: pump appends here and schedules ONE loop drain
        # per burst — delivery is immediate when the loop is idle and
        # batches naturally when it is busy, so a completed task's reply is
        # never held behind a slow successor
        self._done_q: deque = deque()
        self._done_scheduled = False

    # ----------------------------------------------------------- normal path

    async def execute_normal(self, spec: dict) -> dict:
        return await self._execute(spec, self._normal_pool)

    # ------------------------------------------------------------ actor path

    async def create_actor(self, spec: dict, actor_id: bytes) -> dict:
        loop = asyncio.get_running_loop()
        self._loop = loop  # the pump + direct intake need it before any task
        # functions.fetch may hit the GCS KV through the blocking client — keep
        # it off the IO loop.
        cls = await loop.run_in_executor(None, self.core.functions.fetch, spec["fn_key"])
        args, kwargs, pins = await self._resolve_args(spec)

        def make():
            return cls(*args, **kwargs)

        try:
            self.actor_instance = await loop.run_in_executor(self._normal_pool, make)
        except Exception as e:
            return {"ok": False, "error": format_exception(e)}
        finally:
            del args, kwargs, pins
        self.actor_id = actor_id
        self.core.on_became_actor(actor_id, spec)
        self.actor_is_async = any(
            inspect.iscoroutinefunction(getattr(type(self.actor_instance), m, None))
            for m in dir(type(self.actor_instance))
            if not m.startswith("__")
        )
        max_conc = spec.get("max_concurrency", 1)
        if self.actor_is_async:
            self._actor_loop = _AsyncActorLoop()
            self._actor_sem = None  # created lazily on the actor loop
            self._actor_max_conc = max_conc if max_conc > 1 else 1000
        else:
            self._actor_pool = ThreadPoolExecutor(
                max_workers=max(1, max_conc), thread_name_prefix="rtpu-actor"
            )
            self._serial = max_conc <= 1
        return {"ok": True}

    def _enqueue_actor_task(self, spec: dict) -> "asyncio.Future":
        """Order by (caller_id, seq_no); returns a future for the reply."""
        caller = spec.get("caller_id", b"")
        seq = spec.get("seq_no", 0)
        state = self._callers.setdefault(caller, {"expected": None, "buffer": {}})
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        state["buffer"][seq] = (spec, fut)
        if state["expected"] is None:
            state["expected"] = seq
        # drain in order
        while state["expected"] in state["buffer"]:
            s, f = state["buffer"].pop(state["expected"])
            state["expected"] += 1
            asyncio.ensure_future(self._run_actor_task(s, f))
        return fut

    async def push_actor_task(self, spec: dict) -> dict:
        return await self._enqueue_actor_task(spec)

    def enqueue_actor_tasks(self, specs: list) -> list:
        """Batched ordered push: register every spec (the reorder buffer
        sees the whole batch) and return the per-task reply futures —
        the caller streams replies back as they resolve, so one slow task
        never holds a finished peer's reply."""
        return [self._enqueue_actor_task(s) for s in specs]

    async def _run_actor_task(self, spec: dict, fut: asyncio.Future):
        if self._serial and spec.get("type") == TASK_ACTOR:
            with self._pump_lock:
                self._run_q.append((spec, fut))
                start = not self._pump_running
                if start:
                    self._pump_running = True
            if start:
                self._actor_pool.submit(self._serial_pump)
            return
        try:
            if self.actor_is_async:
                reply = await self._execute_async_actor(spec)
            else:
                reply = await self._execute(spec, self._actor_pool)
        except Exception as e:
            reply = {"status": "error", "error": format_exception(e), "app_error": False}
        if not fut.done():
            fut.set_result(reply)

    # ------------------------------------------------- serial-actor pump

    def intake_direct(self, specs: list, reply_cb):
        """Direct-channel intake (runs on the channel's reader thread).
        Queues the batch for the serial pump — one enqueue+wake for the
        whole recv batch, no io-loop hop (direct_channel.py's reason for
        being). The pump itself always runs on the actor's single
        _actor_pool thread: executing inline here would be one wake
        cheaper, but a serial actor's tasks must stay on ONE thread for
        its whole lifetime (thread-bound user state — sqlite handles,
        threading.local caches; the reference runs all actor tasks on the
        actor's main thread). Ordering: the channel is FIFO and, once
        active, carries every task for this caller, so arrival order is
        submission order."""
        with self._pump_lock:
            for spec in specs:
                self._run_q.append((spec, reply_cb))
            start = not self._pump_running
            if start:
                self._pump_running = True
        if start:
            self._actor_pool.submit(self._serial_pump)

    def _serial_pump(self):
        """Consumer loop in the (single) actor thread — or, for
        direct-channel tasks, in the channel's reader thread that claimed
        the pump. Executes queued tasks back-to-back. Replies sink either
        to the io loop (loop-path tasks: batched _done_q + one pending
        wakeup) or straight onto the direct channel (callable sink) from
        this thread."""
        while True:
            with self._pump_lock:
                if not self._run_q:
                    self._pump_running = False
                    return
                spec, sink = self._run_q.popleft()
            reply = self._run_one_serial(spec)
            if callable(sink):
                if isinstance(reply, tuple) and reply[0] == "plasma":
                    # Large return: the plasma put needs the io loop; the
                    # channel write then happens on a pool thread — the io
                    # loop must never block in sendall.
                    asyncio.run_coroutine_threadsafe(
                        self._finish_direct(spec, sink, reply[1]), self._loop)
                else:
                    sink(spec, reply)
                continue
            self._done_q.append((spec, sink, reply))
            with self._pump_lock:
                schedule = not self._done_scheduled
                if schedule:
                    self._done_scheduled = True
            if schedule:
                self._loop.call_soon_threadsafe(self._drain_done)

    async def _finish_direct(self, spec: dict, sink, payloads):
        try:
            reply = await self._finish_results(spec, payloads)
        except Exception as e:
            reply = self._error_reply(spec, e)
        # sink -> pipe.send -> blocking sendall: keep it off the io loop.
        asyncio.get_running_loop().run_in_executor(None, sink, spec, reply)

    def _drain_done(self):
        """On the io loop: resolve queued reply futures."""
        with self._pump_lock:
            self._done_scheduled = False
        while True:
            try:
                spec, fut, reply = self._done_q.popleft()
            except IndexError:
                return
            if isinstance(reply, tuple) and reply[0] == "plasma":
                asyncio.ensure_future(
                    self._finish_deferred(spec, fut, reply[1])
                )
            elif not fut.done():
                fut.set_result(reply)

    def _run_one_serial(self, spec: dict):
        """Execute one actor task entirely in the actor thread: resolve
        args, run, serialize. Only plasma-bound returns defer to the loop."""
        task_id = spec["task_id"]
        if task_id in self._cancelled:
            self._cancelled.discard(task_id)
            return self._error_reply(spec, TaskCancelledError(), cancelled=True)
        try:
            fn = self._actor_method(spec["method_name"])
            args, kwargs, pins = self._decode_args(
                spec,
                lambda ref: asyncio.run_coroutine_threadsafe(
                    self.core.async_get_one(ref), self._loop
                ).result(),
            )
        except Exception as e:
            return {"status": "error", "error": format_exception(e),
                    "app_error": False}
        self.core.task_events.record(spec, "RUNNING")
        old_ctx = self.core.push_task_context(spec)
        try:
            result = self._call_with_trace(spec, fn, args, kwargs)
            payloads = self._serialize_returns(spec, result)
        except Exception as e:
            return self._error_reply(spec, e)
        finally:
            self.core.pop_task_context(old_ctx)
            del args, kwargs, pins
        if all(size <= self.core.inline_threshold for _, size in payloads):
            self.core.task_events.record(spec, "FINISHED")
            return {"status": "ok",
                    "results": [
                        {"inline": serialization.inline_payload(p, bufs)}
                        for (p, bufs), _ in payloads
                    ]}
        return ("plasma", payloads)

    async def _finish_deferred(self, spec: dict, fut: asyncio.Future, payloads):
        try:
            reply = await self._finish_results(spec, payloads)
        except Exception as e:
            reply = self._error_reply(spec, e)
        if not fut.done():
            fut.set_result(reply)


    def _actor_method(self, method_name):
        """Resolve an actor method; `__ray_call__` runs an arbitrary function
        against the instance (reference: actor.__ray_call__.remote(fn))."""
        if method_name == "__ray_call__":
            inst = self.actor_instance
            return lambda fn, *a, **kw: fn(inst, *a, **kw)
        return getattr(self.actor_instance, method_name)

    async def _execute_async_actor(self, spec: dict) -> dict:
        method_name = spec["method_name"]
        args, kwargs, pins = await self._resolve_args(spec)
        method = self._actor_method(method_name)
        outer = asyncio.get_running_loop()
        result_fut = outer.create_future()

        sem_holder = self

        async def run_on_actor_loop():
            tctx = spec.get("trace_ctx")
            if tctx:
                from ray_tpu_torch.util import tracing

                # the spec-borne enabled bit short-circuits the KV TTL:
                # spans in this task (and its immediate children) record
                # even in a worker whose cached flag is stale/cold
                tracing._mark_enabled()
                tracing.set_context({
                    k: v for k, v in tctx.items() if k != "enabled"
                })  # task-local contextvar copy
            if sem_holder._actor_sem is None:
                sem_holder._actor_sem = asyncio.Semaphore(sem_holder._actor_max_conc)
            async with sem_holder._actor_sem:
                if inspect.iscoroutinefunction(method):
                    return await method(*args, **kwargs)
                return method(*args, **kwargs)

        def done_cb(f):
            def transfer():
                if result_fut.done():
                    return
                if f.cancelled():
                    result_fut.set_exception(TaskCancelledError())
                elif f.exception() is not None:
                    result_fut.set_exception(f.exception())
                else:
                    result_fut.set_result(f.result())

            outer.call_soon_threadsafe(transfer)

        inner = asyncio.run_coroutine_threadsafe(run_on_actor_loop(), self._actor_loop.loop)
        inner.add_done_callback(done_cb)
        self.core.register_running_task(spec["task_id"], inner)
        try:
            result = await result_fut
            return await self._package_results(spec, result)
        except Exception as e:
            return self._error_reply(spec, e)
        finally:
            self.core.unregister_running_task(spec["task_id"])
            del args, kwargs, pins

    # --------------------------------------------------------------- shared

    def _decode_args(self, spec: dict, resolve_ref):
        """Deserialize wire args. resolve_ref(ObjectRef) -> value supplies
        top-level ref args (style — await-bridged, blocking — is the
        caller's choice); None is fine when the spec has no ref args."""
        args: list = []
        kwargs: dict = {}
        pins = []  # keep plasma pin handles alive for the call duration
        for kind, key, wire in spec["args"]:
            if "v" in wire:
                val, _refs = serialization.deserialize_inline(wire["v"])
            elif "ref" in wire:
                id_bytes, owner = wire["ref"]
                ref = ObjectRef(ObjectID(id_bytes), tuple(owner) if owner else None)
                val = resolve_ref(ref)
                pins.append(val)
            else:
                raise ValueError(f"bad wire arg {wire}")
            if kind == "p":
                args.append(val)
            else:
                kwargs[key] = val
        return args, kwargs, pins

    async def _resolve_args(self, spec: dict):
        """IO-loop arg resolution: refs fetch asynchronously first, then the
        shared decode runs with them pre-resolved."""
        resolved: Dict[bytes, Any] = {}
        for _kind, _key, wire in spec["args"]:
            if "ref" in wire:
                id_bytes, owner = wire["ref"]
                ref = ObjectRef(ObjectID(id_bytes), tuple(owner) if owner else None)
                resolved[id_bytes] = await self.core.async_get_one(ref)
        return self._decode_args(
            spec, lambda r: resolved[r.object_id().binary()]
        )

    def _call_with_trace(self, spec: dict, fn, args, kwargs):
        """Run fn under the caller's propagated trace context (reference:
        _ray_trace_ctx kwarg propagation) in the current thread."""
        tctx = spec.get("trace_ctx")
        if tctx:
            from ray_tpu_torch.util import tracing

            tracing._mark_enabled()  # spec-borne enabled bit beats KV TTL
            tracing.set_context(
                {k: v for k, v in tctx.items() if k != "enabled"})
        try:
            return fn(*args, **kwargs)
        finally:
            if tctx:
                tracing.set_context(None)

    async def execute_batch(self, specs) -> list:
        """Execute a PushTasks batch: ONE pooled thread runs the tasks
        back-to-back (run_in_executor per task cost ~40 µs of submit +
        wakeup — the dominant worker-side cost for tiny tasks), with a
        spill-on-block escape hatch: if the serial runner makes no progress
        for 15 ms (a task is blocking, likely synchronizing with a
        batch-mate), every remaining task gets its own thread — restoring
        the tasks-own-a-thread semantics separate leases would have given
        them. Claims make serial/spilled execution race-free."""
        loop = asyncio.get_running_loop()
        n = len(specs)
        prepared: list = [None] * n
        replies: list = [None] * n

        async def _prep(i, spec):
            task_id = spec["task_id"]
            if task_id in self._cancelled:
                self._cancelled.discard(task_id)
                replies[i] = self._error_reply(
                    spec, TaskCancelledError(), cancelled=True
                )
                return
            try:
                fn = self.core.functions.fetch_cached(spec["fn_key"])
                if fn is None:
                    fn = await loop.run_in_executor(
                        None, self.core.functions.fetch, spec["fn_key"]
                    )
                args, kwargs, pins = await self._resolve_args(spec)
            except Exception as e:
                replies[i] = {"status": "error",
                              "error": format_exception(e),
                              "app_error": False}
                return
            prepared[i] = (fn, args, kwargs, pins)

        # Resolve all tasks' ref args concurrently (a batch of plasma/borrow
        # fetches must overlap, not serialize).
        await asyncio.gather(*(_prep(i, s) for i, s in enumerate(specs)))

        todo = [i for i in range(n) if prepared[i] is not None]
        outcomes: list = [None] * n
        if todo:
            claim_lock = threading.Lock()
            claimed: set = set()

            def run_one(i):
                with claim_lock:
                    if i in claimed:
                        return
                    claimed.add(i)
                spec = specs[i]
                fn, args, kwargs, pins = prepared[i]
                self.core.task_events.record(spec, "RUNNING")
                old_ctx = self.core.push_task_context(spec)
                try:
                    result = self._call_with_trace(spec, fn, args, kwargs)
                    outcomes[i] = ("ok", self._serialize_returns(spec, result))
                except Exception as e:
                    outcomes[i] = ("err", e)
                finally:
                    self.core.pop_task_context(old_ctx)
                    prepared[i] = None  # drop args/pins promptly

            def run_serial():
                for i in todo:
                    run_one(i)

            pool = self._batch_pool
            # The serial runner occupies a pool thread for the whole batch —
            # account for it (and grow the cap) so many concurrently-blocked
            # batches can't starve each other's spills of threads.
            self._batch_inflight += 1
            if self._batch_inflight > pool._max_workers:
                pool._max_workers = self._batch_inflight + 16
            serial_fut = loop.run_in_executor(pool, run_serial)
            try:
                last_progress = -1
                while True:
                    try:
                        await asyncio.wait_for(asyncio.shield(serial_fut), 0.015)
                        break
                    except asyncio.TimeoutError:
                        pass
                    with claim_lock:
                        progress = len(claimed)
                    if progress > last_progress:
                        # still advancing — a batch of short tasks merely
                        # totals >15 ms; keep it serial and re-arm
                        last_progress = progress
                        continue
                    # stalled: the claimed task is blocking (likely on a
                    # batch-mate) — give the unclaimed remainder their own
                    # threads; claims keep serial/spilled execution disjoint
                    with claim_lock:
                        unclaimed = [i for i in todo if i not in claimed]
                    if not unclaimed:
                        await serial_fut  # last task just runs long
                        break
                    self._batch_inflight += len(unclaimed)
                    if self._batch_inflight > pool._max_workers:
                        pool._max_workers = self._batch_inflight + 16
                    try:
                        spills = [
                            loop.run_in_executor(pool, run_one, i)
                            for i in unclaimed
                        ]
                        await asyncio.gather(serial_fut, *spills)
                    finally:
                        self._batch_inflight -= len(unclaimed)
                    break
            finally:
                self._batch_inflight -= 1

        for i in todo:
            status, val = outcomes[i]
            if status == "err":
                replies[i] = self._error_reply(specs[i], val)
            else:
                try:
                    replies[i] = await self._finish_results(specs[i], val)
                except Exception as e:
                    replies[i] = self._error_reply(specs[i], e)
        return replies

    async def _execute(self, spec: dict, pool: ThreadPoolExecutor) -> dict:
        task_id = spec["task_id"]
        if task_id in self._cancelled:
            self._cancelled.discard(task_id)
            return self._error_reply(spec, TaskCancelledError(), cancelled=True)
        loop = asyncio.get_running_loop()
        try:
            if spec["type"] == TASK_ACTOR:
                fn = self._actor_method(spec["method_name"])
            else:
                # cache hit is the common case after the first execution —
                # skip the threadpool hop the blocking KV fetch needs
                fn = self.core.functions.fetch_cached(spec["fn_key"])
                if fn is None:
                    fn = await loop.run_in_executor(
                        None, self.core.functions.fetch, spec["fn_key"]
                    )
            args, kwargs, pins = await self._resolve_args(spec)
        except Exception as e:
            return {"status": "error", "error": format_exception(e), "app_error": False}

        self.core.task_events.record(spec, "RUNNING")
        old_ctx = self.core.push_task_context(spec)

        def call():
            # Serialize the returns in the execution thread too: pushing
            # them back through run_in_executor costs a loop round-trip per
            # task (the reference serializes in the executing C++ thread,
            # core_worker.cc HandlePushTask).
            result = self._call_with_trace(spec, fn, args, kwargs)
            return self._serialize_returns(spec, result)

        try:
            payloads = await loop.run_in_executor(pool, call)
        except Exception as e:
            return self._error_reply(spec, e)
        finally:
            self.core.pop_task_context(old_ctx)
            del args, kwargs, pins
        return await self._finish_results(spec, payloads)

    def _error_reply(self, spec, e: Exception, cancelled=False):
        self.core.task_events.record(spec, "FAILED", error=str(e)[:500])
        return {
            "status": "error",
            "error": format_exception(e),
            "exception": serialization.serialize_inline(e)[0],
            "app_error": True,
            "cancelled": cancelled,
        }

    def _serialize_returns(self, spec: dict, result: Any) -> list:
        """Serialize return values (runs in the execution thread)."""
        num_returns = spec["num_returns"]
        if num_returns == 1:
            values = [result]
        elif num_returns == 0:
            values = []
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(values)} values"
                )
        out = []
        for value in values:
            # Keep the raw protocol-5 buffer views: plasma-bound returns
            # stream them straight into shm (put_return_to_plasma) and only
            # inline returns materialize bytes (_finish_results).
            p, bufs, _refs = serialization.serialize(value)
            size = len(p) + serialization.buffers_nbytes(bufs)
            out.append(((p, bufs), size))
        return out

    async def _finish_results(self, spec: dict, payloads: list) -> dict:
        """Build the reply from pre-serialized returns (runs on the loop —
        the plasma path needs it)."""
        return_ids = return_object_ids(spec)
        results = []
        for oid, ((p, bufs), size) in zip(return_ids, payloads):
            if size <= self.core.inline_threshold:
                results.append({"inline": serialization.inline_payload(p, bufs)})
            else:
                meta = await self.core.put_return_to_plasma(oid, (p, bufs), spec)
                results.append({"plasma": meta})
        self.core.task_events.record(spec, "FINISHED")
        return {"status": "ok", "results": results}

    async def _package_results(self, spec: dict, result: Any) -> dict:
        """Serialize-and-reply for results produced on the loop (async
        actors); sync paths serialize in the execution thread instead."""
        loop = asyncio.get_running_loop()
        try:
            payloads = await loop.run_in_executor(
                None, self._serialize_returns, spec, result
            )
        except Exception as e:
            return self._error_reply(spec, e)
        return await self._finish_results(spec, payloads)

    def cancel(self, task_id: bytes):
        self._cancelled.add(task_id)
        self.core.try_cancel_running(task_id)

    def shutdown(self):
        self._normal_pool.shutdown(wait=False)
        self._batch_pool.shutdown(wait=False)
        if self._actor_pool:
            self._actor_pool.shutdown(wait=False)
