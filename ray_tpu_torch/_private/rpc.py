"""Asyncio msgpack-framed RPC used by every control-plane connection.

The reference uses gRPC for all inter-process control traffic
(reference: src/ray/rpc/grpc_server.h, grpc_client.h). We use a leaner
length-prefixed msgpack protocol over asyncio TCP: one persistent duplex
connection per (client, server) pair, request/response multiplexed by sequence
number, plus fire-and-forget notifications. This keeps per-call overhead low
(single syscall write of one small frame) which matters for the task
throughput benchmarks, and avoids protoc codegen for every service.

Frame layout: 4-byte little-endian length, then msgpack array:
    [MSG_REQUEST,  seq, method: str, payload]
    [MSG_RESPONSE, seq, None,        payload]
    [MSG_ERROR,    seq, traceback: str, exc: bytes(cloudpickle)]
    [MSG_NOTIFY,   0,   method: str, payload]

Out-of-band frames (the bulk-data plane): a 5th element carries the byte
length of a RAW binary payload appended immediately AFTER the msgpack body
— the length prefix covers only the msgpack header, writev-style:
    [u32 len(header)][msgpack [MSG_REQUEST_OOB,  seq, method, payload, n]][n raw bytes]
    [u32 len(header)][msgpack [MSG_RESPONSE_OOB, seq, None,   payload, n]][n raw bytes]
The bulk bytes are never msgpack-encoded: the sender writes the caller's
buffer view (e.g. a plasma slice) directly after the header — zero copies
on the send side — and the receiver lands the payload at its final
destination in bounded pieces via a per-method sink (RpcServer.set_oob_sink)
or a caller-provided buffer (RpcClient.call(oob_dest=...)), so a 4 MiB
transfer chunk is never materialized as one Python bytes object. Handlers
see the landed payload as payload["_oob"]: an int byte-count when a sink /
oob_dest absorbed it in place, else a bytearray holding the raw bytes.
Handlers reply out-of-band by returning an OobPayload.

Threading model — the sharded reactor
--------------------------------------
Every process owns a single background IO thread running one asyncio loop
(mirroring the reference's per-process asio io_service,
reference: src/ray/common/asio/). Synchronous front-end code posts coroutines
onto it via run_coroutine_threadsafe. That loop is a server's HOME loop:
``RpcServer.start()`` records it, and all shared handler state belongs to it.

With ``RTPU_TORCH_rpc_reactor_shards`` > 1 (default ``min(4, cpus)``; a 1-core box
degenerates to exactly the old single-loop behavior), the server accepts on
the home loop but hands each accepted connection to one of N reactor shard
loops, each running in its own thread (process-global pool, shared by every
RpcServer in the process). Per-connection work — frame reads, msgpack
decode/encode, response writes, drain/flow-control, the chaos ``rpc.recv``
seam, OOB payload landing via the per-method sink, and connection-upgrade
hooks — runs on the connection's shard, so independent connections stop
serializing behind one thread.

What is per-shard vs shared:
  per-shard   frame parse/serialize, socket IO, writer locks, OOB sinks,
              upgrade hooks, chaos seams (chaos.py is internally locked)
  shared      registered handlers and the state they close over. By default
              a handler coroutine HOPS to the home loop
              (run_coroutine_threadsafe + wrap_future), so raylet/GCS/worker
              handler state keeps its single-threaded invariants by
              construction rather than by accident. Methods whose handlers
              are thread-safe (pure reads, natively-locked plasma ops) can
              opt into running directly on the shard via
              ``set_shard_safe({...})`` — the raylet marks its bulk
              data-plane methods (ReceiveChunk/FetchChunk/...) this way.
"""

from __future__ import annotations

import asyncio
import os
import socket as _socket_mod
import struct
import threading
import traceback
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

import cloudpickle
import msgpack

from ray_tpu_torch._private import chaos as _chaos

MSG_REQUEST = 0
MSG_RESPONSE = 1
MSG_ERROR = 2
MSG_NOTIFY = 3
MSG_REQUEST_OOB = 4
MSG_RESPONSE_OOB = 5

_LEN = struct.Struct("<I")
# Allow frames up to 2 GiB; large data rides the plasma plane, not RPC, but
# inline task args/returns can reach tens of MiB.
_MAX_FRAME = (1 << 31) - 1
# Out-of-band payloads land at their destination in pieces of this size, so
# receiving a chunk never allocates more than this on the heap.
_OOB_READ_PIECE = 1 << 16


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteError(RpcError):
    """Server-side handler raised; carries the remote traceback and exception."""

    def __init__(self, tb: str, exc: Exception | None):
        super().__init__(tb)
        self.remote_traceback = tb
        self.exception = exc


def _pack(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return _LEN.pack(len(body)) + body


def _pack_oob(mtype: int, seq: int, method, payload, data):
    """Build an out-of-band frame header for `data` (any bytes-like).

    Returns (header_bytes, data_view): the caller writes both back-to-back
    (writev-style). data is NEVER copied or msgpack-encoded here — the
    returned view aliases the caller's buffer.
    """
    mv = data if isinstance(data, memoryview) else memoryview(data)
    header = msgpack.packb(
        [mtype, seq, method, payload, mv.nbytes], use_bin_type=True
    )
    return _LEN.pack(len(header)) + header, mv


async def _read_frame(reader: asyncio.StreamReader):
    """Read one msgpack frame header. For OOB frame types the raw payload
    (msg[4] bytes) follows on the stream and the caller MUST consume it
    (via _read_oob_into) before reading the next frame."""
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > _MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


async def _read_oob_into(reader: asyncio.StreamReader, dest, nbytes: int):
    """Land an out-of-band payload straight into `dest` (a writable
    memoryview, e.g. a plasma buffer slice) in bounded pieces — the full
    payload is never materialized as one heap object. dest=None drains and
    discards (receiver had nowhere to put it but the stream must stay
    framed)."""
    off = 0
    while off < nbytes:
        piece = await reader.read(min(nbytes - off, _OOB_READ_PIECE))
        if not piece:
            raise asyncio.IncompleteReadError(b"", nbytes - off)
        if dest is not None:
            dest[off : off + len(piece)] = piece
        off += len(piece)


class OobPayload:
    """Handler return marker: respond with an out-of-band frame.

    `header` is the msgpack-able response payload; `data` is any bytes-like
    (typically a plasma memoryview slice) appended raw after the header.
    `release`, if given, is called exactly once after the frame has been
    handed to the transport — use it to drop plasma pins.
    """

    __slots__ = ("header", "data", "_release")

    def __init__(self, header, data, release=None):
        self.header = header
        self.data = data
        self._release = release

    def release(self):
        cb, self._release = self._release, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


# ------------------------------------------------------- reactor shard pool
# Process-global pool of extra event-loop threads serving accepted
# connections (shard 0 is always the server's home loop, so the pool holds
# shards 1..N-1). Grown lazily, shared by every RpcServer in the process.

_shard_lock = threading.Lock()
_shard_loops: List[asyncio.AbstractEventLoop] = []


def _shard_loop(index: int) -> asyncio.AbstractEventLoop:
    with _shard_lock:
        while len(_shard_loops) <= index:
            loop = asyncio.new_event_loop()
            t = threading.Thread(
                target=_run_shard, args=(loop,),
                name=f"rtpu-rpc-shard-{len(_shard_loops) + 1}", daemon=True)
            t.start()
            _shard_loops.append(loop)
        return _shard_loops[index]


def _run_shard(loop: asyncio.AbstractEventLoop):
    asyncio.set_event_loop(loop)
    loop.run_forever()


def resolve_reactor_shards(requested: Optional[int] = None) -> int:
    """Shard count: explicit arg > RTPU_TORCH_rpc_reactor_shards > min(4, cpus).
    1 (any 1-core box) means the classic single-loop reactor."""
    n = requested
    if n is None:
        from ray_tpu_torch._private.config import CONFIG

        n = CONFIG.rpc_reactor_shards
    n = int(n or 0)
    if n <= 0:
        n = min(4, os.cpu_count() or 1)
    return max(1, n)


Handler = Callable[[Any], Awaitable[Any]]

# Per-method receive sink: sink(payload, nbytes) -> None | (dest_view, done).
# Returning a (writable memoryview, done_callback|None) lands the raw
# payload directly at its final destination (done(ok) fires after the read
# completes); returning None makes the server buffer it into a bytearray.
OobSink = Callable[[Any, int], Optional[Tuple[memoryview, Optional[Callable]]]]


class RpcServer:
    """Serves registered async handlers; one instance per process role."""

    def __init__(self, host: str = "127.0.0.1", shards: Optional[int] = None):
        self._host = host
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        # writer -> owning event loop (close must happen on that loop)
        self._conns: Dict[Any, asyncio.AbstractEventLoop] = {}
        self._validator = None
        self._upgrades: Dict[str, Any] = {}
        self._oob_sinks: Dict[str, OobSink] = {}
        # sharded reactor state (module docstring "Threading model")
        self._shards_requested = shards
        self.num_shards = 1
        self._home_loop: Optional[asyncio.AbstractEventLoop] = None
        self._lsock = None
        self._accept_task = None
        self._next_shard = 0
        self._shard_safe: set = set()

    def set_shard_safe(self, methods):
        """Mark methods whose handlers may run directly on a connection's
        shard loop (thread-safe by construction: pure reads or
        natively-locked state). Everything else hops to the home loop.

        Raises at registration on a name with no registered handler: a
        typo here is otherwise invisible — the real method silently keeps
        hopping home, which is correct but quietly defeats the
        optimization. Register handlers (register/register_all) first.
        """
        methods = set(methods)
        unknown = sorted(m for m in methods if m not in self._handlers)
        if unknown:
            raise ValueError(
                f"set_shard_safe: no registered handler for {unknown} "
                f"(known: {sorted(self._handlers)[:20]}...); register "
                "handlers before marking them shard-safe"
            )
        self._shard_safe.update(methods)

    def set_oob_sink(self, method: str, sink: OobSink):
        """Register a landing sink for MSG_REQUEST_OOB frames of `method`:
        the raw payload streams straight into the memoryview the sink
        returns (e.g. a pre-created plasma buffer at the chunk's offset)
        instead of being buffered on the heap first."""
        self._oob_sinks[method] = sink

    def set_upgrade_hook(self, method: str, hook):
        """Register a connection-upgrade method: ``hook(payload) ->
        (response_payload, adopt_cb | None)``. When adopt_cb is returned the
        socket is detached from asyncio after the response is flushed and
        handed to ``adopt_cb(raw_blocking_socket)`` — the basis of the
        direct call channel (direct_channel.py). The client must not send
        anything after the upgrade request until it reads the response, or
        those bytes would be lost in the asyncio transport buffer."""
        self._upgrades[method] = hook

    def set_validator(self, fn):
        """Optional (method, payload) -> None hook run before dispatch;
        raise to reject (see _private/schema.py typed wire contracts)."""
        self._validator = fn

    def register(self, method: str, handler: Handler):
        self._handlers[method] = handler

    def register_all(self, obj, prefix: str = ""):
        """Register every ``handle_<name>`` coroutine method of obj as <name>."""
        for attr in dir(obj):
            if attr.startswith("handle_"):
                self.register(prefix + attr[len("handle_") :], getattr(obj, attr))

    async def start(self, port: int = 0) -> int:
        self._home_loop = asyncio.get_running_loop()
        self.num_shards = resolve_reactor_shards(self._shards_requested)
        if self.num_shards <= 1:
            self._server = await asyncio.start_server(
                self._on_connection, self._host, port, limit=_MAX_FRAME
            )
            self.port = self._server.sockets[0].getsockname()[1]
            return self.port
        sock = _socket_mod.socket(_socket_mod.AF_INET, _socket_mod.SOCK_STREAM)
        sock.setsockopt(_socket_mod.SOL_SOCKET, _socket_mod.SO_REUSEADDR, 1)
        sock.bind((self._host, port))
        sock.listen(256)
        sock.setblocking(False)
        self._lsock = sock
        self.port = sock.getsockname()[1]
        self._accept_task = asyncio.ensure_future(self._accept_loop())
        return self.port

    async def _accept_loop(self):
        """Accept on the home loop, serve each connection on a shard loop
        picked round-robin (shard 0 IS the home loop, so a 1-shard server
        never crosses threads)."""
        loop = self._home_loop
        while True:
            try:
                conn, _addr = await loop.sock_accept(self._lsock)
            except (asyncio.CancelledError, OSError):
                return
            conn.setblocking(False)
            shard = self._next_shard % self.num_shards
            self._next_shard += 1
            if shard == 0:
                asyncio.ensure_future(self._serve_conn(conn))
            else:
                asyncio.run_coroutine_threadsafe(
                    self._serve_conn(conn), _shard_loop(shard - 1))

    async def _serve_conn(self, sock):
        try:
            reader, writer = await asyncio.open_connection(
                sock=sock, limit=_MAX_FRAME)
        except Exception:
            try:
                sock.close()
            except Exception:
                pass
            return
        await self._on_connection(reader, writer)

    async def stop(self):
        if self._accept_task is not None:
            self._accept_task.cancel()
            self._accept_task = None
        if self._lsock is not None:
            try:
                self._lsock.close()
            except Exception:
                pass
            self._lsock = None
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
        here = asyncio.get_running_loop()
        for w, loop in list(self._conns.items()):
            try:
                if loop is here:
                    w.close()
                else:
                    loop.call_soon_threadsafe(w.close)
            except Exception:
                pass

    async def _on_connection(self, reader, writer):
        self._conns[writer] = asyncio.get_running_loop()
        lock = asyncio.Lock()
        try:
            while True:
                try:
                    msg = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                mtype, seq, method, payload = msg[0], msg[1], msg[2], msg[3]
                if mtype == MSG_REQUEST_OOB:
                    try:
                        payload = await self._land_oob(reader, method, payload, msg[4])
                    except (asyncio.IncompleteReadError, ConnectionResetError):
                        return
                    asyncio.ensure_future(
                        self._dispatch(writer, lock, seq, method, payload)
                    )
                    continue
                if mtype == MSG_REQUEST and method in self._upgrades:
                    try:
                        resp, adopt = self._upgrades[method](payload)
                    except Exception as e:
                        resp, adopt = {"ok": False, "reason": str(e)}, None
                    writer.write(_pack([MSG_RESPONSE, seq, None, resp]))
                    await writer.drain()
                    if adopt is not None:
                        sock = writer.get_extra_info("socket")
                        dup = sock.dup()
                        dup.setblocking(True)
                        self._conns.pop(writer, None)
                        writer.transport.pause_reading()
                        # drain() only waits for the buffer to fall below
                        # the high-water mark; abort() discards whatever is
                        # still buffered. Under a full socket buffer that
                        # loses the upgrade response and costs the client a
                        # timeout + backoff — wait for a true flush first
                        # via the transport's own flow-control signal.
                        await self._flush_transport(writer)
                        # Closes the transport's fd only; the dup keeps the
                        # TCP connection alive for the adopting thread.
                        writer.transport.abort()
                        adopt(dup)
                        return
                    continue
                if mtype == MSG_REQUEST:
                    if _chaos.ARMED:
                        act = _chaos.hit("rpc.recv", method=method)
                        if act is not None:
                            if act["action"] == "drop":
                                continue  # swallowed: the caller times out
                            if act["action"] == "dup":
                                # receiver idempotence under at-least-once
                                # delivery: dispatch the same request twice
                                asyncio.ensure_future(self._dispatch(
                                    writer, lock, seq, method, payload))
                            elif act["action"] == "delay":
                                asyncio.ensure_future(self._dispatch_later(
                                    act["delay_s"], writer, lock, seq,
                                    method, payload))
                                continue
                    asyncio.ensure_future(
                        self._dispatch(writer, lock, seq, method, payload)
                    )
                elif mtype == MSG_NOTIFY:
                    handler = self._handlers.get(method)
                    if handler is not None:
                        asyncio.ensure_future(
                            self._run_notify(method, handler, payload))
        finally:
            self._conns.pop(writer, None)
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    async def _flush_transport(writer, timeout: float = 5.0):
        """Wait for a TRUE transport flush (buffer empty, not merely below
        the high-water mark): shrink the flow-control window to zero so
        ``drain()`` returns only once the kernel accepted every buffered
        byte. This is the transport's own resume_writing signal — no
        polling loop."""
        t = writer.transport
        try:
            if t.get_write_buffer_size() == 0:
                return
            t.set_write_buffer_limits(high=0, low=0)
            await asyncio.wait_for(writer.drain(), timeout)
        except Exception:
            pass

    async def _land_oob(self, reader, method, payload, nbytes: int):
        """Consume an OOB request's raw payload. The method's sink, when
        registered, hands back the final destination buffer (a plasma slice)
        so the bytes never exist as one heap object; otherwise the payload
        buffers into a bytearray. Returns the payload dict annotated with
        "_oob" (int = landed in place via sink; bytearray = buffered)."""
        if nbytes > _MAX_FRAME:
            raise RpcError(f"oob payload too large: {nbytes}")
        payload = dict(payload) if isinstance(payload, dict) else {}
        sink = self._oob_sinks.get(method)
        dest = done = None
        if sink is not None:
            try:
                hooked = sink(payload, nbytes)
            except Exception:
                traceback.print_exc()
                hooked = None
            if hooked is not None:
                dest, done = hooked
        if dest is not None:
            ok = False
            try:
                await _read_oob_into(reader, dest, nbytes)
                ok = True
            finally:
                if done is not None:
                    try:
                        done(ok)
                    except Exception:
                        traceback.print_exc()
            payload["_oob"] = nbytes
        else:
            scratch = bytearray(nbytes)
            await _read_oob_into(reader, memoryview(scratch), nbytes)
            payload["_oob"] = scratch
        return payload

    async def _dispatch_later(self, delay_s, writer, lock, seq, method,
                              payload):
        """Chaos-delayed dispatch (rpc.recv delay action)."""
        await asyncio.sleep(delay_s)
        await self._dispatch(writer, lock, seq, method, payload)

    async def _run_handler(self, method: str, handler, payload):
        """Run a handler with the home-loop dispatch contract: on the home
        loop (or for shard-safe methods) call it in place; from a shard
        loop, hop — the coroutine executes on the home loop and the shard
        awaits its result, so shared handler state never sees two threads.
        The response is packed and written back on the shard."""
        loop = asyncio.get_running_loop()
        if loop is self._home_loop or method in self._shard_safe \
                or self._home_loop is None:
            return await handler(payload)
        cf = asyncio.run_coroutine_threadsafe(handler(payload),
                                              self._home_loop)
        try:
            return await asyncio.wrap_future(cf)
        except asyncio.CancelledError:
            cf.cancel()
            raise

    async def _run_notify(self, method, handler, payload):
        try:
            await self._run_handler(method, handler, payload)
        except Exception:
            traceback.print_exc()

    async def _dispatch(self, writer, lock, seq, method, payload):
        try:
            handler = self._handlers.get(method)
            if handler is None:
                raise RpcError(f"no such method: {method}")
            if self._validator is not None:
                self._validator(method, payload)
            result = await self._run_handler(method, handler, payload)
            if isinstance(result, OobPayload):
                await self._reply_oob(writer, lock, seq, result)
                return
            out = _pack([MSG_RESPONSE, seq, None, result])
        except Exception as e:
            tb = traceback.format_exc()
            try:
                exc_bytes = cloudpickle.dumps(e)
            except Exception:
                exc_bytes = cloudpickle.dumps(RpcError(str(e)))
            out = _pack([MSG_ERROR, seq, tb, exc_bytes])
        async with lock:
            try:
                writer.write(out)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _reply_oob(self, writer, lock, seq, result: OobPayload):
        """Send a response whose bulk payload rides raw after the header —
        the handler's buffer view (e.g. a plasma slice) goes straight to the
        transport, no bytes() and no msgpack encode of the data."""
        hdr, mv = _pack_oob(
            MSG_RESPONSE_OOB, seq, None, result.header, result.data
        )
        async with lock:
            try:
                writer.write(hdr)
                writer.write(mv)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
            finally:
                # the transport owns (a copy of) any unsent tail after
                # write(); the handler's pin can drop now
                result.release()


class RpcClient:
    """Single persistent connection with multiplexed in-flight requests."""

    def __init__(self, host: str, port: int):
        self._host, self._port = host, port
        self._reader = None
        self._writer = None
        self._seq = 0
        self._pending: Dict[int, asyncio.Future] = {}
        # seq -> writable memoryview an OOB response lands into directly
        self._pending_oob_dest: Dict[int, memoryview] = {}
        self._lock: Optional[asyncio.Lock] = None
        self._connected = False
        self._read_task = None

    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    async def connect(self):
        self._reader, self._writer = await asyncio.open_connection(
            self._host, self._port, limit=_MAX_FRAME
        )
        self._lock = asyncio.Lock()
        self._connected = True
        self._read_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self):
        try:
            while True:
                msg = await _read_frame(self._reader)
                mtype, seq, extra, payload = msg[0], msg[1], msg[2], msg[3]
                if mtype == MSG_RESPONSE_OOB:
                    payload = await self._land_oob_response(seq, payload, msg[4])
                fut = self._pending.pop(seq, None)
                self._pending_oob_dest.pop(seq, None)
                if fut is None or fut.done():
                    continue
                if mtype in (MSG_RESPONSE, MSG_RESPONSE_OOB):
                    fut.set_result(payload)
                elif mtype == MSG_ERROR:
                    try:
                        exc = cloudpickle.loads(payload)
                    except Exception:
                        exc = None
                    fut.set_exception(RemoteError(extra, exc))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self._connected = False
            err = ConnectionLost(f"connection to {self._host}:{self._port} lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            self._pending_oob_dest.clear()

    async def _land_oob_response(self, seq: int, payload, nbytes: int):
        """Consume an OOB response's raw payload: straight into the buffer
        the caller registered via call(oob_dest=...) when sizes agree (the
        zero-copy pull path), else into a bytearray."""
        payload = dict(payload) if isinstance(payload, dict) else {}
        dest = self._pending_oob_dest.pop(seq, None)
        if dest is not None and dest.nbytes == nbytes:
            await _read_oob_into(self._reader, dest, nbytes)
            payload["_oob"] = nbytes
        else:
            scratch = bytearray(nbytes)
            await _read_oob_into(self._reader, memoryview(scratch), nbytes)
            payload["_oob"] = scratch
        return payload

    async def call(self, method: str, payload: Any = None, timeout: float = None,
                   oob=None, oob_dest: Optional[memoryview] = None):
        """One request/response round-trip.

        oob: bytes-like sent RAW after the request header (MSG_REQUEST_OOB)
        — the view goes straight to the transport, never copied into a
        packed frame. The caller must keep the underlying buffer valid
        until call() returns (the transport copies any back-pressured tail).
        oob_dest: writable memoryview an out-of-band RESPONSE payload lands
        into directly; on success the response dict carries "_oob" == nbytes.
        """
        if not self._connected:
            raise ConnectionLost(f"not connected to {self._host}:{self._port}")
        self._seq += 1
        seq = self._seq
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        if oob_dest is not None:
            self._pending_oob_dest[seq] = oob_dest
        chaos_act = _chaos.hit("rpc.send", method=method) if _chaos.ARMED \
            else None
        try:
            if chaos_act is not None and chaos_act["action"] == "delay":
                await asyncio.sleep(chaos_act["delay_s"])
            if chaos_act is not None and chaos_act["action"] == "drop":
                pass  # never sent: the caller's timeout is the symptom
            elif oob is not None:
                hdr, mv = _pack_oob(MSG_REQUEST_OOB, seq, method, payload, oob)
                async with self._lock:
                    self._writer.write(hdr)
                    self._writer.write(mv)
                    await self._writer.drain()
            else:
                frame = _pack([MSG_REQUEST, seq, method, payload])
                async with self._lock:
                    self._writer.write(frame)
                    if chaos_act is not None and chaos_act["action"] == "dup":
                        self._writer.write(frame)
                    await self._writer.drain()
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        finally:
            if fut.cancelled() or not fut.done():
                # timeout/cancel: a late OOB response must not land into
                # the caller's buffer after it may have been reused
                self._pending_oob_dest.pop(seq, None)
                self._pending.pop(seq, None)

    async def notify(self, method: str, payload: Any = None):
        if not self._connected:
            raise ConnectionLost(f"not connected to {self._host}:{self._port}")
        frame = _pack([MSG_NOTIFY, 0, method, payload])
        async with self._lock:
            self._writer.write(frame)
            await self._writer.drain()

    def is_connected(self) -> bool:
        return self._connected

    async def close(self):
        self._connected = False
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass


class IoThread:
    """The per-process background asyncio loop (the 'io_service').

    Debug mode (the asyncio runtime's sanitizer analogue — the reference
    ships tsan/asan build configs, .bazelrc :104; a single-threaded asyncio
    control plane's failure mode is instead a BLOCKED loop): set
    ``RTPU_TORCH_DEBUG_LOOP_MS=<n>`` to (a) log callbacks that hold the loop
    longer than n ms via asyncio's slow-callback detector and (b) run a
    watchdog thread that dumps all stacks if the loop stops ticking for
    10×n ms — catching accidental sync work (ray_tpu_torch.get etc.) posted onto
    the io loop, the class of deadlock the client-server had."""

    _singleton = None
    _singleton_lock = threading.Lock()

    def __init__(self, name="rtpu-io"):
        import os as _os

        self.loop = asyncio.new_event_loop()
        self._debug_ms = float(_os.environ.get("RTPU_TORCH_DEBUG_LOOP_MS", "0") or 0)
        if self._debug_ms > 0:
            self.loop.slow_callback_duration = self._debug_ms / 1000.0
            self.loop.set_debug(True)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()
        if self._debug_ms > 0:
            self._last_tick = 0.0
            threading.Thread(
                target=self._watchdog, name=name + "-watchdog", daemon=True
            ).start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def _watchdog(self):
        import faulthandler
        import sys
        import time as _time

        stall = self._debug_ms * 10 / 1000.0
        self._last_tick = _time.monotonic()

        async def _tick():
            self._last_tick = _time.monotonic()

        warned = 0.0
        while True:
            _time.sleep(stall / 2)
            try:
                asyncio.run_coroutine_threadsafe(_tick(), self.loop)
            except RuntimeError:
                return  # loop closed
            _time.sleep(stall / 2)
            now = _time.monotonic()
            if now - self._last_tick > stall and now - warned > 5.0:
                warned = now
                print(
                    f"[rtpu-io watchdog] io loop blocked > {stall:.2f}s — "
                    "sync work is running on the io thread; stacks follow",
                    file=sys.stderr, flush=True,
                )
                faulthandler.dump_traceback(file=sys.stderr)

    @classmethod
    def current(cls) -> "IoThread":
        with cls._singleton_lock:
            if cls._singleton is None or not cls._singleton._thread.is_alive():
                cls._singleton = cls()
            return cls._singleton

    def run(self, coro, timeout=None):
        """Run a coroutine on the io loop from a foreign (sync) thread."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def post(self, coro):
        """Fire-and-forget a coroutine on the io loop."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop)


class ClientPool:
    """Cache of RpcClients keyed by address, created lazily on the io loop."""

    def __init__(self):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._locks: Dict[Tuple[str, int], asyncio.Lock] = {}

    async def get(self, host: str, port: int) -> RpcClient:
        key = (host, port)
        client = self._clients.get(key)
        if client is not None and client.is_connected():
            return client
        lock = self._locks.setdefault(key, asyncio.Lock())
        async with lock:
            client = self._clients.get(key)
            if client is not None and client.is_connected():
                return client
            client = RpcClient(host, port)
            await client.connect()
            self._clients[key] = client
            return client

    async def close_all(self):
        for c in self._clients.values():
            await c.close()
        self._clients.clear()
