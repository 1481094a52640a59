"""Mutable shared-memory channels for compiled actor DAGs, the port of
``ray_tpu/experimental/channel.py``.

A channel is a plasma object that is sealed once and then *mutated in
place* (reference: python/ray/experimental/channel/shared_memory_channel.py:147,
src/ray/core_worker/experimental_mutable_object_manager.h:39): every process
on the node maps the same writable segment of the port's store, so handoff is
one memcpy with no RPC, no allocation, and no per-step object creation.

Protocol (single writer, up to MAX_READERS readers, buffer depth 1):

    header: [u64 write_seq][u64 data_len][u32 flags][u32 n_readers]
            [u64 ack_seq x MAX_READERS]
    body:   serialized payload (serialization.write_blob format)

- writer: wait until every registered reader's ack_seq == write_seq
  (previous value consumed), write body + data_len + flags, memory fence,
  then publish write_seq+1.
- reader r: wait until write_seq > last seen, read body, set ack_seq[r].
Because the writer never mutates while a reader is between "observe seq"
and "ack", readers never see torn data. Blocking is a futex wait on the
header words (adaptive spin where there is no futex); a teardown flag
turns every blocked peer into ChannelClosed.

Torch tensors ride the port's serializer, as they do through ``put``: a
CUDA tensor is copied to the host once when it is written, and every
reader rebuilds it as a CPU tensor of the same dtype (bf16 included); the
reading stage moves it to its own device. There is no NCCL channel (the
JAX package has none either). The header layout and flags are the JAX
package's.
"""

from __future__ import annotations

import ctypes
import os
import platform
import struct
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID

MAX_READERS = 8
_HEADER = struct.Struct("<QQII" + "Q" * MAX_READERS)
_FLAG_ERROR = 1
_FLAG_CLOSED = 2

DEFAULT_BUFFER_SIZE = 4 * 1024 * 1024


# --------------------------------------------------------------------- futex
# Event-based blocking on the shared header words (reference analogue: the
# mutable-object manager blocks on a sema,
# core_worker/experimental_mutable_object_manager.h:39). A blocked peer
# sleeps in the kernel instead of burning a core in a spin loop; wakers are
# the writer's publish and each reader's ack. Falls back to adaptive spin
# where the futex syscall is unavailable.

_SYS_FUTEX = {"x86_64": 202, "aarch64": 98}.get(platform.machine())
_FUTEX_WAIT = 0
_FUTEX_WAKE = 1


class _timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


try:
    _libc = ctypes.CDLL(None, use_errno=True)
    _libc.syscall  # probe
except Exception:  # pragma: no cover - non-POSIX
    _libc = None

# futex is Linux-only: on other POSIX systems the same syscall number is
# an unrelated call, so gate on the OS, not just the arch
_FUTEX_OK = (
    _SYS_FUTEX is not None
    and _libc is not None
    and platform.system() == "Linux"
)


def _futex_wait(addr: int, expected_u32: int, timeout: float):
    """Sleep while *(u32*)addr == expected, up to timeout seconds. Spurious
    returns (EINTR/EAGAIN/timeout) are fine — callers re-check their
    predicate."""
    ts = _timespec(int(timeout), int((timeout % 1.0) * 1e9))
    _libc.syscall(
        _SYS_FUTEX, ctypes.c_void_p(addr), _FUTEX_WAIT,
        ctypes.c_uint(expected_u32), ctypes.byref(ts), None, 0,
    )


def _futex_wake(addr: int):
    _libc.syscall(
        _SYS_FUTEX, ctypes.c_void_p(addr), _FUTEX_WAKE,
        ctypes.c_int(0x7FFFFFFF), None, None, 0,
    )


class ChannelClosed(Exception):
    pass


class ChannelFull(Exception):
    pass


def _plasma():
    from ray_tpu_torch._private.worker import get_global_worker

    return get_global_worker().plasma


class Channel:
    """One-writer/N-reader mutable shared-memory slot.

    Create with ``Channel.create(n_readers)`` on the driver; ship the
    descriptor (``.descriptor()``) to actors which ``Channel.attach`` it with
    their reader index (or as writer with ``reader_index=None``).
    """

    def __init__(self, oid: bytes, view, reader_index: Optional[int],
                 n_readers: int, own_view=None):
        self._oid = oid
        self._view = view  # writable memoryview over the plasma payload
        self._reader_index = reader_index
        self._n_readers = n_readers
        # Resume from this reader's own ack slot — NOT the current write seq:
        # a value published before the reader attached must still be read.
        if reader_index is not None:
            self._last_seen = _HEADER.unpack_from(view, 0)[4 + reader_index]
        else:
            self._last_seen = 0
        self._own = own_view
        # base address of the mapped header for futex waits (0 = fall back
        # to spin: non-Linux, or a non-ctypes-mappable buffer)
        try:
            self._base_addr = (
                ctypes.addressof(ctypes.c_char.from_buffer(view))
                if _FUTEX_OK else 0
            )
        except Exception:
            self._base_addr = 0

    # ------------------------------------------------------------ lifecycle

    @staticmethod
    def create(n_readers: int, buffer_size: int = DEFAULT_BUFFER_SIZE):
        if not (1 <= n_readers <= MAX_READERS):
            raise ValueError(f"n_readers must be in [1, {MAX_READERS}]")
        plasma = _plasma()
        oid = os.urandom(20)
        total = _HEADER.size + buffer_size
        buf = plasma.create(oid, total)
        buf[: _HEADER.size] = _HEADER.pack(0, 0, 0, n_readers,
                                           *([0] * MAX_READERS))
        buf.release()
        plasma.seal(oid)
        view = plasma.get(oid)  # pins; writable (shared PROT_WRITE mapping)
        return Channel(oid, view, None, n_readers, own_view=view)

    @staticmethod
    def attach(descriptor: dict, reader_index: Optional[int]):
        plasma = _plasma()
        view = plasma.get(descriptor["oid"])
        if view is None:
            raise ChannelClosed(
                f"channel object {descriptor['oid'].hex()} not found"
            )
        return Channel(descriptor["oid"], view, reader_index,
                       descriptor["n_readers"], own_view=view)

    def descriptor(self) -> dict:
        return {"oid": self._oid, "n_readers": self._n_readers}

    def close(self):
        """Mark closed; blocked peers raise ChannelClosed."""
        flags = struct.unpack_from("<I", self._view, 16)[0]
        struct.pack_into("<I", self._view, 16, flags | _FLAG_CLOSED)
        if self._base_addr:
            _futex_wake(self._base_addr)  # seq waiters
            for r in range(self._n_readers):
                _futex_wake(self._base_addr + 24 + 8 * r)  # ack waiters

    def release(self):
        try:
            if self._own is not None:
                self._own.release()
                _plasma().release(ObjectID(self._oid))
                self._own = None
        except Exception:
            pass

    def destroy(self):
        self.close()
        self.release()
        try:
            _plasma().delete(ObjectID(self._oid))
        except Exception:
            pass

    # ------------------------------------------------------------- plumbing

    def _peek_seq(self) -> int:
        return struct.unpack_from("<Q", self._view, 0)[0]

    def _flags(self) -> int:
        return struct.unpack_from("<I", self._view, 16)[0]

    def _acks(self):
        return _HEADER.unpack_from(self._view, 0)[4:4 + self._n_readers]

    @staticmethod
    def _spin(predicate, timeout: Optional[float], what: str):
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.0
        while not predicate():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"channel {what} timed out")
            if delay:
                time.sleep(delay)
            delay = min((delay or 5e-5) * 2, 1e-3)

    # ------------------------------------------------------------------- io

    def write(self, value: Any, timeout: Optional[float] = None,
              is_error: bool = False):
        seq = self._peek_seq()

        def consumed():
            if self._flags() & _FLAG_CLOSED:
                raise ChannelClosed("channel closed")
            return all(a >= seq for a in self._acks())

        if self._base_addr:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not consumed():
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("channel write timed out")
                acks = self._acks()
                for r, a in enumerate(acks):
                    if a < seq:
                        # sleep until reader r's ack word changes (each ack
                        # slot has a single writing process, so the low
                        # 32 bits are a valid futex value)
                        _futex_wait(
                            self._base_addr + 24 + 8 * r,
                            a & 0xFFFFFFFF, 0.2,
                        )
                        break
        else:
            self._spin(consumed, timeout, "write")
        # raw protocol-5 buffers stream straight into the shared-memory ring
        # (one copy total) — same discipline as the plasma put path
        p, bufs, _refs = serialization.serialize(value)
        size = serialization.blob_size(p, bufs)
        cap = len(self._view) - _HEADER.size
        if size > cap:
            raise ChannelFull(
                f"serialized value is {size} bytes; channel buffer is {cap} "
                "(pass a larger buffer_size_bytes to experimental_compile)"
            )
        serialization.write_blob(self._view[_HEADER.size:], p, bufs)
        struct.pack_into("<QI", self._view, 8, size,
                         _FLAG_ERROR if is_error else 0)
        # publish: plain store is a fence-enough on x86/ARM under the GIL
        struct.pack_into("<Q", self._view, 0, seq + 1)
        if self._base_addr:
            _futex_wake(self._base_addr)

    def read(self, timeout: Optional[float] = None) -> Any:
        """Blocking read of the next value; deserializes a fresh copy."""
        r = self._reader_index
        if r is None:
            raise RuntimeError("writer end cannot read")

        def available():
            if self._flags() & _FLAG_CLOSED:
                raise ChannelClosed("channel closed")
            return self._peek_seq() > self._last_seen

        if self._base_addr:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not available():
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("channel read timed out")
                _futex_wait(
                    self._base_addr, self._last_seen & 0xFFFFFFFF, 0.2
                )
        else:
            self._spin(available, timeout, "read")
        seq = self._peek_seq()
        size, flags = struct.unpack_from("<QI", self._view, 8)
        body = self._view[_HEADER.size:_HEADER.size + size]
        value, _refs = serialization.read_blob(bytes(body))
        self._last_seen = seq
        struct.pack_into("<Q", self._view, 24 + 8 * r, seq)
        if self._base_addr:
            _futex_wake(self._base_addr + 24 + 8 * r)
        if flags & _FLAG_ERROR:
            raise _PropagatedError(value)
        return value


class _PropagatedError(Exception):
    """Wraps an upstream exception flowing through a channel."""

    def __init__(self, inner):
        super().__init__(repr(inner))
        self.inner = inner


# ------------------------------------------------------------ socket channel


class SocketChannel:
    """Cross-node channel edge: the same single-writer/N-reader depth-1
    write/ack protocol as the shm Channel, over persistent TCP streams.

    This is the hop between nodes of a pipeline: where the reference moves
    GPU tensors over NCCL p2p
    (python/ray/experimental/channel/torch_tensor_nccl_channel.py:191),
    this edge rides the hosts' TCP streams, and a CUDA tensor crosses it
    as its host copy; the edges within a node stay on shared memory.

    Wire: writer listens; each reader connects and sends [u32 reader_idx].
    Value frames writer->reader: [u64 seq][u32 flags][u64 len][payload];
    ack frames reader->writer: [u64 seq]. The writer publishes seq N only
    after every reader acked N-1 (depth 1), matching the shm semantics so
    the compiled-DAG exec loop treats both identically.
    """

    def __init__(self, n_readers: int):
        self._n_readers = n_readers
        self._server = None
        self._conns: Dict[int, Any] = {}
        self._seq = 0
        self._closed = False
        self._addr = None
        self._token = os.urandom(8)
        self._acked: Dict[int, int] = {}  # per reader: last ack consumed
        self._rxbuf: Dict[int, bytearray] = {}  # per reader: partial acks

    def _recv_buffered(self, ridx, conn, n: int, deadline) -> bytes:
        buf = self._rxbuf.setdefault(ridx, bytearray())
        return _buffered_recv_exact(
            conn, buf, n, deadline,
            timeout_msg="channel write timed out awaiting ack",
            closed_msg=f"reader {ridx} gone",
        )

    # --------------------------------------------------------------- writer

    @staticmethod
    def create(n_readers: int, buffer_size: int = 0) -> "SocketChannel":
        import socket as _socket

        ch = SocketChannel(n_readers)
        srv = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        srv.bind((_node_ip(), 0))
        srv.listen(n_readers)
        ch._server = srv
        ch._addr = srv.getsockname()
        import threading

        t = threading.Thread(target=ch._accept_loop, daemon=True,
                             name="rtpu-chan-accept")
        t.start()
        return ch

    def _accept_loop(self):
        import socket as _socket

        try:
            while len(self._conns) < self._n_readers and not self._closed:
                conn, _ = self._server.accept()
                conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                tok = _recv_exact(conn, 8)
                ridx = struct.unpack("<I", _recv_exact(conn, 4))[0]
                if tok != self._token or not (0 <= ridx < self._n_readers):
                    conn.close()
                    continue
                self._conns[ridx] = conn
        except OSError:
            return  # closed during accept

    def descriptor(self) -> dict:
        return {
            "type": "socket",
            "addr": list(self._addr),
            "n_readers": self._n_readers,
            "token": self._token,
        }

    def write(self, value: Any, timeout: Optional[float] = None,
              is_error: bool = False):
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(self._conns) < self._n_readers:
            if self._closed:
                raise ChannelClosed("channel closed")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("channel write timed out (readers absent)")
            time.sleep(0.005)
        if self._seq > 0:
            # depth-1 backpressure: collect every reader's ack of seq-1.
            # Resumable buffered recv: a timeout mid-ack must not desync
            # the stream (the bytes stay buffered for the retry), and must
            # surface as TimeoutError like the shm channel, not
            # ChannelClosed.
            for ridx, conn in self._conns.items():
                if self._acked.get(ridx, 0) >= self._seq:
                    continue  # already consumed on an earlier (timed-out) try
                ack = struct.unpack(
                    "<Q", self._recv_buffered(ridx, conn, 8, deadline)
                )[0]
                if ack != self._seq:
                    raise ChannelClosed(
                        f"protocol error: reader {ridx} acked {ack}, "
                        f"expected {self._seq}"
                    )
                self._acked[ridx] = ack
        blob = serialization.serialize_to_blob(value)
        self._seq += 1
        header = struct.pack("<QIQ", self._seq,
                             _FLAG_ERROR if is_error else 0, len(blob))
        for ridx, conn in list(self._conns.items()):
            # Honor the caller's deadline during the send too: a reader
            # stalled with a full kernel buffer must not block forever.
            # A deadline that is ALREADY spent raises retryable
            # TimeoutError before any bytes go out; a timeout mid-frame is
            # unrecoverable for this stream (sendall may have written part
            # of the frame) -> ChannelClosed.
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0.05:
                raise TimeoutError("channel write timed out before send")
            conn.settimeout(remaining)
            try:
                conn.sendall(header + blob)
            except TimeoutError:
                raise ChannelClosed(
                    f"reader {ridx} stalled mid-frame (send timeout)"
                )
            except OSError as e:
                raise ChannelClosed(f"reader {ridx} gone: {e}")

    # --------------------------------------------------------------- reader

    @staticmethod
    def attach(descriptor: dict, reader_index: int) -> "_SocketReader":
        return _SocketReader(descriptor, reader_index)

    # ------------------------------------------------------------ lifecycle

    def close(self):
        self._closed = True
        for conn in self._conns.values():
            try:
                conn.close()
            except Exception:
                pass
        try:
            self._server.close()
        except Exception:
            pass

    def destroy(self):
        self.close()


class _SocketReader:
    def __init__(self, descriptor: dict, reader_index: int):
        import socket as _socket

        if reader_index is None:
            raise RuntimeError(
                "socket channel writer must be the creating process"
            )
        self._sock = _socket.create_connection(
            tuple(descriptor["addr"]), timeout=30
        )
        self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._sock.sendall(
            descriptor["token"] + struct.pack("<I", reader_index)
        )
        self._sock.settimeout(None)
        self._rxbuf = bytearray()
        self._hdr = None  # parsed header of a frame whose body is pending

    def _recv_exact(self, n: int, deadline) -> bytes:
        return _buffered_recv_exact(
            self._sock, self._rxbuf, n, deadline,
            timeout_msg="channel read timed out",
            closed_msg="writer closed the channel",
        )

    def read(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._hdr is None:
            self._hdr = struct.unpack("<QIQ", self._recv_exact(20, deadline))
        seq, flags, length = self._hdr
        body = self._recv_exact(length, deadline)
        self._hdr = None
        value, _refs = serialization.read_blob(memoryview(body))
        try:
            self._sock.sendall(struct.pack("<Q", seq))
        except OSError:
            raise ChannelClosed("writer gone at ack")
        if flags & _FLAG_ERROR:
            raise _PropagatedError(value)
        return value

    def close(self):
        try:
            self._sock.close()
        except Exception:
            pass

    def destroy(self):
        self.close()


def _buffered_recv_exact(sock, buf: bytearray, n: int, deadline,
                         timeout_msg: str, closed_msg: str) -> bytes:
    """Shared resumable recv over a caller-owned bytearray: consumes and
    returns n bytes once available. Partial bytes accumulate IN PLACE, so
    they survive a timeout and a retry continues mid-frame instead of
    desyncing the stream. TimeoutError means retryable; ChannelClosed
    means the peer is gone."""
    while len(buf) < n:
        sock.settimeout(
            None if deadline is None
            else max(0.01, deadline - time.monotonic())
        )
        try:
            chunk = sock.recv(n - len(buf))
        except TimeoutError:
            raise TimeoutError(timeout_msg) from None
        except OSError as e:
            raise ChannelClosed(f"{closed_msg}: {e}")
        if not chunk:
            raise ChannelClosed(closed_msg)
        buf += chunk
    out = bytes(buf[:n])
    del buf[:n]
    return out


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("socket closed")
        buf += chunk
    return buf


def _node_ip() -> str:
    """The address this process's node is reached at: the worker's own
    (``address[0]``, as ``util.collective`` resolves it), never a
    ``gethostbyname`` of the host name."""
    from ray_tpu_torch._private.worker import get_global_worker

    try:
        return get_global_worker().address[0]
    except Exception:
        return "127.0.0.1"


# -------------------------------------------------- registry + attach helper
# Channels created inside an actor process on behalf of a compiled DAG are
# kept alive (and torn down) through this registry, keyed by a token the
# driver holds.

_registry: Dict[bytes, Any] = {}


def register_channel(token: bytes, ch) -> bytes:
    _registry[token] = ch
    return token


def close_registered(token: bytes):
    ch = _registry.pop(token, None)
    if ch is not None:
        try:
            ch.destroy()
        except Exception:
            pass


def attach_channel(descriptor: dict, reader_index: Optional[int]):
    """Attach either channel kind from its descriptor. The writer end of a
    socket channel only exists in its creating process — resolve it from
    the registry there."""
    if descriptor.get("type") == "socket":
        if reader_index is None:
            ch = _registry.get(descriptor["token"])
            if ch is None:
                raise ChannelClosed("socket channel writer not in this process")
            return ch
        return SocketChannel.attach(descriptor, reader_index)
    return Channel.attach(descriptor, reader_index)
