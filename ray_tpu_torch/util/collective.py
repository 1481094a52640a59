"""ray_tpu_torch.util.collective — host-side collective communication groups.

API parity with the reference's ray.util.collective (collective.py:
init_collective_group :120, create_collective_group :151, allreduce :258,
barrier :298, broadcast :373, allgather :423, reducescatter :472, send :531,
recv :594). Two planes, per SURVEY.md §2.4:

- **Device plane (CUDA)**: collectives between cards run over NCCL through
  ``torch.distributed`` (a mesh and ``ray_tpu_torch.parallel``'s
  collectives) — you don't call this module for those.
- **Host plane (this module)**: numpy arrays and torch tensors between
  actors/tasks over a TCP ring with GCS-KV rendezvous — the Gloo replacement
  (reference gloo_collective_group.py:184 rendezvoused via the Ray internal
  KV :66).

The ring implementation: rank r listens on an ephemeral port, publishes its
address in the GCS KV under the group name, and lazily opens one socket per
peer pair (lower rank dials, higher rank accepts). allreduce is the classic
ring: world-1 reduce-scatter steps + world-1 all-gather steps, so bandwidth
is 2·(w-1)/w · payload regardless of world size.

numpy arrays take the same ring, in the same chunk order, as in the JAX
package, so the results are bitwise the same. A ``torch.Tensor`` is taken on
any device: its bytes go to the host once (a CUDA tensor's one copy to the
host; a contiguous CPU tensor's own storage), the ring runs on them, and
they come back once into the tensor, which is updated in place wherever
an array would be, and returned on its own device. bf16 has no numpy
dtype without ml_dtypes: its bits travel as int16 and each ring step
reduces them with torch's CPU ops, one rounding a step, as ml_dtypes'
ufuncs do. torch is never imported here: a tensor's module is found in
``sys.modules``.
"""

from __future__ import annotations

import socket
import struct
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

_KV_NS = "collective"
_CONNECT_TIMEOUT = 60.0


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: lambda a, b: np.add(a, b, out=a),
    ReduceOp.PRODUCT: lambda a, b: np.multiply(a, b, out=a),
    ReduceOp.MIN: lambda a, b: np.minimum(a, b, out=a),
    ReduceOp.MAX: lambda a, b: np.maximum(a, b, out=a),
}


def _worker():
    from ray_tpu_torch._private.worker import get_global_worker

    return get_global_worker()


def _kv():
    return _worker().gcs


def _send_msg(sock: socket.socket, payload):
    """One length-prefixed frame; ``payload`` is any contiguous buffer (an
    array's chunk is sent from its own memory, never copied to bytes)."""
    if isinstance(payload, np.ndarray):
        payload = np.ascontiguousarray(payload).reshape(-1).view(np.uint8)
    view = memoryview(payload).cast("B")
    sock.sendall(struct.pack("<Q", view.nbytes))
    sock.sendall(view)


def _recv_msg(sock: socket.socket) -> bytearray:
    hdr = _recv_exact(sock, 8)
    (n,) = struct.unpack("<Q", hdr)
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes, received into one buffer that the caller keeps (an
    array over it is writeable)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("collective peer closed connection")
        got += r
    return buf


@dataclass
class _Group:
    name: str
    rank: int
    world_size: int
    listener: Optional[socket.socket] = None
    port: int = 0

    def __post_init__(self):
        self._conns: Dict[int, socket.socket] = {}
        self._incoming: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # Serializes connection establishment so concurrent _conn(peer) calls
        # (e.g. world_size==2, where the send and recv neighbor are the same
        # peer) cannot both miss the cache and dial twice. Safe to hold while
        # waiting: a dial never blocks on the remote peer's establish lock,
        # only on its listener (created before KV registration).
        self._estab_lock = threading.Lock()
        if self.world_size > 1:
            self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind(("", 0))
            self.listener.listen(self.world_size)
            self.port = self.listener.getsockname()[1]
            t = threading.Thread(target=self._accept_loop, daemon=True)
            t.start()

    # ------------------------------------------------------------ plumbing

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer_rank = struct.unpack("<I", _recv_exact(conn, 4))[0]
            with self._cv:
                self._incoming[peer_rank] = conn
                self._cv.notify_all()

    def _conn(self, peer: int) -> socket.socket:
        """One socket per pair: the lower rank dials, the higher accepts."""
        # Fast path outside _estab_lock: a cached-peer send must not stall
        # behind another thread's in-progress (up to 60 s) establishment.
        with self._lock:
            if peer in self._conns:
                return self._conns[peer]
        with self._estab_lock:
            with self._lock:
                if peer in self._conns:
                    return self._conns[peer]
            if self.rank < peer:
                addr = _wait_for_addr(self.name, peer)
                s = socket.create_connection(addr, timeout=_CONNECT_TIMEOUT)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(None)
                s.sendall(struct.pack("<I", self.rank))
            else:
                deadline = time.time() + _CONNECT_TIMEOUT
                with self._cv:
                    while peer not in self._incoming:
                        left = deadline - time.time()
                        if left <= 0:
                            raise TimeoutError(
                                f"rank {self.rank}: no connection from rank "
                                f"{peer}"
                            )
                        self._cv.wait(left)
                    s = self._incoming[peer]
            with self._lock:
                self._conns[peer] = s
            return s

    def send_bytes(self, peer: int, payload):
        _send_msg(self._conn(peer), payload)

    def recv_bytes(self, peer: int) -> bytearray:
        return _recv_msg(self._conn(peer))

    def close(self):
        if self.listener is not None:
            try:
                self.listener.close()
            except OSError:
                pass
        for s in list(self._conns.values()):
            try:
                s.close()
            except OSError:
                pass


_groups: Dict[str, _Group] = {}


def _wait_for_addr(group_name: str, rank: int):
    kv = _kv()
    key = f"{group_name}/{rank}".encode()
    deadline = time.time() + _CONNECT_TIMEOUT
    while time.time() < deadline:
        v = kv.kv_get(_KV_NS, key)
        if v:
            host, port = v.decode().rsplit(":", 1)
            return host, int(port)
        time.sleep(0.02)
    raise TimeoutError(f"rank {rank} of group '{group_name}' never registered")


# ============================================================== public API


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "ring",
    group_name: str = "default",
):
    """Call on every participant (reference: collective.py:120)."""
    if backend not in ("ring", "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if group_name in _groups:
        raise RuntimeError(f"group '{group_name}' already initialized")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    g = _Group(group_name, rank, world_size)
    if world_size > 1:
        # the host this process's runtime RPC serves on: every peer of the
        # cluster reaches it (a machine's hostname need not resolve)
        ip = _worker().address[0]
        _kv().kv_put(_KV_NS, f"{group_name}/{rank}".encode(),
                     f"{ip}:{g.port}".encode())
    _groups[group_name] = g
    return g


def create_collective_group(
    actors: List,
    world_size: int,
    ranks: List[int],
    backend: str = "ring",
    group_name: str = "default",
):
    """Declarative setup from the driver (reference: collective.py:151):
    remotely initializes the group on every actor, in parallel."""
    import ray_tpu_torch

    refs = [
        actor.__ray_call__.remote(
            lambda self, *, _w=world_size, _r=rank, _b=backend, _g=group_name:
            init_collective_group(_w, _r, _b, _g) and None
        )
        for actor, rank in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs)


def destroy_collective_group(group_name: str = "default"):
    g = _groups.pop(group_name, None)
    if g is not None:
        try:
            _kv().kv_del(_KV_NS, f"{group_name}/{g.rank}".encode())
        except Exception:
            pass
        g.close()


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def _get(group_name: str) -> _Group:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' is not initialized; call "
            "init_collective_group/create_collective_group first"
        )
    return g


def _torch_of(x):
    """torch, where ``x`` is a ``torch.Tensor``; else None. Found in
    ``sys.modules``: whoever made a tensor has loaded torch already."""
    torch = sys.modules.get("torch")
    return torch if torch is not None and isinstance(x, torch.Tensor) else None


def _staged(tensor):
    """``(a, host)``: the numpy array the ring sends and reduces, and for a
    torch tensor its contiguous host tensor, whose memory ``a`` is (bf16
    seen as int16 bits); ``host`` is None for anything else."""
    torch = _torch_of(tensor)
    if torch is None:
        return np.ascontiguousarray(tensor), None
    host = tensor.detach().to("cpu").contiguous()
    bits = host.view(torch.int16) if host.dtype == torch.bfloat16 else host
    return bits.numpy(), host


def _unstaged(tensor, host):
    """Write ``host`` back into ``tensor`` where it is not the tensor's own
    memory (one copy to a CUDA tensor), and return the tensor."""
    if host.data_ptr() != tensor.data_ptr():
        with _torch_of(tensor).no_grad():
            tensor.copy_(host)
    return tensor


def _as_tensor(a: np.ndarray, like):
    """An array the ring made, as a tensor of ``like``'s dtype on its device."""
    torch = _torch_of(like)
    t = torch.from_numpy(a)
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def _reducer(op: str, host):
    """The in-place reduction of one ring step: numpy's ufunc, or for bf16
    tensors torch's CPU op on the int16 bits seen as bf16."""
    torch = _torch_of(host)
    if torch is None or host.dtype != torch.bfloat16:
        return _REDUCERS[op]
    fn = {ReduceOp.SUM: torch.add, ReduceOp.PRODUCT: torch.mul,
          ReduceOp.MIN: torch.minimum, ReduceOp.MAX: torch.maximum}[op]

    def reduce(a, b):
        ta = torch.from_numpy(a).view(torch.bfloat16)
        fn(ta, torch.from_numpy(b).view(torch.bfloat16), out=ta)
        return a

    return reduce


def _sendrecv(g: _Group, right: int, left: int, out) -> bytearray:
    """Send to the right neighbor while receiving from the left."""
    box = {}

    def _tx():
        g.send_bytes(right, out)

    t = threading.Thread(target=_tx, daemon=True)
    t.start()
    box["rx"] = g.recv_bytes(left)
    t.join()
    return box["rx"]


def allreduce(tensor, group_name: str = "default", op: str = ReduceOp.SUM):
    """In-place ring allreduce; also returns the reduced array (a torch
    tensor: the tensor itself, on its device)."""
    from ray_tpu_torch._private import flight_recorder as _fr

    g = _get(group_name)
    a, host = _staged(tensor)
    if not a.flags.writeable:
        a = a.copy()  # zero-copy object-store views are read-only
    if g.world_size == 1:
        return a if host is None else tensor
    # enter/exit bracket: a rank stuck INSIDE the collective (the classic
    # mismatched-collective hang) shows an unmatched collective.enter in
    # its flight-recorder tail — the single most valuable hang breadcrumb
    _fr.record("collective.enter",
               f"{group_name}:r{g.rank}".encode(), f"allreduce {a.nbytes}B")
    try:
        _allreduce_ring(g, a, _reducer(op, host))
    finally:
        _fr.record("collective.exit",
                   f"{group_name}:r{g.rank}".encode(), "allreduce")
    if host is not None:
        return _unstaged(tensor, host)
    if (isinstance(tensor, np.ndarray) and tensor is not a
            and tensor.flags.writeable):
        tensor[...] = a.reshape(tensor.shape)
    return a.reshape(np.shape(tensor))


def _allreduce_ring(g, a, reduce_fn):
    """Reduce ``a`` over the group, in place: reduce-scatter, then
    all-gather, one chunk a step."""
    w, r = g.world_size, g.rank
    right, left = (r + 1) % w, (r - 1) % w
    flat = a.reshape(-1)
    chunks = np.array_split(flat, w)
    offsets = np.cumsum([0] + [c.size for c in chunks])
    # reduce-scatter
    for step in range(w - 1):
        send_idx = (r - step) % w
        recv_idx = (r - step - 1) % w
        rx = _sendrecv(g, right, left, chunks[send_idx])
        incoming = np.frombuffer(rx, dtype=a.dtype)
        seg = flat[offsets[recv_idx]:offsets[recv_idx + 1]]
        reduce_fn(seg, incoming)
    # all-gather
    for step in range(w - 1):
        send_idx = (r - step + 1) % w
        recv_idx = (r - step) % w
        rx = _sendrecv(g, right, left, chunks[send_idx])
        flat[offsets[recv_idx]:offsets[recv_idx + 1]] = np.frombuffer(
            rx, dtype=a.dtype
        )


def barrier(group_name: str = "default"):
    g = _get(group_name)
    if g.world_size == 1:
        return
    allreduce(np.zeros(1, np.int8), group_name)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Ring pipeline broadcast from src_rank; in-place on non-src ranks."""
    g = _get(group_name)
    a, host = _staged(tensor)
    if g.world_size == 1:
        return a if host is None else tensor
    w, r = g.world_size, g.rank
    right, left = (r + 1) % w, (r - 1) % w
    if r == src_rank:
        g.send_bytes(right, a)
        return a if host is None else tensor
    data = g.recv_bytes(left)
    if right != src_rank:
        g.send_bytes(right, data)
    got = np.frombuffer(data, dtype=a.dtype).reshape(a.shape)
    if host is not None:
        a[...] = got
        return _unstaged(tensor, host)
    a = got.reshape(np.shape(tensor)).copy()
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        tensor[...] = a
    return a


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    """Returns [rank0_tensor, ..., rankN-1_tensor] (functional form; the
    reference fills a tensor_list in place — same data); tensors on the
    argument's device for a torch tensor."""
    g = _get(group_name)
    a, host = _staged(tensor)
    w, r = g.world_size, g.rank
    out: List[Optional[np.ndarray]] = [None] * w
    out[r] = a.copy()
    if w > 1:
        right, left = (r + 1) % w, (r - 1) % w
        for step in range(w - 1):
            send_idx = (r - step) % w
            recv_idx = (r - step - 1) % w
            rx = _sendrecv(g, right, left, out[send_idx])
            out[recv_idx] = np.frombuffer(rx, dtype=a.dtype).reshape(a.shape)
    if host is not None:
        return [_as_tensor(x, tensor) for x in out]
    return out  # type: ignore[return-value]


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM) -> np.ndarray:
    """Reduce across ranks, return this rank's 1/world shard (reference
    :472 takes a tensor list; here the input is the full array); a tensor
    on the argument's device for a torch tensor."""
    g = _get(group_name)
    a, host = _staged(tensor)
    a = a.copy()
    w, r = g.world_size, g.rank
    flat = a.reshape(-1)
    chunks = np.array_split(flat, w)
    offsets = np.cumsum([0] + [c.size for c in chunks])
    if w == 1:
        return flat if host is None else _as_tensor(flat, tensor)
    right, left = (r + 1) % w, (r - 1) % w
    reduce_fn = _reducer(op, host)
    for step in range(w - 1):
        send_idx = (r - step) % w
        recv_idx = (r - step - 1) % w
        rx = _sendrecv(g, right, left, chunks[send_idx])
        seg = flat[offsets[recv_idx]:offsets[recv_idx + 1]]
        reduce_fn(seg, np.frombuffer(rx, dtype=a.dtype))
    mine = (r + 1) % w
    shard = flat[offsets[mine]:offsets[mine + 1]].copy()
    return shard if host is None else _as_tensor(shard, tensor)


def send(tensor, dst_rank: int, group_name: str = "default"):
    import json

    g = _get(group_name)
    a, host = _staged(tensor)
    meta = {"dtype": a.dtype.str, "shape": list(a.shape)}
    if host is not None:
        meta["torch"] = str(host.dtype).rsplit(".", 1)[-1]
    g.send_bytes(dst_rank, json.dumps(meta).encode() + b"\x00" + a.tobytes())


def recv(src_rank: int, group_name: str = "default") -> np.ndarray:
    """The array sent by ``src_rank``; a CPU tensor of its dtype where it
    sent a torch tensor."""
    import json

    g = _get(group_name)
    payload = g.recv_bytes(src_rank)
    head, _, body = payload.partition(b"\x00")
    meta = json.loads(head.decode())
    a = np.frombuffer(body, dtype=np.dtype(meta["dtype"])).copy()
    a = a.reshape(meta["shape"])
    if "torch" not in meta:
        return a
    import torch

    return torch.from_numpy(a).view(getattr(torch, meta["torch"]))
