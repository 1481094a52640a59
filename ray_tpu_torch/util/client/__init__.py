"""Remote-driver client: drive a cluster from a process outside it
(reference: python/ray/util/client/ — ClientContext, api.py, worker.py; proto
surface ray_client.proto:326. Ours rides the framework msgpack RPC).

Usage (no ray_tpu_torch.init in this process):

    from ray_tpu_torch.util import client
    ctx = client.connect("127.0.0.1:10001")
    f = ctx.remote(lambda x: x * 2)
    assert ctx.get(f.remote(21)) == 42
    ctx.disconnect()

Functions/classes are shipped by cloudpickle; object refs and actor handles
stay server-side, the client holds tickets (ClientObjectRef/ClientActorHandle)
that release on GC or disconnect.
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private.rpc import IoThread, RpcClient
from ray_tpu_torch.util.client.common import dumps_with_tickets, loads_with_tickets


class ClientObjectRef:
    __slots__ = ("id", "_ctx", "__weakref__")

    def __init__(self, rid: bytes, ctx: "ClientContext"):
        self.id = rid
        self._ctx = ctx

    def binary(self) -> bytes:
        return self.id

    def hex(self) -> str:
        return self.id.hex()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ClientObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ClientObjectRef({self.id.hex()[:16]})"

    def __del__(self):
        try:
            ctx = self._ctx
            if ctx is not None and ctx.is_connected():
                ctx._queue_release(ref_id=self.id)
        except Exception:
            pass


class ClientRemoteMethod:
    def __init__(self, handle: "ClientActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        return self._handle._ctx._actor_call(
            self._handle._id, self._name, args, kwargs
        )


class ClientActorHandle:
    def __init__(self, aid: bytes, ctx: "ClientContext"):
        self._id = aid
        self._ctx = ctx

    def __getattr__(self, name: str) -> ClientRemoteMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientRemoteMethod(self, name)

    def __repr__(self):
        return f"ClientActorHandle({self._id.hex()[:16]})"


class ClientRemoteFunction:
    def __init__(self, fn, ctx: "ClientContext", opts: Optional[dict] = None):
        self._fn = fn
        self._ctx = ctx
        self._opts = opts or {}
        # Cache key = content digest of the pickled function (as the
        # reference client does): id()-based keys alias after GC, making
        # the server silently run a stale cached function.
        self._fn_bytes: Optional[bytes] = None
        self._fn_id: Optional[bytes] = None

    def options(self, **opts) -> "ClientRemoteFunction":
        merged = {**self._opts, **opts}
        out = ClientRemoteFunction(self._fn, self._ctx, merged)
        out._fn_bytes, out._fn_id = self._fn_bytes, self._fn_id
        return out

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        if self._fn_id is None:
            import hashlib

            self._fn_bytes = self._ctx._dumps(self._fn)
            self._fn_id = hashlib.sha256(self._fn_bytes).hexdigest().encode()
        return self._ctx._task(self._fn_bytes, self._fn_id, self._opts,
                               args, kwargs)


class ClientActorClass:
    def __init__(self, cls, ctx: "ClientContext", opts: Optional[dict] = None):
        self._cls = cls
        self._ctx = ctx
        self._opts = opts or {}

    def options(self, **opts) -> "ClientActorClass":
        return ClientActorClass(self._cls, self._ctx, {**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        return self._ctx._create_actor(self._cls, self._opts, args, kwargs)


class ClientContext:
    """A connection to a ClientServer; exposes the core API surface."""

    def __init__(self, host: str, port: int):
        self._io = IoThread.current()
        self._client = RpcClient(host, port)
        self._io.run(self._client.connect())
        self._release_lock = threading.Lock()
        self._pending_release: List[bytes] = []
        self._pending_actor_release: List[bytes] = []
        self._call("client_ping", {})

    # ------------------------------------------------------------ plumbing

    def _call(self, method: str, payload, timeout: Optional[float] = None):
        return self._io.run(self._client.call(method, payload), timeout)

    def is_connected(self) -> bool:
        try:
            return self._client.is_connected()
        except Exception:
            return False

    def _ticket_of(self, obj):
        if isinstance(obj, ClientObjectRef):
            return ("ref", obj.id)
        if isinstance(obj, ClientActorHandle):
            return ("actor", obj._id)
        return None

    def _resolve(self, pid):
        kind, rid = pid
        if kind == "ref":
            return ClientObjectRef(rid, self)
        if kind == "actor":
            return ClientActorHandle(rid, self)
        raise KeyError(kind)

    def _dumps(self, value) -> bytes:
        return dumps_with_tickets(value, self._ticket_of)

    def _loads(self, data: bytes):
        return loads_with_tickets(data, self._resolve)

    def _queue_release(self, ref_id: bytes = None, actor_id: bytes = None):
        with self._release_lock:
            if ref_id is not None:
                self._pending_release.append(ref_id)
            if actor_id is not None:
                self._pending_actor_release.append(actor_id)
            flush = (len(self._pending_release)
                     + len(self._pending_actor_release)) >= 64
            if flush:
                ids, aids = self._pending_release, self._pending_actor_release
                self._pending_release, self._pending_actor_release = [], []
        if flush:
            try:
                self._io.post(self._client.notify(
                    "client_release", {"ids": ids, "actor_ids": aids}
                ))
            except Exception:
                pass

    # ----------------------------------------------------------- public API

    def remote(self, obj=None, **opts):
        """Like ray_tpu_torch.remote: decorate a function or class; with only
        keyword options, returns a decorator."""
        if obj is None:
            return lambda o: self.remote(o, **opts)
        if inspect.isclass(obj):
            return ClientActorClass(obj, self, opts)
        return ClientRemoteFunction(obj, self, opts)

    def put(self, value: Any) -> ClientObjectRef:
        r = self._call("client_put", {"data": self._dumps(value)})
        return ClientObjectRef(r["id"], self)

    def get(self, refs: Union[ClientObjectRef, Sequence[ClientObjectRef]],
            *, timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ClientObjectRef)
        ids = [refs.id] if single else [r.id for r in refs]
        r = self._call(
            "client_get", {"ids": ids, "timeout": timeout},
            timeout=None if timeout is None else timeout + 10,
        )
        values = self._loads(r["data"])
        return values[0] if single else values

    def wait(self, refs: Sequence[ClientObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[ClientObjectRef], List[ClientObjectRef]]:
        r = self._call("client_wait", {
            "ids": [x.id for x in refs],
            "num_returns": num_returns,
            "timeout": timeout,
        })
        by_id = {x.id: x for x in refs}
        return ([by_id[i] for i in r["ready"]],
                [by_id[i] for i in r["pending"]])

    def _task(self, fn_bytes, fn_id, opts, args, kwargs) -> ClientObjectRef:
        r = self._call("client_task", {
            "fn": fn_bytes,
            "fn_id": fn_id,
            "opts": opts,
            "args": self._dumps((list(args), kwargs)),
        })
        return ClientObjectRef(r["id"], self)

    def _create_actor(self, cls, opts, args, kwargs) -> ClientActorHandle:
        r = self._call("client_create_actor", {
            "cls": self._dumps(cls),
            "opts": opts,
            "args": self._dumps((list(args), kwargs)),
        })
        return ClientActorHandle(r["id"], self)

    def _actor_call(self, aid, method, args, kwargs) -> ClientObjectRef:
        r = self._call("client_actor_call", {
            "id": aid,
            "method": method,
            "args": self._dumps((list(args), kwargs)),
        })
        return ClientObjectRef(r["id"], self)

    def kill(self, handle: ClientActorHandle, *, no_restart: bool = True):
        self._call("client_kill_actor",
                   {"id": handle._id, "no_restart": no_restart})

    def get_actor(self, name: str) -> ClientActorHandle:
        r = self._call("client_get_actor", {"name": name})
        return ClientActorHandle(r["id"], self)

    def cluster_info(self) -> Dict[str, Any]:
        return self._call("client_cluster_info", {})

    def disconnect(self):
        try:
            with self._release_lock:
                ids = self._pending_release
                aids = self._pending_actor_release
                self._pending_release, self._pending_actor_release = [], []
            if ids or aids:
                self._io.run(self._client.notify(
                    "client_release", {"ids": ids, "actor_ids": aids}
                ))
        except Exception:
            pass
        self._io.run(self._client.close())


def connect(address: str) -> ClientContext:
    """Connect to a ClientServer at 'host:port'."""
    host, _, port = address.rpartition(":")
    return ClientContext(host or "127.0.0.1", int(port))
