"""Client proxy server: hosts a real driver on the cluster and serves the
remote-driver API (reference: python/ray/util/client/server/server.py — the
RayletServicer; our transport is the framework's msgpack RPC, not gRPC).

Run standalone:  python -m ray_tpu_torch.util.client.server --address <gcs> --port N
or in-process:   ClientServer(port).start()  (requires ray_tpu_torch.init first)

Blocking operations (get/wait/task results) run on a thread pool so the RPC
io-loop never stalls; the hosted CoreWorker's API is thread-safe.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.rpc import IoThread, RpcServer
from ray_tpu_torch.actor import ActorHandle
from ray_tpu_torch.util.client.common import dumps_with_tickets, loads_with_tickets


def _actor_key(handle) -> bytes:
    aid = handle._actor_id
    return aid if isinstance(aid, bytes) else aid.binary()


class ClientServer:
    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._server = RpcServer(host)
        self._port = port
        self.port = None
        # Tables of live server-side objects, keyed by ticket id (bytes).
        self._refs: Dict[bytes, ObjectRef] = {}
        self._actors: Dict[bytes, ActorHandle] = {}
        self._fn_cache: Dict[bytes, Any] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="client-server"
        )

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        io = IoThread.current()
        self._server.register_all(self)
        self.port = io.run(self._server.start(self._port))
        return self.port

    def stop(self):
        io = IoThread.current()
        io.run(self._server.stop())
        self._pool.shutdown(wait=False)

    # -------------------------------------------------------- serialization

    def _ticket_of(self, obj):
        if isinstance(obj, ObjectRef):
            with self._lock:
                self._refs[obj.binary()] = obj
            return ("ref", obj.binary())
        if isinstance(obj, ActorHandle):
            aid = _actor_key(obj)
            with self._lock:
                self._actors[aid] = obj
            return ("actor", aid)
        return None

    def _resolve(self, pid):
        kind, rid = pid
        with self._lock:
            if kind == "ref":
                return self._refs[rid]
            if kind == "actor":
                return self._actors[rid]
        raise KeyError(f"unknown ticket kind {kind!r}")

    def _dumps(self, value) -> bytes:
        return dumps_with_tickets(value, self._ticket_of)

    def _loads(self, data: bytes):
        return loads_with_tickets(data, self._resolve)

    async def _blocking(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn, *args
        )

    # ------------------------------------------------------------- handlers

    async def handle_client_ping(self, payload):
        # NB: every handler runs ON the io loop; sync framework APIs
        # (ray_tpu_torch.get/put/nodes/kill) post coroutines to that same loop and
        # block — so they must always go through the thread pool.
        n = await self._blocking(lambda: len(ray_tpu_torch.nodes()))
        return {"ok": True, "num_nodes": n}

    async def handle_client_put(self, payload):
        value = self._loads(payload["data"])
        ref = await self._blocking(ray_tpu_torch.put, value)
        with self._lock:
            self._refs[ref.binary()] = ref
        return {"id": ref.binary()}

    async def handle_client_get(self, payload):
        with self._lock:
            refs = [self._refs[i] for i in payload["ids"]]

        def do_get():
            return ray_tpu_torch.get(refs, timeout=payload.get("timeout"))

        values = await self._blocking(do_get)
        return {"data": self._dumps(values)}

    async def handle_client_wait(self, payload):
        with self._lock:
            refs = [self._refs[i] for i in payload["ids"]]

        def do_wait():
            return ray_tpu_torch.wait(
                refs,
                num_returns=payload["num_returns"],
                timeout=payload.get("timeout"),
            )

        ready, pending = await self._blocking(do_wait)
        return {
            "ready": [r.binary() for r in ready],
            "pending": [r.binary() for r in pending],
        }

    def _remote_fn(self, payload):
        key = payload.get("fn_id")
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._loads(payload["fn"])
            if key:
                self._fn_cache[key] = fn
        opts = payload.get("opts") or {}
        return ray_tpu_torch.remote(**opts)(fn) if opts else ray_tpu_torch.remote(fn)

    async def handle_client_task(self, payload):
        rf = self._remote_fn(payload)
        args, kwargs = self._loads(payload["args"])
        ref = await self._blocking(lambda: rf.remote(*args, **kwargs))
        with self._lock:
            self._refs[ref.binary()] = ref
        return {"id": ref.binary()}

    async def handle_client_create_actor(self, payload):
        cls = self._loads(payload["cls"])
        opts = payload.get("opts") or {}
        actor_cls = ray_tpu_torch.remote(**opts)(cls) if opts else ray_tpu_torch.remote(cls)
        args, kwargs = self._loads(payload["args"])
        handle = await self._blocking(
            lambda: actor_cls.remote(*args, **kwargs)
        )
        aid = _actor_key(handle)
        with self._lock:
            self._actors[aid] = handle
        return {"id": aid}

    async def handle_client_actor_call(self, payload):
        with self._lock:
            handle = self._actors[payload["id"]]
        args, kwargs = self._loads(payload["args"])
        method = getattr(handle, payload["method"])
        ref = await self._blocking(lambda: method.remote(*args, **kwargs))
        with self._lock:
            self._refs[ref.binary()] = ref
        return {"id": ref.binary()}

    async def handle_client_kill_actor(self, payload):
        with self._lock:
            handle = self._actors.get(payload["id"])
        if handle is not None:
            await self._blocking(
                lambda: ray_tpu_torch.kill(
                    handle, no_restart=payload.get("no_restart", True)
                )
            )
        return {}

    async def handle_client_get_actor(self, payload):
        handle = await self._blocking(
            lambda: ray_tpu_torch.get_actor(payload["name"])
        )
        aid = _actor_key(handle)
        with self._lock:
            self._actors[aid] = handle
        return {"id": aid}

    async def handle_client_release(self, payload):
        with self._lock:
            for rid in payload.get("ids", []):
                self._refs.pop(rid, None)
            for aid in payload.get("actor_ids", []):
                self._actors.pop(aid, None)
        return {}

    async def handle_client_cluster_info(self, payload):
        return await self._blocking(lambda: {
            "nodes": len(ray_tpu_torch.nodes()),
            "resources": ray_tpu_torch.cluster_resources(),
            "available": ray_tpu_torch.available_resources(),
        })


def main():
    import argparse
    import signal
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--address", default=None,
                    help="GCS address of an existing cluster (host:port); "
                         "omit to start a local cluster")
    ap.add_argument("--port", type=int, default=10001)
    ap.add_argument("--num-cpus", type=int, default=None)
    args = ap.parse_args()

    if args.address:
        ray_tpu_torch.init(address=args.address)
    else:
        ray_tpu_torch.init(num_cpus=args.num_cpus)
    srv = ClientServer(args.port)
    port = srv.start()
    # SIGTERM (a supervisor's stop) leaves as Ctrl-C does: through the
    # shutdown below, so a cluster this process started goes with it
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    print(f"client server listening on {port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
