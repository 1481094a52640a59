"""Client for the GCS server (async core + blocking facade).

Counterpart of the reference's gcs_client/accessor
(reference: src/ray/gcs/gcs_client/gcs_client.h, accessor.h) plus the Python
GcsClient binding (reference: python/ray/_raylet.pyx:2670).
"""

from __future__ import annotations

import asyncio
import os
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.rpc import ConnectionLost, IoThread, RpcClient


class GcsAioClient:
    """All methods must run on the IO loop.

    Calls that hit a dead GCS retry with backoff for up to
    ``gcs_reconnect_timeout_s`` — this is what lets raylets and workers ride
    out a GCS restart (reference: gcs_rpc_server_reconnect_timeout_s and the
    retryable gRPC client, src/ray/rpc/gcs_server/gcs_rpc_client.h).
    """

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._client: Optional[RpcClient] = None
        self._lock = asyncio.Lock()

    async def _c(self) -> RpcClient:
        if self._client is None or not self._client.is_connected():
            async with self._lock:
                if self._client is None or not self._client.is_connected():
                    c = RpcClient(self.host, self.port)
                    await c.connect()
                    self._client = c
        return self._client

    async def call(self, method, payload=None, timeout=None, retry_s=None):
        """Issue an RPC; retry connection failures until ``retry_s`` elapses.

        Only transport failures are retried (the GCS handlers are
        at-least-once safe: table writes are idempotent overwrites); remote
        exceptions and response timeouts propagate immediately.
        """
        if retry_s is None:
            retry_s = CONFIG.gcs_reconnect_timeout_s
        deadline = asyncio.get_running_loop().time() + retry_s
        delay = 0.05
        while True:
            try:
                c = await self._c()
                return await c.call(
                    method, payload, timeout or CONFIG.gcs_rpc_timeout_s
                )
            except (ConnectionLost, ConnectionError, OSError):
                if asyncio.get_running_loop().time() >= deadline:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)

    async def notify(self, method, payload=None):
        try:
            c = await self._c()
            await c.notify(method, payload)
        except (ConnectionLost, OSError):
            pass

    # convenience wrappers -----------------------------------------------

    async def kv_put(self, ns, key, value, overwrite=True):
        r = await self.call("KVPut", {"ns": ns, "key": key, "value": value, "overwrite": overwrite})
        return r["added"]

    async def kv_get(self, ns, key):
        return (await self.call("KVGet", {"ns": ns, "key": key}))["value"]

    async def kv_del(self, ns, key):
        return (await self.call("KVDel", {"ns": ns, "key": key}))["deleted"]

    async def kv_keys(self, ns, prefix=b""):
        return (await self.call("KVKeys", {"ns": ns, "prefix": prefix}))["keys"]

    async def kv_exists(self, ns, key):
        return (await self.call("KVExists", {"ns": ns, "key": key}))["exists"]

    async def get_all_node_info(self) -> List[dict]:
        return (await self.call("GetAllNodeInfo", {}))["nodes"]

    async def close(self):
        if self._client is not None:
            await self._client.close()


class GcsClient:
    """Blocking facade over GcsAioClient for driver/user threads."""

    def __init__(self, host: str, port: int, io: Optional[IoThread] = None):
        self.aio = GcsAioClient(host, port)
        self._io = io or IoThread.current()

    @classmethod
    def from_address(cls, address: str):
        host, port = address.rsplit(":", 1)
        return cls(host, int(port))

    @property
    def address(self):
        return f"{self.aio.host}:{self.aio.port}"

    def call(self, method, payload=None, timeout=None, retry_s=None):
        return self._io.run(self.aio.call(method, payload, timeout, retry_s))

    def kv_put(self, ns, key, value, overwrite=True):
        return self._io.run(self.aio.kv_put(ns, key, value, overwrite))

    def kv_get(self, ns, key):
        return self._io.run(self.aio.kv_get(ns, key))

    def kv_del(self, ns, key):
        return self._io.run(self.aio.kv_del(ns, key))

    def kv_keys(self, ns, prefix=b""):
        return self._io.run(self.aio.kv_keys(ns, prefix))

    def kv_exists(self, ns, key):
        return self._io.run(self.aio.kv_exists(ns, key))

    def get_all_node_info(self):
        return self._io.run(self.aio.get_all_node_info())

    def get_cluster_resources(self):
        return self.call("GetClusterResources", {})

    def ping(self, timeout=5):
        # Bounded retry window: a ping probe should fail fast, not wait out
        # the full reconnect budget.
        return self.call("Ping", {}, timeout=timeout, retry_s=timeout)
