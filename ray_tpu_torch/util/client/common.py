"""Shared wire helpers for the client proxy
(reference: python/ray/util/client/ — the ray_client.proto:326 surface,
re-designed over our msgpack RPC instead of gRPC).

Serialization contract: values cross the wire as cloudpickle bytes. Object
refs and actor handles never serialize their runtime state — a custom
``persistent_id`` swaps them for (kind, id) tickets, and the peer's
``persistent_load`` resolves tickets against its own table (client side:
ClientObjectRef stubs; server side: real ObjectRefs/ActorHandles owned by the
hosted driver). This mirrors the reference client's ClientObjectRef
indirection without needing a proto schema.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable

import cloudpickle


def dumps_with_tickets(value: Any, ticket_of: Callable[[Any], Any]) -> bytes:
    """cloudpickle.dumps, but objects for which ticket_of returns non-None
    are replaced by persistent-id tickets."""
    buf = io.BytesIO()

    class P(cloudpickle.CloudPickler):
        def persistent_id(self, obj):
            return ticket_of(obj)

    P(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
    return buf.getvalue()


def loads_with_tickets(data: bytes, resolve: Callable[[Any], Any]) -> Any:
    class U(pickle.Unpickler):
        def persistent_load(self, pid):
            return resolve(pid)

    return U(io.BytesIO(data)).load()
