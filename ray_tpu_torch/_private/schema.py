"""Typed wire contracts for the msgpack RPC surface
(reference: the src/ray/protobuf/ *.proto files — gcs_service.proto,
node_manager.proto:381, core_worker.proto:439. The framework's RPC carries
msgpack maps instead of protobuf messages; this module is the schema: one
declarative spec per method, a protocol version, and a validator that the
RPC server runs on every request when RTPU_TORCH_VALIDATE_RPC=1 (tests set it) —
so contract drift fails loudly at the boundary instead of as a KeyError
deep inside a handler).

Field spec syntax:
    "field": type            required field of that type
    "field?": type           optional field
    type may be a tuple of accepted types; `object` accepts anything.
Unknown fields are allowed (forward compatibility, like proto3 unknowns).

Out-of-band payloads: methods whose bulk bytes ride raw after the frame
header (rpc.py MSG_REQUEST_OOB / MSG_RESPONSE_OOB) see the landed payload
as an "_oob" field injected by the transport — an int byte count when it
streamed straight into its destination buffer, else a bytearray. Schemas
list the legacy inline field ("data") as optional for those methods.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

PROTOCOL_VERSION = 2  # v2: out-of-band bulk frames (ReceiveChunk/FetchChunk)

TypeSpec = Union[type, Tuple[type, ...]]

_num = (int, float)
_addr = list  # [host, port]


class SchemaError(Exception):
    pass


GCS_SCHEMAS: Dict[str, Dict[str, TypeSpec]] = {
    "RegisterNode": {"node_id": bytes, "ip": str, "raylet_port": int,
                     "resources?": dict, "labels?": dict, "is_head?": bool,
                     "object_manager_port?": int, "plasma_name?": str,
                     "metrics_port?": int},
    "UnregisterNode": {"node_id": bytes},
    "GetAutoscalerActive": {},
    "Heartbeat": {"node_id": bytes},
    "ReportResources": {"node_id": bytes, "available": dict, "total": dict,
                        "pending_demands?": list, "num_leases?": int,
                        "num_workers?": int},
    "GetAllNodeInfo": {"limit?": int},
    "GetClusterResources": {},
    "GetInternalConfig": {},
    "GetClusterLoad": {},
    "KVPut": {"ns": (bytes, str), "key": (bytes, str),
              "value": (bytes, str), "overwrite?": bool},
    "KVGet": {"ns": (bytes, str), "key": (bytes, str)},
    "KVDel": {"ns": (bytes, str), "key": (bytes, str)},
    "KVKeys": {"ns": (bytes, str), "prefix?": (bytes, str)},
    "KVExists": {"ns": (bytes, str), "key": (bytes, str)},
    "Subscribe": {"sub_id": bytes, "channel": str},
    "SubscribeMany": {"sub_id": bytes, "channels": list},
    "RegisterActors": {"items": list},
    "Unsubscribe": {"sub_id": bytes, "channel?": str},
    "PubsubPoll": {"sub_id": bytes, "timeout?": _num},
    "Publish": {"channel": str, "message": object},
    "AddJob": {"job_id": bytes, "driver_addr?": _addr, "entrypoint?": str,
               "driver_sys_path?": list, "metadata?": dict},
    "GetJob": {"job_id": bytes},
    "MarkJobFinished": {"job_id": bytes},
    "GetAllJobInfo": {"limit?": int},
    "RegisterActor": {"actor_id": bytes, "creation_spec": dict,
                      "name?": str, "namespace?": str, "max_restarts?": int,
                      "detached?": bool},
    "ReportWorkerDeath": {"worker_id?": bytes, "node_id?": bytes,
                          "actor_id?": (bytes, type(None)), "reason?": str},
    "GetActorInfo": {"actor_id": bytes},
    "GetActorByName": {"name": str, "namespace?": (str, type(None))},
    "ListActors": {"limit?": int},
    "KillActor": {"actor_id": bytes, "no_restart?": bool},
    "CreatePlacementGroup": {"pg_id": bytes, "bundles": list,
                             "strategy?": str, "name?": str,
                             "job_id?": bytes,
                             "owner_worker_id?": (bytes, type(None))},
    "GetPlacementGroup": {"pg_id": bytes},
    "ListPlacementGroups": {"limit?": int},
    "WaitPlacementGroupReady": {"pg_id": bytes, "timeout?": _num},
    "RemovePlacementGroup": {"pg_id": bytes},
    "AddTaskEvents": {"events": list},
    # job_id accepts the stored hex-string form too (events materialize ids
    # to hex at flush); trace_id narrows to one trace's SPAN events.
    "GetTaskEvents": {"job_id?": (bytes, str, type(None)), "limit?": int,
                      "trace_id?": (str, type(None))},
    "ListTasks": {"job_id?": (bytes, type(None)), "limit?": int,
                  "detail?": bool},
    "GetWorkerFailures": {"limit?": int},
    "ReportIncident": {"incident": dict},
    "ListIncidents": {"limit?": int, "detail?": bool},
    "DumpFlightRecorder": {"limit?": int},
    "ReportUserMetrics": {"records?": list},
    "GetUserMetrics": {"prefix?": str},
    "StartProfile": {"duration?": _num, "hz?": _num},
    "CollectProfile": {},
    "Ping": {},
}

RAYLET_SCHEMAS: Dict[str, Dict[str, TypeSpec]] = {
    "RegisterWorker": {"worker_id": bytes, "port": int,
                       "startup_token?": int,
                       "actor_result?": dict},
    "RequestWorkerLease": {"job_id": bytes, "resources?": dict,
                           "strategy?": dict,
                           "runtime_env?": (dict, type(None))},
    "ReturnWorker": {"lease_id": bytes, "kill?": bool},
    "GetNodeInfo": {},
    "LeaseWorkerForActor": {"actor_id": bytes, "job_id": bytes,
                            "resources": dict, "strategy?": dict,
                            "runtime_env?": (dict, type(None)),
                            "spec?": dict},
    "LeaseWorkersForActors": {"items": list},
    "KillWorker": {"worker_id": bytes, "reason?": str},
    "JobFinished": {"job_id": bytes},
    "PrepareBundle": {"pg_id": bytes, "bundle_index": int,
                      "resources": dict},
    "CommitBundle": {"pg_id": bytes, "bundle_index": int},
    "PrepareBundles": {"items": list, "commit?": bool},
    "CommitBundles": {"items": list},
    "CancelBundle": {"pg_id?": bytes, "bundle_index?": int},
    "ReturnBundle": {"pg_id?": bytes, "bundle_index?": int},
    "SpillObjects": {"bytes": int},
    # meta: ownership attribution (job/actor/task/callsite/size) kept for
    # the leak detector and OOM forensics — see raylet _pin_meta handling
    "PinObject": {"object_id": bytes, "owner_addr?": _addr, "meta?": dict},
    "FreeObjects": {"ids": list},
    "PushObject": {"object_id": bytes, "target": bytes,
                   "owner_addr?": (_addr, type(None))},
    "ReceiveBegin": {"object_id": bytes, "size": int,
                     "owner_addr?": (_addr, type(None))},
    # chunk bytes normally arrive out-of-band ("_oob"); inline "data" is the
    # fallback for senders without a raw buffer at hand
    "ReceiveChunk": {"object_id": bytes, "offset": int,
                     "data?": (bytes, bytearray)},
    "ReceiveEnd": {"object_id": bytes},
    "FetchObjectInfo": {"object_id": bytes},
    "FetchChunk": {"object_id": bytes, "offset": int, "size": int},
    "PullObject": {"object_id": bytes, "owner_addr?": _addr},
    "GetLocalObjectInfo": {},
    "GetLocalWorkerInfo": {},
    "ProfileWorker": {"worker_id?": bytes, "pid?": int,
                      "duration?": _num, "hz?": _num},
    "StartProfile": {"duration?": _num, "hz?": _num,
                     "include_workers?": bool},
    "CollectProfile": {},
    "DumpFlightRecorder": {"limit?": int, "include_workers?": bool},
    # sweep=True forces a leak sweep before replying (CLI --leaks path)
    "GetMemoryReport": {"include_workers?": bool, "limit?": int,
                        "sweep?": bool},
    # plasma-backed submit ring (_private/submit_ring.py): attach/detach a
    # shared-memory spec mailbox; the doorbell is the only hot-path RPC
    "AttachSubmitRing": {"object_id": bytes, "reply_addr": _addr,
                         "job_id": bytes},
    "DetachSubmitRing": {"object_id": bytes},
    "SubmitRingDoorbell": {"object_id?": (bytes, type(None))},
    "Ping": {},
}

WORKER_SCHEMAS: Dict[str, Dict[str, TypeSpec]] = {
    "PushTask": {"spec": dict},
    "PushTasks": {"specs": list},
    "CreateActor": {"spec": dict, "actor_id": bytes},
    "PushActorTask": {"spec": dict},
    "PushActorTasks": {"specs": list, "reply_addr": _addr},
    "ActorTaskReplies": {"replies": list},
    # batched replies for ring-submitted specs (raylet -> submitter)
    "SubmitRingReplies": {"replies": list},
    "GetObjectStatus": {"object_id": bytes, "wait?": bool,
                        "timeout?": (_num, type(None))},
    "AddBorrowerRef": {"object_id": bytes, "borrower": _addr},
    "RemoveBorrowerRef": {"object_id": bytes, "borrower": _addr},
    "AddObjectLocation": {"object_id": bytes, "node_id": bytes},
    "RemoveObjectLocation": {"object_id": bytes, "node_id": bytes},
    "CancelTask": {"task_id": bytes, "force?": bool},
    "Profile": {"duration?": _num, "hz?": _num},
    "StartProfile": {"duration?": _num, "hz?": _num},
    "CollectProfile": {},
    "DumpFlightRecorder": {"limit?": int},
    "KillActor": {"no_restart?": bool},
    "Exit": {},
    "Ping": {},
    "GetCoreWorkerStats": {},
    "GetMemoryReport": {"limit?": int},
    "CheckRefs": {"ids": list},
}


def _check_type(method: str, key: str, value: Any, spec: TypeSpec):
    if spec is object:
        return
    if isinstance(spec, tuple):
        if not isinstance(value, spec):
            raise SchemaError(
                f"{method}.{key}: expected one of "
                f"{[t.__name__ for t in spec]}, got {type(value).__name__}"
            )
        return
    if spec is float:
        spec = _num  # ints are acceptable floats on the wire
    if not isinstance(value, spec):
        raise SchemaError(
            f"{method}.{key}: expected "
            f"{getattr(spec, '__name__', spec)}, got {type(value).__name__}"
        )


def validate(schemas: Dict[str, Dict[str, TypeSpec]], method: str,
             payload: Any) -> None:
    """Raise SchemaError if payload doesn't satisfy the method's schema.
    Methods without a schema pass (extension surface)."""
    schema = schemas.get(method)
    if schema is None:
        return
    if payload is None:
        payload = {}
    if not isinstance(payload, dict):
        raise SchemaError(f"{method}: payload must be a map, got "
                          f"{type(payload).__name__}")
    for key, spec in schema.items():
        optional = key.endswith("?")
        name = key[:-1] if optional else key
        if name not in payload:
            if optional:
                continue
            raise SchemaError(f"{method}: missing required field {name!r}")
        value = payload[name]
        if optional and value is None:
            continue
        _check_type(method, name, value, spec)


def validation_enabled() -> bool:
    return os.environ.get("RTPU_TORCH_VALIDATE_RPC", "") not in ("", "0", "false")


def make_validator(schemas: Dict[str, Dict[str, TypeSpec]]):
    """Validator hook for RpcServer.set_validator; None when disabled."""
    if not validation_enabled():
        return None

    def _validate(method: str, payload: Any):
        validate(schemas, method, payload)

    return _validate
