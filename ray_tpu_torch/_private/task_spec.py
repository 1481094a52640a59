"""Task specification: the wire representation of a task/actor call.

Counterpart of the reference's TaskSpecification (reference:
src/ray/common/task/task_spec.h, protobuf common.proto TaskSpec). Plain
msgpack-able dicts; helpers here keep construction/parsing in one place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef

TASK_NORMAL = 0
TASK_ACTOR_CREATION = 1
TASK_ACTOR = 2


def normalize_resources(
    num_cpus=None, num_gpus=None, memory=None, resources=None, default_cpus=1.0
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    out["CPU"] = float(num_cpus) if num_cpus is not None else float(default_cpus)
    if num_gpus:
        out["GPU"] = float(num_gpus)
    if memory:
        out["memory"] = float(memory)
    for k, v in (resources or {}).items():
        if k in ("CPU", "GPU", "memory"):
            raise ValueError(f"Use the dedicated option for {k}, not resources=")
        out[k] = float(v)
    return {k: v for k, v in out.items() if v != 0}


def serialize_args(
    args: tuple, kwargs: dict, inline_threshold: int
) -> Tuple[list, List[ObjectRef], list]:
    """Returns (wire_args, contained_refs, large_values).

    Each wire arg is one of:
      {"v": inline_payload}          — plain value (may contain nested refs)
      {"ref": [id_bytes, owner]}     — top-level ObjectRef arg (resolved by executor)
    Values larger than inline_threshold are returned in large_values as
    (position_key, (pickle_bytes, raw_buffers)) for the caller to store via
    put_serialized() and replace with a ref — the value is serialized
    exactly once and its buffers stay raw until they stream into plasma.
    """
    wire = []
    refs: List[ObjectRef] = []
    large = []

    def one(pos_key, val):
        if isinstance(val, ObjectRef):
            refs.append(val)
            return {"ref": [val.object_id().binary(), list(val.owner_address or ())]}
        p, bufs, contained = serialization.serialize(val)
        if len(p) + serialization.buffers_nbytes(bufs) > inline_threshold:
            large.append((pos_key, (p, bufs)))
            return {"big": pos_key}
        refs.extend(contained)
        return {"v": serialization.inline_payload(p, bufs)}

    for i, a in enumerate(args):
        wire.append(["p", i, one(("p", i), a)])
    for k, v in (kwargs or {}).items():
        wire.append(["k", k, one(("k", k), v)])
    return wire, refs, large


def build_task_spec(
    *,
    task_id: TaskID,
    job_id: JobID,
    name: str,
    fn_key: bytes,
    wire_args: list,
    num_returns: int,
    resources: Dict[str, float],
    owner_addr: Tuple[str, int],
    owner_worker_id: bytes,
    max_retries: int = 0,
    retry_exceptions: bool = False,
    scheduling_strategy: Optional[dict] = None,
    task_type: int = TASK_NORMAL,
    actor_id: Optional[ActorID] = None,
    seq_no: int = 0,
    method_name: str = "",
    runtime_env: Optional[dict] = None,
    max_concurrency: int = 1,
    max_restarts: int = 0,
    caller_id: bytes = b"",
) -> dict:
    return {
        "task_id": task_id.binary(),
        "job_id": job_id.binary(),
        "name": name,
        "fn_key": fn_key,
        "args": wire_args,
        "num_returns": num_returns,
        "resources": resources,
        "owner_addr": list(owner_addr),
        "owner_worker_id": owner_worker_id,
        "max_retries": max_retries,
        "retry_exceptions": retry_exceptions,
        "strategy": scheduling_strategy or {},
        "type": task_type,
        "actor_id": actor_id.binary() if actor_id else b"",
        "seq_no": seq_no,
        "method_name": method_name,
        "runtime_env": runtime_env or {},
        "max_concurrency": max_concurrency,
        "max_restarts": max_restarts,
        "caller_id": caller_id,
    }


def return_object_ids(spec: dict) -> List[ObjectID]:
    tid = TaskID(spec["task_id"])
    return [ObjectID.from_task(tid, i + 1) for i in range(spec["num_returns"])]


def scheduling_key(spec: dict) -> tuple:
    """Leases are cached per (function, resource shape, strategy, runtime
    env) like the reference's SchedulingKey (reference:
    normal_task_submitter.h — runtime_env_hash is part of the key so tasks
    with different environments never share a leased worker)."""
    res = tuple(sorted(spec["resources"].items()))
    strat = tuple(sorted((k, str(v)) for k, v in spec["strategy"].items()))
    return (spec["fn_key"], res, strat, runtime_env_key(spec.get("runtime_env")))


RUNTIME_ENV_SUPPORTED = (
    "env_vars", "working_dir", "pip", "py_modules", "conda", "container",
)


def normalize_pip(pip) -> Optional[dict]:
    """Canonical pip spec: {"packages": [...], "pip_install_options": [...]}
    (reference: _private/runtime_env/pip.py accepts a list or dict)."""
    if pip is None:
        return None
    if isinstance(pip, (list, tuple)):
        pip = {"packages": list(pip)}
    if not isinstance(pip, dict) or not isinstance(pip.get("packages"), list):
        raise ValueError(
            "runtime_env pip must be a list of requirements or "
            '{"packages": [...], "pip_install_options": [...]}'
        )
    unknown = set(pip) - {"packages", "pip_install_options"}
    if unknown:
        # silent drops are worse than errors (same rule as the top-level
        # runtime_env fields)
        raise ValueError(f"unsupported pip option(s): {sorted(unknown)}")
    return {
        "packages": [str(p) for p in pip["packages"]],
        "pip_install_options": [
            str(o) for o in pip.get("pip_install_options", [])
        ],
    }


def runtime_env_key(runtime_env: Optional[dict]) -> str:
    """Canonical string form; '' for the default environment. JSON so
    values containing separator characters cannot make two distinct
    environments share a scheduling key / pooled worker."""
    if not runtime_env:
        return ""
    import json

    env_vars = runtime_env.get("env_vars") or {}
    return json.dumps(
        {"env_vars": dict(sorted(env_vars.items())),
         "working_dir": runtime_env.get("working_dir") or "",
         "pip": runtime_env.get("pip") or None,
         "py_modules": list(runtime_env.get("py_modules") or [])},
        sort_keys=True,
    )


def validate_runtime_env(runtime_env: Optional[dict]) -> Optional[dict]:
    """Reject unsupported runtime_env fields loudly.

    The reference supports many plugins (python/ray/_private/runtime_env/
    plugin.py); this framework implements env_vars, working_dir, pip, and
    py_modules. Accepting-and-ignoring an option would be a silent no-op,
    which is worse than an error.
    """
    if not runtime_env:
        return runtime_env
    unknown = set(runtime_env) - set(RUNTIME_ENV_SUPPORTED)
    if unknown:
        raise ValueError(
            f"unsupported runtime_env field(s) {sorted(unknown)}; "
            f"supported: {list(RUNTIME_ENV_SUPPORTED)}"
        )
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None:
        if not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()
        ):
            raise ValueError("runtime_env env_vars must be a Dict[str, str]")
    wd = runtime_env.get("working_dir")
    if wd is not None and not isinstance(wd, str):
        raise ValueError("runtime_env working_dir must be a path string")
    out = dict(runtime_env)
    if "pip" in runtime_env:
        out["pip"] = normalize_pip(runtime_env["pip"])
    pm = runtime_env.get("py_modules")
    if pm is not None:
        if not isinstance(pm, (list, tuple)) or not all(
            isinstance(p, str) for p in pm
        ):
            raise ValueError(
                "runtime_env py_modules must be a list of directory paths"
            )
        out["py_modules"] = list(pm)
    return out
