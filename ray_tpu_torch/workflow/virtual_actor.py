"""Virtual actors: durable actor state, checkpointed per method call (the
port of ``ray_tpu/workflow/virtual_actor.py``, the same storage layout).

Reference: python/ray/workflow/ virtual actors — an actor whose identity
and state live in workflow storage, not in any process. Every
non-readonly method call runs as a task that loads the latest state
snapshot, applies the method, and COMMITS the new snapshot write-ahead
before the result resolves; a crashed call simply re-runs against the
last committed state (exactly-once on committed state, at-least-once on
the method body). ``get_actor(actor_id)`` resurrects the actor on any
cluster from storage alone.

    from ray_tpu_torch import workflow

    @workflow.virtual_actor
    class Counter:
        def __init__(self, start=0):
            self.count = start

        def add(self, n):
            self.count += n
            return self.count

        @workflow.virtual_actor.readonly
        def get(self):
            return self.count

    workflow.init(storage="/tmp/wf")
    c = Counter.get_or_create("my-counter", 10)
    assert c.add.run(5) == 15
    # ... cluster restarts ...
    c2 = workflow.get_actor("my-counter")
    assert c2.get.run() == 15
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import cloudpickle

import ray_tpu_torch


def _actors_root():
    from ray_tpu_torch import workflow as _wf

    path = os.path.join(_wf._root(), "virtual_actors")
    os.makedirs(path, exist_ok=True)
    return path


def _actor_dir(actor_id: str) -> str:
    return os.path.join(_actors_root(), actor_id)


def _latest_seq(adir: str) -> int:
    best = -1
    for f in os.listdir(adir):
        if f.startswith("state_") and f.endswith(".pkl"):
            try:
                best = max(best, int(f[len("state_"):-len(".pkl")]))
            except ValueError:
                pass
    return best


def _commit_state(adir: str, seq: int, state: dict, exclusive: bool = False):
    """Write snapshot `seq`. exclusive=True is optimistic concurrency for
    method commits: os.link fails if ANOTHER writer committed this seq
    first, turning a cross-handle race into a loud conflict instead of a
    silent lost update."""
    path = os.path.join(adir, f"state_{seq:08d}.pkl")
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        cloudpickle.dump(state, f)
    try:
        if exclusive:
            try:
                os.link(tmp, path)
            except FileExistsError:
                raise RuntimeError(
                    f"concurrent write conflict on virtual actor state "
                    f"{path} — another handle committed seq {seq} first; "
                    "retry the call against the new state"
                )
        else:
            os.replace(tmp, path)
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
    # retain only the latest two snapshots (the previous one guards
    # against a torn read racing the replace on exotic filesystems)
    for f in os.listdir(adir):
        if f.startswith("state_") and f.endswith(".pkl"):
            try:
                s = int(f[len("state_"):-len(".pkl")])
            except ValueError:
                continue
            if s < seq - 1:
                try:
                    os.remove(os.path.join(adir, f))
                except OSError:
                    pass


@ray_tpu_torch.remote(max_retries=0)
def _virtual_actor_call(adir: str, method_name: str, args, kwargs,
                        readonly: bool):
    """One durable method call: load latest state -> apply -> commit."""
    with open(os.path.join(adir, "class.pkl"), "rb") as f:
        cls = cloudpickle.load(f)
    seq = _latest_seq(adir)
    if seq < 0:
        raise RuntimeError(f"virtual actor storage at {adir} has no state")
    with open(os.path.join(adir, f"state_{seq:08d}.pkl"), "rb") as f:
        state = cloudpickle.load(f)
    inst = cls.__new__(cls)
    inst.__dict__.update(state)
    result = getattr(inst, method_name)(*args, **kwargs)
    if not readonly:
        _commit_state(adir, seq + 1, dict(inst.__dict__), exclusive=True)
    return result


class _VirtualMethod:
    def __init__(self, handle: "VirtualActorHandle", name: str,
                 readonly: bool):
        self._handle = handle
        self._name = name
        self._readonly = readonly

    def run(self, *args, **kwargs):
        return ray_tpu_torch.get(self.run_async(*args, **kwargs), timeout=600)

    def run_async(self, *args, **kwargs):
        h = self._handle
        if self._readonly:
            # readers never take the writer lock: they read the latest
            # committed snapshot and commit nothing
            return _virtual_actor_call.remote(
                h._dir, self._name, args, kwargs, True
            )
        # Per-actor writer serialization: durable state has no reorder
        # buffer, so overlapping writers would both load snapshot N and
        # both commit N+1 (lost update). A writer that outlives the wait
        # budget FAILS the next submission loudly — proceeding anyway
        # would silently drop one of the commits.
        with h._lock:
            ref = _virtual_actor_call.remote(
                h._dir, self._name, args, kwargs, False
            )
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=300)
            if not ready:
                raise TimeoutError(
                    f"virtual actor {h.actor_id!r} write "
                    f"{self._name!r} did not commit within 300s; "
                    "not submitting further writes (ordering would break)"
                )
            return ref


class VirtualActorHandle:
    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self._dir = _actor_dir(actor_id)
        self._lock = threading.Lock()
        with open(os.path.join(self._dir, "class.pkl"), "rb") as f:
            self._cls = cloudpickle.load(f)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        attr = getattr(self._cls, name, None)
        if attr is None or not callable(attr):
            raise AttributeError(
                f"virtual actor {self._cls.__name__} has no method {name!r}"
            )
        return _VirtualMethod(
            self, name, getattr(attr, "_workflow_readonly", False)
        )


class VirtualActorClass:
    def __init__(self, cls):
        self._cls = cls

    def get_or_create(self, actor_id: str, *args, **kwargs) -> VirtualActorHandle:
        adir = _actor_dir(actor_id)
        if not os.path.exists(os.path.join(adir, "class.pkl")):
            os.makedirs(adir, exist_ok=True)
            inst = self._cls(*args, **kwargs)
            with open(os.path.join(adir, "class.pkl.tmp"), "wb") as f:
                cloudpickle.dump(self._cls, f)
            os.replace(os.path.join(adir, "class.pkl.tmp"),
                       os.path.join(adir, "class.pkl"))
            _commit_state(adir, 0, dict(inst.__dict__))
            with open(os.path.join(adir, "meta.json"), "w") as f:
                json.dump({"actor_id": actor_id,
                           "class": self._cls.__name__}, f)
        return VirtualActorHandle(actor_id)


def virtual_actor(cls) -> VirtualActorClass:
    """Class decorator making a durable, storage-backed actor class."""
    return VirtualActorClass(cls)


def _readonly(method):
    """Mark a virtual-actor method as not mutating state: it reads the
    latest snapshot without committing a new one."""
    method._workflow_readonly = True
    return method


virtual_actor.readonly = _readonly


def get_actor(actor_id: str) -> VirtualActorHandle:
    """Resurrect a virtual actor from storage (any process, any cluster)."""
    adir = _actor_dir(actor_id)
    if not os.path.exists(os.path.join(adir, "class.pkl")):
        raise ValueError(f"no virtual actor {actor_id!r} in storage")
    return VirtualActorHandle(actor_id)


def list_actors() -> list:
    root = _actors_root()
    out = []
    for aid in sorted(os.listdir(root)):
        meta = os.path.join(root, aid, "meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                out.append(json.load(f))
    return out
