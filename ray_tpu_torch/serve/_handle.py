"""DeploymentHandle: the client side of a deployment.

Counterpart of the reference's handle → router → replica-scheduler chain
(reference: python/ray/serve/handle.py:714 DeploymentHandle,
_private/router.py:320, _private/replica_scheduler/pow_2_scheduler.py:49
PowerOfTwoChoicesReplicaScheduler). Replica-set changes arrive by
LONG-POLL push from the controller (reference: _private/long_poll.py) — a
background updater holds a poll open and applies new sets the moment the
controller reconciles, so scale-downs re-route within one poll instead of
a TTL window. Each call picks two random replicas and PROBES their actual
queue depths (pow-2 with probes, like the reference's scheduler), falling
back to handle-local in-flight counts when a probe times out.

One long-poll per process and runtime session serves every handle of
every deployment there (``_Subscriptions``, over the controller's
``poll_replica_sets``). A poll holds one of the caller's pipelined
actor-push slots to the controller (``RTPU_TORCH_actor_push_max_inflight``)
until it answers, up to ``_POLL_TIMEOUT_S``, so polls per handle (each
``options()`` and each method attribute is a new handle) or per deployment
would fill those slots and hold back every other controller call of the
process (``serve.start_rpc_ingress``, the proxy's route refresh, a forced
refresh). A handle subscribes its deployment to that poll when it first
routes; :meth:`DeploymentHandle.close` ends its subscription, and the poll
ends when no open handle is left.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"
_POLL_TIMEOUT_S = 20.0
_PROBE_TIMEOUT_S = 0.5

_handle_metrics = None


def _metrics():
    """Caller-side serve metrics (lazy singleton). The handle lives in the
    caller's worker process, so these flush through THAT worker's
    util.metrics push — the latency here is the true end-to-end view
    (routing + queueing + execution + transport), complementing the
    replica-side ray_tpu_serve_request_latency_seconds."""
    global _handle_metrics
    if _handle_metrics is None:
        from ray_tpu_torch.util.metrics import Counter, Histogram

        _handle_metrics = {
            "latency": Histogram(
                "ray_tpu_serve_handle_latency_seconds",
                "caller-observed end-to-end request latency",
                boundaries=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                            0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
                tag_keys=("deployment",)),
            "requests": Counter(
                "ray_tpu_serve_handle_requests_total",
                "requests dispatched through deployment handles",
                tag_keys=("deployment",)),
        }
    return _handle_metrics


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef
    (reference: serve/handle.py DeploymentResponse)."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        return ray_tpu_torch.get(self._ref, timeout=timeout)

    def _to_object_ref(self):
        return self._ref


class StreamingResponse:
    """Iterator over a streaming deployment call (reference:
    serve/handle.py DeploymentResponseGenerator): the replica runs the
    generator; items arrive in pulled batches."""

    def __init__(self, replica, stream_id: str, handle, idx: int):
        self._replica = replica
        self._stream_id = stream_id
        self._handle = handle
        self._idx = idx
        self._buf: List[Any] = []
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch

        while not self._buf:
            if self._done:
                self._finish()
                raise StopIteration
            reply = ray_tpu_torch.get(
                self._replica.next_stream_items.remote(self._stream_id),
                timeout=120,
            )
            self._buf.extend(reply["items"])
            self._done = reply["done"]
        return self._buf.pop(0)

    def _finish(self):
        if self._handle is not None:
            self._handle._done(self._idx)
            self._handle = None

    def close(self):
        """Abandon the stream: frees the replica-side generator."""
        if not self._done:
            self._done = True
            try:
                self._replica.cancel_stream.remote(self._stream_id)
            except Exception:
                pass
        self._finish()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DeploymentHandle:
    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 multiplexed_model_id: str = "", stream: bool = False,
                 idempotent: bool = False):
        self.deployment_name = deployment_name
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._stream = stream
        # idempotent methods opt into bounded ActorDiedError retry: a call
        # that dies with its replica is transparently re-dispatched to a
        # survivor (RTPU_TORCH_serve_failover_retries, capped backoff)
        self._idempotent = idempotent
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}  # replica name -> in-flight
        self._sub: Optional[_ReplicaSet] = None  # the set this handle follows
        self._closed = False

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self._method, self._model_id,
                 self._stream, self._idempotent))

    def options(self, method_name: Optional[str] = None, *,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                idempotent: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name,
            method_name if method_name is not None else self._method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._model_id,
            self._stream if stream is None else stream,
            self._idempotent if idempotent is None else idempotent,
        )

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, name, self._model_id,
                                self._stream, self._idempotent)

    def _refresh_replicas(self, force: bool = False):
        rs = _replica_set(self.deployment_name)
        with self._lock:
            if not self._closed and self._sub is not rs:
                # a set that no open handle followed was not polled: fetch it
                force = rs.subs.subscribe(rs) or force
                self._sub = rs
        rs.ensure(force)

    def _pick(self) -> tuple:
        """Power-of-two-choices with queue-length probes: two random
        candidates report their actual in-flight depth (reference:
        pow_2_scheduler.py:49); handle-local counts break probe failures
        and ties. Multiplexed requests get deterministic model→replica
        affinity so each model's weights stay warm on one replica."""
        rs = _replica_set(self.deployment_name)
        with rs.lock:
            names, replicas = rs.names, rs.replicas
        n = len(replicas)
        if n == 0:
            raise RuntimeError(
                f"no replicas for deployment '{self.deployment_name}'"
            )
        if n == 1:
            cand = [0]
        elif self._model_id:
            import zlib

            cand = [zlib.crc32(self._model_id.encode()) % n]
        else:
            cand = random.sample(range(n), 2)
        cand_named = [(i, names[i], replicas[i]) for i in cand]
        if len(cand_named) == 1:
            idx, name, replica = cand_named[0]
        else:
            import ray_tpu_torch

            # probe candidates INDEPENDENTLY: one dead/slow replica must
            # neither discard the live candidate's answer nor stall the
            # request past the probe budget — an unanswered or failed
            # probe falls back to the local count, and a probe that
            # ERRORS (replica dead) is penalized so the live one wins
            refs = [r.queue_len.remote() for _, _, r in cand_named]
            try:
                ready, _ = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=_PROBE_TIMEOUT_S
                )
                ready_set = set(ready)
            except Exception:
                ready_set = set()
            depths = []
            for ref, (_i, nm, _r) in zip(refs, cand_named):
                if ref in ready_set:
                    try:
                        depths.append(ray_tpu_torch.get(ref, timeout=1))
                        continue
                    except Exception:
                        depths.append(1 << 30)  # dead replica: avoid
                        continue
                with self._lock:
                    depths.append(self._inflight.get(nm, 0))
            pick = min(range(len(cand_named)), key=lambda i: depths[i])
            idx, name, replica = cand_named[pick]
        with self._lock:
            self._inflight[name] = self._inflight.get(name, 0) + 1
        return name, replica

    def _done(self, name: str):
        with self._lock:
            if self._inflight.get(name, 0) > 0:
                self._inflight[name] -= 1

    def close(self):
        """Stop following the deployment's replica set (reference:
        ``ray_tpu/serve/_handle.py:307``): the handle leaves the process's
        long-poll. As in the reference, a call on a closed handle still
        routes, from the set last seen (fetched once where there is none),
        and subscribes nothing."""
        with self._lock:
            self._closed = True
            sub, self._sub = self._sub, None
        if sub is not None:
            sub.subs.unsubscribe(sub)

    def pick_replica(self) -> tuple:
        """Pick one replica (pow-2 probed, like remote()) and charge an
        in-flight slot to it; returns ``(replica_name, actor)``. The
        caller OWNS the slot and must call :meth:`release` when the
        pinned interaction ends — the proxy's llm stream path uses this
        to keep every pull of one token stream on the replica that holds
        its KV blocks."""
        self._refresh_replicas()
        return self._pick()

    def release(self, replica_name: str):
        """Return the in-flight slot taken by :meth:`pick_replica`."""
        self._done(replica_name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        retries = 0
        if self._idempotent and not self._stream:
            from ray_tpu_torch._private.config import CONFIG

            retries = max(0, int(CONFIG.serve_failover_retries))
        return self._remote(args, kwargs, retries)

    def _remote(self, args: tuple, kwargs: dict,
                died_retries: int = 0) -> DeploymentResponse:
        t0 = time.time()
        deadline = t0 + 60
        last_err: Optional[Exception] = None
        while time.time() < deadline:
            try:
                self._refresh_replicas()
                idx, replica = self._pick()
            except Exception as e:
                last_err = e
                time.sleep(0.25)
                continue
            try:
                if self._model_id:
                    kwargs = {**kwargs,
                              "__multiplexed_model_id": self._model_id}
                if self._stream:
                    import ray_tpu_torch

                    sid = ray_tpu_torch.get(
                        replica.start_stream.remote(
                            self._method, args, kwargs),
                        timeout=60,
                    )
                    try:
                        _metrics()["requests"].inc(
                            1, tags={"deployment": self.deployment_name})
                    except Exception:
                        pass
                    return StreamingResponse(replica, sid, self, idx)
                ref = replica.handle_request.remote(
                    self._method, args, kwargs
                )
                # decrement when the call resolves (best effort, piggybacks
                # on the ref's completion via a daemon thread-free path: the
                # response object decrements on result()).
                resp = DeploymentResponse(ref)
                _attach_done(resp, self, idx, t0, args=args, kwargs=kwargs,
                             died_retries=died_retries)
                try:
                    _metrics()["requests"].inc(
                        1, tags={"deployment": self.deployment_name})
                except Exception:
                    pass
                return resp
            except Exception as e:
                last_err = e
                # the pick's in-flight increment must not outlive a failed
                # dispatch (counts persist across set refreshes now)
                self._done(idx)
                self._refresh_replicas(force=True)
        raise RuntimeError(
            f"could not reach any replica of '{self.deployment_name}': {last_err}"
        )


class _ReplicaSet:
    """The replica set of one deployment as this process sees it. The
    process's one long-poll (``_Subscriptions``) keeps it current."""

    def __init__(self, deployment_name: str, subs: "_Subscriptions"):
        self.deployment_name = deployment_name
        self.subs = subs
        self.lock = threading.Lock()
        self.replicas: List[Any] = []
        self.names: List[str] = []
        self.version = -1
        self.holders = 0   # open handles that follow this set (subs.lock)

    def apply(self, names: List[str], version: int):
        import ray_tpu_torch

        replicas = []
        kept = []
        for n in names:
            try:
                replicas.append(ray_tpu_torch.get_actor(n))
                kept.append(n)
            except Exception:
                pass
        with self.lock:
            self.replicas = replicas
            self.names = kept
            self.version = version

    def ensure(self, force: bool = False):
        """With ``force`` or an empty set, fetch the current set now."""
        if force or not self.replicas:
            import ray_tpu_torch

            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            r = ray_tpu_torch.get(
                controller.poll_replica_sets.remote(
                    {self.deployment_name: -1}, 0.0
                ),
                timeout=30,
            )[self.deployment_name]
            self.apply(r["names"], r["version"])


class _Subscriptions:
    """Every deployment this process routes to, kept current by ONE
    background long-poll (``ServeController.poll_replica_sets``) while an
    open handle follows it: the poll applies replica-set changes the moment
    the controller publishes them, and ends when no set has a holder. The
    thread is bound to ONE runtime session — after ray_tpu_torch.shutdown
    (tests, notebooks) it retires instead of polling a dead or unrelated
    cluster, and the next call subscribes afresh in the new session."""

    def __init__(self, worker):
        self.worker = worker
        self.lock = threading.Lock()
        self.sets: Dict[str, _ReplicaSet] = {}
        self._poller: Optional[threading.Thread] = None

    def get(self, deployment_name: str) -> _ReplicaSet:
        with self.lock:
            rs = self.sets.get(deployment_name)
            if rs is None:
                rs = self.sets[deployment_name] = _ReplicaSet(
                    deployment_name, self)
            return rs

    def subscribe(self, rs: _ReplicaSet) -> bool:
        """One more open handle follows ``rs``; starts the long-poll if it
        is not running. True when ``rs`` had no holder (its set may be
        stale)."""
        with self.lock:
            rs.holders += 1
            if self._poller is None:
                self._poller = threading.Thread(
                    target=self._poll_loop, daemon=True, name="serve-poll")
                self._poller.start()
            return rs.holders == 1

    def unsubscribe(self, rs: _ReplicaSet):
        with self.lock:
            rs.holders -= 1

    def _poll_loop(self):
        import ray_tpu_torch
        from ray_tpu_torch._private import worker as worker_mod

        try:
            while worker_mod.global_worker is self.worker:
                with self.lock:
                    sets = {n: rs for n, rs in self.sets.items() if rs.holders}
                    if not sets:
                        self._poller = None   # under the lock: subscribe restarts it
                        return
                known = {n: rs.version for n, rs in sets.items()}
                try:
                    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                    changed = ray_tpu_torch.get(
                        controller.poll_replica_sets.remote(
                            known, _POLL_TIMEOUT_S),
                        timeout=_POLL_TIMEOUT_S + 15,
                    )
                    for name, r in changed.items():
                        sets[name].apply(r["names"], r["version"])
                except Exception:
                    for _ in range(10):
                        if worker_mod.global_worker is not self.worker:
                            return
                        time.sleep(0.1)
        finally:
            with self.lock:
                if self._poller is threading.current_thread():
                    self._poller = None


_subs: Optional[_Subscriptions] = None
_subs_lock = threading.Lock()


def _replica_set(deployment_name: str) -> _ReplicaSet:
    """The process's set for ``deployment_name`` in the current runtime
    session."""
    global _subs
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    with _subs_lock:
        if _subs is None or _subs.worker is not w:
            _subs = _Subscriptions(w)
        subs = _subs
    return subs.get(deployment_name)


def _is_actor_death(e: BaseException) -> bool:
    from ray_tpu_torch.exceptions import (
        ActorDiedError,
        ActorUnavailableError,
        TaskError,
    )

    if isinstance(e, TaskError):
        e = e.cause
    return isinstance(e, (ActorDiedError, ActorUnavailableError))


def _attach_done(resp: DeploymentResponse, handle: DeploymentHandle, idx: int,
                 t0: Optional[float] = None, *, args: tuple = (),
                 kwargs: Optional[dict] = None, died_retries: int = 0):
    original = resp.result
    done = {"fired": False}
    deployment = handle.deployment_name

    def _settle():
        if not done["fired"]:
            done["fired"] = True
            handle._done(idx)
            if t0 is not None:
                # caller-observed e2e latency, observed once per request
                # at first resolution (repeat result() calls are reads)
                try:
                    _metrics()["latency"].observe(
                        time.time() - t0, tags={"deployment": deployment})
                except Exception:
                    pass

    def result(timeout: Optional[float] = None):
        try:
            out = original(timeout)
        except BaseException as e:
            if died_retries > 0 and _is_actor_death(e):
                # bounded retry for idempotent methods: the replica died
                # with our call in flight — back off (capped exponential:
                # replacements take seconds to appear), re-pick a survivor
                # and re-dispatch
                _settle()
                from ray_tpu_torch._private.config import CONFIG

                attempt = max(
                    0, int(CONFIG.serve_failover_retries) - died_retries)
                time.sleep(min(CONFIG.serve_failover_backoff_max_s,
                               CONFIG.serve_failover_backoff_s
                               * (2 ** attempt))
                           * (0.5 + random.random() / 2))
                from ray_tpu_torch.serve.rpc_ingress import _note_failover

                _note_failover(deployment)
                handle._refresh_replicas(force=True)
                return handle._remote(
                    args, dict(kwargs or {}), died_retries - 1
                ).result(timeout)
            _settle()
            raise
        _settle()
        return out

    resp.result = result
