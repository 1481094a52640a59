"""ServeController: the reconciling control plane of Serve.

Counterpart of the reference's controller actor
(reference: python/ray/serve/_private/controller.py:86 with the
application/deployment state machines deployment_state.py and autoscaling
autoscaling_state.py / autoscaling_policy.py). One detached actor owns the
replica actors; a reconcile loop converges actual replicas to target
counts, restarts failed replicas, and applies request-based autoscaling.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.serve.controller")


class ServeController:
    def __init__(self):
        # deployment name -> state dict
        self._deployments: Dict[str, dict] = {}
        # app name -> {"route_prefix": str, "ingress": deployment name}
        self._apps: Dict[str, dict] = {}
        self._proxy = None
        self._proxy_port = 0
        self._proxy_lock = None  # created lazily on the actor loop
        self._loop_task = None
        # replica name -> (last push ts, meta) — pushed by the replicas
        self._metrics: Dict[str, tuple] = {}
        # long-poll config push (reference: serve/_private/long_poll.py):
        # each process holds one poll_replica_sets for all the deployments
        # it routes to; any deployment's change wakes it
        self._versions: Dict[str, int] = {}
        self._last_sets: Dict[str, tuple] = {}
        self._epoch = 0
        self._any_change: Optional[asyncio.Event] = None

    def _bump_version(self, dep_name: str):
        self._versions[dep_name] = self._versions.get(dep_name, 0) + 1
        self._epoch += 1
        ev, self._any_change = self._any_change, None
        if ev is not None:
            ev.set()

    def _notify_changes(self):
        """Detect replica-set changes and wake long-pollers."""
        seen = set()
        for dep_name, st in self._deployments.items():
            seen.add(dep_name)
            cur = tuple(sorted(st["replicas"].keys()))
            if cur != self._last_sets.get(dep_name):
                self._last_sets[dep_name] = cur
                self._bump_version(dep_name)
        for dep_name in list(self._last_sets):
            if dep_name not in seen:
                del self._last_sets[dep_name]
                self._bump_version(dep_name)

    def _ensure_loop(self):
        if self._loop_task is None:
            self._loop_task = asyncio.ensure_future(self._reconcile_loop())

    # ------------------------------------------------------------ deploy API

    async def deploy_application(
        self,
        name: str,
        route_prefix: Optional[str],
        deployments: List[dict],
    ) -> str:
        """deployments: [{name, callable(bytes), init_args, init_kwargs,
        num_replicas, max_ongoing_requests, ray_actor_options,
        autoscaling_config}] — last entry is the ingress."""
        import hashlib

        self._ensure_loop()
        for spec in deployments:
            dep_name = spec["name"]
            st = self._deployments.get(dep_name)
            target = spec["num_replicas"]
            if spec.get("autoscaling_config"):
                target = max(
                    spec["autoscaling_config"].get("min_replicas", 1), 1
                )
            # Version = hash of code + config: redeploying changed code
            # rolls replicas (reference: deployment_state version-based
            # rollout).
            h = hashlib.sha1(spec["callable"])
            h.update(repr((spec.get("init_args"), spec.get("init_kwargs"),
                           spec.get("ray_actor_options"),
                           spec.get("max_ongoing_requests"))).encode())
            spec["version"] = h.hexdigest()
            # Idempotent redeploy of an unchanged autoscaled version keeps
            # the scaled-up target: resetting to min would kill loaded
            # replicas and force a re-climb.
            if (
                st is not None
                and spec.get("autoscaling_config")
                and st["spec"].get("version") == spec["version"]
            ):
                cfg = spec["autoscaling_config"]
                target = min(
                    max(st["target"], cfg.get("min_replicas", 1)),
                    cfg.get("max_replicas", 4),
                )
            self._deployments[dep_name] = {
                "spec": spec,
                "target": target,
                "replicas": (st or {}).get("replicas", {}),  # name -> rec
                "draining": (st or {}).get("draining", {}),
                "next_id": (st or {}).get("next_id", 0),
                "overload_since": None,
                "underload_since": None,
            }
        ingress = deployments[-1]["name"]
        self._apps[name] = {
            "route_prefix": route_prefix,
            "ingress": ingress,
            "deployments": [d["name"] for d in deployments],
        }
        await self._reconcile_once()
        return ingress

    async def delete_application(self, name: str):
        app = self._apps.pop(name, None)
        if app is None:
            return
        # Tear down only THIS app's deployments, and only those no
        # remaining app (ingress or inner) still references.
        in_use = set()
        for a in self._apps.values():
            in_use.update(a.get("deployments", [a["ingress"]]))
        import ray_tpu_torch

        for dep_name in app.get("deployments", [app["ingress"]]):
            st = self._deployments.get(dep_name)
            if st is None or dep_name in in_use:
                continue
            for rname, rec in {
                **st["replicas"], **st.get("draining", {})
            }.items():
                self._metrics.pop(rname, None)
                try:
                    ray_tpu_torch.kill(rec["handle"])
                except Exception:
                    pass
            del self._deployments[dep_name]
        self._notify_changes()

    async def report_replica_metrics(self, dep_name: str, replica_name: str, meta: dict):
        self._metrics[replica_name] = (time.time(), meta)

    # -------------------------------------------------------------- queries

    async def get_replica_names(self, deployment_name: str) -> List[str]:
        st = self._deployments.get(deployment_name)
        if st is None:
            return []
        return list(st["replicas"].keys())

    async def poll_replica_sets(self, known: Dict[str, int],
                                timeout: float = 25.0) -> Dict[str, dict]:
        """Long-poll over many deployments at once (reference: the
        LongPollClient's listen_for_change over many keys): reply with
        ``{name: {"version", "names"}}`` for every deployment in ``known``
        whose version moved, as soon as one has — or as soon as ANY
        deployment changed (the reply may then be empty), so a poller that
        has since learned of a new deployment re-polls with it — or empty
        at the timeout."""
        deadline = time.time() + timeout
        epoch = self._epoch
        while True:
            changed = {}
            for name, v in known.items():
                cur = self._versions.get(name, 0)
                if cur != v:
                    changed[name] = {
                        "version": cur,
                        "names": await self.get_replica_names(name),
                    }
            left = deadline - time.time()
            if changed or self._epoch != epoch or left <= 0:
                return changed
            if self._any_change is None:
                self._any_change = asyncio.Event()
            try:
                await asyncio.wait_for(self._any_change.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def get_app_info(self, name: str) -> Optional[dict]:
        return self._apps.get(name)

    async def list_apps(self) -> Dict[str, dict]:
        return dict(self._apps)

    async def get_proxy_port(self) -> int:
        return self._proxy_port

    async def ensure_rpc_ingress(self, port: int = 0) -> int:
        """Binary (msgpack-RPC) ingress beside the HTTP proxy (reference:
        the gRPC proxy, serve/_private/proxy.py:540)."""
        import ray_tpu_torch

        await self.ensure_proxy(0)
        return await asyncio.get_running_loop().run_in_executor(
            None,
            lambda: ray_tpu_torch.get(
                self._proxy.start_rpc_ingress.remote(port), timeout=60
            ),
        )

    async def ensure_proxy(self, port: int = 0) -> int:
        # Serialize concurrent callers: the second must await the first's
        # startup, not read a not-yet-assigned port 0.
        if self._proxy_lock is None:
            self._proxy_lock = asyncio.Lock()
        async with self._proxy_lock:
            if self._proxy is not None:
                return self._proxy_port
            import ray_tpu_torch
            from ray_tpu_torch.serve._proxy import ProxyActor

            proxy = (
                ray_tpu_torch.remote(ProxyActor)
                .options(name="SERVE_PROXY", max_concurrency=64, num_cpus=0)
                .remote()
            )
            self._proxy_port = await asyncio.get_running_loop().run_in_executor(
                None, lambda: ray_tpu_torch.get(proxy.start.remote(port), timeout=60)
            )
            self._proxy = proxy
            return self._proxy_port

    # ------------------------------------------------------------ reconcile

    async def _reconcile_loop(self):
        while True:
            try:
                await self._reconcile_once()
                await self._autoscale_once()
            except Exception:
                logger.exception("reconcile error")
            await asyncio.sleep(0.5)

    async def _reconcile_once(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve._replica import Replica

        now = time.time()
        for dep_name, st in self._deployments.items():
            spec = st["spec"]
            # Version rollout: replicas of an older spec are replaced.
            for rname in list(st["replicas"]):
                rec = st["replicas"][rname]
                if rec.get("version") != spec["version"]:
                    logger.info("replica %s outdated; rolling", rname)
                    st["replicas"].pop(rname, None)
                    self._metrics.pop(rname, None)
                    try:
                        ray_tpu_torch.kill(rec["handle"])
                    except Exception:
                        pass
            # Health = freshness of the replica's metric pushes. A pull-based
            # probe would queue behind user requests and mark busy replicas
            # dead; pushes keep flowing even under full load.
            for rname in list(st["replicas"]):
                rec = st["replicas"][rname]
                pushed = self._metrics.get(rname)
                if pushed is not None:
                    stale = now - pushed[0] > 6.0 or not pushed[1].get("healthy", True)
                elif now - rec["created"] <= 20.0:
                    continue
                elif self._actor_pending(rname):
                    # Still waiting for resources (e.g. the cluster
                    # autoscaler is booting a node) or still in its
                    # constructor (a model's build can outlast the grace):
                    # not a failure — killing it would flap forever. The
                    # first push's grace counts from the last such sighting.
                    rec["pending_at"] = now
                    continue
                else:
                    stale = now - rec.get("pending_at", rec["created"]) > 20.0
                if stale:
                    logger.warning("replica %s unhealthy; replacing", rname)
                    st["replicas"].pop(rname, None)
                    self._metrics.pop(rname, None)
                    try:
                        ray_tpu_torch.kill(rec["handle"])
                    except Exception:
                        pass
            while len(st["replicas"]) < st["target"]:
                rid = st["next_id"]
                st["next_id"] += 1
                rname = f"SERVE_REPLICA::{dep_name}::{rid}"
                opts = dict(spec.get("ray_actor_options") or {})
                opts.setdefault("num_cpus", 1)
                handle = (
                    ray_tpu_torch.remote(Replica)
                    .options(
                        name=rname,
                        # +8 headroom over the user-request cap (which the
                        # replica self-gates): queue_len probes and metrics
                        # answer instantly even at saturation
                        max_concurrency=spec.get("max_ongoing_requests", 8) + 8,
                        **opts,
                    )
                    .remote(
                        {"callable": spec["callable"], "name": dep_name,
                         "max_ongoing": spec.get("max_ongoing_requests", 8)},
                        spec.get("init_args", ()),
                        spec.get("init_kwargs", {}),
                    )
                )
                handle.start_metrics_push.remote(
                    rname, spec.get("health_check_period_s", 2.0)
                )
                st["replicas"][rname] = {
                    "handle": handle,
                    "created": now,
                    "version": spec["version"],
                }
            # Scale-down drains gracefully: the replica leaves the
            # advertised set FIRST (long-pollers re-route within one poll),
            # then dies once its in-flight requests finish (or after a
            # 30 s grace) — a scale-down must not fail live requests.
            draining = st.setdefault("draining", {})
            while len(st["replicas"]) > st["target"]:
                rname = next(iter(st["replicas"]))
                rec = st["replicas"].pop(rname)
                rec["drain_started"] = now
                rec["drain_deadline"] = now + 30.0
                draining[rname] = rec
            for rname in list(draining):
                rec = draining[rname]
                pushed = self._metrics.get(rname)
                # Idle only counts from a push that POSTDATES the drain
                # start by a push period: a pre-drain ongoing=0 snapshot
                # says nothing about requests dispatched by handles that
                # had not yet seen the set change.
                idle = (
                    pushed is not None
                    and pushed[0] > rec["drain_started"] + 2.5
                    and pushed[1].get("ongoing", 1) == 0
                )
                if idle or now > rec["drain_deadline"]:
                    draining.pop(rname)
                    self._metrics.pop(rname, None)
                    try:
                        ray_tpu_torch.kill(rec["handle"])
                    except Exception:
                        pass
        self._notify_changes()

    @staticmethod
    def _actor_pending(replica_name: str) -> bool:
        """True while the named replica actor is still awaiting placement
        or running its constructor (it is ALIVE only once that returns)."""
        try:
            from ray_tpu_torch._private import worker as worker_mod

            r = worker_mod.global_worker.gcs.call(
                "GetActorByName", {"name": replica_name, "namespace": ""},
                timeout=5,
            )
            return bool(r.get("found")) and r["actor"]["state"] in (
                "PENDING_CREATION",
                "RESTARTING",
            )
        except Exception:
            return False

    async def _autoscale_once(self):
        """Request-based autoscaling (reference: autoscaling_policy.py —
        scale toward total_ongoing / target_ongoing_requests, bounded by
        min/max, with up/down delays)."""
        now = time.time()
        for dep_name, st in self._deployments.items():
            cfg = st["spec"].get("autoscaling_config")
            if not cfg or not st["replicas"]:
                continue
            ongoing = 0
            for rname in st["replicas"]:
                pushed = self._metrics.get(rname)
                if pushed is not None and now - pushed[0] < 3.0:
                    # "load" folds in engine-internal queues (serve.llm
                    # sequences waiting+running) on top of the request-level
                    # in-flight count; older replicas only push "ongoing"
                    meta = pushed[1]
                    ongoing += meta.get("load", meta.get("ongoing", 0))
            import math

            target_per = max(cfg.get("target_ongoing_requests", 2.0), 0.1)
            desired = max(
                cfg.get("min_replicas", 1),
                min(
                    cfg.get("max_replicas", 4),
                    math.ceil(ongoing / target_per)
                    if ongoing
                    else cfg.get("min_replicas", 1),
                ),
            )
            cur = st["target"]
            if desired > cur:
                if st["overload_since"] is None:
                    st["overload_since"] = now
                if now - st["overload_since"] >= cfg.get("upscale_delay_s", 2.0):
                    st["target"] = desired
                    st["overload_since"] = None
                    logger.info("autoscale %s: %d -> %d", dep_name, cur, desired)
            else:
                st["overload_since"] = None
            if desired < cur:
                if st["underload_since"] is None:
                    st["underload_since"] = now
                if now - st["underload_since"] >= cfg.get("downscale_delay_s", 10.0):
                    st["target"] = desired
                    st["underload_since"] = None
                    logger.info("autoscale %s: %d -> %d", dep_name, cur, desired)
            else:
                st["underload_since"] = None
