"""Deterministic fault injection: the chaos plane.

The observability stack (incidents, leak sweeps, perf gates) explains
failures after the fact; this module CAUSES them on purpose so the whole
robustness story — failover, admission control, autoscaler reconvergence,
KV/plasma leak freedom — can be asserted end-to-end in a repeatable test
(reference analogues: the reference's nightly chaos suites +
test_utils.py RayletKiller; Jepsen-style fault schedules, but seeded and
replayable).

Named **injection sites** are threaded through the hot seams of the
runtime; each is a plain ``hit(site, **attrs)`` call guarded by the
module-level ``ARMED`` flag, so with no plan loaded the per-call cost is
one module attribute read (the tier-1 perf gate keeps this honest: with
``RTPU_TORCH_chaos_plan`` unset the microbench rows must stay in-band).

SITE-NAME STABILITY CONTRACT
----------------------------
Like the flight-recorder event names, the site names are a public
debugging/testing surface — chaos plans in CI and operator runbooks key
on them. Renaming one is a breaking change; add new sites instead.

  rpc.send          client side, before a request frame is written
                    (attrs: method). drop = never send (caller times
                    out), delay, dup = send the frame twice
  rpc.recv          server side, before dispatch (attrs: method).
                    drop = swallow the request, delay, dup = dispatch
                    twice (exercises receiver idempotence)
  raylet.spawn      worker-pool spawn path (attrs: job). fail = the
                    spawn raises, delay
  raylet.heartbeat  the raylet's GCS heartbeat loop (attrs: node).
                    drop = skip one beat, delay
  plasma.write      worker plasma put path. error = the put raises,
                    delay
  replica.step      after each PRODUCTIVE serve.llm engine step
                    (attrs: deployment, replica). kill = SIGKILL the
                    replica process, hang = stall the step loop for
                    delay_s, error = raise in the step loop

THE PLAN
--------
A plan is JSON — ``{"seed": s, "rules": [...]}`` or a bare rule list —
set via the ``RTPU_TORCH_chaos_plan`` env var or published to GCS KV
(namespace ``chaos``, key ``plan``). Drivers publish their env plan at
``init`` and raylets/workers load it when they join, so the whole
cluster replays ONE schedule. Each rule:

    {"site": "replica.step",    # required: a site name above
     "action": "kill",          # required: see the site's actions
     "after_n": 50,             # skip the first N matching hits
                                # (alias: after_steps)
     "every_n": 0,              # 0 = fire once; k = fire on every k-th
                                # eligible hit
     "count": 1,                # max fires per process (0 = unlimited)
     "prob": 1.0,               # fire probability per eligible hit,
                                # drawn from the rule's seeded RNG
     "delay_s": 0.05,           # duration for delay / hang actions
     <attr>: "value"}           # any other key must match the site's
                                # attrs: exact string, fnmatch pattern,
                                # or a list of either

Determinism: rule state (hit counters, RNG) lives per process and every
random draw comes from ``random.Random(seed * 1000003 + rule_index)``,
so the same plan against the same workload replays the same injection
schedule. Every fired injection emits a ``chaos.inject`` flight event
and bumps ``ray_tpu_chaos_injections_total`` (labels: site, action) —
tests assert *exactly-one attributed incident per induced fault* by
joining those against the GCS incident table.
"""

from __future__ import annotations

import json
import random
import threading
from fnmatch import fnmatchcase
from typing import Any, Dict, List, Optional

__all__ = ["ARMED", "hit", "load_plan", "clear", "sync_with_gcs",
           "injections_total"]

# The hot-seam guard: seams check `chaos.ARMED` before calling hit(), so a
# disarmed process pays one module attribute read per site.
ARMED = False

_KV_NS = b"chaos"
_KV_KEY = b"plan"

_lock = threading.Lock()
_sites: Dict[str, List["_Rule"]] = {}
_injections = 0

_CONTROL_KEYS = {"site", "action", "after_n", "after_steps", "every_n",
                 "count", "prob", "delay_s", "seed"}


class _Rule:
    __slots__ = ("site", "action", "match", "after_n", "every_n", "count",
                 "prob", "delay_s", "rng", "hits", "fired", "index")

    def __init__(self, spec: dict, index: int, seed: int):
        self.site = str(spec["site"])
        self.action = str(spec["action"])
        self.after_n = int(spec.get("after_n", spec.get("after_steps", 0)))
        self.every_n = int(spec.get("every_n", 0))
        self.count = int(spec.get("count", 1))
        self.prob = float(spec.get("prob", 1.0))
        self.delay_s = float(spec.get("delay_s", 0.05))
        self.match = {k: v for k, v in spec.items()
                      if k not in _CONTROL_KEYS}
        # per-rule seeded RNG: the prob draws replay identically run to run
        self.rng = random.Random(int(spec.get("seed", seed)) * 1000003
                                 + index)
        self.index = index
        self.hits = 0
        self.fired = 0

    def _matches(self, attrs: dict) -> bool:
        for key, want in self.match.items():
            got = attrs.get(key)
            if got is None:
                return False
            got = str(got)
            opts = want if isinstance(want, (list, tuple)) else [want]
            if not any(fnmatchcase(got, str(o)) for o in opts):
                return False
        return True

    def check(self, attrs: dict) -> Optional[dict]:
        """One site hit against this rule; returns the action dict when
        the rule fires. Counters/RNG advance under the module lock so the
        schedule is deterministic even with concurrent hitters."""
        if not self._matches(attrs):
            return None
        self.hits += 1
        if self.hits <= self.after_n:
            return None
        if self.count and self.fired >= self.count:
            return None
        eligible = self.hits - self.after_n
        if self.every_n > 0:
            if eligible % self.every_n != 0:
                return None
        elif self.fired:
            # every_n == 0: a one-shot trigger point (still capped by
            # count, so count>1 re-fires on consecutive hits)
            pass
        if self.prob < 1.0 and self.rng.random() >= self.prob:
            return None
        self.fired += 1
        return {"action": self.action, "delay_s": self.delay_s,
                "rule": self.index}


def hit(site: str, **attrs) -> Optional[dict]:
    """One pass of an injection site. Returns ``None`` (no fault) or the
    fired rule's action dict ``{"action", "delay_s", "rule"}``. The SEAM
    interprets the action — this function only decides, records the
    ``chaos.inject`` flight event, and bumps the counter."""
    rules = _sites.get(site)
    if not rules:
        return None
    with _lock:
        act = None
        for r in rules:
            act = r.check(attrs)
            if act is not None:
                break
    if act is None:
        return None
    _emit(site, act, attrs)
    return act


def _emit(site: str, act: dict, attrs: dict):
    global _injections
    _injections += 1
    detail = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
    try:
        from ray_tpu_torch._private import flight_recorder as _fr

        _fr.record("chaos.inject", b"",
                   f"{site} {act['action']} rule={act['rule']} {detail}")
    except Exception:
        pass
    try:
        _metric().inc(1, tags={"site": site, "action": act["action"]})
    except Exception:
        pass


_counter = None


def _metric():
    global _counter
    if _counter is None:
        from ray_tpu_torch.util.metrics import Counter

        _counter = Counter(
            "ray_tpu_chaos_injections_total",
            "faults fired by the chaos plane", tag_keys=("site", "action"))
    return _counter


def injections_total() -> int:
    """Faults fired by THIS process since the plan loaded."""
    return _injections


def load_plan(plan: Any) -> int:
    """Arm this process with ``plan`` (dict, rule list, JSON str/bytes).
    Replaces any previous plan and resets all rule state; returns the
    number of rules loaded. An empty/falsy plan disarms."""
    global ARMED, _sites, _injections
    if isinstance(plan, (bytes, bytearray)):
        plan = bytes(plan).decode("utf-8")
    if isinstance(plan, str):
        plan = json.loads(plan) if plan.strip() else None
    if isinstance(plan, dict):
        seed = int(plan.get("seed", 0))
        specs = plan.get("rules") or []
    else:
        seed = 0
        specs = plan or []
    sites: Dict[str, List[_Rule]] = {}
    for i, spec in enumerate(specs):
        rule = _Rule(spec, i, seed)
        sites.setdefault(rule.site, []).append(rule)
    with _lock:
        _sites = sites
        _injections = 0
        ARMED = bool(sites)
    return sum(len(v) for v in sites.values())


def clear():
    """Disarm: all sites become no-ops again."""
    load_plan(None)


def sync_with_gcs(gcs, publish: bool = False) -> bool:
    """Arm from ``RTPU_TORCH_chaos_plan`` or, failing that, from the plan
    published in GCS KV. With ``publish`` (drivers at init), an env plan
    is ALSO written to the KV so every process that joins later — raylet,
    fork-server worker, another driver — replays the same schedule.
    Returns True when a plan was armed."""
    from ray_tpu_torch._private.config import CONFIG

    env_plan = CONFIG.chaos_plan
    if env_plan:
        load_plan(env_plan)
        if publish:
            try:
                gcs.kv_put(_KV_NS, _KV_KEY, env_plan.encode("utf-8"))
            except Exception:
                pass
        return ARMED
    try:
        value = gcs.kv_get(_KV_NS, _KV_KEY)
    except Exception:
        return False
    if value:
        load_plan(value)
    return ARMED
