"""Open-loop arrival load generator for the chaos/scenario suite.

Closed-loop load tests (fire the next request when the previous one
returns) suffer **coordinated omission**: a stalled server pauses the
generator too, so the stall never shows up in the latency histogram.
This generator is open-loop — the arrival schedule is computed up front
(fixed-rate or seeded-Poisson) and every request fires at its scheduled
wall-clock time on its own thread, whether or not earlier requests have
completed. Latency is measured from the SCHEDULED arrival, so queueing
delay during a stall or a replica-kill storm lands in the tail where it
belongs (see Tene, "How NOT to Measure Latency").

    from ray_tpu_torch.util.loadgen import OpenLoopLoadGen

    gen = OpenLoopLoadGen(lambda i: client.call("app", i),
                          rate_hz=50, duration_s=10, arrival="poisson",
                          seed=7)
    report = gen.run()
    assert report["p99_s"] < 0.5 and not report["errors"]

The schedule is deterministic given (rate_hz, duration_s, arrival, seed),
so a chaos scenario replayed with the same seed sees the same offered
load.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["OpenLoopLoadGen"]


class OpenLoopLoadGen:
    """Fire ``fn(i)`` at precomputed arrival times; collect per-request
    records ``{i, scheduled, start, end, ok, error, result}``."""

    def __init__(self, fn: Callable[[int], Any], *, rate_hz: float,
                 duration_s: float, arrival: str = "uniform", seed: int = 0,
                 max_outstanding: int = 512):
        if rate_hz <= 0 or duration_s <= 0:
            raise ValueError("rate_hz and duration_s must be positive")
        self.fn = fn
        self.records: List[dict] = []
        self._lock = threading.Lock()
        self._offsets = self._schedule(rate_hz, duration_s, arrival, seed)
        # backstop against unbounded thread growth when the system under
        # test stops answering entirely; hitting it is itself recorded
        # (shed=True) so the report can't silently under-count load
        self._max_outstanding = max_outstanding
        self.shed = 0

    @staticmethod
    def _schedule(rate_hz: float, duration_s: float, arrival: str,
                  seed: int) -> List[float]:
        if arrival == "uniform":
            n = int(rate_hz * duration_s)
            return [i / rate_hz for i in range(n)]
        if arrival == "poisson":
            import random

            rng = random.Random(seed)
            offsets, t = [], 0.0
            while True:
                t += rng.expovariate(rate_hz)
                if t >= duration_s:
                    return offsets
                offsets.append(t)
        raise ValueError(f"unknown arrival process {arrival!r}")

    def _fire(self, i: int, scheduled_abs: float):
        start = time.perf_counter()
        ok, err, result = True, "", None
        try:
            result = self.fn(i)
        except Exception as e:  # noqa: BLE001 — recorded, not raised
            ok, err = False, f"{type(e).__name__}: {e}"
        end = time.perf_counter()
        with self._lock:
            self.records.append({
                "i": i, "scheduled": scheduled_abs, "start": start,
                "end": end, "ok": ok, "error": err, "result": result,
            })

    def run(self, join_timeout_s: float = 120.0) -> Dict[str, Any]:
        """Blocking: plays the whole schedule, joins the stragglers, and
        returns :meth:`report`."""
        threads: List[threading.Thread] = []
        t0 = time.perf_counter()
        for i, off in enumerate(self._offsets):
            now = time.perf_counter()
            if t0 + off > now:
                time.sleep(t0 + off - now)
            live = sum(1 for t in threads if t.is_alive())
            if live >= self._max_outstanding:
                self.shed += 1
                continue
            th = threading.Thread(target=self._fire, args=(i, t0 + off),
                                  daemon=True)
            th.start()
            threads.append(th)
        deadline = time.perf_counter() + join_timeout_s
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        return self.report()

    @staticmethod
    def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
        if not sorted_vals:
            return None
        return sorted_vals[min(len(sorted_vals) - 1,
                               int(q * len(sorted_vals)))]

    def report(self) -> Dict[str, Any]:
        with self._lock:
            recs = list(self.records)
        # latency from the SCHEDULED arrival (not the thread's start):
        # this is where coordinated omission would otherwise hide
        lats = sorted(r["end"] - r["scheduled"] for r in recs if r["ok"])
        errors: Dict[str, int] = {}
        for r in recs:
            if not r["ok"]:
                key = r["error"].split(":", 1)[0]
                errors[key] = errors.get(key, 0) + 1
        return {
            "offered": len(self._offsets),
            "completed": len(lats),
            "failed": len(recs) - len(lats),
            "shed": self.shed,
            "errors": errors,
            "p50_s": self._pct(lats, 0.50),
            "p95_s": self._pct(lats, 0.95),
            "p99_s": self._pct(lats, 0.99),
            "max_s": lats[-1] if lats else None,
        }
