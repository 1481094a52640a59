"""Control-plane microbenchmarks of the port, for its perf gate.

A copy of the repo's ``microbench.py`` (the JAX package's table) over
``ray_tpu_torch``: the same rows (reference: Ray's
``python/ray/_private/ray_perf.py`` task / actor-call / put throughput and
``release/microbenchmark`` metric names), the same ``microbench.v1`` JSON
schema and the same flags, so ``_private/perf_gate.py`` reads either. The
``serve_llm*`` rows run the port's ``LLMEngine`` on the ``gpt2-tiny``
adapter (the fake adapter for the spec rows) on ``--device``: the CUDA
card unless ``--device cpu`` is given.

Run:  python -m ray_tpu_torch._private.microbench              # full table
      python -m ray_tpu_torch._private.microbench --only put   # rows whose
                                                # name holds a substring
                                                # (comma-separated)
      python -m ray_tpu_torch._private.microbench --json [--only ...]
                                                # one microbench.v1 line:
                                                # per-metric value + rep
                                                # min/median/max
      ... --output FILE                         # also write the table as
                                                # markdown (no file
                                                # otherwise)

Numbers compare against Ray's release rig (m5.16xlarge):
  single_client_tasks_sync 1,046/s · async 8,051/s · 1:1 actor sync 2,050/s ·
  async 8,719/s · n:n async 28,466/s · put 20.8 GiB/s · pg 814/s.
"""

from __future__ import annotations

import json
import time

import numpy as np


_REPS = 1  # set by run_benches: 3 for the committed table, 1 for quick
_DEVICE = None  # the serve_llm rows' device: None is the CUDA card

# Per-metric rep spread of the last run_benches call, keyed by the metric
# name (timeit's `key`): {"min", "median", "max", "reps"}. The --json output
# and perf_gate consume this instead of scraping the printed table.
_REP_DETAIL = {}


def timeit(name, fn, multiplier=1, warmup=1, min_time=2.0, reps=None,
           key=None):
    """Run fn repeatedly for >= min_time, `reps` times back-to-back in the
    same process state; report the MEDIAN rep's ops/s. Mirrors
    ray_perf.timeit plus a pinned repetition protocol — single runs on this
    box swing ±25-30%, so regressions would otherwise hide in noise."""
    if reps is None:
        reps = _REPS
    for _ in range(warmup):
        fn()
    rates = []
    for _ in range(reps):
        count = 0
        t0 = time.perf_counter()
        while True:
            fn()
            count += 1
            dt = time.perf_counter() - t0
            if dt >= min_time:
                break
        rates.append(count * multiplier / dt)
    rates.sort()
    rate = rates[len(rates) // 2]
    _REP_DETAIL[key or name] = {
        "min": min(rates), "median": rate, "max": max(rates), "reps": reps}
    spread = (
        f"  (min {min(rates):,.0f} max {max(rates):,.0f})" if reps > 1 else ""
    )
    print(f"  {name}: {rate:,.1f} /s{spread}")
    return rate


def _scale_detail(key, factor):
    """Apply a post-hoc unit conversion (e.g. puts/s -> GiB/s) to a rep
    detail record so --json reports the same unit as the table."""
    d = _REP_DETAIL.get(key)
    if d:
        for f in ("min", "median", "max"):
            d[f] *= factor


def last_run_detail() -> dict:
    """{metric: {"value", "min", "median", "max", "reps"}} for the metrics
    the last run_benches() call measured."""
    return {
        k: {"value": round(d["median"], 3),
            "min": round(d["min"], 3),
            "median": round(d["median"], 3),
            "max": round(d["max"], 3),
            "reps": d["reps"]}
        for k, d in _REP_DETAIL.items()
    }


def _bench_serve_llm(quick: bool, reps: int) -> dict:
    """serve/llm CPU-plane load test: the continuous-batching engine vs the
    same model (gpt2-tiny adapter, identical prompts/sampling) behind
    static request batching — groups of max_batch admitted together and run
    to completion before the next group, i.e. ``@serve.batch`` semantics at
    the request level. Both sides share the engine, cache and adapter; only
    the admission policy differs, so the ratio isolates iteration-level
    scheduling. Full mode runs >= 1k concurrent streams (the ROADMAP item 1
    acceptance scale); per-stream completion latency feeds the p99 metric
    (lower is better — the perf gate knows, see
    _private/perf_gate._LOWER_IS_BETTER).
    """
    import time as _time

    from ray_tpu_torch.serve.llm.adapters import build_adapter
    from ray_tpu_torch.serve.llm.engine import LLMEngine, SamplingParams

    n_streams = 256 if quick else 1024
    max_batch = 32
    adapter = build_adapter(
        "gpt2-tiny",
        {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 512,
         "block_size": 256, "use_flash_attention": False},
        seed=0, device=_DEVICE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 17))).tolist()
               for _ in range(n_streams)]
    # varied lengths: the continuous win comes from refilling the slots
    # short requests free — uniform lengths would understate it
    max_toks = rng.integers(4, 33, n_streams)
    total_tokens = int(max_toks.sum())

    def make_engine():
        return LLMEngine(adapter, num_blocks=4096, block_size=16,
                         max_batch=max_batch, max_waiting=n_streams + 1)

    def run_continuous():
        eng = make_engine()
        t0 = _time.perf_counter()
        rids = [eng.submit(p, SamplingParams(max_tokens=int(m)))
                for p, m in zip(prompts, max_toks)]
        idx = {r: i for i, r in enumerate(rids)}
        done_at = np.zeros(n_streams)
        while eng.has_work():
            st = eng.step()
            now = _time.perf_counter() - t0
            for r in st.get("finished_ids", ()):
                done_at[idx[r]] = now
        dt = _time.perf_counter() - t0
        return total_tokens / dt, float(np.percentile(done_at, 99) * 1000)

    def run_static():
        # Faithful @serve.batch inference: fixed-shape groups of max_batch,
        # every decode step computes the FULL padded batch (finished rows
        # included — compiled static shapes can't shrink), and the group
        # holds its slots until the longest member finishes. Dense
        # contiguous KV on the adapter's device, no paging overhead —
        # generous to this side.
        import torch

        dev = adapter.device
        t0 = _time.perf_counter()
        for i in range(0, n_streams, max_batch):
            gp = prompts[i:i + max_batch]
            gm = max_toks[i:i + max_batch]
            B = len(gp)
            lens = torch.tensor([len(p) for p in gp], dtype=torch.long,
                                device=dev)
            steps = int(gm.max())
            tmax = int(lens.max()) + steps
            L, H, D = (adapter.n_layers, adapter.n_kv_heads,
                       adapter.head_dim)
            k_ctx = torch.zeros((B, L, tmax, H, D), dtype=adapter.dtype,
                                device=dev)
            v_ctx = torch.zeros_like(k_ctx)
            toks = torch.zeros(B, dtype=torch.long, device=dev)
            for j, p in enumerate(gp):
                logits, k, v = adapter.prefill(np.asarray(p))
                k_ctx[j, :, :len(p)] = k
                v_ctx[j, :, :len(p)] = v
                toks[j] = torch.argmax(logits)
            rows = torch.arange(B, device=dev)
            for _ in range(steps - 1):
                logits, k_new, v_new = adapter.decode(
                    toks, lens, k_ctx, v_ctx, lens)
                k_ctx[rows, :, lens] = k_new
                v_ctx[rows, :, lens] = v_new
                lens = lens + 1
                toks = torch.argmax(logits, dim=-1)
        _sync(dev)
        return total_tokens / (_time.perf_counter() - t0)

    cont, p99, stat = [], [], []
    for _ in range(reps):
        c, p = run_continuous()
        cont.append(c)
        p99.append(p)
        stat.append(run_static())
    out = {}
    for key, vals in (("serve_llm_tokens_per_s", cont),
                      ("serve_llm_static_batch_tokens_per_s", stat),
                      ("serve_llm_stream_p99_ms", p99)):
        vals = sorted(vals)
        med = vals[len(vals) // 2]
        _REP_DETAIL[key] = {"min": vals[0], "median": med, "max": vals[-1],
                            "reps": reps}
        out[key] = med
        print(f"  {key}: {med:,.1f}")
    print(f"  serve_llm continuous/static ratio: "
          f"{out['serve_llm_tokens_per_s'] / out['serve_llm_static_batch_tokens_per_s']:.2f} "
          f"({n_streams} streams)")
    return out


def _sync(device) -> None:
    """Wait for the card's queued work before a clock is read."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _record_rows(rows: dict, reps: int) -> dict:
    """Fold per-rep lists into the _REP_DETAIL median protocol."""
    out = {}
    for key, vals in rows.items():
        vals = sorted(vals)
        med = vals[len(vals) // 2]
        _REP_DETAIL[key] = {"min": vals[0], "median": med, "max": vals[-1],
                            "reps": reps}
        out[key] = med
        print(f"  {key}: {med:,.3f}" if med < 10 else f"  {key}: {med:,.1f}")
    return out


def _bench_serve_llm_prefix(quick: bool, reps: int) -> dict:
    """Prefix-caching A/B at a high prompt-overlap mix: every stream's
    prompt is one shared ~96-token system prefix plus a short unique tail
    (>= 0.9 overlap — the million-users-one-template serving shape), run
    once with the prefix cache on and once cold on the SAME gpt2-tiny
    adapter/engine config. The warm run prefills only each tail, so the
    ratio isolates exactly what copy-on-write block sharing buys;
    `serve_llm_prefix_kv_hit_rate` (0-1, higher is better) gates the
    matcher itself — a hashing/registration regression shows up here even
    if throughput noise hides it.
    """
    import time as _time

    from ray_tpu_torch.serve.llm.adapters import build_adapter
    from ray_tpu_torch.serve.llm.engine import LLMEngine, SamplingParams

    # quick keeps the FULL workload geometry and only drops reps: the
    # admitted-cold fraction — and with it the tightly-banded hit-rate row
    # and the per-step throughput — must stay comparable to the full-mode
    # ledger baseline, and this section costs seconds, not minutes
    n_streams, max_batch = 96, 16
    adapter = build_adapter(
        "gpt2-tiny",
        {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 512,
         "block_size": 256, "use_flash_attention": False},
        seed=0, device=_DEVICE)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 512, 96).tolist()          # the system prompt
    prompts = [shared + rng.integers(0, 512, int(rng.integers(4, 9))).tolist()
               for _ in range(n_streams)]
    max_toks = rng.integers(8, 17, n_streams)
    total_tokens = int(max_toks.sum())

    def run(prefix_cache: bool):
        eng = LLMEngine(adapter, num_blocks=4096, block_size=16,
                        max_batch=max_batch, max_waiting=n_streams + 1,
                        prefix_cache=prefix_cache)
        t0 = _time.perf_counter()
        for p, m in zip(prompts, max_toks):
            eng.submit(p, SamplingParams(max_tokens=int(m)))
        eng.run_until_drained()
        return total_tokens / (_time.perf_counter() - t0), \
            eng.cache.hit_rate()

    run(prefix_cache=True)   # untimed warmup: page-fault/alloc state
    warm, cold, hits = [], [], []
    for _ in range(reps):
        w, h = run(prefix_cache=True)
        warm.append(w)
        hits.append(h)
        cold.append(run(prefix_cache=False)[0])
    out = _record_rows({"serve_llm_prefix_tokens_per_s": warm,
                        "serve_llm_prefix_cold_tokens_per_s": cold,
                        "serve_llm_prefix_kv_hit_rate": hits}, reps)
    print(f"  serve_llm prefix warm/cold ratio: "
          f"{out['serve_llm_prefix_tokens_per_s'] / out['serve_llm_prefix_cold_tokens_per_s']:.2f} "
          f"({n_streams} streams, ~0.93 overlap)")
    return out


def _bench_serve_llm_spec(quick: bool, reps: int) -> dict:
    """Speculative-decoding A/B on the deterministic fake adapter with a
    modeled 10:1 target:draft step cost (the Gemma-31B-vs-2B serving
    shape, `step_cost_s` sleeps once per fused call like one accelerator
    dispatch) and a draft that deterministically disagrees on ~1/7 of
    positions. The row gates the ENGINE's propose/verify/rollback
    machinery and its overhead — model quality is fixed by construction,
    so `serve_llm_spec_acceptance` (0-1, higher is better) is a tight
    regression tripwire for the acceptance logic itself. The real-model
    correctness bar (byte-equality vs non-speculative greedy on gpt2 and
    llama) lives in tests/test_torch_serve_llm.py.
    """
    import time as _time

    from ray_tpu_torch.serve.llm.adapters import FakeAdapter
    from ray_tpu_torch.serve.llm.engine import LLMEngine, SamplingParams

    n_streams = 16 if quick else 32
    max_tokens = 64
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, int(rng.integers(4, 9))).tolist()
               for _ in range(n_streams)]
    total_tokens = n_streams * max_tokens

    def run(spec: bool):
        eng = LLMEngine(
            FakeAdapter(vocab_size=97, step_cost_s=5e-3, device=_DEVICE),
            num_blocks=2048, block_size=16, max_batch=8,
            max_waiting=n_streams + 1, prefix_cache=False,
            draft_adapter=(FakeAdapter(vocab_size=97, step_cost_s=5e-4,
                                       disagree_every=7, device=_DEVICE)
                           if spec else None),
            spec_k=4)
        t0 = _time.perf_counter()
        for p in prompts:
            eng.submit(p, SamplingParams(max_tokens=max_tokens))
        eng.run_until_drained()
        return total_tokens / (_time.perf_counter() - t0), \
            eng.spec_acceptance()

    run(spec=True)           # untimed warmup (same reason as prefix)
    fast, base, acc = [], [], []
    for _ in range(reps):
        f, a = run(spec=True)
        fast.append(f)
        acc.append(a)
        base.append(run(spec=False)[0])
    out = _record_rows({"serve_llm_spec_tokens_per_s": fast,
                        "serve_llm_spec_baseline_tokens_per_s": base,
                        "serve_llm_spec_acceptance": acc}, reps)
    print(f"  serve_llm spec/baseline ratio: "
          f"{out['serve_llm_spec_tokens_per_s'] / out['serve_llm_spec_baseline_tokens_per_s']:.2f} "
          f"(k=4, 10:1 cost model)")
    return out


def _bench_submit_storm(quick: bool, reps: int, min_time: float) -> dict:
    """many_drivers_submit_storm: K driver-like client actors (separate
    processes, each with its own CoreWorker) concurrently flood the node
    with tiny no-arg tasks — the many-drivers control-plane shape ROADMAP
    item 1 names. Measured twice on identical fresh clusters: once with
    the plasma-backed submit ring (the default path: specs memcpy into
    shared memory, the raylet drains batches, one doorbell RPC per
    empty→non-empty transition) and once with the ring disabled
    (``RTPU_TORCH_submit_ring_slots=0``: one PushTask RPC write per batch from
    each submitter). The pair is the ring-vs-RPC A/B the perf gate tracks;
    on a 1-core box both sides timeshare the core, so the ratio
    understates the design by the core count (same caveat as the other
    multi-process rows). Quick mode keeps the FULL storm geometry and only
    drops reps/min_time (the serve_llm_prefix precedent) — a smaller storm
    measures a different contention shape and would make quick runs
    incomparable with the committed ledger rows."""
    import os

    import ray_tpu_torch

    n_cli = 4
    per = 200
    out = {}
    for key, ring in (("many_drivers_submit_storm", True),
                      ("many_drivers_submit_storm_rpc", False)):
        saved = os.environ.get("RTPU_TORCH_submit_ring_slots")
        if not ring:
            os.environ["RTPU_TORCH_submit_ring_slots"] = "0"
        try:
            ray_tpu_torch.init(num_cpus=8)
            try:
                _small, _a, _aa, Client = _define_remotes()
                clients = [Client.remote([]) for _ in range(n_cli)]
                ray_tpu_torch.get([c.task_batch.remote(1) for c in clients])
                out[key] = timeit(
                    key,
                    lambda: ray_tpu_torch.get(
                        [c.task_batch.remote(per) for c in clients]),
                    multiplier=n_cli * per, min_time=min_time, reps=reps,
                    key=key)
            finally:
                ray_tpu_torch.shutdown()
        finally:
            if not ring:
                if saved is None:
                    os.environ.pop("RTPU_TORCH_submit_ring_slots", None)
                else:
                    os.environ["RTPU_TORCH_submit_ring_slots"] = saved
    if out.get("many_drivers_submit_storm_rpc"):
        print(f"  submit storm ring/rpc ratio: "
              f"{out['many_drivers_submit_storm'] / out['many_drivers_submit_storm_rpc']:.2f} "
              f"({n_cli} drivers x {per}/batch)")
    return out


def _define_remotes():
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def small_task():
        return b"ok"

    @ray_tpu_torch.remote
    class Actor:
        def small_value(self):
            return b"ok"

        def small_value_arg(self, x):
            return b"ok"

    @ray_tpu_torch.remote
    class AsyncActor:
        async def small_value(self):
            return b"ok"

    @ray_tpu_torch.remote
    class Client:
        """A driver-side load generator living in its own process
        (ray_perf's multi-client benches)."""

        def __init__(self, servers):
            self.servers = servers

        def actor_batch(self, n):
            import ray_tpu_torch as rt

            rt.get([s.small_value.remote() for s in self.servers
                    for _ in range(n)])

        def task_batch(self, n):
            import ray_tpu_torch as rt

            rt.get([small_task.remote() for _ in range(n)])

    return small_task, Actor, AsyncActor, Client


def run_benches(quick: bool = False, only: str = None) -> dict:
    """Run the bench table. `only` (comma-separated substring match on the
    metric name) restricts the run to matching metrics — each section boots
    only the actors it needs, so `--only put` answers "did the put path
    regress?" in seconds instead of a full bench round."""
    import ray_tpu_torch
    from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group

    global _REPS
    small_task, Actor, AsyncActor, Client = _define_remotes()
    results = {}
    _REP_DETAIL.clear()
    min_time = 0.5 if quick else 2.0
    batch = 100 if quick else 1000
    _REPS = 1 if quick else 3
    parts = [p for p in (only or "").split(",") if p]

    def sel(metric: str) -> bool:
        return not parts or any(p in metric for p in parts)

    # serve/llm engine A/B runs in-process (no cluster): the CI row
    # `--only serve_llm` answers "did continuous batching regress?" without
    # paying a cluster boot
    if (sel("serve_llm_tokens_per_s")
            or sel("serve_llm_static_batch_tokens_per_s")
            or sel("serve_llm_stream_p99_ms")):
        results.update(_bench_serve_llm(quick, reps=_REPS))
    if (sel("serve_llm_prefix_tokens_per_s")
            or sel("serve_llm_prefix_cold_tokens_per_s")
            or sel("serve_llm_prefix_kv_hit_rate")):
        results.update(_bench_serve_llm_prefix(quick, reps=_REPS))
    if (sel("serve_llm_spec_tokens_per_s")
            or sel("serve_llm_spec_baseline_tokens_per_s")
            or sel("serve_llm_spec_acceptance")):
        results.update(_bench_serve_llm_spec(quick, reps=_REPS))
    # submit-storm rows boot their own clusters (the ring-vs-RPC A/B needs
    # a different env per side), so they run outside the shared init below
    if sel("many_drivers_submit_storm") or sel("many_drivers_submit_storm_rpc"):
        results.update(_bench_submit_storm(quick, reps=_REPS,
                                           min_time=min_time))
    cluster_metrics = (
        "single_client_tasks_sync", "single_client_tasks_async",
        "wait_1k_refs", "multi_client_tasks_async", "1_1_actor_calls_sync",
        "1_1_actor_calls_async", "1_1_async_actor_calls_async",
        "n_n_actor_calls_async", "single_client_put_calls",
        "single_client_put_gigabytes", "single_client_get_calls_plasma",
        "placement_group_create_removal",
    )
    if not any(sel(m) for m in cluster_metrics):
        return {k: round(v, 3 if abs(v) < 10 else 1)
            for k, v in results.items()}

    ray_tpu_torch.init(num_cpus=8)
    try:
        # tasks
        if sel("single_client_tasks_sync") or sel("single_client_tasks_async"):
            ray_tpu_torch.get(small_task.remote())  # prime worker + fn export
        if sel("single_client_tasks_sync"):
            results["single_client_tasks_sync"] = timeit(
                "single client tasks sync",
                lambda: ray_tpu_torch.get(small_task.remote()),
                min_time=min_time, key="single_client_tasks_sync")
        if sel("single_client_tasks_async"):
            results["single_client_tasks_async"] = timeit(
                "single client tasks async",
                lambda: ray_tpu_torch.get([small_task.remote() for _ in range(batch)]),
                multiplier=batch, min_time=min_time,
                key="single_client_tasks_async")

        # wait() at 1k-ref scale (reference: release/benchmarks single-node
        # ray.get/wait batch limits)
        if sel("wait_1k_refs"):
            wait_n = 200 if quick else 1000

            def wait_cycle():
                refs = [small_task.remote() for _ in range(wait_n)]
                ready, _ = ray_tpu_torch.wait(refs, num_returns=wait_n, timeout=60)
                assert len(ready) == wait_n

            results["wait_1k_refs"] = timeit(
                "wait on 1k refs", wait_cycle, multiplier=wait_n,
                min_time=min_time, key="wait_1k_refs")

        # multi-client task submission: n driver-like client actors each
        # submitting async task batches (ray_perf multi_client_tasks_async)
        if sel("multi_client_tasks_async"):
            n_cli = 2 if quick else 4
            per_cli = 50 if quick else 200
            task_clients = [Client.remote([]) for _ in range(n_cli)]
            ray_tpu_torch.get([c.task_batch.remote(1) for c in task_clients])
            results["multi_client_tasks_async"] = timeit(
                "multi client tasks async",
                lambda: ray_tpu_torch.get(
                    [c.task_batch.remote(per_cli) for c in task_clients]
                ),
                multiplier=n_cli * per_cli, min_time=min_time,
                key="multi_client_tasks_async")
            for c in task_clients:
                ray_tpu_torch.kill(c)

        # actor calls
        if sel("1_1_actor_calls_sync") or sel("1_1_actor_calls_async"):
            a = Actor.remote()
            ray_tpu_torch.get(a.small_value.remote())
            if sel("1_1_actor_calls_sync"):
                results["1_1_actor_calls_sync"] = timeit(
                    "1:1 actor calls sync",
                    lambda: ray_tpu_torch.get(a.small_value.remote()),
                    min_time=min_time, key="1_1_actor_calls_sync")
            if sel("1_1_actor_calls_async"):
                results["1_1_actor_calls_async"] = timeit(
                    "1:1 actor calls async",
                    lambda: ray_tpu_torch.get(
                        [a.small_value.remote() for _ in range(batch)]),
                    multiplier=batch, min_time=min_time,
                    key="1_1_actor_calls_async")
            ray_tpu_torch.kill(a)

        if sel("1_1_async_actor_calls_async"):
            aa = AsyncActor.remote()
            ray_tpu_torch.get(aa.small_value.remote())
            results["1_1_async_actor_calls_async"] = timeit(
                "1:1 async-actor calls async",
                lambda: ray_tpu_torch.get(
                    [aa.small_value.remote() for _ in range(batch)]),
                multiplier=batch, min_time=min_time,
                key="1_1_async_actor_calls_async")
            ray_tpu_torch.kill(aa)

        # n:n actor calls — n clients (separate processes) × n servers
        if sel("n_n_actor_calls_async"):
            n = 2 if quick else 4
            per = 50 if quick else 200
            servers = [Actor.remote() for _ in range(n)]
            ray_tpu_torch.get([s.small_value.remote() for s in servers])
            clients = [Client.remote(servers) for _ in range(n)]
            ray_tpu_torch.get([c.actor_batch.remote(1) for c in clients])
            results["n_n_actor_calls_async"] = timeit(
                "n:n actor calls async",
                lambda: ray_tpu_torch.get(
                    [c.actor_batch.remote(per) for c in clients]),
                multiplier=n * n * per, min_time=min_time,
                key="n_n_actor_calls_async")
            for actor in servers + clients:
                ray_tpu_torch.kill(actor)

        # puts
        if sel("single_client_put_calls"):
            small = b"x" * 100
            results["single_client_put_calls"] = timeit(
                "single client put calls (100B)",
                lambda: ray_tpu_torch.put(small),
                min_time=min_time, key="single_client_put_calls")
        if sel("single_client_put_gigabytes"):
            big = np.zeros(256 * 1024 * 1024 // 8, dtype=np.float64)  # 256 MiB
            gib = big.nbytes / (1 << 30)
            results["single_client_put_gigabytes"] = timeit(
                "single client put GiB/s",
                lambda: ray_tpu_torch.put(big),
                multiplier=1, min_time=min_time,
                key="single_client_put_gigabytes") * gib
            _scale_detail("single_client_put_gigabytes", gib)

        # plasma get calls
        if sel("single_client_get_calls_plasma"):
            ref = ray_tpu_torch.put(np.zeros(2 * 1024 * 1024 // 8))  # 2 MiB -> plasma
            results["single_client_get_calls_plasma"] = timeit(
                "single client plasma get calls",
                lambda: ray_tpu_torch.get(ref),
                min_time=min_time, key="single_client_get_calls_plasma")

        if sel("placement_group_create_removal"):
            def pg_cycle():
                pg = placement_group([{"CPU": 1}] * 2)
                pg.ready()  # blocks until reserved (returns self, not a ref)
                remove_placement_group(pg)

            results["placement_group_create_removal"] = timeit(
                "pg create+remove", pg_cycle, min_time=min_time,
                key="placement_group_create_removal")
    finally:
        ray_tpu_torch.shutdown()
    return {k: round(v, 3 if abs(v) < 10 else 1)
        for k, v in results.items()}


BASELINE = {
    "single_client_tasks_sync": 1046,
    "single_client_tasks_async": 8051,
    "multi_client_tasks_async": 24773,
    "1_1_actor_calls_sync": 2050,
    "1_1_actor_calls_async": 8719,
    "n_n_actor_calls_async": 28466,
    "single_client_put_gigabytes": 20.8,
    "placement_group_create_removal": 814,
}


def render_table(results: dict) -> str:
    """The measured rows as a markdown table beside Ray's release rig."""
    lines = [
        "# Microbenchmarks of ray_tpu_torch (ray_perf port)",
        "",
        "`python -m ray_tpu_torch._private.microbench --output FILE`.",
        "Protocol: each metric runs 3 back-to-back timing reps (>=2 s each)",
        "in the same process state; the table records the MEDIAN rep.",
        "The gate's noise bands are `_private/perf_gate.py`'s.",
        "",
        "| metric | ray_tpu_torch | reference | ratio |",
        "|---|---|---|---|",
    ]
    for k, v in results.items():
        base = BASELINE.get(k)
        ratio = f"{v / base:.2f}" if base else "—"
        lines.append(f"| {k} | {v:,} | {base or '—'} | {ratio} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    import argparse
    import os

    global _DEVICE
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--only", default=None, metavar="METRIC",
        help="run only metrics whose name contains one of these "
             "comma-separated substrings (e.g. 'put', "
             "'single_client,1_1_actor')")
    ap.add_argument(
        "--quick", action="store_true",
        help="reduced-duration single-rep pass")
    ap.add_argument(
        "--json", dest="as_json", action="store_true",
        help="print one machine-readable JSON line (schema microbench.v1: "
             "per-metric value + rep min/median/max) — the perf gate "
             "consumes this")
    ap.add_argument(
        "--device", default=None,
        help="device of the serve_llm rows (default: the CUDA card; "
             "'cpu' runs them on the CPU)")
    ap.add_argument(
        "--output", default=None, metavar="FILE",
        help="also write the table as markdown to FILE")
    args = ap.parse_args(argv)
    _DEVICE = args.device
    results = run_benches(quick=args.quick, only=args.only)
    if not results:
        raise SystemExit(f"no metric matches --only {args.only!r}")
    if args.output:
        with open(args.output, "w") as f:
            f.write(render_table(results))
    if args.as_json:
        print(json.dumps({
            "schema": "microbench.v1",
            "time": time.time(),
            "quick": args.quick,
            "reps": 1 if args.quick else 3,
            "host": {"cpus": os.cpu_count()},
            "metrics": last_run_detail(),
        }))
        return
    print(json.dumps(results))


if __name__ == "__main__":
    main()
