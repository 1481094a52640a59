"""Central config-flag system of the port.

A copy of ``ray_tpu/_private/config.py`` (the port imports nothing of the
JAX package): every flag is declared once in _FLAGS, with the JAX
runtime's defaults, and is overridable through ``RTPU_TORCH_<name>``
environment variables or an explicit ``system_config`` dict passed at init
time, so the two packages can be tuned apart in one process (reference:
src/ray/common/ray_config_def.h). The TPU flags (``num_tpu_chips``,
``tpu_pod_type``) give way to ``num_gpus``; the device-trace flags drive
``torch.profiler`` where the JAX package drives ``jax.profiler``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_FLAGS: Dict[str, Any] = {
    # --- object store / serialization -------------------------------------
    # Results at or below this size are returned inline in the task reply and live
    # in the owner's in-process memory store; larger ones go to plasma.
    "max_direct_call_object_size": 100 * 1024,
    # Shared-memory object store capacity per node (bytes).
    "object_store_memory": 2 * 1024**3,
    # Chunk size for node-to-node object transfer.
    "object_manager_chunk_size": 4 * 1024**2,
    # --- object spilling / memory pressure ---------------------------------
    # Watermark: spill pinned primaries to disk when plasma use crosses this
    # fraction (reference: object_spilling_threshold).
    "object_spilling_threshold": 0.8,
    "object_spilling_check_period_ms": 500,
    # Node memory fraction beyond which the raylet kills a worker to avert
    # host OOM (reference: memory_monitor.h memory_usage_threshold). Set
    # memory_monitor_refresh_ms to 0 to disable.
    "memory_usage_threshold": 0.95,
    "memory_monitor_refresh_ms": 250,
    # --- control-plane parallelism (stability contract) ---------------------
    # Operators size the control plane with these (README "Scaling the
    # control plane"); renaming any is a breaking change — add new flags
    # instead.
    #   rpc_reactor_shards     event-loop shards per RpcServer: accepted
    #                          connections round-robin across N loops
    #                          (shard 0 = the server's home loop, handlers
    #                          hop home unless marked shard-safe — see the
    #                          rpc.py module docstring). 0 = auto
    #                          (min(4, cpus)); 1 = the classic single-loop
    #                          reactor (what any 1-core box resolves to)
    #   submit_ring_slots      per-submitter plasma-backed submit ring
    #                          capacity in budgeted entries (~1 KiB each):
    #                          eligible tiny-task specs are memcpy'd into
    #                          shared memory and the raylet drains them in
    #                          batches, leaving one doorbell RPC per
    #                          empty→non-empty transition on the hot path.
    #                          0 disables (every submit rides RPC); a full
    #                          or dead ring always falls back to RPC
    #   submit_ring_dead_s     consumer-heartbeat staleness after which a
    #                          producer declares the raylet-side drain dead
    #                          and resubmits pending ring specs via RPC
    #   lease_starvation_passes  batched lease-grant passes a queued lease
    #                          request may be skipped (smaller later
    #                          requests fitting first) before it becomes a
    #                          FIFO barrier that later overlapping requests
    #                          cannot leapfrog — bounds large-request
    #                          starvation under a stream of small leases
    "rpc_reactor_shards": 0,
    "submit_ring_slots": 128,
    "submit_ring_dead_s": 5.0,
    "lease_starvation_passes": 32,
    # --- scheduling --------------------------------------------------------
    # Hybrid policy: pack onto nodes until utilization crosses this, then spread.
    "scheduler_spread_threshold": 0.5,
    "worker_lease_timeout_ms": 30_000,
    # Max tasks shipped per PushTasks RPC when the submit queue is deep
    # (adaptive: batch stays 1 unless queue >> leased workers).
    "task_push_max_batch": 16,
    # Cap on concurrent RequestWorkerLease RPCs per scheduling key.
    "max_lease_requests_in_flight": 16,
    # Direct call channels: blocking-socket fast path for serial sync actor
    # calls (direct_channel.py). RTPU_TORCH_direct_channels=0 disables.
    "direct_channels": True,
    # Per-node dashboard agent process (dashboard/agent.py): host stats,
    # metrics, profiling, log serving off the raylet's loop. The test
    # suite disables it (conftest) — one extra python process per raylet
    # is pure boot cost on a 1-core CI box.
    "dashboard_agent": True,
    # How many actor-creation lease BATCHES the GCS drives concurrently;
    # each batch pays one GCS->raylet round-trip for up to
    # actor_creation_lease_batch actors (reference: gcs_actor_scheduler.cc
    # leases per-actor in parallel; we batch on top).
    "actor_creation_parallelism": 8,
    "actor_creation_lease_batch": 16,
    # Warm worker pool: after a lease, top idle workers for that job back
    # up to this many in the background (reference: worker_pool.h:359
    # PrestartWorkers). 0 disables.
    "prestart_workers_min_idle": 2,
    # Actor-task pushes pipeline up to this many batch RPCs per actor
    # (reference: actor_task_submitter.h pushes without waiting for prior
    # replies; the receiver's seq_no reorder buffer restores order).
    "actor_push_max_inflight": 4,
    # Thread cap of the persistent pool serving batched normal-task
    # execution (tasks in one batch may synchronize with each other, so
    # each needs its own thread while running).
    "batch_exec_max_threads": 256,
    # How long a PG-bound task waits for its group's 2PC to finish before failing.
    "placement_group_ready_timeout_s": 60.0,
    # Max idle workers kept alive per node (soft cap, like num_cpus in reference).
    "idle_worker_keep_alive_s": 120.0,
    "worker_startup_timeout_s": 60.0,
    # --- fault tolerance ---------------------------------------------------
    "task_max_retries_default": 3,
    "actor_max_restarts_default": 0,
    "health_check_period_ms": 1000,
    "health_check_failure_threshold": 5,
    "max_lineage_bytes": 64 * 1024**2,
    # --- GCS fault tolerance ----------------------------------------------
    # Persist GCS tables to <session_dir>/gcs.log so a restarted GCS resumes
    # the cluster (reference: redis_store_client.h).
    "gcs_persistence": True,
    # fsync every log append (durability vs throughput).
    "gcs_log_fsync": False,
    # Compact the append log into a snapshot once it exceeds this size.
    "gcs_log_compact_bytes": 64 * 1024**2,
    # How long clients retry connecting to a dead GCS before giving up.
    "gcs_reconnect_timeout_s": 30.0,
    # --- timeouts ----------------------------------------------------------
    "gcs_rpc_timeout_s": 30.0,
    "get_timeout_warning_s": 10.0,
    "resource_report_period_ms": 250,
    # --- pubsub ------------------------------------------------------------
    "pubsub_poll_timeout_s": 30.0,
    "pubsub_max_batch": 1000,
    # --- task events / observability --------------------------------------
    "task_events_flush_period_ms": 1000,
    "task_events_max_buffer": 10_000,
    "metrics_report_period_ms": 2000,
    # Flight recorder (_private/flight_recorder.py): per-process ring of
    # structured runtime events, always on (RTPU_TORCH_flight_recorder=0 disables,
    # e.g. for A/B overhead measurement). Size is events per process.
    "flight_recorder": True,
    "flight_recorder_size": 4096,
    # Stall watchdog (_private/watchdog.py + raylet loop): check cadence;
    # <= 0 disables. A RUNNING/leased task older than watchdog_task_timeout_s,
    # a submitter making no completions for that long, or train-step
    # telemetry silent for watchdog_step_timeout_s raises a GCS incident
    # with captured stacks + a flight-recorder snapshot.
    "watchdog_interval_s": 10.0,
    "watchdog_task_timeout_s": 600.0,
    "watchdog_step_timeout_s": 300.0,
    # --- profiling plane (stability contract) ------------------------------
    # The flag names below are a public interface (operators set them in
    # automation, the README documents them); renaming any is a breaking
    # change — add new flags instead.
    #   profile_slow_step_factor     a train step slower than factor x the
    #                                trailing-median step time triggers an
    #                                automatic cluster profile capture +
    #                                slow_step incident (0 disables)
    #   profile_slow_step_cooldown_s minimum gap between slow-step captures
    #   profile_trigger_duration_s   capture window for triggered profiles
    #   profile_trigger_hz           sampling rate for triggered profiles
    #   profile_on_incident          attach a cluster profile to watchdog
    #                                incidents (stuck_task/no_progress/...)
    #   profile_max_samples          per-process cap on timestamped samples
    #                                kept for the timeline (folded counts
    #                                keep aggregating past it)
    #   device_trace_steps           arm a device trace (torch.profiler)
    #                                for N steps at the next train step;
    #                                no-ops without a CUDA device unless
    #                                RTPU_TORCH_device_trace_force=1
    #   device_trace_force           capture device traces without a
    #                                CUDA device too (tests / card-free
    #                                debugging of the trace plumbing)
    "profile_slow_step_factor": 3.0,
    "profile_slow_step_cooldown_s": 600.0,
    "profile_trigger_duration_s": 1.5,
    "profile_trigger_hz": 99.0,
    "profile_on_incident": True,
    "profile_max_samples": 200_000,
    "device_trace_steps": 0,
    "device_trace_force": False,
    # --- perf regression plane (stability contract) -------------------------
    # Same contract as the profiling flags above: operators and CI key on
    # these names (perf.yml, README "Catching a perf regression").
    #   perf_history_path            the port's perf ledger (JSONL, one
    #                                entry per committed measurement; not
    #                                the JAX package's PERF_HISTORY.jsonl);
    #                                relative paths resolve against the
    #                                repo root
    #   perf_band_scale              multiplier applied to every noise band
    #                                in _private/perf_gate.py (set >1 on
    #                                boxes noisier than the reference box)
    #   perf_compile_storm_k         >= K post-warmup jit compiles within
    #                                perf_compile_storm_window_s raise a
    #                                jit_cache_miss_storm incident
    #                                (0 disables the check)
    #   perf_compile_storm_window_s  the storm counting window
    #   perf_compile_warmup_steps    compiles while total recorded steps
    #                                <= N are expected (first trace /
    #                                shape priming) and never counted
    "perf_history_path": "PERF_HISTORY_TORCH.jsonl",
    "perf_band_scale": 1.0,
    "perf_compile_storm_k": 3,
    "perf_compile_storm_window_s": 120.0,
    "perf_compile_warmup_steps": 4,
    # --- memory observability plane (stability contract) --------------------
    # Same contract as the profiling/perf flags above: operators key on
    # these names (README "Hunting a memory leak", alerting automation).
    #   memory_ledger_callsite       capture the user callsite (file:line)
    #                                of every ray.put-shaped object
    #                                creation in the ownership ledger
    #                                (one bounded frame walk per put;
    #                                0 disables, rows show "")
    #   memory_snapshot_period_s     cadence of the per-worker on-disk
    #                                memory snapshot
    #                                (<session>/logs/memory_worker-<pid>
    #                                .json) that OOM forensics attaches to
    #                                death reports; 0 disables
    #   memory_report_top_n          ledger rows per worker in RPC reports
    #                                and snapshots (top holders by size)
    #   memory_leak_sweep_period_s   cadence of the raylet's leak sweep
    #                                (pinned/spilled primaries with no
    #                                live ref in any owner's ledger,
    #                                confirmed across two sweeps);
    #                                0 disables
    #   memory_leak_min_age_s        objects younger than this are never
    #                                leak candidates (in-flight guard on
    #                                top of the two-sweep cross-check)
    #   memory_leak_cooldown_s       minimum gap between object_leak
    #                                incidents from one raylet (each leaked
    #                                object is reported at most once)
    "memory_ledger_callsite": True,
    "memory_snapshot_period_s": 10.0,
    "memory_report_top_n": 50,
    "memory_leak_sweep_period_s": 60.0,
    "memory_leak_min_age_s": 30.0,
    "memory_leak_cooldown_s": 300.0,
    # --- serve.llm continuous-batching engine (stability contract) ----------
    # Same contract as the profiling/perf/memory flags above: operators size
    # replicas with these (README "Serving an LLM"); renaming any is a
    # breaking change — add new flags instead.
    #   llm_block_size        tokens per paged-KV block; admission cost is
    #                         ceil(prompt/block_size) blocks
    #   llm_num_blocks        KV pool size per replica (blocks); with
    #                         block_size 16 the default holds 16k tokens
    #   llm_max_batch         max sequences per fused engine step (prefill
    #                         admits only into spare slots)
    #   llm_max_waiting       admission control: past this many queued
    #                         prompts, submits are shed with a structured
    #                         LLMBackpressure error instead of OOMing the
    #                         cache
    #   llm_pull_wait_s       long-poll window of a token pull (the stream
    #                         ingress re-pulls after an empty reply)
    #   llm_prefix_cache      share full prompt blocks between sequences
    #                         (chained content hash + copy-on-write block
    #                         tables); admission then only prefills the
    #                         un-hit tail. Outputs stay byte-equal to the
    #                         uncached path; 0 disables (cold cache)
    #   llm_spec_k            draft tokens proposed per speculative-decode
    #                         step (verified by the target model in one
    #                         fused forward); only greedy sequences
    #                         speculate. 0 disables even with a draft
    #   llm_draft_model       zoo name of the draft model every LLMReplica
    #                         loads for speculative decoding ("" = off;
    #                         per-deploy `draft_model=` overrides)
    "llm_block_size": 16,
    "llm_num_blocks": 1024,
    "llm_max_batch": 32,
    "llm_max_waiting": 512,
    "llm_pull_wait_s": 2.0,
    "llm_prefix_cache": True,
    "llm_spec_k": 4,
    "llm_draft_model": "",
    # --- chaos / robustness plane (stability contract) ----------------------
    # Same contract as the sections above: CI chaos plans and operator
    # runbooks key on these names (README "Surviving failures").
    #   chaos_plan               declarative fault-injection plan, JSON:
    #                            {"seed": s, "rules": [{"site", "action",
    #                            "after_n"/"after_steps", "every_n",
    #                            "count", "prob", "delay_s", <match>}]}.
    #                            "" disarms and the injection sites cost
    #                            one module attribute read. Drivers publish
    #                            their env plan to GCS KV (ns "chaos", key
    #                            "plan") at init so every joining process
    #                            replays ONE schedule. Site names are a
    #                            contract — see _private/chaos.py.
    #   llm_stream_timeout_s     client-side per-pull timeout of a
    #                            serve.llm token stream (LlmStream); on
    #                            expiry the stream raises a structured
    #                            LlmStreamTimeoutError carrying the stream
    #                            id + tokens received, instead of a raw
    #                            get() timeout
    #   serve_failover_retries   resubmission attempts when a replica dies
    #                            mid-llm-stream (the remaining generation
    #                            moves to a surviving replica, riding the
    #                            prefix cache) and the ActorDiedError retry
    #                            budget of idempotent DeploymentHandle
    #                            calls; 0 disables failover
    #   serve_failover_backoff_s      base of the capped exponential
    #                                 backoff (+/-50% jitter) between
    #                                 failover attempts
    #   serve_failover_backoff_max_s  backoff cap
    #   incident_on_worker_crash publish a worker_crash incident when a
    #                            worker dies by signal with no recorded
    #                            kill reason (OOM kills, scale-downs and
    #                            idle reaps stay incident-free) — the
    #                            chaos suite asserts exactly one incident
    #                            per induced kill
    "chaos_plan": "",
    "llm_stream_timeout_s": 120.0,
    "serve_failover_retries": 6,
    "serve_failover_backoff_s": 0.25,
    "serve_failover_backoff_max_s": 4.0,
    "incident_on_worker_crash": True,
    # --- GPU ---------------------------------------------------------------
    # GPUs this node offers; -1 autodetects them without CUDA
    # (_private/accelerators.py): CUDA_VISIBLE_DEVICES, then the driver's
    # /proc entries, then nvidia-smi -L.
    "num_gpus": -1,
}


class _Config:
    """Attribute access over the flag table with env-var overrides.

    Precedence: explicit ``apply_system_config`` > ``RTPU_TORCH_<name>`` env var > default.
    """

    def __init__(self):
        self._overrides: Dict[str, Any] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._overrides:
            return self._overrides[name]
        if name not in _FLAGS:
            raise AttributeError(f"Unknown config flag: {name}")
        default = _FLAGS[name]
        env = os.environ.get(f"RTPU_TORCH_{name}")
        if env is None:
            return default
        if isinstance(default, bool):
            return env.lower() in ("1", "true", "yes")
        if isinstance(default, int):
            return int(env)
        if isinstance(default, float):
            return float(env)
        return env

    def apply_system_config(self, cfg: Dict[str, Any] | str | None):
        if cfg is None:
            return
        if isinstance(cfg, str):
            cfg = json.loads(cfg)
        for k, v in cfg.items():
            if k not in _FLAGS:
                raise ValueError(f"Unknown config flag: {k}")
            self._overrides[k] = v

    def dump(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in _FLAGS}


CONFIG = _Config()
