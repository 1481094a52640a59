"""Defaults of the port, overridable from the environment.

A copy of the flags of ``ray_tpu/_private/config.py`` that the port's
modules read, with the same defaults (the port imports nothing of the JAX
package). They are read from ``RTPU_TORCH_<name>`` environment variables,
so the two packages can be tuned apart in one process.

Serving (``serve/llm``):

  llm_block_size     tokens per paged-KV block; admission costs
                     ceil(prompt / block_size) blocks
  llm_num_blocks     KV pool size per engine (blocks); with block_size 16
                     the default holds 16k tokens
  llm_max_batch      max sequences per engine step (prefills admit only
                     into spare slots)
  llm_max_waiting    admission control: past this many queued prompts,
                     submits are shed with a structured LLMBackpressure
                     error instead of exhausting the cache
  llm_prefix_cache   share full prompt blocks between sequences (chained
                     content hash + copy-on-write); 0 disables
  llm_spec_k         draft tokens proposed per speculative-decode step
                     (verified by the target model in one fused forward)
                     when the engine has a draft model; only greedy
                     sequences speculate. 0 disables even with a draft

Flight recorder (``_private/flight_recorder.py``):

  flight_recorder    per-process ring of structured events, always on; 0
                     gives the no-op recorder (A/B overhead measurement)
  flight_recorder_size  events kept per process

Train telemetry (``train/_telemetry.py``):

  profile_slow_step_factor     a train step slower than factor x the
                               trailing-median step time raises the
                               recorder's slow-step flag (0 disables)
  device_trace_steps           arm a device trace (torch.profiler) for N
                               steps at the next train step; no-ops
                               without a CUDA device unless
                               RTPU_TORCH_device_trace_force=1
  device_trace_force           capture device traces without a CUDA
                               device too (tests, host-trace debugging)
  perf_compile_storm_k         >= K post-warm-up compile steps within
                               perf_compile_storm_window_s raise the
                               recorder's compile-storm flag (0 disables)
  perf_compile_storm_window_s  the storm counting window
  perf_compile_warmup_steps    compile steps while the recorded steps are
                               <= N are expected and never counted
"""

from __future__ import annotations

import os
from typing import Any, Dict

_FLAGS: Dict[str, Any] = {
    "llm_block_size": 16,
    "llm_num_blocks": 1024,
    "llm_max_batch": 32,
    "llm_max_waiting": 512,
    "llm_prefix_cache": True,
    "llm_spec_k": 4,
    "flight_recorder": True,
    "flight_recorder_size": 4096,
    "profile_slow_step_factor": 3.0,
    "device_trace_steps": 0,
    "device_trace_force": False,
    "perf_compile_storm_k": 3,
    "perf_compile_storm_window_s": 120.0,
    "perf_compile_warmup_steps": 4,
}


class _Config:
    """Attribute access over the flag table; ``RTPU_TORCH_<name>`` wins."""

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
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


CONFIG = _Config()
