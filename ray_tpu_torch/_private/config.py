"""Serving defaults of the port, overridable from the environment.

A copy of the ``llm_*`` engine defaults of ``ray_tpu/_private/config.py``
(the port imports nothing of the JAX package). They are read from
``RTPU_TORCH_<name>`` environment variables, so the two packages can be
tuned apart in one process:

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
        return env


CONFIG = _Config()
