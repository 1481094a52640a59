"""ray_tpu_torch.serve.llm — continuous-batching LLM inference engine on
a CUDA card.

The port of ``ray_tpu.serve.llm``: a paged KV cache whose pools live on the
device (``kv_cache.PagedKVCache``), the prefill/decode scheduler with
preemption (``scheduler.Scheduler``, copied unchanged), prefix caching with
copy-on-write block sharing, admission control with a structured
``LLMBackpressure`` error, and model adapters whose cold prefill attention
runs the hand-written flash kernel (``ray_tpu_torch/csrc``).

Quick start (tokens in, tokens out; weights are seeded random)::

    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    engine = LLMEngine(build_adapter("gpt2"))           # on the card
    rid = engine.submit([5, 9, 17], SamplingParams(max_tokens=32))
    engine.run_until_drained()
    tokens, done, reason = engine.pull(rid)

In this slice the engine is the entry point; ``LLMReplica``, ``deploy``,
``stream`` and ``generate`` (the serve deployment) come later.
"""

from __future__ import annotations

from ray_tpu_torch.serve.llm.engine import (
    LLMBackpressure,
    LLMEngine,
    SamplingParams,
)
from ray_tpu_torch.serve.llm.kv_cache import PagedKVCache
from ray_tpu_torch.serve.llm.scheduler import Scheduler, Sequence, StepPlan

__all__ = [
    "PagedKVCache",
    "Scheduler",
    "Sequence",
    "StepPlan",
    "LLMEngine",
    "LLMBackpressure",
    "SamplingParams",
]
