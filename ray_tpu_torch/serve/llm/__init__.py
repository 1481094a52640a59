"""ray_tpu_torch.serve.llm — continuous-batching LLM inference engine on
a CUDA card.

The port of ``ray_tpu.serve.llm``: a paged KV cache whose pools live on the
device (``kv_cache.PagedKVCache``), the prefill/decode scheduler with
preemption (``scheduler.Scheduler``, copied unchanged), prefix caching with
copy-on-write block sharing, speculative decoding against a draft model
(``draft_adapter=``, ``spec_k=``), admission control with a structured
``LLMBackpressure`` error, and model adapters (GPT-2, GPT-2-MoE, Llama)
whose cold prefill attention runs the hand-written flash kernel
(``ray_tpu_torch/csrc``).

Quick start (tokens in, tokens out; weights are seeded random)::

    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    engine = LLMEngine(build_adapter("llama-160m"),     # on the card
                       draft_adapter=build_adapter(
                           "llama-tiny",
                           {"vocab_size": 32000, "block_size": 1024}),
                       spec_k=4)
    rid = engine.submit([5, 9, 17], SamplingParams(max_tokens=32))
    engine.run_until_drained()
    tokens, done, reason = engine.pull(rid)

In this slice the engine is the entry point; ``LLMReplica``, ``deploy``,
``stream`` and ``generate`` (the serve deployment) come later.
"""

from __future__ import annotations

from ray_tpu_torch.serve.llm.adapters import (
    MODEL_ZOO,
    FakeAdapter,
    GPT2Adapter,
    GPT2MoEAdapter,
    LlamaAdapter,
    ModelAdapter,
    build_adapter,
)
from ray_tpu_torch.serve.llm.engine import (
    LLMBackpressure,
    LLMEngine,
    SamplingParams,
)
from ray_tpu_torch.serve.llm.kv_cache import PagedKVCache
from ray_tpu_torch.serve.llm.scheduler import Scheduler, Sequence, StepPlan

__all__ = [
    "MODEL_ZOO",
    "ModelAdapter",
    "GPT2Adapter",
    "GPT2MoEAdapter",
    "LlamaAdapter",
    "FakeAdapter",
    "build_adapter",
    "PagedKVCache",
    "Scheduler",
    "Sequence",
    "StepPlan",
    "LLMEngine",
    "LLMBackpressure",
    "SamplingParams",
]
