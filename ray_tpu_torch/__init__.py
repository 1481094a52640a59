"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A second package beside ``ray_tpu``, which stays the JAX reference. The
port imports ``torch`` and numpy and nothing of JAX or of ``ray_tpu``: the
device-free pieces it needs (the LLM scheduler, the KV-cache bookkeeping,
the engine's config defaults) are copied into it. Every Pallas kernel of
the JAX package on a ported path becomes a kernel written by hand for the
H100 (``csrc/``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use),
with its plain PyTorch version beside it.

What is ported so far (the serving slice):

  ops/attention.py       causal attention; on a CUDA tensor the flash
                         forward kernel ``csrc/flash_attn_fwd.cu`` (the
                         port of ``_fwd_kernel``), on a CPU tensor its plain
                         version
  models/gpt2.py         GPT-2 as an ``nn.Module`` + flax weight loader
  serve/llm/             LLM engine, scheduler, paged KV cache on the
                         device, GPT-2 and fake adapters

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
Training (the backward kernels, ``TrainStep``) comes in the next slice.
"""

__version__ = "0.1.0"
