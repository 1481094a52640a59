"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A second package beside ``ray_tpu``, which stays the JAX reference. The
port imports ``torch`` and numpy and nothing of JAX or of ``ray_tpu``: the
device-free pieces it needs (the LLM scheduler, the KV-cache bookkeeping,
the engine's config defaults) are copied into it. Every Pallas kernel of
the JAX package on a ported path becomes a kernel written by hand for the
H100 (``csrc/``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use),
with its plain PyTorch version beside it.

What is ported so far (the serving and training slices):

  ops/attention.py       causal attention, differentiable; on a CUDA tensor
                         the flash forward kernel ``csrc/flash_attn_fwd.cu``
                         (the port of ``_fwd_kernel``) and the dq and dk/dv
                         backward kernels ``csrc/flash_attn_bwd.cu`` (the
                         ports of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``),
                         on a CPU tensor their plain versions
  models/gpt2.py         GPT-2 as an ``nn.Module`` (fp32 parameters, compute
                         in ``config.dtype``, per-block checkpointing) + flax
                         weight and train-state loaders
  parallel/train_step.py TrainStep at dp = 1: AdamW with optax's clip and
                         weight-decay mask, step / multi_step
  train/_telemetry.py    StepRecorder arithmetic: goodput, tokens/s, MFU, HBM
  serve/llm/             LLM engine, scheduler, paged KV cache on the
                         device, GPT-2 and fake adapters

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
The trainer (worker groups over the runtime) comes later.
"""

__version__ = "0.1.0"
