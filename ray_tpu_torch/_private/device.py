"""Where the port runs: the CUDA card unless the caller asks for the CPU.

The counterpart of ``_on_tpu`` in ``ray_tpu/ops/attention.py``, with the
opposite default: the JAX package fell back to the CPU silently when no TPU
was there; the port's entry points never do. ``device=None`` means CUDA,
and a missing CUDA device is an error. Tests pass ``device="cpu"``
explicitly and then run the plain PyTorch versions of every kernel.

fp32 policy: the port compares itself with fp32 references (the JAX
package's numpy adapters and XLA forward), so TF32 is off for matrix
products and for cuDNN whenever a CUDA device is resolved. TF32 keeps about
three decimal digits, far outside the fp32 tolerances the tests state.
"""

from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Full-precision fp32 products on the card (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device unless told otherwise, "
                "and torch.cuda.is_available() is False here; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        set_fp32_policy()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
