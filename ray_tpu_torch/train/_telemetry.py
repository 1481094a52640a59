"""Step-level training telemetry: the device-free arithmetic of the JAX
package's ``ray_tpu/train/_telemetry.py`` ``StepRecorder``.

A :class:`StepRecorder` takes one ``record_step`` per step call and gives
goodput, tokens and examples per second, MFU and a summary dict, with the
same formulas and keys as the JAX package's. What differs on the card:

  - The peak table is keyed by substrings of ``torch.cuda.get_device_name``
    and holds the H100 SXM's dense bf16 peak; an unknown device (the CPU,
    another card) gets no MFU rather than a wrong one.
  - HBM comes from ``torch.cuda.memory_allocated`` (in use) and
    ``torch.cuda.max_memory_allocated`` (peak); absent on the CPU.
  - Torch keeps no jit cache, so there is no cache miss to detect: the
    caller books its first step (the kernels' build and cuBLAS's warm-up)
    as the compile step.

Not ported yet (ROADMAP Queue A item 5): metric, span and flight-recorder
publishing, slow-step and compile-storm flags, and the device-trace window.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

# Peak dense matmul throughput per card (bf16 FLOP/s), keyed by substrings of
# torch.cuda.get_device_name: NVIDIA's H100 SXM data sheet (the SXM part
# reports itself as "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts, whose
# peaks are lower, do not match).
_PEAK_FLOPS_BY_NAME = {
    "H100 80GB HBM3": 989e12,
}


def peak_flops_per_device(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a ``torch.cuda.get_device_name`` string,
    or None for a device the table does not know."""
    for name, flops in _PEAK_FLOPS_BY_NAME.items():
        if name.lower() in device_name.lower():
            return flops
    return None


def estimate_flops_per_token(model_cfg: Any) -> Optional[float]:
    """~6N FLOPs/token (forward + backward) from a transformer config's
    shape fields (n_layer, n_embd, vocab_size): N = 12 L d^2 + vocab d.
    Attention's sequence-length-dependent FLOPs are left out, as in the JAX
    package, which underestimates MFU by a few percent."""
    n_layer = getattr(model_cfg, "n_layer", None)
    n_embd = getattr(model_cfg, "n_embd", None)
    vocab = getattr(model_cfg, "vocab_size", None)
    if not (n_layer and n_embd and vocab):
        return None
    params = 12 * n_layer * n_embd * n_embd + vocab * n_embd
    return 6.0 * params


class StepRecorder:
    """Accumulates step-level training telemetry for one run on one device.

    ``device`` (a torch device) is where HBM is read and, when
    ``peak_flops`` is not given, whose name picks the peak; ``clock`` is
    injectable for tests."""

    def __init__(
        self,
        *,
        flops_per_step: Optional[float] = None,
        flops_per_token: Optional[float] = None,
        peak_flops: Optional[float] = None,
        device=None,
        clock=time.monotonic,
    ):
        self._clock = clock
        self._flops_per_step = flops_per_step
        self._flops_per_token = flops_per_token
        self._explicit_peak = peak_flops
        self._device = torch.device(device) if device is not None else None
        self._start = self._clock()
        self.steps = 0
        self.productive_steps = 0
        self.productive_s = 0.0
        self.compile_s = 0.0
        self.tokens = 0
        self.examples = 0
        self._last_step_s = 0.0

    # ------------------------------------------------------------ recording

    def record_step(
        self,
        duration_s: float,
        *,
        steps: int = 1,
        tokens: Optional[int] = None,
        examples: Optional[int] = None,
        compile_step: bool = False,
    ) -> None:
        """Record ``steps`` optimizer steps that took ``duration_s`` of wall
        time in total. A ``compile_step`` is booked as compile time, not
        productive time, so MFU and throughput are not poisoned by it."""
        duration_s = max(0.0, float(duration_s))
        self.steps += steps
        if compile_step:
            self.compile_s += duration_s
        else:
            self.productive_s += duration_s
            self.productive_steps += steps
            self._last_step_s = duration_s / max(steps, 1)
        if tokens:
            self.tokens += tokens
        if examples:
            self.examples += examples

    # ------------------------------------------------------------- derived

    def _elapsed(self) -> float:
        return max(self._clock() - self._start, 1e-9)

    def goodput(self) -> float:
        """Fraction of elapsed wall time spent in productive steps."""
        return min(1.0, self.productive_s / self._elapsed())

    def tokens_per_second(self) -> Optional[float]:
        if not self.tokens or self.productive_s <= 0:
            return None
        return self.tokens / self.productive_s

    def examples_per_second(self) -> Optional[float]:
        if not self.examples or self.productive_s <= 0:
            return None
        return self.examples / self.productive_s

    def _peak_flops(self) -> Optional[float]:
        if self._explicit_peak is not None:
            return self._explicit_peak
        if self._device is None or self._device.type != "cuda":
            return None
        return peak_flops_per_device(torch.cuda.get_device_name(self._device))

    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization: achieved FLOP/s over peak FLOP/s; None
        without a FLOPs estimate or a known peak."""
        peak = self._peak_flops()
        if peak is None or self.productive_s <= 0:
            return None
        if self._flops_per_step is not None:
            achieved = self._flops_per_step * self.productive_steps
        elif self._flops_per_token is not None and self.tokens:
            achieved = self._flops_per_token * self.tokens
        else:
            return None
        return achieved / self.productive_s / peak

    def hbm_bytes(self) -> Dict[str, float]:
        """``{"in_use": ..., "peak": ...}`` bytes allocated by PyTorch on the
        recorder's CUDA device; {} elsewhere."""
        if self._device is None or self._device.type != "cuda":
            return {}
        return {"in_use": float(torch.cuda.memory_allocated(self._device)),
                "peak": float(torch.cuda.max_memory_allocated(self._device))}

    def summary(self) -> Dict[str, Any]:
        """Rolling summary dict, with the JAX package's keys (plus
        ``hbm_peak_bytes``)."""
        out = {
            "steps": self.steps,
            "step_time_s": self._last_step_s,
            "productive_time_s": round(self.productive_s, 6),
            "compile_time_s": round(self.compile_s, 6),
            "goodput": round(self.goodput(), 6),
        }
        tps = self.tokens_per_second()
        if tps is not None:
            out["tokens_per_s"] = round(tps, 3)
        eps = self.examples_per_second()
        if eps is not None:
            out["examples_per_s"] = round(eps, 3)
        mfu = self.mfu()
        if mfu is not None:
            out["mfu"] = round(mfu, 6)
        hbm = self.hbm_bytes()
        if hbm:
            out["hbm_bytes_in_use"] = hbm["in_use"]
            out["hbm_peak_bytes"] = hbm["peak"]
        return out
