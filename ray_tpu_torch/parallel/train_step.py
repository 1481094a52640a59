"""One training step on one CUDA card: the port of
``ray_tpu/parallel/train_step.py`` ``TrainStep`` at dp = 1, for every model
family of the port.

The config's type picks the family, as ``model_for_mesh`` does in the JAX
package: ``GPT2Config`` trains GPT-2, ``GPT2MoEConfig`` GPT-2-MoE (whose
summed MoE aux loss is added to the objective) and ``LlamaConfig`` Llama.
The JAX package compiles one sharded step under jit over a device mesh.
The port runs eagerly on one device: the forward and backward go through
the module (whose attention is the hand-written flash kernels on the card,
forward and backward, with each block recomputed in the backward pass),
and the update is a faithful copy of the optax chain the JAX step builds:

    clip_by_global_norm(grad_clip)        g <- g              if |g| < clip
                                          g <- g / |g| * clip otherwise
    adamw(lr, b1=0.9, b2=beta2, eps=1e-8, weight_decay, mask=ndim > 1)

so weight decay touches the dense kernels, embedding tables and the MoE
expert stacks only, never biases, LayerNorm or RMSNorm weights.
``grad_norm`` in the metrics is the global norm before clipping, as in the
JAX step.

State is a dict ``{"params": model, "opt_state": {"count", "mu", "nu"},
"step": int}``: the module's fp32 parameters are the master weights, and
``mu``/``nu`` are keyed by parameter name. Where the JAX step donates its
state buffers, this one updates the parameters and moments in place and
returns the same dict.

Not ported yet: a mesh (dp/fsdp/tp/sp/ep, ROADMAP Queue A item 8) raises
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import gpt2, gpt2_moe, llama
from ray_tpu_torch.train import _telemetry

ADAM_B1 = 0.9
ADAM_EPS = 1e-8


def _batch_counts(batch) -> Tuple[Optional[int], Optional[int]]:
    """(tokens, examples) in a batch dict: the idx array's element count is
    the token count, its second-to-last dim the batch size (works for (B, T)
    steps and (num_steps, B, T) stacks)."""
    idx = batch.get("idx")
    if idx is None or not hasattr(idx, "shape"):
        return None, None
    tokens = 1
    for d in idx.shape:
        tokens *= int(d)
    return tokens, (tokens // int(idx.shape[-1]) if idx.shape[-1] else None)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax's ``clip_by_global_norm``: returns (clipped grads, the global
    norm before clipping). Below the limit the gradients pass unchanged;
    at or above it each is divided by the norm and multiplied by the limit
    (no ``+1e-6`` as in ``torch.nn.utils.clip_grad_norm_``). No host
    synchronisation: the choice is made on the device.

    The norm is optax's ``global_norm``, sqrt(sum of each tensor's sum of
    squares): ``sum`` reduces pairwise on both devices, where the CPU's
    ``vector_norm`` of an fp32 tensor of tens of millions of elements (the
    GPT-2 embedding's gradient) drifts by 1e-3 relative."""
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(out, torch.where(keep, one, one * max_norm))
    return out, norm


def family_of(model_cfg):
    """(model module, model class) a config trains, by its type:
    ``gpt2_moe``/``GPT2MoE``, ``llama``/``Llama`` or ``gpt2``/``GPT2``
    (``GPT2MoEConfig`` is tested before its base ``GPT2Config``)."""
    for cfg_cls, family, model_cls in (
            (gpt2_moe.GPT2MoEConfig, gpt2_moe, gpt2_moe.GPT2MoE),
            (llama.LlamaConfig, llama, llama.Llama),
            (gpt2.GPT2Config, gpt2, gpt2.GPT2)):
        if isinstance(model_cfg, cfg_cls):
            return family, model_cls
    raise TypeError(
        f"TrainStep takes the port's GPT2Config, GPT2MoEConfig or "
        f"LlamaConfig (ray_tpu_torch.models), got {type(model_cfg).__module__}."
        f"{type(model_cfg).__name__}")


class TrainStep:
    """The JAX package's ``TrainStep`` on one CUDA card (``device=None``) or,
    for the tests, the CPU (``device="cpu"``)::

        ts = TrainStep(GPT2Config.tiny())     # or LlamaConfig, GPT2MoEConfig
        state = ts.init(torch.Generator().manual_seed(0))
        state, metrics = ts.step(state, ts.shard_batch(batch))
        # batch: dict idx/targets (B, T); metrics: loss, grad_norm

    With ``telemetry`` on, each step call ends in a device synchronise so
    that the recorder (``self.telemetry``, made the process's current
    recorder) books the step's device time, and the first call (the
    kernels' build, cuBLAS's warm-up) is booked as the compile step; a
    device-trace window armed on the recorder (``request_device_trace``)
    opens and closes around step calls. With it off, each call still
    leaves a ``train.step`` event in the flight recorder."""

    def __init__(
        self,
        model_cfg,
        mesh=None,
        *,
        learning_rate: float = 3e-4,
        weight_decay: float = 0.1,
        beta2: float = 0.95,
        grad_clip: float = 1.0,
        flops_per_step: Optional[float] = None,
        telemetry: bool = True,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "the port's TrainStep runs on one device; meshes (dp, fsdp, "
                "tp, sp, ep) come with ROADMAP Queue A item 8")
        self.family, self._model_cls = family_of(model_cfg)
        self._is_moe = self.family is gpt2_moe
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.beta2 = beta2
        self.grad_clip = grad_clip
        self._warm = False
        self.telemetry = None
        if telemetry:
            self.telemetry = _telemetry.StepRecorder(
                flops_per_step=flops_per_step,
                flops_per_token=(None if flops_per_step is not None else
                                 _telemetry.estimate_flops_per_token(model_cfg)),
                device=self.device)
            _telemetry.set_current_recorder(self.telemetry)

    # ----------------------------------------------------------------- state

    def init(self, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Fresh state: flax-initialised fp32 parameters (drawn on the CPU
        from ``generator``, default seed 0), zero moments, step 0."""
        model = self.family.init_params(self.model_cfg, generator, device=self.device)
        zeros = lambda: {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        return {"params": model,
                "opt_state": {"count": 0, "mu": zeros(), "nu": zeros()},
                "step": 0}

    def new_model(self):
        """The family's module for this config on this step's device, with
        torch's default initialisation (``load_flax_state`` fills it)."""
        return self._model_cls(self.model_cfg, device=self.device)

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A batch of token ids (numpy or tensors) as int64 on the device."""
        return {k: torch.as_tensor(v).to(self.device, torch.long)
                for k, v in batch.items()}

    # ------------------------------------------------------------------ step

    def loss_and_grads(self, state, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss (with the MoE aux loss for GPT-2-MoE, as the JAX step's
        objective) and the raw (unclipped) gradient of every parameter."""
        model = state["params"]
        names, params = zip(*model.named_parameters())
        if self._is_moe:
            logits, aux = model(batch["idx"])
            loss = self.family.loss_fn(logits, batch["targets"]) + aux
        else:
            loss = self.family.loss_fn(model(batch["idx"]), batch["targets"])
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))

    def _step(self, state, batch) -> Dict[str, torch.Tensor]:
        loss, grads = self.loss_and_grads(state, batch)
        names = list(grads)
        params = dict(state["params"].named_parameters())
        g, norm = clip_by_global_norm([grads[n] for n in names], self.grad_clip)
        opt = state["opt_state"]
        mu = [opt["mu"][n] for n in names]
        nu = [opt["nu"][n] for n in names]
        p = [params[n] for n in names]
        b2 = self.beta2
        with torch.no_grad():
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            opt["count"] += 1
            count = opt["count"]
            den = torch._foreach_div(nu, 1 - b2 ** count)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            upd = torch._foreach_div(mu, 1 - ADAM_B1 ** count)
            torch._foreach_div_(upd, den)
            decayed = [i for i, x in enumerate(p) if x.ndim > 1]
            torch._foreach_add_([upd[i] for i in decayed],
                                [p[i] for i in decayed], alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-self.learning_rate)
        state["step"] += 1
        return {"loss": loss, "grad_norm": norm}

    def _record(self, t0: float, batch, steps: int, compiled: bool,
                repeats: int = 1) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tokens, examples = (None, None) if compiled else _batch_counts(batch)
        self.telemetry.record_step(
            time.perf_counter() - t0, steps=steps,
            tokens=tokens and tokens * repeats,
            examples=examples and examples * repeats, compile_step=compiled)

    def step(self, state, batch) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """One optimizer step. Updates ``state`` in place (where the JAX
        step donates it) and returns it with ``{"loss", "grad_norm"}``."""
        rec = self.telemetry
        if rec is None:
            # telemetry off: one breadcrumb per call ("did step N start" is
            # what a hung job gets asked)
            _fr.record("train.step", b"", "dispatch" if self._warm else "trace+compile")
            metrics = self._step(state, batch)
            self._warm = True
            return state, metrics
        rec.device_trace.on_step_begin()
        t0 = time.perf_counter()
        compiled = not self._warm
        metrics = self._step(state, batch)
        self._warm = True
        self._record(t0, batch, 1, compiled)
        rec.device_trace.on_step_end(metrics)
        return state, metrics

    def multi_step(self, state, batches, num_steps: int):
        """``num_steps`` optimizer steps in one call, metrics stacked over
        steps. ``batches`` holds arrays with a leading (num_steps, ...) axis,
        or is a single batch reused every step (the JAX step's rule: a batch
        is already stacked iff it carries that extra leading axis)."""
        sample = next(iter(batches.values()))
        stacked = sample.ndim >= 3 and sample.shape[0] == num_steps
        rec = self.telemetry
        if rec is None:
            _fr.record("train.step", b"", f"multi_step x{num_steps}")
        else:
            rec.device_trace.on_step_begin()
        t0 = time.perf_counter()
        compiled = not self._warm
        out = []
        for i in range(num_steps):
            batch = {k: v[i] for k, v in batches.items()} if stacked else batches
            out.append(self._step(state, batch))
        self._warm = True
        metrics = {k: torch.stack([m[k] for m in out]) for k in out[0]}
        if rec is not None:
            self._record(t0, batches, num_steps, compiled,
                         repeats=1 if stacked else num_steps)
            rec.device_trace.on_step_end(metrics)
        return state, metrics
