"""Pipeline parallelism (pp) for GPT-2: the port of
``ray_tpu/parallel/pipeline.py``.

The JAX package stacks the transformer blocks along a leading layer dim
sharded over the ``pp`` mesh axis and runs a GPipe microbatch schedule as
a ``lax.scan`` over clock ticks, ``ppermute`` shifting activations from
stage to stage; autodiff through the scan gives the backward. The port
runs one process per rank, so each pp rank holds its stage's
``n_layer / pp`` blocks (layers ``[r · L/pp, (r+1) · L/pp)`` of stage r)
as modules and runs the GPipe schedule itself, its stage hand-offs plain
point-to-point sends (``_collectives.send_to`` / ``recv_from``) and its
backward an explicit loop over the microbatches.

Every rank of the pp group runs these in the same order, with M
microbatches (rows ``[m · B/M, (m+1) · B/M)`` of this dp rank's rows):

  forward   for m = 0 .. M-1: stage 0 embeds microbatch m, stage r > 0
            receives x_m from r - 1; the stage's blocks give y_m; stage
            r < pp - 1 sends y_m to r + 1
  head      the last stage runs the final norm, the tied head and the
            loss over its M outputs concatenated (JAX runs the head over
            the reassembled batch)
  backward  for m = M-1 .. 0: the last stage takes dy_m from the head's
            backward, stage r < pp - 1 receives dy_m from r + 1; the
            stage's blocks backpropagate it; stage r > 0 sends dx_m to
            r - 1 (stage 0's reaches the embedding)
  then      the loss broadcast from the last stage over pp; the gradients
            of ``wte``, ``wpe`` and ``ln_f`` summed over pp (``wte`` is
            tied: its lookup's gradient arises on stage 0 and its head's
            on the last stage, Megatron's first/last-stage all-reduce);
            every gradient averaged over dp; the blocks' square sums of
            the norm summed over pp

A send may block until its peer receives it (gloo's do); the schedule is
a chain in each direction, so no rank waits on one that waits on it. At
pp = 1 the one rank is both stages and sends nothing.

The JAX ``PipelineTrainStep`` holds its parameters replicated over dp (its
state specs name pp only), so the port's are too: the dp average is one
all-reduce per gradient, with no FSDP2 sharding. Its parameters and
update are its own and not ``TrainStep``'s: ``wte`` and ``wpe`` raw tables
drawn normal · 0.02, the final norm hand-written (eps 1e-5, the head in
fp32), and optax ``adamw`` at its default b2 = 0.999.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import _flax
from ray_tpu_torch.models.gpt2 import Block, GPT2Config, loss_fn
from ray_tpu_torch.parallel import mesh as _mesh
from ray_tpu_torch.parallel._collectives import all_reduce_mean, recv_from, send_to
from ray_tpu_torch.parallel.train_step import adamw_update_, clip_by_global_norm

HEAD_NORM_EPS = 1e-5   # the JAX step's hand-written final norm
ADAM_B2 = 0.999        # optax.adamw's default: the JAX step passes no b2


class _Stage:
    """This rank's place in the pipeline: its pp group, rank and size."""

    def __init__(self, mesh):
        self.group = _mesh.axis_group(mesh, "pp")
        self.size = _mesh.axis_size(mesh, "pp")
        self.rank = _mesh.axis_index(mesh, "pp")
        self.first = self.rank == 0
        self.last = self.rank == self.size - 1


def _schedule_forward(stage: _Stage, run_stack: Callable, first_input: Callable,
                      num_micro: int, shape, dtype, device, grad: bool
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The forward half of the schedule: (x_m, y_m) of each microbatch on
    this stage, x_m a received leaf (with ``grad``, one that keeps its
    gradient) on every stage but the first."""
    pairs = []
    for m in range(num_micro):
        if stage.first:
            x = first_input(m)
        else:
            x = recv_from(shape, dtype, device, stage.group, stage.rank - 1)
            x.requires_grad_(grad)
        y = run_stack(x)
        if not stage.last:
            send_to(y.detach(), stage.group, stage.rank + 1)
        pairs.append((x, y))
    return pairs


def _broadcast_from_last(t: torch.Tensor, stage: _Stage) -> torch.Tensor:
    if stage.group is not None:
        dist.broadcast(t, dist.get_global_rank(stage.group, stage.size - 1),
                       group=stage.group)
    return t


def pipeline_apply(mesh, block_apply: Callable, local_stack: Sequence, h: torch.Tensor,
                   num_micro: int) -> torch.Tensor:
    """Run ``h`` (B_local, T, D: this dp rank's rows) through the
    pp-split blocks on the GPipe schedule, forward only.

    ``block_apply(layer, x)`` applies one block; ``local_stack`` is this
    stage's layers in order (modules, parameters, or a tensor whose dim 0
    is the layer). Stage 0 reads ``h``; the result is the last stage's,
    given to every pp rank, as the JAX function's ``psum`` over pp does."""
    stage = _Stage(mesh)
    B = h.shape[0]
    if B % num_micro:
        raise ValueError(f"{B} rows do not split into {num_micro} microbatches")
    mb = B // num_micro
    shape = (mb,) + tuple(h.shape[1:])

    def run_stack(x):
        for layer in local_stack:
            x = block_apply(layer, x)
        return x

    with torch.no_grad():
        pairs = _schedule_forward(stage, run_stack, lambda m: h[m * mb:(m + 1) * mb],
                                  num_micro, shape, h.dtype, h.device, grad=False)
        out = (torch.cat([y for _, y in pairs]) if stage.last
               else torch.empty_like(h))
        return _broadcast_from_last(out.contiguous(), stage)


class _HeadNorm(nn.Module):
    """The JAX step's final norm parameters, ``ln_f/scale`` and ``ln_f/bias``."""

    def __init__(self, n: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))


class PipelineGPT2(nn.Module):
    """One pipeline stage's parameters: ``wte`` (V, C) and ``wpe``
    (block, C) as raw fp32 tables, this stage's ``n_layer / pp`` port
    ``Block``s (layers ``first_layer`` onwards) and ``ln_f``. Every stage
    holds the tables and the norm (JAX replicates them over pp); stage 0
    looks up and the last stage runs the head."""

    def __init__(self, cfg: GPT2Config, stage: int, n_stages: int, device):
        super().__init__()
        per = cfg.n_layer // n_stages
        self.config = cfg
        self.first_layer = stage * per
        C = cfg.n_embd
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, C, device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.block_size, C, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(per))
        self.ln_f = _HeadNorm(C, device)

    def embed(self, idx):
        """``wte.astype(dtype)[idx] + wpe.astype(dtype)[arange(T)]``."""
        dt = self.config.dtype
        pos = torch.arange(idx.shape[-1], device=idx.device)
        return F.embedding(idx, self.wte).to(dt) + F.embedding(pos, self.wpe).to(dt)[None]

    def run_stack(self, x):
        """This stage's blocks, each checkpointed under grad (``remat``)."""
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return x

    def head(self, h):
        """The JAX step's hand-written norm in ``h``'s type (eps 1e-5), its
        fp32 scale and bias, then ``h.float() @ wte.T`` in fp32."""
        mean = h.mean(-1, keepdim=True)
        var = ((h - mean) ** 2).mean(-1, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + HEAD_NORM_EPS)
        h = h * self.ln_f.scale + self.ln_f.bias
        return h.float() @ self.wte.T

    def flax_path(self, name: str) -> Tuple[str, Optional[int]]:
        """(the JAX state's path of parameter ``name``, its layer in the
        stacked blocks or None)."""
        if name.startswith("blocks."):
            _, j, rest = name.split(".", 2)
            path = _flax.flax_path(self.blocks[int(j)], rest)
            return f"blocks/{path}", self.first_layer + int(j)
        return name.replace(".", "/"), None

    def shared(self, name: str) -> bool:
        """Whether every stage holds parameter ``name`` (not a block's)."""
        return not name.startswith("blocks.")


def _init_values(cfg: GPT2Config, generator: Optional[torch.Generator]):
    """Whole fp32 parameters on the CPU, as the JAX step's ``init_fn`` has
    them: ``wte`` and ``wpe`` normal · 0.02, each layer flax's Block
    initialisers, ``ln_f`` ones and zeros; ``{flax path: tensor}``, the
    blocks stacked (L, ...) in flax's layout."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    C = cfg.n_embd
    out = {"wte": torch.randn(cfg.vocab_size, C, generator=gen) * 0.02,
           "wpe": torch.randn(cfg.block_size, C, generator=gen) * 0.02,
           "ln_f/scale": torch.ones(C), "ln_f/bias": torch.zeros(C)}
    layers = []
    for _ in range(cfg.n_layer):
        block = _flax.flax_init_(Block(cfg, "cpu"), 1.0 / math.sqrt(C), gen)
        layers.append({_flax.flax_path(block, n): (p.detach().T if n.endswith("weight")
                                                   and p.ndim == 2 else p.detach())
                       for n, p in block.named_parameters()})
    for path in layers[0]:
        out[f"blocks/{path}"] = torch.stack([layer[path] for layer in layers])
    return out


def _local_value(model: PipelineGPT2, name: str, values: Dict[str, Any]) -> torch.Tensor:
    """This stage's tensor of parameter ``name`` from whole values keyed by
    flax path (blocks stacked), dense kernels transposed to (out, in)."""
    path, layer = model.flax_path(name)
    if path not in values:
        raise ValueError(f"no {path} in the state for parameter {name}")
    t = torch.as_tensor(np.asarray(values[path], dtype=np.float32))
    if layer is not None:
        t = t[layer]
    if path.endswith("kernel"):
        t = t.T
    return t


class PipelineTrainStep:
    """The JAX package's ``PipelineTrainStep`` for GPT-2 on a (dp, pp) mesh,
    one process per rank::

        pts = PipelineTrainStep(GPT2Config(...), make_mesh({"dp": 2, "pp": 2}),
                                num_microbatches=4)
        state = pts.init(torch.Generator().manual_seed(0))
        state, metrics = pts.step(state, pts.shard_batch(batch))

    State is ``{"params": this stage's PipelineGPT2, "opt_state": {"count",
    "mu", "nu"}, "step"}``; metrics are the global batch's loss and the
    whole gradient's norm before clipping, the same on every rank. The
    update is optax's ``clip_by_global_norm(grad_clip)`` then ``adamw(lr,
    b1=0.9, b2=0.999, eps=1e-8, weight_decay)`` on the parameters of
    ndim > 1 (per layer, as the JAX step's mask counts them)."""

    def __init__(self, model_cfg: GPT2Config, mesh, *, num_microbatches: Optional[int] = None,
                 learning_rate: float = 3e-4, weight_decay: float = 0.1,
                 grad_clip: float = 1.0, device=None):
        if "pp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("PipelineTrainStep needs a 'pp' mesh axis")
        pp = _mesh.axis_size(mesh, "pp")
        if model_cfg.n_layer % pp:
            raise ValueError(f"n_layer={model_cfg.n_layer} not divisible by pp={pp}")
        if device is not None and torch.device(device).type != mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
        self.model_cfg = model_cfg
        self.mesh = mesh
        self.pp = pp
        self.num_micro = num_microbatches or 2 * pp
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.device = torch.device(mesh.device_type)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stage = _Stage(mesh)
        self.dp = _mesh.axis_size(mesh, "dp")
        self._dp_group = _mesh.axis_group(mesh, "dp")

    # ----------------------------------------------------------------- state

    def new_model(self) -> PipelineGPT2:
        """This stage's module, uninitialised (``load_full`` fills it)."""
        return PipelineGPT2(self.model_cfg, self.stage.rank, self.pp, self.device)

    def load_full(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """A fresh state (zero moments, step 0) whose parameters come from
        whole values keyed by the JAX state's paths (blocks stacked)."""
        model = self.new_model()
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(_local_value(model, name, values))
        zeros = lambda: {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        return {"params": model, "opt_state": {"count": 0, "mu": zeros(), "nu": zeros()},
                "step": 0}

    def init(self, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Fresh state: every rank draws the whole parameters on the CPU from
        ``generator`` (default seed 0) and keeps its stage's."""
        return self.load_full(_init_values(self.model_cfg, generator))

    def _check_batch(self, B: int) -> None:
        dp = self.dp
        if B % dp or (B // dp) % self.num_micro:
            raise ValueError(
                f"batch size {B} must divide by dp={dp} and the per-shard "
                f"batch ({B // dp if B % dp == 0 else '?'}) by "
                f"num_microbatches={self.num_micro}; pass a compatible "
                "batch size or num_microbatches to PipelineTrainStep")

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This dp rank's rows of a global (B, T) batch, as int64 on the
        device (replicated over pp)."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            self._check_batch(v.shape[0])
            rows = _mesh._block(self.mesh, ("dp",), v.shape[0])
            out[k] = v[rows].to(self.device, torch.long)
        return out

    # ------------------------------------------------------------------ step

    def forward(self, model: PipelineGPT2, idx: torch.Tensor) -> torch.Tensor:
        """The fp32 logits (B_local, T, V) of this dp rank's rows, on every
        pp rank: the embedding, ``pipeline_apply`` over the stages, the
        head. No gradient."""
        with torch.no_grad():
            h = model.embed(idx)
            h = pipeline_apply(self.mesh, lambda blk, x: blk(x), model.blocks, h,
                               self.num_micro)
            return model.head(h)

    def _loss_and_backward(self, model: PipelineGPT2, batch) -> torch.Tensor:
        """The schedule: forward, head and loss on the last stage, backward
        microbatch by microbatch in reverse; each parameter's ``grad`` holds
        this rank's part. Returns the loss of this dp rank's rows on the
        last stage (0 elsewhere)."""
        stage, cfg = self.stage, self.model_cfg
        idx, targets = batch["idx"], batch["targets"]
        M = self.num_micro
        mb = idx.shape[0] // M
        shape = (mb, idx.shape[1], cfg.n_embd)
        pairs = _schedule_forward(stage, model.run_stack,
                                  lambda m: model.embed(idx[m * mb:(m + 1) * mb]),
                                  M, shape, cfg.dtype, self.device, grad=True)
        loss = torch.zeros((), device=self.device)
        if stage.last:
            outs = [y.detach().requires_grad_() for _, y in pairs]
            loss = loss_fn(model.head(torch.cat(outs)), targets)
            loss.backward()
        for m in reversed(range(M)):
            x, y = pairs[m]
            if stage.last:
                dy = outs[m].grad
            else:
                dy = recv_from(shape, cfg.dtype, self.device, stage.group, stage.rank + 1)
            torch.autograd.backward(y, dy)
            if not stage.first:
                send_to(x.grad, stage.group, stage.rank - 1)
        return loss.detach()

    def loss_and_grads(self, state, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The global batch's loss (on every rank) and this stage's gradient
        of every parameter it holds: shared ones summed over pp, every one
        averaged over dp."""
        self._check_batch(batch["idx"].shape[0] * self.dp)
        model = state["params"]
        loss = _broadcast_from_last(self._loss_and_backward(model, batch), self.stage)
        grads = {}
        for name, p in model.named_parameters():
            grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        shared = [n for n in grads if model.shared(n)]
        if self.stage.group is not None:
            for n in shared:
                dist.all_reduce(grads[n], group=self.stage.group)
        if self._dp_group is not None:
            for g in grads.values():
                dist.all_reduce(g, group=self._dp_group)
                g.div_(self.dp)
            loss = all_reduce_mean(loss, self._dp_group)
        return loss, grads

    def _norm(self, model: PipelineGPT2, names, grads) -> torch.Tensor:
        """The whole gradient's global norm: the blocks' square sums over
        every stage, the shared parameters' once."""
        sq = torch.stack([g.square().sum() for g in grads])
        shared = torch.tensor([model.shared(n) for n in names], device=sq.device)
        blocks = sq[~shared].sum()
        if self.stage.group is not None:
            dist.all_reduce(blocks, group=self.stage.group)
        return (blocks + sq[shared].sum()).sqrt()

    def step(self, state, batch) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """One optimizer step; updates ``state`` in place and returns it with
        ``{"loss", "grad_norm"}``."""
        loss, grads = self.loss_and_grads(state, batch)
        model = state["params"]
        names = list(grads)
        norm = self._norm(model, names, [grads[n] for n in names])
        g, norm = clip_by_global_norm([grads[n] for n in names], self.grad_clip, norm)
        params = dict(model.named_parameters())
        opt = state["opt_state"]
        opt["count"] += 1
        adamw_update_([params[n] for n in names], g, [opt["mu"][n] for n in names],
                      [opt["nu"][n] for n in names], opt["count"],
                      learning_rate=self.learning_rate, beta2=ADAM_B2,
                      weight_decay=self.weight_decay)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": norm}


def load_flax_state(pts: PipelineTrainStep, state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX ``PipelineTrainStep`` state (numpy leaves: ``params`` with
    ``wte``, ``wpe``, the stacked ``blocks`` and ``ln_f``, the optax
    chain's Adam ``count``/``mu``/``nu``, ``step``) as the port's, each
    stage keeping its layers."""
    out = pts.load_full(_flax._flatten(state["params"]))
    adam = _flax._adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    model = out["params"]
    for key in ("mu", "nu"):
        values = _flax._flatten(getattr(adam, key))
        for name, t in out["opt_state"][key].items():
            t.copy_(_local_value(model, name, values))
    out["opt_state"]["count"] = int(np.asarray(adam.count))
    out["step"] = int(np.asarray(state["step"]))
    return out


def full_state(pts: PipelineTrainStep, state: Dict[str, Any]) -> Dict[str, Any]:
    """The state gathered whole, in the JAX state's layout: ``{"params",
    "mu", "nu"}`` each ``{flax path: fp32 CPU tensor}`` with the blocks
    stacked (L, ...) and kernels (in, out), and ``count`` and ``step``. A
    collective over pp: every rank calls it, and every rank gets it."""
    model = state["params"]
    opt = state["opt_state"]
    L = pts.model_cfg.n_layer
    out = {"params": {}, "mu": {}, "nu": {}, "count": opt["count"], "step": state["step"]}
    for key, tensors in (("params", dict(model.named_parameters())),
                         ("mu", opt["mu"]), ("nu", opt["nu"])):
        stacked = {}
        for name, t in tensors.items():
            path, layer = model.flax_path(name)
            t = t.detach().float()
            if path.endswith("kernel"):
                t = t.T
            if layer is None:
                out[key][path] = t.cpu()
                continue
            if path not in stacked:
                stacked[path] = t.new_zeros((L,) + tuple(t.shape))
            stacked[path][layer] = t
        for path in sorted(stacked):
            if pts.stage.group is not None:
                dist.all_reduce(stacked[path], group=pts.stage.group)
            out[key][path] = stacked[path].cpu()
    return out
