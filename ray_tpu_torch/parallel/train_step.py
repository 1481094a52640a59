"""The training step: the port of ``ray_tpu/parallel/train_step.py``
``TrainStep``, on one CUDA card and on a device mesh of dp, fsdp, tp, sp
and ep, for every model family of the port.

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

On a mesh (``TrainStep(cfg, make_mesh({...}))``, one process per rank,
each calling the same methods in the same order) each rank computes its
shard, and losses, gradient norms and gathered parameters are those of the
JAX step on the same mesh:

  dp, fsdp  FSDP2 ``fully_shard`` over the 2-D (replicate, fsdp) mesh of
            ``mesh.data_parallel_mesh``: parameters, gradients and Adam's
            moments sharded over fsdp on the dimension the sharding rule
            names (dim 0 where it names none), gradients averaged over dp,
            fsdp and sp (the JAX loss is the global batch's mean)
  tp        Megatron layers on local tensors (``models/gpt2.py``,
            ``models/llama.py``) with the collectives of
            ``parallel/_collectives.py``, a vocab-parallel embedding, head
            and loss (where tp is a multiple of GPT-2's head count,
            tp / n_head ranks compute each head alike)
  sp        ring attention over the sp ranks (``ops/ring_attention.py``)
            in place of the model's attention, positions offset by the
            rank's place in the sequence; GPT-2-MoE routes over the
            global sequence
  ep        GPT-2-MoE's experts split over the ep ranks, tokens
            replicated over them (``ops/moe.py``); each MoE layer under
            its own ``fully_shard`` on the data ranks of its ep coordinate
            (``mesh.expert_data_parallel_mesh``)
  pp, other axes named by no rule: replicated, as under JAX's
            ``batch_sharding`` (``PipelineTrainStep`` in
            ``parallel/pipeline.py`` pipelines over pp)

The backward is ``loss.backward()`` (``torch.autograd.grad`` cannot see
FSDP2's sharded parameters), GPT-2-MoE's aux loss added with its gradient
taken sp times (one global value whose gradient each sp rank carries only
for its own tokens); gradients of rows that several tp ranks hold (a GQA
KV head, a GPT-2 head at tp > n_head) are summed over them, and the
global norm counts each element once (tp-replicated gradients from tp rank
0 only, every gradient but an expert stack's from ep rank 0 only). The
update is the same optax chain on each rank's local shards. The reported
loss is the mean over every rank. The only refusals are JAX's own
(``ValueError``): a tp that does not fit the heads, an ep that does not
divide the experts.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Shard

from ray_tpu_torch._private import flight_recorder as _fr
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import _flax, gpt2, gpt2_moe, llama
from ray_tpu_torch.ops.ring_attention import ring_causal_attention
from ray_tpu_torch.parallel import mesh as _mesh
from ray_tpu_torch.parallel._collectives import TPGroup, all_reduce_mean
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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax's ``clip_by_global_norm``: returns (clipped grads, the global
    norm before clipping). Below the limit the gradients pass unchanged;
    at or above it each is divided by the norm and multiplied by the limit
    (no ``+1e-6`` as in ``torch.nn.utils.clip_grad_norm_``). No host
    synchronisation: the choice is made on the device.

    The norm is optax's ``global_norm``, sqrt(sum of each tensor's sum of
    squares): ``sum`` reduces pairwise on both devices, where the CPU's
    ``vector_norm`` of an fp32 tensor of tens of millions of elements (the
    GPT-2 embedding's gradient) drifts by 1e-3 relative. On a mesh the
    caller passes the ``norm`` of the whole gradient, of which ``grads``
    are this rank's shards."""
    if norm is None:
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(out, torch.where(keep, one, one * max_norm))
    return out, norm


def adamw_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                  mu: List[torch.Tensor], nu: List[torch.Tensor], count: int, *,
                  learning_rate: float, beta2: float, weight_decay: float) -> None:
    """optax's ``adamw(lr, b1=0.9, b2=beta2, eps=1e-8, weight_decay,
    mask=ndim > 1)`` step ``count`` (counted from 1), in place on the
    parameters and moments (this rank's local shards of FSDP2 DTensors)."""
    mu = [_flax.local_tensor(t) for t in mu]
    nu = [_flax.local_tensor(t) for t in nu]
    p = [_flax.local_tensor(t) for t in params]
    g, b2 = grads, beta2
    with torch.no_grad():
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        den = torch._foreach_div(nu, 1 - b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(mu, 1 - ADAM_B1 ** count)
        torch._foreach_div_(upd, den)
        decayed = [i for i, x in enumerate(p) if x.ndim > 1]
        torch._foreach_add_([upd[i] for i in decayed],
                            [p[i] for i in decayed], alpha=weight_decay)
        torch._foreach_add_(p, upd, alpha=-learning_rate)


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


def check_mesh(model_cfg, mesh) -> None:
    """Refuse, before any collective runs, what JAX's shardings refuse too
    (``ValueError``): a tp that does not fit the model's heads, an ep that
    does not divide an MoE model's experts."""
    family, _ = family_of(model_cfg)
    tp = _mesh.axis_size(mesh, "tp")
    fake = TPGroup(None, tp, 0) if tp > 1 else None
    gpt2.head_split(model_cfg.n_head, fake)
    if family is llama:
        llama.local_kv_heads(model_cfg.n_head, model_cfg.n_kv_head, fake)
    ep = _mesh.axis_size(mesh, "ep")
    if family is gpt2_moe and model_cfg.moe.num_experts % ep:
        raise ValueError(f"ep = {ep} does not divide num_experts = "
                         f"{model_cfg.moe.num_experts}")


def axis_group(mesh, axis: str) -> Optional[TPGroup]:
    """This rank's group on ``axis``, or None where the axis is absent or
    of size 1."""
    group = _mesh.axis_group(mesh, axis)
    return None if group is None else TPGroup(group, _mesh.axis_size(mesh, axis),
                                              _mesh.axis_index(mesh, axis))


def model_for_mesh(cfg, mesh, device=None):
    """This rank's module of ``cfg``'s family on ``mesh``: ring attention
    over the sp ranks iff sp > 1, this tp rank's shard of every layer, and
    for GPT-2-MoE this ep rank's experts with routing over the global
    sequence; torch's default initialisation."""
    check_mesh(cfg, mesh)
    family, model_cls = family_of(cfg)
    sp = _mesh.axis_group(mesh, "sp")
    if sp is not None:
        cfg = dataclasses.replace(
            cfg, attn_fn=functools.partial(ring_causal_attention, group=sp))
    if family is gpt2_moe:
        return model_cls(cfg, device=device, tp=axis_group(mesh, "tp"),
                         ep=axis_group(mesh, "ep"), sp=axis_group(mesh, "sp"))
    return model_cls(cfg, device=device, tp=axis_group(mesh, "tp"))


def default_rules_for(cfg) -> _mesh.ShardingRules:
    """The family's sharding rules."""
    if isinstance(cfg, gpt2_moe.GPT2MoEConfig):
        return gpt2_moe.GPT2_MOE_SHARDING_RULES
    if isinstance(cfg, llama.LlamaConfig):
        return llama.LLAMA_SHARDING_RULES
    return gpt2.GPT2_SHARDING_RULES


class TrainStep:
    """The JAX package's ``TrainStep`` on one CUDA card (``device=None``) or,
    for the tests, the CPU (``device="cpu"``); with a ``mesh`` (a
    ``DeviceMesh`` from ``parallel.mesh.make_mesh``), this rank's part of
    the step on that mesh, on the mesh's device type::

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
        self.family, self._model_cls = family_of(model_cfg)
        self._is_moe = self.family is gpt2_moe
        self.mesh = mesh
        self.tp = self.ep = None
        self._token_scale = self._example_scale = 1
        n_devices = 1
        if mesh is not None:
            check_mesh(model_cfg, mesh)
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
            device = mesh.device_type
            self.rules = default_rules_for(model_cfg)
            self.tp = axis_group(mesh, "tp")
            self.ep = axis_group(mesh, "ep")
            self._dp_mesh = _mesh.data_parallel_mesh(mesh)
            self._expert_mesh = (_mesh.expert_data_parallel_mesh(mesh)
                                 if self._is_moe and self.ep is not None else None)
            self._fsdp_group = self._dp_mesh.get_group("fsdp")
            rows = _mesh.axis_size(mesh, "dp") * _mesh.axis_size(mesh, "fsdp")
            self._seq_index = _mesh.axis_index(mesh, "sp")
            self._seq_parts = _mesh.axis_size(mesh, "sp")
            self._example_scale = rows
            self._token_scale = rows * _mesh.axis_size(mesh, "sp")
            n_devices = mesh.size()
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
                n_devices=n_devices, device=self.device)
            _telemetry.set_current_recorder(self.telemetry)

    # ----------------------------------------------------------------- state

    def init(self, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Fresh state: flax-initialised fp32 parameters (drawn on the CPU
        from ``generator``, default seed 0, so a mesh starts from the same
        weights as one device), zero moments, step 0."""
        if self.mesh is None:
            model = self.family.init_params(self.model_cfg, generator, device=self.device)
        else:
            whole = self.family.init_params(self.model_cfg, generator, device="cpu")
            model = _flax.load_full(self.new_model(), {
                n: p.detach() for n, p in whole.named_parameters()})
        zeros = lambda: {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        return {"params": model,
                "opt_state": {"count": 0, "mu": zeros(), "nu": zeros()},
                "step": 0}

    def new_model(self):
        """The family's module for this config on this step's device, with
        torch's default initialisation (``load_flax_state`` fills it); on a
        mesh, this rank's shard of it (``model_for_mesh``) under FSDP2, each
        block and then the root wrapped by ``fully_shard``. Under ep each
        MoE layer is wrapped first on the mesh of the data ranks that hold
        the same experts (``expert_data_parallel_mesh``): its experts'
        gradients are averaged over those, never over ep. Its router rides
        with it; the router's gradient is the same on every ep rank."""
        if self.mesh is None:
            return self._model_cls(self.model_cfg, device=self.device)
        model = model_for_mesh(self.model_cfg, self.mesh, self.device)
        names = {id(p): n for n, p in model.named_parameters()}

        def placement(p):   # fsdp on the dimension the rule names, else 0
            dim = _mesh.spec_dim(self.rules.spec_for(names[id(p)]), "fsdp")
            return Shard(dim or 0)

        for block in model.h:
            if self._expert_mesh is not None and hasattr(block, "moe"):
                fully_shard(block.moe, mesh=self._expert_mesh,
                            shard_placement_fn=placement)
            fully_shard(block, mesh=self._dp_mesh, shard_placement_fn=placement)
        fully_shard(model, mesh=self._dp_mesh, shard_placement_fn=placement)
        return model

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A batch of token ids (numpy or tensors) as int64 on the device; on
        a mesh, the (rows, positions) of the global (..., B, T) batch that
        this rank holds (``mesh.batch_sharding``)."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if self.mesh is not None:
                v = v[(...,) + _mesh.batch_sharding(self.mesh, v.shape[-2:])]
            out[k] = v.to(self.device, torch.long)
        return out

    # ------------------------------------------------------------------ step

    def loss_and_grads(self, state, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss (with the MoE aux loss for GPT-2-MoE, as the JAX step's
        objective) and the raw (unclipped) gradient of every parameter; on
        a mesh the loss is the mean over every rank and the gradients are
        this rank's shards of the global batch's gradient."""
        model = state["params"]
        if self.mesh is not None:
            return self._mesh_loss_and_grads(model, batch)
        names, params = zip(*model.named_parameters())
        if self._is_moe:
            logits, aux = model(batch["idx"])
            loss = self.family.loss_fn(logits, batch["targets"]) + aux
        else:
            loss = self.family.loss_fn(model(batch["idx"]), batch["targets"])
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))

    def _mesh_loss_and_grads(self, model, batch):
        idx = batch["idx"]
        out = model(idx, pos_offset=self._seq_index * idx.shape[-1])
        logits, aux = out if self._is_moe else (out, None)
        loss = self.family.vocab_parallel_loss(logits, batch["targets"], self.tp,
                                               model.vocab_start)
        if aux is None:
            loss.backward()     # FSDP2 averages each gradient over dp, fsdp and sp
        else:
            # The aux loss is one value over the global sequence, the same
            # on every sp rank, and each rank's backward carries its own
            # tokens' part of its gradient; FSDP2's mean over sp would take
            # 1/sp of their sum, so the backward takes the aux loss sp times
            # (over dp it is a mean over rows, which the mean keeps).
            (loss + aux * self._seq_parts).backward()
            loss = loss.detach() + aux.detach()
        grads = {}
        for name, p in model.named_parameters():
            grads[name] = _flax.local_tensor(p.grad)
            p.grad = None
            layout = _flax.tp_layout(model, name)
            if layout is not None and layout.copies > 1:
                self._sum_copies(grads[name], layout)
        return all_reduce_mean(loss), grads

    def _sum_copies(self, g: torch.Tensor, layout) -> None:
        """Sum the gradient of rows that several tp ranks hold (a KV head
        read by each rank's query heads) over those ranks, in place."""
        shape = list(g.shape)
        shape[layout.dim] = layout.full
        index = layout.index.to(g.device)
        full = g.new_zeros(shape).index_copy_(layout.dim, index, g)
        dist.all_reduce(full, group=self.tp.group)
        g.copy_(full.index_select(layout.dim, index))

    def _mesh_norm(self, model, names, grads) -> torch.Tensor:
        """The global norm of the whole gradient from this rank's shards:
        square sums summed over fsdp, then over tp and ep, where a
        tp-replicated gradient (or a head's copy) counts on one tp rank only
        and every gradient but an expert stack's on ep rank 0 only."""
        sq = torch.stack([g.square().sum() for g in grads])
        dist.all_reduce(sq, group=self._fsdp_group)
        if self.tp is None and self.ep is None:
            return sq.sum().sqrt()
        owner = []
        for name in names:
            tp, ep = _flax.tp_layout(model, name), _flax.ep_layout(model, name)
            owner.append((tp.owner if tp is not None else
                          self.tp is None or self.tp.rank == 0)
                         and (ep is not None or self.ep is None or self.ep.rank == 0))
        total = (sq * torch.tensor(owner, dtype=sq.dtype, device=sq.device)).sum()
        for group in (self.tp, self.ep):
            if group is not None:
                dist.all_reduce(total, group=group.group)
        return total.sqrt()

    def _step(self, state, batch) -> Dict[str, torch.Tensor]:
        loss, grads = self.loss_and_grads(state, batch)
        names = list(grads)
        model = state["params"]
        params = dict(model.named_parameters())
        norm = (None if self.mesh is None else
                self._mesh_norm(model, names, [grads[n] for n in names]))
        g, norm = clip_by_global_norm([grads[n] for n in names], self.grad_clip, norm)
        opt = state["opt_state"]
        opt["count"] += 1
        adamw_update_([params[n] for n in names], g, [opt["mu"][n] for n in names],
                      [opt["nu"][n] for n in names], opt["count"],
                      learning_rate=self.learning_rate, beta2=self.beta2,
                      weight_decay=self.weight_decay)
        state["step"] += 1
        return {"loss": loss, "grad_norm": norm}

    def _record(self, t0: float, batch, steps: int, compiled: bool,
                repeats: int = 1) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # a mesh rank books the global batch: its shard times the data shards
        tokens, examples = (None, None) if compiled else _batch_counts(batch)
        self.telemetry.record_step(
            time.perf_counter() - t0, steps=steps,
            tokens=tokens and tokens * repeats * self._token_scale,
            examples=examples and examples * repeats * self._example_scale,
            compile_step=compiled)

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
