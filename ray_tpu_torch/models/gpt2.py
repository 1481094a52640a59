"""GPT-2 as a PyTorch module, the port of ``ray_tpu/models/gpt2.py``.

Submodule names follow the flax parameter tree (``wte``, ``wpe``,
``h.{i}.ln_1``, ``h.{i}.attn.c_attn``, ``h.{i}.attn.c_proj``, ``h.{i}.ln_2``,
``h.{i}.mlp.c_fc``, ``h.{i}.mlp.c_proj``, ``ln_f``) so that
:func:`load_flax_params` can carry the JAX package's weights across, and the
arithmetic follows flax's: LayerNorm with eps 1e-6 (flax's value, not
torch's 1e-5), tanh-gelu, learned positions, and a weight-tied head.
Attention goes through ``ops.attention.causal_attention``, which is the
hand-written flash kernel on a CUDA tensor and is differentiable.

Precision follows flax's rule: parameters are always fp32 (the optimizer's
master weights) and ``config.dtype`` is the compute type only. Each
submodule casts at its own call, as flax's ``promote_dtype`` does: a dense
layer casts its input, weight and bias to ``dtype``; LayerNorm takes its
statistics in fp32 with fp32 scale and bias, then casts to ``dtype``;
embedding rows are cast to ``dtype``; the tied head (``Embed.attend``)
computes in ``dtype``. So a bf16 config gives bf16 logits, as JAX's does,
and its gradients land on fp32 parameters.

Attention follows ``config.use_flash_attention`` (``attention_for``), as
in flax: on, it is ``causal_attention`` (the flash kernels on the card, at
any head dim up to 128); off, the einsum path (fp32 scores, a causal mask
of -1e30, the softmax cast to ``dtype``). ``dropout`` is declared and never read, as in the flax model.

Each block is checkpointed while grad is enabled (``config.remat``), the
counterpart of ``nn.remat(Block)``: its activations are recomputed in the
backward pass, so the attention forward kernel runs twice per block per
training step. Serving under ``torch.inference_mode`` never checkpoints.

On a mesh (``parallel/train_step.py``) the module is built with a
:class:`~ray_tpu_torch.parallel._collectives.TPGroup` and holds this tp
rank's shard, Megatron's layout of ``GPT2_SHARDING_PATTERNS``:
column-parallel ``c_attn`` (this rank's heads of q, of k and of v) and
``c_fc``, row-parallel ``c_proj`` (partial sums all-reduced before the
replicated bias), a vocab-parallel ``wte`` whose tied head gives this
rank's slice of the logits (:func:`vocab_parallel_loss` takes them), and
LayerNorms and ``wpe`` replicated. ``config.attn_fn`` replaces the
attention (ring attention over sp), and ``pos_offset`` shifts the
positions to the rank's place in the sequence. Without a group it is the
one-device module, operation for operation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import _flax
from ray_tpu_torch.models._flax import flax_init_
from ray_tpu_torch.models._flax import flax_tensors as _flax_tensors  # noqa: F401
from ray_tpu_torch.ops.attention import attention_for
from ray_tpu_torch.parallel._collectives import (
    TPGroup,
    copy_to_tp,
    reduce_from_tp,
    split_range,
    tp_layout,
)
from ray_tpu_torch.parallel.mesh import P, ShardingRules

LAYERNORM_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0                   # declared and never read, as in flax
    dtype: torch.dtype = torch.bfloat16   # compute type; params stay fp32
    use_flash_attention: bool = True       # else the einsum path
    remat: bool = True                     # checkpoint each block under grad
    # Override the attention primitive, e.g. ring attention bound to the sp
    # ranks (parallel/train_step.py). Signature (q, k, v) -> out, all
    # (B, T, H, D).
    attn_fn: Any = None

    @classmethod
    def gpt2_124m(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=512, block_size=128, n_layer=2, n_head=4, n_embd=128)
        base.update(kw)
        return cls(**base)


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``
    (flax ``Dense``: input, kernel and bias promoted to ``dtype``).

    With ``tp``, this rank's shard (``self.tp_layout``): ``tp_dim=0``
    column-parallel (the output rows ``tp_index``, default a contiguous
    part, and their bias), ``tp_dim=1`` row-parallel (the input columns
    ``tp_index``; the partial products are summed over tp, then the whole
    bias is added). The input of a column-parallel layer must come through
    ``copy_to_tp``. ``tp_copies`` is how many tp ranks hold the same rows
    (GQA's KV heads where tp exceeds their count), whose gradients the
    step sums."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device=None,
                 bias: bool = True, *, tp: Optional[TPGroup] = None,
                 tp_dim: int = 0, tp_index=None, tp_copies: int = 1):
        self.tp_layout = tp_layout(tp, tp_dim, (n_out, n_in)[tp_dim], tp_index, tp_copies)
        if self.tp_layout is not None:
            local = len(self.tp_layout.index)
            n_out, n_in = (local, n_in) if tp_dim == 0 else (n_out, local)
        super().__init__(n_in, n_out, bias=bias, device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        self.reduce = tp if tp_dim == 1 else None

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.reduce is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        y = reduce_from_tp(F.linear(x.to(dt), self.weight.to(dt)), self.reduce)
        return y if bias is None else y + bias


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: fp32 statistics, fp32 scale and bias, the result
    cast to ``dtype``."""

    def __init__(self, n: int, dtype: torch.dtype, device=None):
        super().__init__(n, eps=LAYERNORM_EPS, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Embedding(nn.Embedding):
    """flax ``Embed``: an fp32 table whose rows are cast to ``dtype``;
    :meth:`attend` is the tied head, computed in ``dtype``.

    With ``tp``, vocab-parallel: this rank holds rows ``vocab_start`` ...
    ``vocab_stop`` (a contiguous, possibly uneven part), looks up the ids
    that fall there, and the rows are summed over tp; :meth:`attend` then
    gives this rank's slice of the logits."""

    def __init__(self, n: int, dim: int, dtype: torch.dtype, device=None,
                 *, tp: Optional[TPGroup] = None):
        self.tp = tp
        self.tp_layout = tp_layout(tp, 0, n)
        self.vocab_start, self.vocab_stop = (
            split_range(n, tp.size, tp.rank) if tp is not None else (0, n))
        super().__init__(self.vocab_stop - self.vocab_start, dim, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, idx):
        if self.tp is None:
            return super().forward(idx).to(self.compute_dtype)
        inside = (idx >= self.vocab_start) & (idx < self.vocab_stop)
        rows = F.embedding(torch.where(inside, idx - self.vocab_start, 0), self.weight)
        rows = reduce_from_tp(rows.masked_fill(~inside[..., None], 0.0), self.tp)
        return rows.to(self.compute_dtype)

    def attend(self, x):
        dt = self.compute_dtype
        return x.to(dt) @ self.weight.to(dt).T


def local_heads(n_head: int, tp: Optional[TPGroup]) -> Tuple[int, int]:
    """[first, stop) of the query heads a tp rank holds; tp must divide the
    head count (Megatron's layout keeps whole heads on a rank)."""
    if tp is None:
        return 0, n_head
    if n_head % tp.size:
        raise ValueError(
            f"tensor parallelism needs whole heads on each rank: {n_head} "
            f"heads do not split over tp = {tp.size}")
    per = n_head // tp.size
    return tp.rank * per, (tp.rank + 1) * per


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        C = cfg.n_embd
        first, stop = local_heads(cfg.n_head, tp)
        self.tp = tp
        self.n_head = stop - first
        self.head_dim = C // cfg.n_head
        self.attention = attention_for(cfg)
        # this rank's heads of q, of k and of v: the same rows of each third
        rows = torch.arange(first * self.head_dim, stop * self.head_dim)
        self.c_attn = Dense(C, 3 * C, cfg.dtype, device, tp=tp, tp_dim=0,
                            tp_index=torch.cat([rows, rows + C, rows + 2 * C]))
        self.c_proj = Dense(C, C, cfg.dtype, device, tp=tp, tp_dim=1, tp_index=rows)

    def qkv(self, x):
        """(..., C) -> q, k, v each (..., n_head, head_dim), this rank's heads."""
        q, k, v = self.c_attn(copy_to_tp(x, self.tp)).chunk(3, dim=-1)
        shape = x.shape[:-1] + (self.n_head, self.head_dim)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def forward(self, x):
        B, T, _ = x.shape
        y = self.attention(*self.qkv(x))
        return self.c_proj(y.reshape(B, T, self.n_head * self.head_dim))


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        self.tp = tp
        self.c_fc = Dense(cfg.n_embd, 4 * cfg.n_embd, cfg.dtype, device, tp=tp, tp_dim=0)
        self.c_proj = Dense(4 * cfg.n_embd, cfg.n_embd, cfg.dtype, device, tp=tp, tp_dim=1)

    def forward(self, x):
        h = self.c_fc(copy_to_tp(x, self.tp))
        return self.c_proj(F.gelu(h, approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device, tp)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.mlp = MLP(cfg, device, tp)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT2(nn.Module):
    """GPT-2 on ``device`` (default CUDA); with ``tp``, this tp rank's shard
    of it. Its weights start at torch's default initialisation;
    :func:`init_params` gives flax's instead and :func:`load_flax_params`
    loads the JAX package's."""

    def __init__(self, config: GPT2Config, device=None, tp: Optional[TPGroup] = None):
        super().__init__()
        self.config = config
        self.tp = tp
        dev = resolve_device(device)
        dt = config.dtype
        self.wte = Embedding(config.vocab_size, config.n_embd, dt, dev, tp=tp)
        self.wpe = Embedding(config.block_size, config.n_embd, dt, dev)
        self.h = nn.ModuleList(self._block(i, dev) for i in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd, dt, dev)

    @property
    def vocab_start(self) -> int:
        """The first vocabulary id of this rank's logits."""
        return self.wte.vocab_start

    def _block(self, i: int, device) -> nn.Module:
        """Block ``i`` (the hook ``GPT2MoE`` overrides for its MoE blocks)."""
        return Block(self.config, device, self.tp)

    def head(self, x):
        """Final norm + weight-tied head in ``dtype``: (..., C) -> (..., vocab)
        (this rank's vocabulary slice under tp)."""
        return self.wte.attend(copy_to_tp(self.ln_f(x), self.tp))

    def forward(self, idx, pos_offset: int = 0):
        B, T = idx.shape
        pos = torch.arange(T, device=idx.device) + pos_offset
        x = self.wte(idx) + self.wpe(pos)[None]
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.h:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.head(x)


def forward(config: GPT2Config, model: GPT2, idx):
    """Logits (B, T, vocab) in ``config.dtype`` for token ids ``idx`` (B, T)."""
    del config  # kept for the JAX package's signature; the module has it
    return model(idx)


def loss_fn(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def vocab_parallel_loss(logits, targets, tp: Optional[TPGroup], vocab_start: int = 0):
    """:func:`loss_fn` over logits sharded on the vocabulary: ``logits`` is
    this tp rank's slice (..., V_local) of ids ``vocab_start`` onwards.
    flax's fp32 log-softmax: the max (no gradient) and the sum of exps are
    reduced over tp, and the target's logit comes from the rank that holds
    it. Without tp it is :func:`loss_fn`."""
    if tp is None:
        return loss_fn(logits, targets)
    x = logits.float()
    with torch.no_grad():
        m = x.amax(dim=-1)
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX, group=tp.group)
    shifted = x - m[..., None]
    sum_exp = reduce_from_tp(shifted.exp().sum(dim=-1), tp)
    local = targets - vocab_start
    inside = (local >= 0) & (local < x.shape[-1])
    picked = shifted.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    picked = reduce_from_tp(picked.masked_fill(~inside, 0.0), tp)
    return (sum_exp.log() - picked).mean()


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def init_params(config: GPT2Config, generator: Optional[torch.Generator] = None,
                device=None) -> GPT2:
    """A :class:`GPT2` with flax's default initialisers: dense kernels
    lecun-normal, biases 0, LayerNorm scale 1 and bias 0, embeddings normal
    with variance 1/n_embd. The values are drawn in fp32 on the CPU from
    ``generator`` (default: seed 0), so one seed gives the same weights on
    every device; the numbers differ from JAX's, whose generator differs."""
    dev = resolve_device(device)
    model = GPT2(config, device="cpu")
    flax_init_(model, 1.0 / math.sqrt(config.n_embd), generator)
    return model.to(dev)


def load_flax_params(model: GPT2, params: Dict[str, Any]) -> GPT2:
    """Fill ``model`` from the JAX package's parameter tree, given as nested
    dicts of numpy arrays (``h_{i}/attn/c_attn/kernel`` ...). Dense kernels
    are (in, out) and are transposed into ``nn.Linear.weight``; LayerNorm
    ``scale``/``bias`` and embedding tables map by name. Unknown or missing
    keys, and shapes that do not match, raise ``ValueError``."""
    return _flax.load_flax_params(model, params)


load_flax_state = _flax.load_flax_state


# Megatron-style tensor-parallel layout + fsdp on the complementary dim: the
# JAX package's GPT2_SHARDING_PATTERNS in the port's names and layouts (a
# dense weight is (out, in), the transpose of the flax kernel's spec;
# embedding tables are not transposed).
GPT2_SHARDING_PATTERNS = [
    (r"wte\.weight", P("tp", "fsdp")),
    (r"wpe\.weight", P(None, "fsdp")),
    (r"attn\.c_attn\.weight", P("tp", "fsdp")),   # column parallel
    (r"attn\.c_attn\.bias", P("tp")),
    (r"attn\.c_proj\.weight", P("fsdp", "tp")),   # row parallel
    (r"attn\.c_proj\.bias", P()),
    (r"mlp\.c_fc\.weight", P("tp", "fsdp")),
    (r"mlp\.c_fc\.bias", P("tp")),
    (r"mlp\.c_proj\.weight", P("fsdp", "tp")),
    (r"mlp\.c_proj\.bias", P()),
    (r"ln_", P()),
]
GPT2_SHARDING_RULES = ShardingRules(GPT2_SHARDING_PATTERNS, default=P())
