"""Model adapters: the seam between the engine and ``ray_tpu_torch/models``.

The port of ``ray_tpu/serve/llm/adapters.py``, with the same contract
(shapes below; ``L`` layers, ``H`` KV heads, ``D`` head dim) but with
torch tensors on the adapter's device instead of fp32 numpy:

  ``prefill(tokens)``       one sequence's full context: the last
                            position's logits ``[vocab]`` plus per-layer
                            K/V ``[L, T, H, D]`` for every position;
  ``prefill_ctx(...)``      the chunked form: run only the un-cached TAIL
                            of a context against KV the prefix cache
                            already holds (``prefill`` is the start=0
                            case);
  ``decode(...)``           ONE fused step for the whole running batch:
                            each sequence contributes one new token + its
                            gathered paged KV; returns next-token logits
                            ``[B, vocab]`` and the new token's K/V
                            ``[B, L, H, D]`` to append;
  ``decode_chunk(...)``     the speculative-verify form: each sequence
                            contributes a short chunk (last sampled token
                            + the draft's proposals) scored in ONE fused
                            forward: logits ``[B, C, vocab]`` for every
                            chunk position and the chunk's K/V
                            ``[B, L, C, H, D]``.

Token ids arrive as numpy int arrays (the engine's host bookkeeping) or as
integer tensors (a draft's proposals, which stay on the device); cached K/V
arrive as tensors gathered on the device; logits and K/V leave on the
device.

Attention per path: a cold prefill (``start == 0``) is causal
self-attention over the prompt and goes through the model's own attention
(``ops.attention.attention_for``): the hand-written flash kernel on a CUDA
tensor, or the einsum path where the config turns ``use_flash_attention``
off. A prefix-cache hit (``start > 0``), the batched decode and the verify
chunk stay plain PyTorch tensor math (``_ctx_causal_attend``,
``_attend``, ``_chunk_attend``): the JAX package wrote no TPU kernel for
any of them. Llama's K/V are cached per KV head, keys after rotation, and
repeated to the query heads (``repeat_kv``) only to attend.

MoE note: serving routes dropless top-k (every token reaches all its k
experts), as the JAX package's adapter does. Train-time static capacity can
drop tokens under load, which would make a token's output depend on its
batch: a server must not do that.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import repeat_kv
from ray_tpu_torch.ops.attention import NEG_INF

__all__ = ["ModelAdapter", "GPT2Adapter", "GPT2MoEAdapter", "LlamaAdapter",
           "FakeAdapter", "build_adapter", "MODEL_ZOO"]


def _host(x) -> np.ndarray:
    """Token ids as a numpy array, from numpy or from a tensor."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _attend(q, k_ctx, v_ctx, lens, k_new, v_new):
    """Fused single-query attention over (paged-gathered context + self).

    q/k_new/v_new ``[B, H, D]``; k_ctx/v_ctx ``[B, Tmax, H, D]`` undefined
    past ``lens [B]``. Returns ``[B, H, D]``. Scores and softmax in fp32.
    """
    B, Tmax, H, D = k_ctx.shape
    scale = 1.0 / math.sqrt(D)
    s_ctx = torch.einsum("bhd,bthd->bht", q.float(), k_ctx.float()) * scale
    mask = torch.arange(Tmax, device=q.device)[None, :] >= lens[:, None]
    s_ctx = s_ctx.masked_fill(mask[:, None, :], NEG_INF)
    s_self = (q.float() * k_new.float()).sum(-1, keepdim=True) * scale
    probs = torch.softmax(torch.cat([s_ctx, s_self], dim=-1), dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs[..., :Tmax], v_ctx.float())
    return (out + probs[..., Tmax:] * v_new.float()).to(q.dtype)


def _ctx_causal_attend(q, k_ctx, v_ctx, k_ch, v_ch):
    """Chunked prefill attention, one sequence: the chunk's queries
    ``q [T, H, D]`` attend to the already-cached context ``k_ctx/v_ctx
    [P, H, D]`` plus causally to the chunk itself (``k_ch/v_ch [T, H, D]``).
    Scores and softmax in fp32."""
    T, H, D = q.shape
    P = k_ctx.shape[0]
    qf = q.float()
    s_ctx = torch.einsum("thd,shd->hts", qf, k_ctx.float()) / math.sqrt(D)
    s_ch = torch.einsum("thd,shd->hts", qf, k_ch.float()) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s_ch = s_ch.masked_fill(~causal[None], NEG_INF)
    probs = torch.softmax(torch.cat([s_ctx, s_ch], dim=-1), dim=-1)
    out = torch.einsum("hts,shd->thd", probs[..., :P], v_ctx.float()) \
        + torch.einsum("hts,shd->thd", probs[..., P:], v_ch.float())
    return out.to(q.dtype)


def _chunk_attend(q, k_ctx, v_ctx, lens, k_ch, v_ch):
    """Fused multi-token verify attention over (paged-gathered context +
    causal chunk), the batched C > 1 sibling of :func:`_attend`.

    q/k_ch/v_ch ``[B, C, H, D]``; k_ctx/v_ctx ``[B, Tmax, H, D]`` undefined
    past ``lens [B]``. Returns ``[B, C, H, D]``. Scores and softmax in
    fp32."""
    B, Tmax, H, D = k_ctx.shape
    C = q.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    s_ctx = torch.einsum("bchd,bthd->bhct", qf, k_ctx.float()) * scale
    mask = torch.arange(Tmax, device=q.device)[None, :] >= lens[:, None]
    s_ctx = s_ctx.masked_fill(mask[:, None, None, :], NEG_INF)
    s_ch = torch.einsum("bchd,bshd->bhcs", qf, k_ch.float()) * scale
    causal = torch.ones(C, C, dtype=torch.bool, device=q.device).tril()
    s_ch = s_ch.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(torch.cat([s_ctx, s_ch], dim=-1), dim=-1)
    out = torch.einsum("bhct,bthd->bchd", probs[..., :Tmax], v_ctx.float()) \
        + torch.einsum("bhcs,bshd->bchd", probs[..., Tmax:], v_ch.float())
    return out.to(q.dtype)


class ModelAdapter:
    """Shape contract the engine sizes its cache from."""

    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    max_context: int
    device: torch.device
    dtype: torch.dtype  # of the K/V the adapter returns (the cache's type)

    def _ids(self, x) -> torch.Tensor:
        """Token ids or positions (numpy, or a tensor) as int64 on the
        adapter's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.long)
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    def prefill(self, tokens: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-context prefill == ``prefill_ctx`` with an empty cache."""
        L, H, D = self.n_layers, self.n_kv_heads, self.head_dim
        empty = torch.zeros((L, 0, H, D), dtype=self.dtype, device=self.device)
        return self.prefill_ctx(tokens, 0, empty, empty)

    def prefill_ctx(self, tokens: np.ndarray, start: int, k_ctx, v_ctx
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Prefill the context TAIL ``tokens`` (positions ``start`` ..
        ``start+T``) against cached ``k_ctx/v_ctx [n_layers, start, H, D]``
        (a prefix-cache hit's gathered blocks). Returns the last position's
        logits plus the tail's per-layer K/V ``[n_layers, T, H, D]``."""
        raise NotImplementedError

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               k_ctx, v_ctx, lens
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def decode_chunk(self, tokens, positions: np.ndarray, k_ctx, v_ctx, lens
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Speculative-verify forward: score a C-token chunk per sequence
        (``tokens [B, C]`` starting at ``positions [B]``) against the
        gathered paged context ``k_ctx/v_ctx [B, L, Tmax, H, D]`` (valid to
        ``lens [B]``) in ONE fused pass. Returns logits ``[B, C, vocab]`` and
        the chunk's K/V ``[B, L, C, H, D]``; the engine writes only the
        accepted prefix back to the cache."""
        raise NotImplementedError


# --------------------------------------------------------------------- GPT-2


class GPT2Adapter(ModelAdapter):
    """Serving twin of ``models/gpt2.py``: it holds the :class:`GPT2`
    module (one copy of the weights) and runs its layers step by step with
    the K/V cache plumbing the module's training-shaped forward lacks."""

    def __init__(self, config, model):
        self.cfg = config
        # a cold prefill's attention, [1, T, H, D], as the model computes it
        self._cold_attention = model.h[0].attn.attention
        self.model = model
        self.device = model.wte.weight.device
        self.dtype = config.dtype   # compute type; the weights stay fp32
        self.n_layers = config.n_layer
        self.n_heads = self.n_kv_heads = config.n_head
        self.head_dim = config.n_embd // config.n_head
        self.vocab_size = config.vocab_size
        self.max_context = config.block_size

    def _ffn(self, blk, x):
        """The block's FFN on its normalised input (``GPT2MoEAdapter``
        routes its MoE blocks here)."""
        return blk.mlp(x)

    def _layers(self, x, attend):
        """Run every block on ``x`` (..., n_embd), attention through
        ``attend(li, q, k, v)``; returns (x, per-layer k, per-layer v)."""
        ks, vs = [], []
        for li, blk in enumerate(self.model.h):
            q, k, v = blk.attn.qkv(blk.ln_1(x))
            ks.append(k)
            vs.append(v)
            y = attend(li, q, k, v)
            x = x + blk.attn.c_proj(y.flatten(-2))
            x = x + self._ffn(blk, blk.ln_2(x))
        return x, ks, vs

    @torch.inference_mode()
    def prefill_ctx(self, tokens, start, k_ctx, v_ctx):
        m = self.model
        tok = self._ids(tokens)
        T = tok.shape[0]
        if k_ctx.shape[1] != start:
            raise ValueError(f"prefill_ctx at start={start} got "
                             f"{k_ctx.shape[1]} cached positions")
        x = m.wte(tok) + m.wpe(torch.arange(start, start + T, device=self.device))

        def attend(li, q, k, v):                                 # [T, H, D]
            if start == 0:   # cold prefill: the flash kernel on the card
                return self._cold_attention(q[None], k[None], v[None])[0]
            return _ctx_causal_attend(q, k_ctx[li], v_ctx[li], k, v)

        x, ks, vs = self._layers(x, attend)
        return m.head(x[-1]), torch.stack(ks), torch.stack(vs)

    @torch.inference_mode()
    def decode(self, tokens, positions, k_ctx, v_ctx, lens):
        m = self.model
        x = m.wte(self._ids(tokens)) + m.wpe(self._ids(positions))
        x, ks, vs = self._layers(x, lambda li, q, k, v: _attend(
            q, k_ctx[:, li], v_ctx[:, li], lens, k, v))          # [B, H, D]
        return m.head(x), torch.stack(ks, dim=1), torch.stack(vs, dim=1)

    @torch.inference_mode()
    def decode_chunk(self, tokens, positions, k_ctx, v_ctx, lens):
        m = self.model
        tok = self._ids(tokens)                                  # [B, C]
        pos = self._ids(positions)[:, None] + torch.arange(
            tok.shape[1], device=self.device)
        x = m.wte(tok) + m.wpe(pos)
        x, ks, vs = self._layers(x, lambda li, q, k, v: _chunk_attend(
            q, k_ctx[:, li], v_ctx[:, li], lens, k, v))          # [B, C, H, D]
        return m.head(x), torch.stack(ks, dim=1), torch.stack(vs, dim=1)


# ---------------------------------------------------------------------- MoE


def _dropless_moe(moe, x):
    """Serve-time MoE: every token reaches all of its top-k experts (no
    capacity, no drops). The router runs in fp32; the k choices come in a
    descending stable sort's reverse order, so ties resolve as the JAX
    adapter's descending ``np.argsort`` does (the higher expert first); the
    kept gates are renormalised. Each expert runs on its rows only, one
    host read of the chosen experts per choice."""
    k = moe.moe.top_k
    dt = moe.compute_dtype
    probs = torch.softmax(moe.router(x.float()), dim=-1)
    idx = torch.argsort(probs, dim=-1, stable=True).flip(-1)[..., :k]
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for j in range(k):
        for e in idx[..., j].unique().tolist():
            rows = idx[..., j] == e
            h = F.gelu(x[rows].to(dt) @ moe.wi[e].to(dt), approximate="tanh")
            out[rows] += (gates[rows, j:j + 1] * (h @ moe.wo[e].to(dt))).to(x.dtype)
    return out


class GPT2MoEAdapter(GPT2Adapter):
    """gpt2_moe: every ``moe_every``-th block routes its FFN through dropless
    top-k experts (see the module docstring's MoE note)."""

    def _ffn(self, blk, x):
        if not hasattr(blk, "moe"):
            return super()._ffn(blk, x)
        return _dropless_moe(blk.moe, x)


# --------------------------------------------------------------------- llama


class LlamaAdapter(ModelAdapter):
    """Serving twin of ``models/llama.py``: RMSNorm, rotate-half RoPE (keys
    cached after rotation, the standard trick), GQA (K/V cached per KV head,
    repeated to the query heads to attend), SwiGLU, the fp32 untied head."""

    def __init__(self, config, model):
        self.cfg = config
        # a cold prefill's attention, [1, T, H, D], as the model computes it
        self._cold_attention = model.h[0].attn.attention
        self.model = model
        self.device = model.tok_emb.weight.device
        self.dtype = config.dtype   # compute type; the weights stay fp32
        self.n_layers = config.n_layer
        self.n_heads = config.n_head
        self.n_kv_heads = config.n_kv_head
        self.head_dim = config.head_dim
        self.vocab_size = config.vocab_size
        self.max_context = config.block_size
        self.rep = config.n_head // config.n_kv_head

    def _layers(self, x, positions, attend):
        """Every block on ``x`` (..., n_embd) at ``positions`` (x's leading
        shape); attention through ``attend(li, q, k, v)`` on q (..., H, D)
        and the un-repeated k, v (..., H_kv, D)."""
        ks, vs = [], []
        for li, blk in enumerate(self.model.h):
            q, k, v = blk.attn.qkv(blk.attn_norm(x), positions)
            ks.append(k)
            vs.append(v)
            y = attend(li, q, k, v)
            x = x + blk.attn.wo(y.flatten(-2))
            x = x + blk.mlp(blk.mlp_norm(x))
        return x, ks, vs

    @torch.inference_mode()
    def prefill_ctx(self, tokens, start, k_ctx, v_ctx):
        m, rep = self.model, self.rep
        tok = self._ids(tokens)
        T = tok.shape[0]
        if k_ctx.shape[1] != start:
            raise ValueError(f"prefill_ctx at start={start} got "
                             f"{k_ctx.shape[1]} cached positions")

        def attend(li, q, k, v):                                 # [T, H, D]
            k, v = repeat_kv(k, rep), repeat_kv(v, rep)
            if start == 0:   # cold prefill: the flash kernel on the card
                return self._cold_attention(q[None], k[None], v[None])[0]
            return _ctx_causal_attend(q, repeat_kv(k_ctx[li], rep),
                                      repeat_kv(v_ctx[li], rep), k, v)

        pos = torch.arange(start, start + T, device=self.device)
        x, ks, vs = self._layers(m.tok_emb(tok), pos, attend)
        return m.head(x[-1]), torch.stack(ks), torch.stack(vs)

    @torch.inference_mode()
    def decode(self, tokens, positions, k_ctx, v_ctx, lens):
        m, rep = self.model, self.rep

        def attend(li, q, k, v):                                 # [B, H, D]
            return _attend(q, repeat_kv(k_ctx[:, li], rep),
                           repeat_kv(v_ctx[:, li], rep), lens,
                           repeat_kv(k, rep), repeat_kv(v, rep))

        x, ks, vs = self._layers(m.tok_emb(self._ids(tokens)),
                                 self._ids(positions), attend)
        return m.head(x), torch.stack(ks, dim=1), torch.stack(vs, dim=1)

    @torch.inference_mode()
    def decode_chunk(self, tokens, positions, k_ctx, v_ctx, lens):
        m, rep = self.model, self.rep
        tok = self._ids(tokens)                                  # [B, C]
        pos = self._ids(positions)[:, None] + torch.arange(
            tok.shape[1], device=self.device)

        def attend(li, q, k, v):                                 # [B, C, H, D]
            return _chunk_attend(q, repeat_kv(k_ctx[:, li], rep),
                                 repeat_kv(v_ctx[:, li], rep), lens,
                                 repeat_kv(k, rep), repeat_kv(v, rep))

        x, ks, vs = self._layers(m.tok_emb(tok), pos, attend)
        return m.head(x), torch.stack(ks, dim=1), torch.stack(vs, dim=1)


# ---------------------------------------------------------------------- fake


class FakeAdapter(ModelAdapter):
    """Model-free adapter for scheduler/engine tests. Deterministic: the
    next token is a function of the last token AND the KV cache contents
    (each position's K stores its token id), so a block-table bug or a bad
    gather changes the output stream. The same rule as the JAX package's
    ``FakeAdapter``, so both engines give the same streams.

    ``step_cost_s`` sleeps once per adapter CALL (a fused batch is one
    call, like one device dispatch), to model a target:draft cost ratio.
    ``disagree_every`` perturbs the next token whenever the true next token
    is divisible by it: as the DRAFT of a speculative test it gives a
    deterministic, partial acceptance rate (about 1 - 1/q) instead of the
    degenerate 0 or 1."""

    def __init__(self, vocab_size: int = 97, n_layers: int = 1,
                 n_kv_heads: int = 1, head_dim: int = 1,
                 max_context: int = 4096, step_cost_s: float = 0.0,
                 disagree_every: int = 0, device=None):
        self.vocab_size = vocab_size
        self.n_layers = n_layers
        self.n_heads = self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.max_context = max_context
        self.step_cost_s = step_cost_s  # simulated model time per call
        self.disagree_every = int(disagree_every)
        self.device = resolve_device(device)
        self.dtype = torch.float32

    def _sleep(self):
        if self.step_cost_s:
            time.sleep(self.step_cost_s)

    def _next(self, ctx_sum: np.ndarray, tokens: np.ndarray) -> np.ndarray:
        nxt = (np.asarray(ctx_sum).astype(np.int64)
               + tokens * 31 + 7) % self.vocab_size
        if self.disagree_every:
            nxt = np.where(nxt % self.disagree_every == 0,
                           (nxt + 1) % self.vocab_size, nxt)
        return nxt

    def _logits_for(self, nxt: np.ndarray) -> torch.Tensor:
        out = np.zeros(nxt.shape + (self.vocab_size,), dtype=np.float32)
        np.put_along_axis(out, nxt[..., None], 1.0, axis=-1)
        return torch.from_numpy(out).to(self.device)

    def _kv(self, tokens: np.ndarray):
        kv = torch.from_numpy(tokens.astype(np.float32)).to(self.device)
        kv = kv[..., None, None, None].expand(
            tokens.shape + (self.n_layers, self.n_kv_heads, self.head_dim))
        return kv.clone(), kv.clone()

    def _ctx_sum(self, k_ctx, lens) -> np.ndarray:
        """Per sequence, the sum of its cached token ids, read back THROUGH
        the gathered cache ``[B, L, Tmax, H, D]`` (masked by ``lens``:
        padding slots may carry stale block data)."""
        valid = torch.arange(k_ctx.shape[2], device=k_ctx.device)[None, :] \
            < lens[:, None]
        return (k_ctx[:, 0, :, 0, 0].double() * valid).sum(dim=1).cpu().numpy()

    def prefill_ctx(self, tokens, start, k_ctx, v_ctx):
        self._sleep()
        tokens = _host(tokens)
        # same semantics as decode with cache = everything-but-last, input =
        # last (a preempted sequence's recompute must continue identically);
        # the cached prefix is read back THROUGH the gathered blocks so a
        # prefix-cache or COW bug changes the output
        ctx_sum = float(k_ctx[0, :, 0, 0].double().sum()) \
            + np.float64(tokens[:-1].sum())
        nxt = self._next(ctx_sum, tokens[-1:])
        k, v = self._kv(tokens)  # [T, L, H, D] -> [L, T, H, D]
        return self._logits_for(nxt)[0], k.movedim(0, 1), v.movedim(0, 1)

    def decode(self, tokens, positions, k_ctx, v_ctx, lens):
        self._sleep()
        tokens = _host(tokens)
        nxt = self._next(self._ctx_sum(k_ctx, lens), tokens)
        k, v = self._kv(tokens)  # [B, L, H, D]
        return self._logits_for(nxt), k, v

    def decode_chunk(self, tokens, positions, k_ctx, v_ctx, lens):
        self._sleep()
        tokens = _host(tokens)                                    # [B, C]
        # chunk position c additionally sees chunk tokens [0, c)
        csum = np.cumsum(tokens, axis=1) - tokens                 # exclusive
        nxt = self._next(self._ctx_sum(k_ctx, lens)[:, None] + csum, tokens)
        k, v = self._kv(tokens)           # [B, C, L, H, D] -> [B, L, C, H, D]
        return self._logits_for(nxt), k.movedim(1, 2), v.movedim(1, 2)


# ----------------------------------------------------------------- model zoo


MODEL_ZOO = {
    "gpt2-tiny": ("gpt2", "tiny"),
    "gpt2": ("gpt2", "gpt2_124m"),
    "gpt2-moe-tiny": ("gpt2_moe", "tiny_moe"),
    "llama-tiny": ("llama", "tiny"),
    "llama-160m": ("llama", "llama_160m"),
    "fake": ("fake", None),
}


def build_adapter(model: str, model_config: Optional[dict] = None,
                  seed: int = 0, device=None) -> ModelAdapter:
    """Resolve a zoo name to a fresh, seeded adapter on ``device`` (default
    CUDA; a missing CUDA device raises). Weights are random from ``seed``
    (flax's initialisers, drawn on the CPU); checkpoint loading is out of
    scope. Models run in fp32 unless ``model_config`` sets ``dtype``."""
    if model == "fake":
        return FakeAdapter(**(model_config or {}), device=device)
    if model not in MODEL_ZOO:
        raise ValueError(
            f"unknown model {model!r}; zoo: {sorted(MODEL_ZOO)}")
    from ray_tpu_torch.models import gpt2, gpt2_moe, llama

    family, preset = MODEL_ZOO[model]
    kw = dict(model_config or {})
    kw.setdefault("dtype", torch.float32)  # the engine's reference precision
    gen = torch.Generator().manual_seed(seed)
    mod, cfg_cls, adapter_cls = {
        "gpt2": (gpt2, gpt2.GPT2Config, GPT2Adapter),
        "gpt2_moe": (gpt2_moe, gpt2_moe.GPT2MoEConfig, GPT2MoEAdapter),
        "llama": (llama, llama.LlamaConfig, LlamaAdapter),
    }[family]
    cfg = getattr(cfg_cls, preset)(**kw)
    return adapter_cls(cfg, mod.init_params(cfg, gen, device=device))
