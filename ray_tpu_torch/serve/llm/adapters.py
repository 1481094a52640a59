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
                            ``[B, L, H, D]`` to append.

Token ids arrive as numpy int arrays (the engine's host bookkeeping);
cached K/V arrive as tensors gathered on the device; logits and K/V leave
on the device.

Attention per path: a cold prefill (``start == 0``) is causal
self-attention over the prompt and goes through
``ops.attention.causal_attention``, the hand-written flash kernel on a CUDA
tensor. A prefix-cache hit (``start > 0``) and the batched decode stay
plain PyTorch tensor math (``_ctx_causal_attend``, ``_attend``): the JAX
package wrote no TPU kernel for either.

Not ported yet: ``decode_chunk`` (speculative verify), ``LlamaAdapter`` and
``GPT2MoEAdapter``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import NEG_INF, causal_attention

__all__ = ["ModelAdapter", "GPT2Adapter", "FakeAdapter", "build_adapter",
           "MODEL_ZOO"]


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


# --------------------------------------------------------------------- GPT-2


class GPT2Adapter(ModelAdapter):
    """Serving twin of ``models/gpt2.py``: it holds the :class:`GPT2`
    module (one copy of the weights) and runs its layers step by step with
    the K/V cache plumbing the module's training-shaped forward lacks."""

    def __init__(self, config, model):
        self.cfg = config
        self.model = model
        self.device = model.wte.weight.device
        self.dtype = model.wte.weight.dtype
        self.n_layers = config.n_layer
        self.n_heads = self.n_kv_heads = config.n_head
        self.head_dim = config.n_embd // config.n_head
        self.vocab_size = config.vocab_size
        self.max_context = config.block_size

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def prefill_ctx(self, tokens, start, k_ctx, v_ctx):
        m = self.model
        tok = self._ids(tokens)
        T = tok.shape[0]
        if k_ctx.shape[1] != start:
            raise ValueError(f"prefill_ctx at start={start} got "
                             f"{k_ctx.shape[1]} cached positions")
        x = m.wte(tok) + m.wpe.weight[start:start + T]
        ks, vs = [], []
        for li, blk in enumerate(m.h):
            q, k, v = blk.attn.qkv(blk.ln_1(x))                # [T, H, D]
            ks.append(k)
            vs.append(v)
            if start == 0:   # cold prefill: the flash kernel on the card
                y = causal_attention(q[None], k[None], v[None])[0]
            else:
                y = _ctx_causal_attend(q, k_ctx[li], v_ctx[li], k, v)
            x = x + blk.attn.c_proj(y.reshape(T, -1))
            x = x + blk.mlp(blk.ln_2(x))
        return m.head(x[-1]), torch.stack(ks), torch.stack(vs)

    @torch.inference_mode()
    def decode(self, tokens, positions, k_ctx, v_ctx, lens):
        m = self.model
        x = m.wte(self._ids(tokens)) + m.wpe(self._ids(positions))
        k_news, v_news = [], []
        for li, blk in enumerate(m.h):
            q, k, v = blk.attn.qkv(blk.ln_1(x))                # [B, H, D]
            k_news.append(k)
            v_news.append(v)
            y = _attend(q, k_ctx[:, li], v_ctx[:, li], lens, k, v)
            x = x + blk.attn.c_proj(y.reshape(x.shape[0], -1))
            x = x + blk.mlp(blk.ln_2(x))
        return (m.head(x), torch.stack(k_news, dim=1),
                torch.stack(v_news, dim=1))


# ---------------------------------------------------------------------- fake


class FakeAdapter(ModelAdapter):
    """Model-free adapter for scheduler/engine tests. Deterministic: the
    next token is a function of the last token AND the KV cache contents
    (each position's K stores its token id), so a block-table bug or a bad
    gather changes the output stream. The same rule as the JAX package's
    ``FakeAdapter``, so both engines give the same streams."""

    def __init__(self, vocab_size: int = 97, n_layers: int = 1,
                 n_kv_heads: int = 1, head_dim: int = 1,
                 max_context: int = 4096, device=None):
        self.vocab_size = vocab_size
        self.n_layers = n_layers
        self.n_heads = self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.max_context = max_context
        self.device = resolve_device(device)
        self.dtype = torch.float32

    def _next(self, ctx_sum: np.ndarray, tokens: np.ndarray) -> np.ndarray:
        return (np.asarray(ctx_sum).astype(np.int64)
                + tokens * 31 + 7) % self.vocab_size

    def _logits_for(self, nxt: np.ndarray) -> torch.Tensor:
        out = np.zeros(nxt.shape + (self.vocab_size,), dtype=np.float32)
        np.put_along_axis(out, nxt[..., None], 1.0, axis=-1)
        return torch.from_numpy(out).to(self.device)

    def _kv(self, tokens: np.ndarray):
        kv = torch.from_numpy(tokens.astype(np.float32)).to(self.device)
        kv = kv[..., None, None, None].expand(
            tokens.shape + (self.n_layers, self.n_kv_heads, self.head_dim))
        return kv.clone(), kv.clone()

    def prefill_ctx(self, tokens, start, k_ctx, v_ctx):
        tokens = np.asarray(tokens)
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
        tokens = np.asarray(tokens)
        # context read back THROUGH the gathered cache: [B, L, Tmax, H, D]
        # (masked by lens — padding slots may carry stale block data)
        valid = torch.arange(k_ctx.shape[2], device=k_ctx.device)[None, :] \
            < lens[:, None]
        ctx_sum = (k_ctx[:, 0, :, 0, 0].double() * valid).sum(dim=1)
        nxt = self._next(ctx_sum.cpu().numpy(), tokens)
        k, v = self._kv(tokens)  # [B, L, H, D]
        return self._logits_for(nxt), k, v


# ----------------------------------------------------------------- model zoo


MODEL_ZOO = {
    "gpt2-tiny": ("gpt2", "tiny"),
    "gpt2": ("gpt2", "gpt2_124m"),
    "fake": ("fake", None),
}


def build_adapter(model: str, model_config: Optional[dict] = None,
                  seed: int = 0, device=None) -> ModelAdapter:
    """Resolve a zoo name to a fresh, seeded adapter on ``device`` (default
    CUDA; a missing CUDA device raises). Weights are random from ``seed``
    (flax's initialisers, drawn on the CPU); checkpoint loading is out of
    scope. GPT-2 runs in fp32 unless ``model_config`` sets ``dtype``."""
    if model == "fake":
        return FakeAdapter(**(model_config or {}), device=device)
    if model not in MODEL_ZOO:
        raise ValueError(
            f"unknown model {model!r}; zoo: {sorted(MODEL_ZOO)}")
    from ray_tpu_torch.models import gpt2

    _, preset = MODEL_ZOO[model]
    kw = dict(model_config or {})
    kw.setdefault("dtype", torch.float32)  # the engine's reference precision
    cfg = getattr(gpt2.GPT2Config, preset)(**kw)
    gen = torch.Generator().manual_seed(seed)
    return GPT2Adapter(cfg, gpt2.init_params(cfg, gen, device=device))
