"""The LLM engine: continuous batching over a paged KV cache on the device.

The port of ``LLMEngine`` from ``ray_tpu/serve/llm/engine.py``. It owns the
paged cache, the continuous-batching scheduler and a model adapter, and
advances the world one :meth:`step` at a time (prefill the newly admitted,
one fused decode for everything running, commit + deliver tokens). It is
thread-safe behind one coarse lock and drives the adapter directly: in this
slice the engine itself is the entry point a user calls.

Prefix caching (``RTPU_TORCH_llm_prefix_cache``) rides the same step loop
and stays byte-equal to plain greedy decoding: admission maps the longest
indexed prompt prefix read-only into the new sequence's block table (see
``kv_cache.py``) and the engine prefills only the un-hit tail via the
adapter's ``prefill_ctx``.

The cache lives on the adapter's device and takes the adapter's K/V type.
Sampling keeps the JAX engine's semantics: greedy is the argmax of the
logits (taken on the device, one copy to the host per batch), and a
temperature > 0 sequence samples on the host from its own seeded numpy
generator, so a seed gives the same stream as in the JAX engine.

Not ported yet: speculative decoding (``draft_adapter``/``spec_k``),
the metrics and flight-recorder events, and the ``LLMReplica`` serve
deployment; each comes with a later slice.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.serve.llm import scheduler as sched_mod
from ray_tpu_torch.serve.llm.adapters import ModelAdapter
from ray_tpu_torch.serve.llm.kv_cache import KVCacheExhausted, PagedKVCache
from ray_tpu_torch.serve.llm.scheduler import Scheduler, Sequence


class LLMBackpressure(RuntimeError):
    """Structured admission rejection: the engine sheds load instead of
    exhausting the KV cache. Carries enough for a client to make a real
    decision — queue elsewhere, back off, or surface a 429."""

    def __init__(self, queue_depth: int, max_waiting: int,
                 kv_utilization: float):
        self.queue_depth = int(queue_depth)
        self.max_waiting = int(max_waiting)
        self.kv_utilization = float(kv_utilization)
        super().__init__(
            f"llm admission rejected: queue_depth={queue_depth} >= "
            f"max_waiting={max_waiting} (kv_utilization="
            f"{kv_utilization:.2f}); back off and retry"
        )

    def __reduce__(self):
        # pickles with its structure intact (the default would replay the
        # message string into the 3-arg __init__)
        return (LLMBackpressure,
                (self.queue_depth, self.max_waiting, self.kv_utilization))

    def to_dict(self) -> dict:
        return {"backpressure": True, "queue_depth": self.queue_depth,
                "max_waiting": self.max_waiting,
                "kv_utilization": round(self.kv_utilization, 4)}


@dataclass
class SamplingParams:
    max_tokens: int = 16
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = full vocab
    eos_id: Optional[int] = None
    seed: Optional[int] = None


class _SeqSampling:
    """Per-sequence sampling state riding on Sequence.sampling."""

    __slots__ = ("params", "rng")

    def __init__(self, params: SamplingParams):
        self.params = params
        self.rng = (np.random.default_rng(params.seed)
                    if params.temperature > 0 else None)


class _OutBuffer:
    """Tokens produced but not yet pulled by the client."""

    __slots__ = ("tokens", "done", "finish_reason")

    def __init__(self):
        self.tokens: List[int] = []
        self.done = False
        self.finish_reason: Optional[str] = None


class LLMEngine:
    """Synchronous continuous-batching engine (see module docstring)."""

    def __init__(
        self,
        adapter: ModelAdapter,
        *,
        num_blocks: Optional[int] = None,
        block_size: Optional[int] = None,
        max_batch: Optional[int] = None,
        max_waiting: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        draft_adapter: Optional[ModelAdapter] = None,
        spec_k: Optional[int] = None,
    ):
        if draft_adapter is not None or (spec_k or 0) > 0:
            raise NotImplementedError(
                "speculative decoding (draft_adapter/spec_k) is not ported "
                "to ray_tpu_torch yet; it comes with the decode_chunk slice")
        self.adapter = adapter
        block_size = int(block_size or CONFIG.llm_block_size)
        num_blocks = int(num_blocks or CONFIG.llm_num_blocks)
        self.prefix_cache_enabled = bool(
            CONFIG.llm_prefix_cache if prefix_cache is None
            else prefix_cache)
        self.cache = PagedKVCache(
            num_blocks=num_blocks,
            block_size=block_size,
            n_layers=adapter.n_layers,
            n_kv_heads=adapter.n_kv_heads,
            head_dim=adapter.head_dim,
            dtype=adapter.dtype,
            enable_prefix_cache=self.prefix_cache_enabled,
            device=adapter.device,
        )
        self.scheduler = Scheduler(
            self.cache,
            max_batch_size=int(max_batch or CONFIG.llm_max_batch),
            max_waiting=int(max_waiting or CONFIG.llm_max_waiting),
        )
        self._out: Dict[str, _OutBuffer] = {}
        # finish reasons of recently drained sequences: a re-pull of a
        # drained id gets its true terminal marker, not "unknown"
        self._done_reasons: "OrderedDict[str, str]" = OrderedDict()
        self._lock = threading.RLock()
        self._tokens_per_s = 0.0  # EMA over steps
        self.steps_total = 0
        self.tokens_total = 0

    # ------------------------------------------------------------ submission

    def submit(self, prompt: List[int],
               sampling: Optional[SamplingParams] = None) -> str:
        """Admit a prompt; returns the request id. Raises
        :class:`LLMBackpressure` past ``max_waiting`` queued prompts and
        ``ValueError`` for prompts that can never fit the cache."""
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.adapter.vocab_size for t in prompt):
            raise ValueError(
                f"prompt token out of range [0, {self.adapter.vocab_size})")
        limit = min(self.adapter.max_context,
                    self.cache.num_blocks * self.cache.block_size)
        if len(prompt) + 1 > limit:
            raise ValueError(
                f"prompt of {len(prompt)} tokens can never fit "
                f"(context limit {limit})")
        with self._lock:
            if not self.scheduler.can_admit():
                raise LLMBackpressure(
                    self.scheduler.queue_depth(),
                    self.scheduler.max_waiting,
                    self.cache.utilization(),
                )
            seq = Sequence(prompt=prompt, max_tokens=sampling.max_tokens,
                           eos_id=sampling.eos_id,
                           sampling=_SeqSampling(sampling))
            self.scheduler.add(seq)
            self._out[seq.seq_id] = _OutBuffer()
            return seq.seq_id

    def cancel(self, seq_id: str) -> bool:
        """Client abandoned the stream: stop generating and (for waiting
        sequences now, running ones at the next schedule) free the KV."""
        with self._lock:
            ok = self.scheduler.cancel(seq_id)
            buf = self._out.get(seq_id)
            if buf is not None and not buf.done:
                buf.done = True
                buf.finish_reason = sched_mod.FINISH_CANCELLED
            return ok

    def pull(self, seq_id: str, max_tokens: int = 0):
        """Drain up to ``max_tokens`` (0 = all) buffered tokens. Returns
        ``(tokens, done, finish_reason)``; ``done`` only once the buffer is
        empty AND the sequence finished. An unknown or already-drained id
        returns a terminal marker ``([], True, reason)`` immediately;
        recently drained ids keep their true finish reason in a bounded
        ring, everything older reports ``"unknown"``."""
        with self._lock:
            buf = self._out.get(seq_id)
            if buf is None:
                return [], True, self._done_reasons.get(seq_id, "unknown")
            n = len(buf.tokens) if max_tokens <= 0 else int(max_tokens)
            out, buf.tokens = buf.tokens[:n], buf.tokens[n:]
            done = buf.done and not buf.tokens
            if done:
                self._out.pop(seq_id, None)
                self._done_reasons[seq_id] = buf.finish_reason or "unknown"
                while len(self._done_reasons) > 1024:
                    self._done_reasons.popitem(last=False)
            return out, done, buf.finish_reason

    # --------------------------------------------------------------- the step

    @staticmethod
    def _sample_temperature(sp: _SeqSampling, logits: torch.Tensor) -> int:
        p = sp.params
        z = logits.detach().cpu().numpy().astype(np.float64) / p.temperature
        if p.top_k and p.top_k < len(z):
            kth = np.partition(z, -p.top_k)[-p.top_k]
            z = np.where(z < kth, -np.inf, z)
        z -= z.max()
        probs = np.exp(z)
        probs /= probs.sum()
        return int(sp.rng.choice(len(probs), p=probs))

    def _sample(self, seqs: List[Sequence], logits: torch.Tensor) -> List[int]:
        """One token per row of ``logits [B, vocab]``: the greedy argmax of
        every row comes to the host in one copy; temperature rows sample on
        the host."""
        greedy = logits.argmax(dim=-1).tolist()
        out = []
        for i, seq in enumerate(seqs):
            sp: _SeqSampling = seq.sampling
            if sp.params.temperature <= 0 or sp.rng is None:
                out.append(int(greedy[i]))
            else:
                out.append(self._sample_temperature(sp, logits[i]))
        return out

    def _prefill_seq(self, seq: Sequence) -> torch.Tensor:
        """Run the (possibly tail-only) prefill for a just-admitted
        sequence and write + index its KV. Returns the last position's
        logits. Raises KVCacheExhausted if the write cannot complete — the
        caller frees the partial hold and requeues."""
        ctx = seq.context_tokens()
        cached = min(seq.cached_len, len(ctx) - 1)
        if cached:
            k_ctx, v_ctx = self.cache.gather(seq.seq_id)
            logits, k, v = self.adapter.prefill_ctx(
                np.asarray(ctx[cached:], dtype=np.int64), cached,
                k_ctx, v_ctx)
        else:
            logits, k, v = self.adapter.prefill(
                np.asarray(ctx, dtype=np.int64))
        self.cache.write_prefill(seq.seq_id, k, v)
        self.cache.register_prefix(seq.seq_id, ctx)
        return logits

    def step(self) -> Dict[str, Any]:
        """One engine iteration; returns step stats. A no-op returning
        ``{"batch_size": 0, "tokens": 0}`` when idle."""
        with self._lock:
            t0 = time.perf_counter()
            plan = self.scheduler.schedule()
            for seq in plan.reaped:
                self._finish_buffer(seq)
            if plan.batch_size == 0:
                return {"batch_size": 0, "tokens": 0}

            sampled: Dict[str, int] = {}
            for seq in plan.prefills:
                try:
                    logits = self._prefill_seq(seq)
                except KVCacheExhausted:
                    # admission interrupted mid-prefill (e.g. a
                    # copy-on-write with an empty pool): free the partial
                    # hold FIRST — requeueing with blocks still pinned
                    # would leak shared refcounts — then retry next step
                    self.cache.free(seq.seq_id)
                    self.scheduler.requeue(seq)
                    continue
                sampled[seq.seq_id] = self._sample([seq], logits[None])[0]
            if plan.decodes:
                ids = [s.seq_id for s in plan.decodes]
                toks = np.asarray([s.tokens[-1] for s in plan.decodes],
                                  dtype=np.int64)
                pos = np.asarray([self.cache.seq_lens[i] for i in ids],
                                 dtype=np.int64)
                k_ctx, v_ctx, lens = self.cache.gather_batch(ids)
                logits, k_new, v_new = self.adapter.decode(
                    toks, pos, k_ctx, v_ctx, lens)
                for i, seq in enumerate(plan.decodes):
                    self.cache.append(seq.seq_id, k_new[i], v_new[i])
                for seq, tok in zip(plan.decodes,
                                    self._sample(plan.decodes, logits)):
                    sampled[seq.seq_id] = tok

            by_id = {s.seq_id: s for s in plan.prefills + plan.decodes}
            before = {sid: len(by_id[sid].tokens) for sid in sampled}
            finished = self.scheduler.commit(sampled)
            n_tokens = 0
            for sid in sampled:
                seq = by_id[sid]
                committed = seq.tokens[before[sid]:]
                n_tokens += len(committed)
                buf = self._out.get(sid)
                if buf is not None and not buf.done:
                    buf.tokens.extend(committed)
            for seq in finished:
                self._finish_buffer(seq)

            dt = max(time.perf_counter() - t0, 1e-9)
            self.steps_total += 1
            self.tokens_total += n_tokens
            inst = n_tokens / dt
            self._tokens_per_s = (inst if self._tokens_per_s == 0.0
                                  else 0.8 * self._tokens_per_s + 0.2 * inst)
            return {
                "batch_size": plan.batch_size,
                "prefills": len(plan.prefills),
                "decodes": len(plan.decodes),
                "preempted": len(plan.preempted),
                "finished": len(finished),
                "finished_ids": [s.seq_id for s in finished],
                "tokens": n_tokens,
                "step_s": dt,
            }

    def _finish_buffer(self, seq: Sequence):
        buf = self._out.get(seq.seq_id)
        if buf is not None:
            buf.done = True
            buf.finish_reason = seq.finish_reason

    # ------------------------------------------------------------------ misc

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "waiting": len(self.scheduler.waiting),
                "running": len(self.scheduler.running),
                "kv_utilization": round(self.cache.utilization(), 4),
                "kv_free_blocks": self.cache.num_free_blocks,
                "tokens_per_s": round(self._tokens_per_s, 1),
                "tokens_total": self.tokens_total,
                "steps_total": self.steps_total,
                "preemptions_total": self.scheduler.preemptions_total,
                "finished_total": self.scheduler.finished_total,
            }
            if self.prefix_cache_enabled:
                out.update({
                    "prefix_hit_rate": round(self.cache.hit_rate(), 4),
                    "kv_cached_blocks": self.cache.num_cached_blocks,
                    "cow_copies": self.cache.cow_copies,
                })
            return out

    def run_until_drained(self, max_steps: int = 1_000_000) -> int:
        """Drive the engine until no work remains; returns steps executed."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return steps
