"""The LLM engine: continuous batching over a paged KV cache on the device.

The port of ``LLMEngine`` from ``ray_tpu/serve/llm/engine.py``. It owns the
paged cache, the continuous-batching scheduler and a model adapter, and
advances the world one :meth:`step` at a time (prefill the newly admitted,
one fused decode for everything running, commit + deliver tokens). It is
thread-safe behind one coarse lock and drives the adapter directly: in this
slice the engine itself is the entry point a user calls.

Two serving optimizations ride the same step loop, both byte-equal to
plain greedy decoding:

  - **prefix caching** (``RTPU_TORCH_llm_prefix_cache``): admission maps
    the longest indexed prompt prefix read-only into the new sequence's
    block table (see ``kv_cache.py``) and the engine prefills only the
    un-hit tail via the adapter's ``prefill_ctx``;
  - **speculative decoding** (``draft_adapter=`` + ``spec_k``, default
    ``RTPU_TORCH_llm_spec_k``): a small draft model proposes ``k`` tokens
    through its own paged cache, the target verifies all of them in ONE
    fused ``decode_chunk`` forward, and the longest agreeing run (+1 bonus
    token) commits; the draft cache rolls back with a refcount-aware
    ``truncate``. Greedy acceptance means the stream is what the target
    alone would have produced. Only temperature-0 sequences speculate;
    sampled ones take the plain fused decode. The draft's proposals stay
    on the device, and one copy per verify round brings the proposals and
    the target's choices to the host.

The cache lives on the adapter's device and takes the adapter's K/V type.
Sampling keeps the JAX engine's semantics: greedy is the argmax of the
logits (taken on the device, one copy to the host per batch), and a
temperature > 0 sequence samples on the host from its own seeded numpy
generator, so a seed gives the same stream as in the JAX engine.

Per-step telemetry goes through the port's ``util/metrics`` records with
the JAX package's names, help strings and tags (``deployment``, from
``name=`` or :meth:`LLMEngine.set_identity`, and ``replica``):

  ray_tpu_llm_tokens_per_s        gauge, EMA of generated tokens/s
  ray_tpu_llm_kv_utilization      gauge, 0-1 fraction of KV blocks in use
  ray_tpu_llm_batch_size          gauge, sequences in the last step
  ray_tpu_llm_preemptions_total   counter
  ray_tpu_llm_prefix_hit_rate     gauge, cumulative fraction of looked-up
                                  prompt tokens served from the prefix
                                  cache (with the prefix cache on)
  ray_tpu_llm_spec_acceptance     gauge, cumulative fraction of proposed
                                  draft tokens the target accepted (with a
                                  draft model)

and the flight recorder gets ``llm.admit`` / ``llm.preempt`` /
``llm.finish`` / ``llm.prefix_hit`` / ``llm.spec_verify`` events (cheap
tuples, no formatting until dump). ``load()`` is the waiting + running
count a serve autoscaler keys on.

Not ported yet: the ``LLMReplica`` serve deployment (ROADMAP Queue A
item 6).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._private import flight_recorder as _fr
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

    __slots__ = ("params", "rng", "spec")

    def __init__(self, params: SamplingParams):
        self.params = params
        self.rng = (np.random.default_rng(params.seed)
                    if params.temperature > 0 else None)
        # set at prefill time: the draft cache admitted this sequence, so
        # it takes the speculative decode path (greedy sequences only)
        self.spec = False


_llm_metrics = None


def _metrics():
    global _llm_metrics
    if _llm_metrics is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        tags = ("deployment", "replica")
        _llm_metrics = {
            "tokens_per_s": Gauge(
                "ray_tpu_llm_tokens_per_s",
                "generated tokens/s per llm replica (EMA)", tag_keys=tags),
            "kv_util": Gauge(
                "ray_tpu_llm_kv_utilization",
                "fraction of paged KV blocks in use", tag_keys=tags),
            "batch": Gauge(
                "ray_tpu_llm_batch_size",
                "sequences in the last engine step", tag_keys=tags),
            "preempt": Counter(
                "ray_tpu_llm_preemptions_total",
                "sequences requeued on KV exhaustion", tag_keys=tags),
            "prefix_hit": Gauge(
                "ray_tpu_llm_prefix_hit_rate",
                "fraction of prompt tokens served from the prefix cache",
                tag_keys=tags),
            "spec_accept": Gauge(
                "ray_tpu_llm_spec_acceptance",
                "fraction of proposed draft tokens the target accepted",
                tag_keys=tags),
        }
    return _llm_metrics


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
        name: str = "llm",
        prefix_cache: Optional[bool] = None,
        draft_adapter: Optional[ModelAdapter] = None,
        spec_k: Optional[int] = None,
    ):
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
        self.spec_k = int(CONFIG.llm_spec_k if spec_k is None else spec_k)
        self.draft_adapter = draft_adapter if self.spec_k > 0 else None
        self.draft_cache: Optional[PagedKVCache] = None
        if self.draft_adapter is not None:
            da = self.draft_adapter
            if da.vocab_size != adapter.vocab_size:
                raise ValueError(f"draft vocab {da.vocab_size} != "
                                 f"target vocab {adapter.vocab_size}")
            self.draft_cache = PagedKVCache(
                num_blocks=num_blocks,
                block_size=block_size,
                n_layers=da.n_layers,
                n_kv_heads=da.n_kv_heads,
                head_dim=da.head_dim,
                dtype=da.dtype,
                enable_prefix_cache=self.prefix_cache_enabled,
                device=da.device,
            )
        self._out: Dict[str, _OutBuffer] = {}
        # finish reasons of recently drained sequences: a re-pull of a
        # drained id gets its true terminal marker, not "unknown"
        self._done_reasons: "OrderedDict[str, str]" = OrderedDict()
        self._lock = threading.RLock()
        self._tags = {"deployment": name, "replica": ""}
        self._tokens_per_s = 0.0  # EMA over steps
        self.steps_total = 0
        self.tokens_total = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_rounds_total = 0

    def set_identity(self, deployment: str, replica: str = ""):
        """The tags of this engine's series (a serve replica sets them)."""
        self._tags = {"deployment": deployment, "replica": replica}

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

    def _free_draft(self, seq_id: str) -> None:
        if self.draft_cache is not None:
            self.draft_cache.free(seq_id)

    def _prefill_seq(self, seq: Sequence) -> torch.Tensor:
        """Run the (possibly tail-only) prefill for a just-admitted
        sequence, write + index its KV, and mirror it into the draft cache
        when speculating. Returns the last position's logits. Raises
        KVCacheExhausted if the target-side write cannot complete — the
        caller frees the partial hold and requeues."""
        ctx = seq.context_tokens()
        cached = min(seq.cached_len, len(ctx) - 1)
        if cached:
            k_ctx, v_ctx = self.cache.gather(seq.seq_id)
            logits, k, v = self.adapter.prefill_ctx(
                np.asarray(ctx[cached:], dtype=np.int64), cached,
                k_ctx, v_ctx)
            _fr.record("llm.prefix_hit", b"",
                       f"{seq.seq_id} hit={cached}/{len(ctx)}")
        else:
            logits, k, v = self.adapter.prefill(
                np.asarray(ctx, dtype=np.int64))
        self.cache.write_prefill(seq.seq_id, k, v)
        self.cache.register_prefix(seq.seq_id, ctx)
        sp: Optional[_SeqSampling] = seq.sampling
        if (self.draft_cache is not None and sp is not None
                and sp.params.temperature <= 0):
            sp.spec = self._draft_prefill(seq.seq_id, ctx)
        return logits

    def _draft_prefill(self, seq_id: str, ctx: List[int]) -> bool:
        """Mirror the context into the draft cache (prefix-aware too).
        Failure is not fatal — the sequence just decodes without
        speculation."""
        dc, da = self.draft_cache, self.draft_adapter
        dc.free(seq_id)  # defensive: re-admission after an interrupted try
        served = dc.allocate_cached(seq_id, ctx, extra=self.spec_k + 1)
        if served is None:
            return False
        try:
            if served:
                k_ctx, v_ctx = dc.gather(seq_id)
                _, k, v = da.prefill_ctx(
                    np.asarray(ctx[served:], dtype=np.int64), served,
                    k_ctx, v_ctx)
            else:
                _, k, v = da.prefill(np.asarray(ctx, dtype=np.int64))
            dc.write_prefill(seq_id, k, v)
            dc.register_prefix(seq_id, ctx)
        except KVCacheExhausted:
            dc.free(seq_id)
            return False
        return True

    def _draft_extend(self, seqs: List[Sequence], n: int) -> bool:
        for s in seqs:
            if not self.draft_cache.extend(s.seq_id, n):
                return False
        return True

    def _spec_decode(self, seqs: List[Sequence]
                     ) -> Optional[Dict[str, List[int]]]:
        """Speculative decode for one step's greedy sequences: the draft
        proposes up to ``spec_k`` tokens (fused over the batch through its
        own paged cache), the target scores the whole chunk in ONE fused
        ``decode_chunk`` forward, and each sequence keeps its longest
        agreeing run plus the bonus token — exactly the tokens sequential
        greedy decoding would have produced. Rejected draft positions roll
        the draft cache back via the refcount-aware ``truncate``. The
        proposals stay on the device; one copy per round brings them and
        the target's choices to the host. Returns None when the draft pool
        cannot even start a round (callers fall back to the plain fused
        decode this step)."""
        da, dc = self.draft_adapter, self.draft_cache
        ids = [s.seq_id for s in seqs]
        # 1. catch-up: the draft cache must cover exactly the positions the
        #    target cache holds (it runs one token behind after a fully
        #    accepted round; further behind is impossible by construction)
        while True:
            lag = [s for s in seqs
                   if dc.seq_lens[s.seq_id] < self.cache.seq_lens[s.seq_id]]
            if not lag:
                break
            if not self._draft_extend(lag, 1):
                return None
            toks = np.asarray(
                [s.context_tokens()[dc.seq_lens[s.seq_id]] for s in lag],
                dtype=np.int64)
            lag_ids = [s.seq_id for s in lag]
            pos = np.asarray([dc.seq_lens[i] for i in lag_ids],
                             dtype=np.int64)
            k_ctx, v_ctx, lens = dc.gather_batch(lag_ids)
            _, k_new, v_new = da.decode(toks, pos, k_ctx, v_ctx, lens)
            for i, s in enumerate(lag):
                dc.append(s.seq_id, k_new[i], v_new[i])

        # 2. propose: k fused draft decode steps, the tokens kept on the
        #    device (each step's argmax feeds the next without a host copy)
        last = np.asarray([s.tokens[-1] for s in seqs], dtype=np.int64)
        drafts: List[torch.Tensor] = []
        cur: Union[np.ndarray, torch.Tensor] = last
        for _ in range(self.spec_k):
            if not self._draft_extend(seqs, 1):
                break
            pos = np.asarray([dc.seq_lens[i] for i in ids], dtype=np.int64)
            k_ctx, v_ctx, lens = dc.gather_batch(ids)
            logits, k_new, v_new = da.decode(cur, pos, k_ctx, v_ctx, lens)
            for i, s in enumerate(seqs):
                dc.append(s.seq_id, k_new[i], v_new[i])
            cur = logits.argmax(dim=-1)
            drafts.append(cur.to(self.adapter.device))
        k_eff = len(drafts)
        if k_eff == 0:
            return None

        # 3. verify: one fused target forward over [last, d0..d_{k-1}]
        chunk = torch.stack(
            [torch.from_numpy(last).to(self.adapter.device)] + drafts, dim=1)
        pos = np.asarray([self.cache.seq_lens[i] for i in ids],
                         dtype=np.int64)
        k_ctx, v_ctx, lens = self.cache.gather_batch(ids)
        logits, k_new, v_new = self.adapter.decode_chunk(
            chunk, pos, k_ctx, v_ctx, lens)
        # the round's one host copy: proposals [B, k_eff] | choices [B, k_eff+1]
        both = torch.cat([chunk[:, 1:], logits.argmax(dim=-1)], dim=1).cpu().numpy()
        proposed, greedy = both[:, :k_eff], both[:, k_eff:]

        bs = self.cache.block_size
        sampled: Dict[str, List[int]] = {}
        accepted_round = 0
        for i, s in enumerate(seqs):
            agree = 0
            while (agree < k_eff
                   and int(proposed[i, agree]) == int(greedy[i, agree])):
                agree += 1
            n_emit = agree + 1
            # clip to the sequence's budget, to EOS, and to what the pool
            # can still hold this step (>= 1 slot is pre-reserved by the
            # scheduler, so plain-decode progress is always possible)
            n_emit = min(n_emit, max(1, s.max_tokens - len(s.tokens)))
            emitted = [int(greedy[i, c]) for c in range(n_emit)]
            if s.eos_id is not None and s.eos_id in emitted:
                n_emit = emitted.index(s.eos_id) + 1
                emitted = emitted[:n_emit]
            sid = s.seq_id
            slack = (len(self.cache.block_tables[sid]) * bs
                     - self.cache.seq_lens[sid]
                     + self.cache.num_free_blocks * bs)
            if n_emit > slack:
                n_emit = max(1, slack)
                emitted = emitted[:n_emit]
            self.cache.write_prefill(
                sid, k_new[i, :, :n_emit], v_new[i, :, :n_emit])
            # roll the draft back to the accepted length; after a fully
            # accepted chunk it is one token SHORT instead (caught up at
            # the start of the next round)
            new_kv_len = int(pos[i]) + n_emit
            if dc.seq_lens[sid] > new_kv_len:
                dc.truncate(sid, new_kv_len)
            sampled[sid] = emitted
            accepted_round += n_emit - 1
        self.spec_rounds_total += 1
        self.spec_proposed_total += k_eff * len(seqs)
        self.spec_accepted_total += accepted_round
        _fr.record("llm.spec_verify", b"",
                   f"batch={len(seqs)} k={k_eff} accepted={accepted_round}")
        return sampled

    def step(self) -> Dict[str, Any]:
        """One engine iteration; returns step stats (also published as
        series). A no-op returning ``{"batch_size": 0, "tokens": 0}`` when
        idle."""
        with self._lock:
            t0 = time.perf_counter()
            plan = self.scheduler.schedule()
            for seq in plan.reaped:
                self._finish_buffer(seq)
                self._free_draft(seq.seq_id)
            for seq in plan.preempted:
                self._free_draft(seq.seq_id)
                _fr.record("llm.preempt", b"",
                           f"{seq.seq_id} ctx={seq.total_len}")
            if plan.batch_size == 0:
                # as the JAX engine: an empty step publishes no preemption
                self._publish(0, 0)
                return {"batch_size": 0, "tokens": 0}

            sampled: Dict[str, Union[int, List[int]]] = {}
            for seq in plan.prefills:
                try:
                    logits = self._prefill_seq(seq)
                except KVCacheExhausted:
                    # admission interrupted mid-prefill (e.g. a
                    # copy-on-write with an empty pool): free the partial
                    # hold FIRST — requeueing with blocks still pinned
                    # would leak shared refcounts — then retry next step
                    self.cache.free(seq.seq_id)
                    self._free_draft(seq.seq_id)
                    self.scheduler.requeue(seq)
                    _fr.record("llm.preempt", b"",
                               f"{seq.seq_id} ctx={seq.total_len} admit")
                    continue
                sampled[seq.seq_id] = self._sample([seq], logits[None])[0]
                _fr.record("llm.admit", b"",
                           f"{seq.seq_id} prompt={seq.total_len} "
                           f"hit={seq.cached_len} "
                           f"kv={self.cache.utilization():.2f}")
            plain = plan.decodes
            if plan.decodes and self.draft_cache is not None:
                spec_seqs = [s for s in plan.decodes if s.sampling.spec]
                plain = [s for s in plan.decodes if not s.sampling.spec]
                out = self._spec_decode(spec_seqs) if spec_seqs else None
                if out is None:
                    plain = plain + spec_seqs
                else:
                    sampled.update(out)
            if plain:
                ids = [s.seq_id for s in plain]
                toks = np.asarray([s.tokens[-1] for s in plain], dtype=np.int64)
                pos = np.asarray([self.cache.seq_lens[i] for i in ids],
                                 dtype=np.int64)
                k_ctx, v_ctx, lens = self.cache.gather_batch(ids)
                logits, k_new, v_new = self.adapter.decode(
                    toks, pos, k_ctx, v_ctx, lens)
                for i, seq in enumerate(plain):
                    self.cache.append(seq.seq_id, k_new[i], v_new[i])
                for seq, tok in zip(plain, self._sample(plain, logits)):
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
                self._free_draft(seq.seq_id)
                _fr.record("llm.finish", b"",
                           f"{seq.seq_id} reason={seq.finish_reason} "
                           f"tokens={len(seq.tokens)}")

            dt = max(time.perf_counter() - t0, 1e-9)
            self.steps_total += 1
            self.tokens_total += n_tokens
            inst = n_tokens / dt
            self._tokens_per_s = (inst if self._tokens_per_s == 0.0
                                  else 0.8 * self._tokens_per_s + 0.2 * inst)
            self._publish(plan.batch_size, len(plan.preempted))
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

    def spec_acceptance(self) -> float:
        """Cumulative fraction of proposed draft tokens the target
        accepted."""
        if not self.spec_proposed_total:
            return 0.0
        return self.spec_accepted_total / self.spec_proposed_total

    def _publish(self, batch: int, preempted: int):
        try:
            m = _metrics()
            m["tokens_per_s"].set(self._tokens_per_s, tags=self._tags)
            m["kv_util"].set(self.cache.utilization(), tags=self._tags)
            m["batch"].set(batch, tags=self._tags)
            if preempted:
                m["preempt"].inc(preempted, tags=self._tags)
            if self.prefix_cache_enabled:
                m["prefix_hit"].set(self.cache.hit_rate(), tags=self._tags)
            if self.draft_cache is not None:
                m["spec_accept"].set(self.spec_acceptance(),
                                     tags=self._tags)
        except Exception:
            pass  # telemetry must never fail an engine step

    # ------------------------------------------------------------------ misc

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    def load(self) -> int:
        """Waiting + running sequences — what a serve autoscaler keys on."""
        with self._lock:
            return self.scheduler.queue_depth()

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
            if self.draft_cache is not None:
                out.update({
                    "spec_acceptance": round(self.spec_acceptance(), 4),
                    "spec_rounds_total": self.spec_rounds_total,
                })
            return out

    def run_until_drained(self, max_steps: int = 1_000_000) -> int:
        """Drive the engine until no work remains; returns steps executed."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return steps
