"""Continuous-batching scheduler: prefill/decode separation + preemption.

Iteration-level scheduling (Orca's contribution, vLLM's scheduler shape):
the unit of work is ONE engine step, not one request. Every step the
scheduler

  1. reaps cancellations,
  2. makes sure each RUNNING sequence has a KV slot for the token this
     step will produce — preempting the youngest sequence back to the
     waiting queue (recompute-on-resume) when the cache is out of blocks,
  3. admits waiting prompts into spare batch slots while their prompt fits
     in the cache (these run as prefills this step) — admission is
     prefix-aware: the longest cached prefix is mapped read-only into the
     block table and only the tail is charged to the pool (and prefilled),

and returns a :class:`StepPlan`. The engine executes the plan against the
model adapter and calls :meth:`Scheduler.commit` with the sampled tokens;
commit applies the termination rules (EOS / max_tokens / cancel) and frees
finished sequences' blocks.

Deliberately model-free and clock-free: the only dependencies are the
cache's allocator interface and the order requests arrived in, so unit
tests drive it step by step with a fake model and byte-identical results.

A copy of ``ray_tpu/serve/llm/scheduler.py`` (device-free, so nothing in
it changes for the port but the import of the cache).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from ray_tpu_torch.serve.llm.kv_cache import PagedKVCache

WAITING = "WAITING"
RUNNING = "RUNNING"
FINISHED = "FINISHED"

# finish reasons (surfaced to clients in the stream's final frame)
FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_CANCELLED = "cancelled"

_seq_counter = itertools.count()


@dataclass
class Sequence:
    """One generation request as the scheduler sees it."""

    prompt: List[int]
    max_tokens: int = 16
    eos_id: Optional[int] = None
    seq_id: str = ""
    state: str = WAITING
    tokens: List[int] = field(default_factory=list)  # generated so far
    arrival: int = 0          # admission priority (FIFO; preemption victim
    #                           is the HIGHEST arrival = youngest)
    preemptions: int = 0
    cancelled: bool = False
    finish_reason: Optional[str] = None
    # context tokens whose KV the prefix cache already held at admission —
    # the engine prefills only context_tokens()[cached_len:]
    cached_len: int = 0
    # opaque slot for the engine (sampling state rides along)
    sampling: Optional[object] = None

    def __post_init__(self):
        if not self.seq_id:
            self.seq_id = f"seq-{next(_seq_counter)}"
        self.arrival = next(_seq_counter)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.tokens)

    def context_tokens(self) -> List[int]:
        """What a (re)prefill must run over: prompt + everything generated
        before a preemption threw the KV away."""
        return self.prompt + self.tokens


@dataclass
class StepPlan:
    """What one engine step executes: ``prefills`` are sequences admitted
    this step (their context needs a full forward + cache write);
    ``decodes`` were already running and take one fused decode step."""

    prefills: List[Sequence] = field(default_factory=list)
    decodes: List[Sequence] = field(default_factory=list)
    # evicted back to waiting while building this plan (engine telemetry)
    preempted: List[Sequence] = field(default_factory=list)
    # cancelled sequences reaped while building this plan
    reaped: List[Sequence] = field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return len(self.prefills) + len(self.decodes)


class Scheduler:
    def __init__(self, cache: PagedKVCache, max_batch_size: int = 32,
                 max_waiting: int = 512):
        self.cache = cache
        self.max_batch_size = int(max_batch_size)
        self.max_waiting = int(max_waiting)
        self.waiting: List[Sequence] = []   # FIFO (preempted re-enter at head)
        self.running: List[Sequence] = []
        self._by_id: Dict[str, Sequence] = {}
        self.preemptions_total = 0
        self.finished_total = 0

    # ------------------------------------------------------------- admission

    def queue_depth(self) -> int:
        return len(self.waiting) + len(self.running)

    def can_admit(self) -> bool:
        return len(self.waiting) < self.max_waiting

    def add(self, seq: Sequence) -> None:
        """Enqueue a request. Admission control (shedding past
        ``max_waiting``) is the engine's job — it owns the structured
        backpressure error; ``add`` never refuses."""
        seq.state = WAITING
        self._by_id[seq.seq_id] = seq
        self.waiting.append(seq)

    def get(self, seq_id: str) -> Optional[Sequence]:
        return self._by_id.get(seq_id)

    def cancel(self, seq_id: str) -> bool:
        """Mark a sequence cancelled. Waiting sequences finish (and leave)
        immediately; running ones are reaped — and their blocks freed — at
        the start of the next schedule()."""
        seq = self._by_id.get(seq_id)
        if seq is None or seq.state == FINISHED:
            return False
        seq.cancelled = True
        if seq.state == WAITING:
            self.waiting.remove(seq)
            self._finish(seq, FINISH_CANCELLED)
        return True

    # -------------------------------------------------------------- the step

    def schedule(self) -> StepPlan:
        """Build this step's plan (mutates queues + cache allocation)."""
        plan = StepPlan()
        # 1. reap cancellations that arrived mid-flight
        for seq in [s for s in self.running if s.cancelled]:
            self.running.remove(seq)
            self.cache.free(seq.seq_id)
            self._finish(seq, FINISH_CANCELLED)
            plan.reaped.append(seq)

        # 2. every running sequence needs one slot for this step's token;
        #    on exhaustion the YOUNGEST survivor is evicted (its blocks fund
        #    the older sequences), until everyone left can extend
        survivors = sorted(self.running, key=lambda s: s.arrival)
        i = 0
        while i < len(survivors):
            if self.cache.extend(survivors[i].seq_id, 1):
                i += 1
            else:
                victim = survivors.pop()
                self._preempt(victim)
                plan.preempted.append(victim)
        self.running = survivors

        # 3. admit prefills into spare slots while their context fits,
        #    +1 so the first decode step cannot immediately preempt them.
        #    allocate_cached maps the longest indexed prefix read-only into
        #    the block table and charges the pool only for the tail — the
        #    engine then prefills context_tokens()[cached_len:].
        plan.decodes = list(self.running)
        while (self.waiting
               and plan.batch_size < self.max_batch_size):
            seq = self.waiting[0]
            served = self.cache.allocate_cached(
                seq.seq_id, seq.context_tokens(), extra=1)
            if served is None:
                break  # head-of-line blocks: FIFO fairness over packing
            seq.cached_len = served
            self.waiting.pop(0)
            seq.state = RUNNING
            self.running.append(seq)
            plan.prefills.append(seq)
        return plan

    def _preempt(self, seq: Sequence) -> None:
        """Recompute-style preemption: drop the KV, requeue at the head of
        waiting with the generated tokens folded into the context."""
        self.cache.free(seq.seq_id)
        seq.state = WAITING
        seq.cached_len = 0
        seq.preemptions += 1
        self.preemptions_total += 1
        self.waiting.insert(0, seq)

    def requeue(self, seq: Sequence) -> None:
        """Return a just-admitted sequence to the head of waiting after its
        prefill was interrupted (KVCacheExhausted mid-admission). The
        engine has already freed the partial block hold — requeueing with
        it still allocated would leak pinned shared blocks."""
        if seq.seq_id in self.cache.block_tables:
            raise AssertionError(
                f"requeue({seq.seq_id!r}) with blocks still allocated")
        if seq in self.running:
            self.running.remove(seq)
        seq.state = WAITING
        seq.cached_len = 0
        self.waiting.insert(0, seq)

    def commit(self, tokens: Dict[str, Union[int, List[int]]]
               ) -> List[Sequence]:
        """Apply one step's sampled tokens (``seq_id -> token`` or, from a
        speculative-decode step, ``seq_id -> [tokens...]``) and the
        termination rules; returns the sequences that finished this step
        (their cache blocks already freed). A terminal token (EOS /
        max_tokens / cancel) stops the list early — accepted-but-post-EOS
        speculation is discarded, keeping the stream byte-equal to
        non-speculative decoding."""
        finished: List[Sequence] = []
        for seq_id, toks in tokens.items():
            seq = self._by_id.get(seq_id)
            if seq is None or seq.state != RUNNING:
                continue
            reason = None
            for tok in ([toks] if isinstance(toks, int) else toks):
                seq.tokens.append(int(tok))
                if seq.cancelled:
                    reason = FINISH_CANCELLED
                elif seq.eos_id is not None and int(tok) == seq.eos_id:
                    reason = FINISH_EOS
                elif len(seq.tokens) >= seq.max_tokens:
                    reason = FINISH_LENGTH
                if reason is not None:
                    break
            if reason is not None:
                self.running.remove(seq)
                self.cache.free(seq.seq_id)
                self._finish(seq, reason)
                finished.append(seq)
        return finished

    def _finish(self, seq: Sequence, reason: str) -> None:
        seq.state = FINISHED
        seq.finish_reason = reason
        self.finished_total += 1
        self._by_id.pop(seq.seq_id, None)

    def has_work(self) -> bool:
        return bool(self.running or self.waiting)
