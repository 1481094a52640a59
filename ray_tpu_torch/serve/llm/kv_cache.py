"""Paged KV cache: fixed-size blocks + per-sequence block tables +
copy-on-write prefix sharing, with the pools on the device.

The port of ``ray_tpu/serve/llm/kv_cache.py``. The bookkeeping is the JAX
package's, copied as it is: a sequence's KV lives in fixed-size blocks
handed out from one shared pool, so admitting a request costs exactly
``ceil(prompt_len / block_size)`` blocks; every block carries a reference
count; full, immutable prompt blocks are indexed by a chained content hash
(``hash(parent_hash, block_tokens)``, so two prompts share a block only
when everything before it matches too); ``allocate_cached`` maps the
longest cached prefix read-only into a new sequence's block table; writes
into a shared (or still-indexed) block go through copy-on-write; and
``free``/``truncate`` return a block to the pool only when its last
reference drops. Blocks whose refcount reaches zero while indexed park in
an LRU "cached-free" pool: still matchable, first in line for eviction.

What changed is the storage: the pools ``k``/``v`` are torch tensors of
``[n_layers, num_blocks, block_size, n_kv_heads, head_dim]`` on the cache's
device, and the writes and gathers index them with index tensors on that
device, so a decode step never copies the pool through the host (only the
small block-table indices travel). The bookkeeping (free list, tables,
refcounts, hash index) stays on the host.

Thread-unsafe by design: the engine serializes all cache access behind its
step loop.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device


class KVCacheExhausted(RuntimeError):
    """Raised only by callers that choose to treat a failed allocation as
    fatal; the scheduler uses the boolean returns instead (preempting is
    its job, not the allocator's)."""


class PagedKVCache:
    """Block allocator + per-sequence block tables + the backing pools.

    A sequence's logical KV layout: token position ``t`` lives at
    ``block_table[t // block_size]``, offset ``t % block_size``.
    """

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.float32,
        enable_prefix_cache: bool = False,
        device=None,
    ):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.device = resolve_device(device)
        shape = (self.n_layers, self.num_blocks, self.block_size,
                 self.n_kv_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        # LIFO free list: recently freed blocks are cache-warm.
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.block_tables: Dict[str, List[int]] = {}
        self.seq_lens: Dict[str, int] = {}
        # --- prefix-sharing state -------------------------------------
        # per-block reference count (0 = free or cached-free)
        self.ref_counts = np.zeros(self.num_blocks, dtype=np.int32)
        # chained content hash -> block id, and the inverse for eviction
        self._hash_to_block: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        # refcount-0 blocks still in the index, oldest-first (LRU evict)
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # counters (the engine's stats read these)
        self.prefix_query_tokens = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.prefix_evictions = 0

    # ------------------------------------------------------------ accounting

    @property
    def num_free_blocks(self) -> int:
        """Allocatable blocks: truly free + evictable cached-free."""
        return len(self._free) + len(self._cached_free)

    @property
    def num_used_blocks(self) -> int:
        return self.num_blocks - self.num_free_blocks

    @property
    def num_cached_blocks(self) -> int:
        """Indexed blocks kept warm for future prefix hits (refcount 0)."""
        return len(self._cached_free)

    def utilization(self) -> float:
        """Fraction of the pool currently allocated. Cached-free blocks
        count as free: they are reclaimed on demand."""
        return self.num_used_blocks / self.num_blocks

    def hit_rate(self) -> float:
        """Cumulative fraction of looked-up prompt tokens served from the
        prefix index."""
        if not self.prefix_query_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_query_tokens

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= self.num_free_blocks

    # ------------------------------------------------------------ allocation

    def _pop_block(self) -> int:
        """Hand out one block, evicting the LRU cached-free block (and its
        index entry) when the true free list is empty. Raises
        KVCacheExhausted on an empty pool — only reachable from a
        copy-on-write (allocate/extend pre-check capacity)."""
        if self._free:
            return self._free.pop()
        if not self._cached_free:
            raise KVCacheExhausted("no free block for copy-on-write")
        block, _ = self._cached_free.popitem(last=False)
        self._unregister(block)
        self.prefix_evictions += 1
        return block

    def _release_block(self, block: int) -> None:
        """Refcount hit zero: park indexed blocks in the cached-free LRU
        (still matchable), return the rest to the free list."""
        if block in self._block_hash:
            self._cached_free[block] = None
        else:
            self._free.append(block)

    def _incref(self, block: int) -> None:
        if self.ref_counts[block] == 0:
            # resurrect a cached-free block: it is allocated again
            self._cached_free.pop(block, None)
        self.ref_counts[block] += 1

    def _decref(self, block: int) -> None:
        self.ref_counts[block] -= 1
        if self.ref_counts[block] == 0:
            self._release_block(block)

    def allocate(self, seq_id: str, n_tokens: int) -> bool:
        """Reserve blocks for a new sequence of ``n_tokens`` (its prompt).
        False (and no state change) when the pool cannot cover it."""
        if seq_id in self.block_tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        need = self.blocks_needed(max(1, n_tokens))
        if need > self.num_free_blocks:
            return False
        table = [self._pop_block() for _ in range(need)]
        for b in table:
            self._incref(b)
        self.block_tables[seq_id] = table
        self.seq_lens[seq_id] = 0
        return True

    @staticmethod
    def _chain_hash(parent: int, chunk: Tuple[int, ...]) -> int:
        return hash((parent, chunk))

    def match_prefix(self, tokens: List[int]) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens``: returns (block ids, matched
        token count). The match is capped at ``len(tokens) - 1`` so the
        caller always has at least one tail token to prefill (the engine
        needs the last position's logits)."""
        if not self.enable_prefix_cache or len(tokens) < 2:
            return [], 0
        bs = self.block_size
        blocks: List[int] = []
        h = 0
        for i in range(len(tokens) // bs):
            h = self._chain_hash(h, tuple(tokens[i * bs:(i + 1) * bs]))
            b = self._hash_to_block.get(h)
            if b is None:
                break
            blocks.append(b)
        if not blocks:
            return [], 0
        # the cap may land mid-block: that last block maps shared anyway
        # and the tail prefill's write into it goes through copy-on-write
        return blocks, min(len(blocks) * bs, len(tokens) - 1)

    def allocate_cached(self, seq_id: str, tokens: List[int],
                        extra: int = 1) -> Optional[int]:
        """Prefix-aware allocation for a new sequence whose context is
        ``tokens`` (+``extra`` decode slots): map the longest indexed prefix
        read-only into the block table (refcount bump, zero copies) and
        charge fresh blocks only for the tail. Returns the number of prefix
        tokens served from cache (0 = cold), or None — with every partial
        hold rolled back — when the pool cannot cover the remainder.

        A non-block-aligned match (the last-token cap) maps the final
        shared block too; the tail prefill's write into it triggers
        copy-on-write, so the indexed copy stays immutable.
        """
        if seq_id in self.block_tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        matched_blocks, matched_tokens = self.match_prefix(tokens)
        self.prefix_query_tokens += len(tokens)
        need = self.blocks_needed(max(1, len(tokens) + extra))
        fresh_needed = need - len(matched_blocks)
        # incref the hit first: a matched block may sit in cached-free, and
        # counting it free while also mapping it would double-book it
        for b in matched_blocks:
            self._incref(b)
        if fresh_needed > self.num_free_blocks:
            for b in matched_blocks:      # roll the partial hold back
                self._decref(b)
            return None
        table = matched_blocks + [self._pop_block()
                                  for _ in range(fresh_needed)]
        for b in table[len(matched_blocks):]:
            self._incref(b)
        self.block_tables[seq_id] = table
        self.seq_lens[seq_id] = matched_tokens
        self.prefix_hit_tokens += matched_tokens
        return matched_tokens

    def register_prefix(self, seq_id: str, tokens: List[int]) -> int:
        """Index the sequence's full, written blocks covering ``tokens``
        under their chained hashes (idempotent; blocks already indexed —
        its own shared prefix, or a twin admitted the same step — are
        skipped). Called by the engine once a (re)prefill lands; returns
        how many blocks were newly indexed."""
        if not self.enable_prefix_cache:
            return 0
        table = self.block_tables.get(seq_id)
        if table is None:
            return 0
        bs = self.block_size
        n_full = min(len(tokens), self.seq_lens[seq_id]) // bs
        added = 0
        h = 0
        for i in range(n_full):
            h = self._chain_hash(h, tuple(tokens[i * bs:(i + 1) * bs]))
            b = table[i]
            if b in self._block_hash or h in self._hash_to_block:
                continue
            self._hash_to_block[h] = b
            self._block_hash[b] = h
            added += 1
        return added

    def _unregister(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None and self._hash_to_block.get(h) == block:
            self._hash_to_block.pop(h, None)

    def extend(self, seq_id: str, n_tokens: int = 1) -> bool:
        """Ensure capacity for ``n_tokens`` more positions, allocating new
        blocks at the table's tail when the last block is full. False when
        the pool is exhausted (caller preempts); partial growth is rolled
        back so a failed extend is side-effect free."""
        table = self.block_tables[seq_id]
        have = len(table) * self.block_size - self.seq_lens[seq_id]
        need_blocks = self.blocks_needed(max(0, n_tokens - have)) \
            if n_tokens > have else 0
        if need_blocks > self.num_free_blocks:
            return False
        for _ in range(need_blocks):
            b = self._pop_block()
            self._incref(b)
            table.append(b)
        return True

    def free(self, seq_id: str) -> int:
        """Drop the sequence's references; returns how many blocks its
        table held. A block only returns to the pool when its LAST
        reference drops — shared prefix blocks survive their originator
        (indexed ones stay matchable in the cached-free LRU)."""
        table = self.block_tables.pop(seq_id, None)
        self.seq_lens.pop(seq_id, None)
        if not table:
            return 0
        for b in reversed(table):
            self._decref(b)
        return len(table)

    def truncate(self, seq_id: str, n_tokens: int) -> None:
        """Shrink the sequence to ``n_tokens`` positions, dropping
        references to the now-unused tail blocks. A truncated-into block
        that is still shared/indexed is copy-on-write protected at the next
        write, so other readers never see the rollback."""
        cur = self.seq_lens[seq_id]
        n_tokens = int(n_tokens)
        if n_tokens > cur:
            raise ValueError(
                f"truncate({seq_id!r}) to {n_tokens} > current {cur}")
        table = self.block_tables[seq_id]
        keep = max(1, self.blocks_needed(max(1, n_tokens)))
        for b in reversed(table[keep:]):
            self._decref(b)
        del table[keep:]
        self.seq_lens[seq_id] = n_tokens

    # ---------------------------------------------------------------- writes

    def _slots(self, seq_id: str, start: int, n: int):
        """(block_ids, offsets) index tensors on the device for logical
        positions [start, start+n)."""
        table = self.block_tables[seq_id]
        pos = np.arange(start, start + n)
        blocks = np.asarray(table, dtype=np.int64)[pos // self.block_size]
        return (torch.from_numpy(blocks).to(self.device),
                torch.from_numpy(pos % self.block_size).to(self.device))

    def _ensure_writable(self, seq_id: str, block_idx: int) -> None:
        """Copy-on-write guard: a block about to be written must be
        exclusively owned AND out of the prefix index (an indexed block's
        content is pinned by its hash). Shared -> copy into a fresh block;
        exclusively-owned-but-indexed -> just unindex it."""
        table = self.block_tables[seq_id]
        b = table[block_idx]
        if self.ref_counts[b] > 1:
            nb = self._pop_block()          # may evict LRU cached-free
            self.k[:, nb] = self.k[:, b]
            self.v[:, nb] = self.v[:, b]
            self._incref(nb)
            table[block_idx] = nb
            self._decref(b)
            self.cow_copies += 1
        elif b in self._block_hash:
            self._unregister(b)

    def _as_pool(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.k.dtype, device=self.device)

    def write_prefill(self, seq_id: str, k, v):
        """Copy-on-admit prefill write: ``k``/``v`` are
        ``[n_layers, T, n_kv_heads, head_dim]`` for the un-cached tail of
        the context (the whole prompt when cold); the copy into the paged
        pools happens exactly once, here. Raises KVCacheExhausted when the
        pool cannot hold the tail — the engine frees the partial hold and
        requeues the sequence."""
        T = k.shape[1]
        start = self.seq_lens[seq_id]
        if not self.extend(seq_id, T):
            raise KVCacheExhausted(f"prefill of {T} tokens does not fit")
        if self.enable_prefix_cache and T:
            for bi in range(start // self.block_size,
                            (start + T - 1) // self.block_size + 1):
                self._ensure_writable(seq_id, bi)
        blocks, offs = self._slots(seq_id, start, T)
        self.k[:, blocks, offs] = self._as_pool(k)
        self.v[:, blocks, offs] = self._as_pool(v)
        self.seq_lens[seq_id] = start + T

    def append(self, seq_id: str, k, v):
        """Write one decoded token's ``[n_layers, n_kv_heads, head_dim]``
        K/V at the sequence's current length. The slot must already exist
        (``extend`` ran in the schedule phase)."""
        pos = self.seq_lens[seq_id]
        if self.enable_prefix_cache:
            self._ensure_writable(seq_id, pos // self.block_size)
        table = self.block_tables[seq_id]
        block = table[pos // self.block_size]
        off = pos % self.block_size
        self.k[:, block, off] = self._as_pool(k)
        self.v[:, block, off] = self._as_pool(v)
        self.seq_lens[seq_id] = pos + 1

    # ---------------------------------------------------------------- reads

    def gather(self, seq_id: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense ``[n_layers, T, heads, dim]`` copies of one sequence's KV,
        gathered on the device."""
        T = self.seq_lens[seq_id]
        blocks, offs = self._slots(seq_id, 0, T)
        return self.k[:, blocks, offs], self.v[:, blocks, offs]

    def gather_batch(
        self, seq_ids: List[str], pad_to: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Padded batch gather for the fused decode step: returns
        ``(k [B, L, Tmax, H, D], v same, lens [B])``, all on the device;
        positions past a sequence's length are undefined (the adapter masks
        by ``lens``)."""
        lens = np.asarray([self.seq_lens[s] for s in seq_ids], dtype=np.int64)
        tmax = max(int(lens.max(initial=0)), 1)
        if pad_to is not None:
            tmax = max(tmax, pad_to)
        B = len(seq_ids)
        # one fancy-index per pool over [B, Tmax] (block, offset) grids; the
        # block grid is built on the host (padding positions point at block 0)
        pos = np.arange(tmax)
        blk = np.zeros((B, tmax), dtype=np.int64)
        for i, s in enumerate(seq_ids):
            t = int(lens[i])
            if t:
                blk[i, :t] = np.asarray(self.block_tables[s],
                                        dtype=np.int64)[pos[:t]
                                                        // self.block_size]
        blk_t = torch.from_numpy(blk).to(self.device)
        off_t = (torch.arange(tmax, device=self.device)
                 % self.block_size).expand(B, tmax)
        # [L, B, T, H, D] -> [B, L, T, H, D]
        k = self.k[:, blk_t, off_t].movedim(0, 1)
        v = self.v[:, blk_t, off_t].movedim(0, 1)
        return k, v, torch.from_numpy(lens).to(self.device)

    # ------------------------------------------------------------ invariants

    def check_integrity(self) -> List[str]:
        """Cross-check every block against the refcount/index/free-list
        bookkeeping. Returns human-readable violations; empty = consistent.
        Tests assert emptiness after every failure-injection path so an
        interrupted admission or rollback can never strand a pinned
        block."""
        problems: List[str] = []
        mapped: Dict[int, int] = {}
        for sid, table in self.block_tables.items():
            for b in table:
                mapped[b] = mapped.get(b, 0) + 1
        free_set = set(self._free)
        for b in range(self.num_blocks):
            refs = int(self.ref_counts[b])
            if refs != mapped.get(b, 0):
                problems.append(
                    f"block {b}: refcount {refs} != {mapped.get(b, 0)} "
                    f"table references")
            in_free = b in free_set
            in_cached = b in self._cached_free
            if refs > 0 and (in_free or in_cached):
                problems.append(f"block {b}: referenced but on a free list")
            if refs == 0 and not (in_free or in_cached):
                problems.append(f"block {b}: leaked (refcount 0, not free)")
            if in_free and in_cached:
                problems.append(f"block {b}: on both free lists")
        for h, b in self._hash_to_block.items():
            if self._block_hash.get(b) != h:
                problems.append(f"index: hash {h} -> block {b} not inverse")
        for b in self._block_hash:
            if b in free_set:
                problems.append(f"block {b}: indexed but on the free list")
        return problems

    def assert_no_leaks(self) -> None:
        problems = self.check_integrity()
        if problems:
            raise AssertionError(
                "KV cache integrity violations:\n  " + "\n  ".join(problems))
