"""Distributed sample-sort exchange for sort/groupby.

Reference: data/_internal/planner/exchange/sort_task_spec.py — the three
stage shuffle: (1) sample each block's keys, (2) range-partition every
block into P outputs with boundaries cut from the pooled sample, (3) per
partition, a sort-merge task combines its parts. The driver touches ONLY
the key samples and the boundary values — blocks move block-store ref to
ref between tasks, so datasets larger than driver RAM sort fine. Groupby
rides the same exchange: range partitioning by the group key puts every
row of a key into exactly one partition, so per-partition aggregation is
exact with no cross-partition combine step.

A copy of ``ray_tpu/data/_exchange.py``. The seeded shuffle draws exactly
as the reference does (``default_rng(seed)`` for the base, ``base + i``
per scatter task, ``base + 1_000_003 + p`` per merge), so one seed gives
one row order in both packages.
"""

from __future__ import annotations

import operator
from typing import Any, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_num_rows, concat_blocks

_SAMPLES_PER_BLOCK = 32
MAX_PARTITIONS = 32


def _as_1d_key_array(vals: list) -> np.ndarray:
    """1-D key array; composite keys (tuples, mixed types) become a 1-D
    object array so argsort/searchsorted compare element-wise with Python
    semantics instead of building an accidental 2-D array."""
    if not vals:
        return np.asarray([])
    try:
        arr = np.asarray(vals)
        if arr.ndim == 1:
            return arr
    except Exception:
        pass
    arr = np.empty(len(vals), dtype=object)
    arr[:] = vals
    return arr


def _key_array(block: Block, key) -> np.ndarray:
    """Extract the sort/group key column of a block as a 1-D array."""
    if isinstance(block, dict):
        if callable(key):
            from ray_tpu_torch.data.block import rows_of

            return _as_1d_key_array([key(r) for r in rows_of(block)])
        if key is None:
            key = next(iter(block))
        return np.asarray(block[key])
    if not block:
        return np.asarray([])
    if callable(key):
        return _as_1d_key_array([key(r) for r in block])
    if key is None and isinstance(block[0], dict):
        key = next(iter(block[0]))
    if key is None:
        return _as_1d_key_array(list(block))
    getter = operator.itemgetter(key)
    return _as_1d_key_array([getter(r) for r in block])


def _take(block: Block, idx: np.ndarray) -> Block:
    if isinstance(block, dict):
        return {k: np.asarray(v)[idx] for k, v in block.items()}
    return [block[i] for i in idx]


@ray_tpu_torch.remote
def _sample_block(block, key, k: int):
    kv = _key_array(block, key)
    if len(kv) <= k:
        return kv
    idx = np.random.RandomState(0xDA7A).choice(len(kv), size=k, replace=False)
    return kv[idx]


def _scatter(block, part_ids: np.ndarray, P: int):
    """Split a block into P parts by a per-row partition-id array; the
    return shape matches num_returns=P task semantics (list for P>1)."""
    if len(part_ids) == 0:
        empty = {k: np.asarray(v)[:0] for k, v in block.items()} \
            if isinstance(block, dict) else []
        return [empty] * P if P > 1 else empty
    out = [_take(block, np.nonzero(part_ids == p)[0]) for p in range(P)]
    return out if P > 1 else out[0]


@ray_tpu_torch.remote
def _range_partition(block, key, boundaries):
    """Split a block into len(boundaries)+1 parts by key range."""
    kv = _key_array(block, key)
    P = len(boundaries) + 1
    if len(kv) == 0:
        return _scatter(block, np.asarray([]), P)
    part = np.searchsorted(_as_1d_key_array(list(boundaries)), kv,
                           side="right")
    return _scatter(block, part, P)


@ray_tpu_torch.remote
def _sort_merge(key, descending, *parts):
    """Concat one partition's parts and sort within it."""
    whole = concat_blocks(list(parts))
    n = block_num_rows(whole)
    if n == 0:
        return whole
    kv = _key_array(whole, key)
    order = np.argsort(kv, kind="stable")
    if descending:
        order = order[::-1]
    return _take(whole, order)


_AGGS = {
    "count": lambda v: len(v),
    "sum": lambda v: np.sum(v).item(),
    "mean": lambda v: np.mean(v).item(),
    "min": lambda v: np.min(v).item(),
    "max": lambda v: np.max(v).item(),
    "std": lambda v: np.std(v, ddof=1).item() if len(v) > 1 else 0.0,
}


@ray_tpu_torch.remote
def _group_agg(key, column, how, *parts):
    """Aggregate one partition's groups (exact: range partitioning puts a
    key's every row in this partition)."""
    whole = concat_blocks(list(parts))
    name = f"{how}({column})" if column else f"{how}()"
    if block_num_rows(whole) == 0:
        return {key: np.asarray([]), name: np.asarray([])}
    keys = np.asarray(whole[key])
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    bounds = list(starts) + [len(sorted_keys)]
    if how == "count":
        out = [bounds[i + 1] - bounds[i] for i in range(len(uniq))]
    else:
        vals = np.asarray(whole[column])[order]
        fn = _AGGS[how]
        out = [fn(vals[bounds[i]:bounds[i + 1]]) for i in range(len(uniq))]
    return {key: uniq, name: np.asarray(out)}


@ray_tpu_torch.remote
def _group_map(key, fn, *parts):
    """map_groups over one partition."""
    whole = concat_blocks(list(parts))
    if block_num_rows(whole) == 0:
        return []
    keys = np.asarray(whole[key])
    order = np.argsort(keys, kind="stable")
    sorted_block = {k: np.asarray(v)[order] for k, v in whole.items()}
    sorted_keys = keys[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    bounds = list(starts) + [len(sorted_keys)]
    outs = []
    for i in range(len(uniq)):
        sub = {k: v[bounds[i]:bounds[i + 1]] for k, v in sorted_block.items()}
        outs.append(fn(sub))
    return concat_blocks(outs)


def _boundaries(samples: List[np.ndarray], num_parts: int):
    pooled = np.concatenate([s for s in samples if len(s)]) \
        if any(len(s) for s in samples) else np.asarray([])
    if len(pooled) == 0 or num_parts <= 1:
        return []
    pooled = np.sort(pooled)
    cuts = [
        pooled[(len(pooled) * i) // num_parts] for i in range(1, num_parts)
    ]
    # dedupe (heavily skewed samples can repeat a cut — empty partitions
    # are fine, duplicate boundaries are not)
    out = []
    for c in cuts:
        if not out or c > out[-1]:
            out.append(c)
    return out


def exchange_partitions(
    refs: List[Any], key, num_parts: Optional[int] = None
) -> Tuple[List[List[Any]], int]:
    """Common front half: sample keys, cut boundaries, range-partition
    every block. Returns (parts_by_partition, P): parts_by_partition[p]
    is the list of per-block refs for partition p."""
    if not refs:
        return [], 0
    if num_parts is None:
        num_parts = min(len(refs), MAX_PARTITIONS)
    samples = ray_tpu_torch.get(
        [_sample_block.remote(r, key, _SAMPLES_PER_BLOCK) for r in refs]
    )
    bounds = _boundaries(samples, num_parts)
    P = len(bounds) + 1
    part_refs = [
        _range_partition.options(num_returns=P).remote(r, key, bounds)
        for r in refs
    ]
    if P == 1:
        by_part = [[pr for pr in part_refs]]
    else:
        by_part = [
            [block_parts[p] for block_parts in part_refs] for p in range(P)
        ]
    return by_part, P


@ray_tpu_torch.remote
def _random_partition(block, P: int, seed: int):
    """Scatter a block's rows uniformly into P partitions."""
    n = block_num_rows(block)
    if n == 0:
        return _scatter(block, np.asarray([]), P)
    part = np.random.default_rng(seed).integers(0, P, size=n)
    return _scatter(block, part, P)


@ray_tpu_torch.remote
def _shuffle_merge(seed: int, *parts):
    """Concat one partition's parts and permute within it."""
    whole = concat_blocks(list(parts))
    n = block_num_rows(whole)
    if n == 0:
        return whole
    perm = np.random.default_rng(seed).permutation(n)
    return _take(whole, perm)


def distributed_random_shuffle(
    refs: List[Any], seed: Optional[int] = None,
    num_parts: Optional[int] = None,
) -> List[Any]:
    """Two-stage distributed shuffle (reference:
    data/_internal/planner/exchange/shuffle_task_spec.py): every block
    scatters its rows uniformly across P partitions, then each partition
    concat+permutes its parts. The driver holds ONLY refs — blocks move
    store-to-store between tasks, so datasets larger than driver memory
    shuffle fine (the old implementation materialized the whole dataset
    in the driver)."""
    if not refs:
        return []
    # default: preserve the input block count (capped — P scatter outputs
    # exist PER BLOCK, so P*blocks part-objects; beyond the cap pass
    # num_parts explicitly and budget worker memory at dataset/P per merge)
    P = num_parts or min(len(refs), 128)
    base = int(np.random.default_rng(seed).integers(0, 2**31))
    if P == 1:
        # single partition: the scatter stage would only copy blocks
        return [_shuffle_merge.remote(base, *refs)]
    part_refs = [
        _random_partition.options(num_returns=P).remote(r, P, base + i)
        for i, r in enumerate(refs)
    ]
    by_part = [
        [block_parts[p] for block_parts in part_refs] for p in range(P)
    ]
    return [
        _shuffle_merge.remote(base + 1_000_003 + p, *parts)
        for p, parts in enumerate(by_part)
    ]


def distributed_sort(refs: List[Any], key, descending: bool) -> List[Any]:
    """Sample-sort: returns refs of globally-sorted blocks (partition p
    holds keys <= partition p+1's; each block internally sorted)."""
    by_part, P = exchange_partitions(refs, key)
    if P == 0:
        return []
    merged = [
        _sort_merge.remote(key, descending, *parts) for parts in by_part
    ]
    return list(reversed(merged)) if descending else merged


def distributed_group_agg(
    refs: List[Any], key: str, column: Optional[str], how: str
) -> List[Any]:
    by_part, P = exchange_partitions(refs, key)
    if P == 0:
        return []
    return [
        _group_agg.remote(key, column, how, *parts) for parts in by_part
    ]


def distributed_group_map(refs: List[Any], key: str, fn) -> List[Any]:
    by_part, P = exchange_partitions(refs, key)
    if P == 0:
        return []
    return [_group_map.remote(key, fn, *parts) for parts in by_part]
