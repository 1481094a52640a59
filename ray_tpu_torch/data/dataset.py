"""Dataset: lazy logical plan over object-store blocks
(reference: python/ray/data/dataset.py:139 — the streaming subset).

A Dataset is (source block refs, chain of map operators). Transformations
append operators; consumption (iter_batches/take/count/materialize) runs the
streaming executor. Blocks live in plasma; workers read them zero-copy.

The port of ``ray_tpu/data/dataset.py``: the same plan, transforms,
exchange and consumers, over this package's runtime. The JAX package's
``iter_jax_batches`` becomes :meth:`Dataset.iter_torch_batches` and its
iterator, :class:`TorchBatchIterator`, which places batches on the CUDA
card; torch is imported there and nowhere else in this package.
"""

from __future__ import annotations

import collections
import logging
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data._streaming import (
    DEFAULT_MAX_IN_FLIGHT,
    MapOperator,
    execute_plan,
    iter_batches_from_stream,
)
from ray_tpu_torch.data.block import (
    Block,
    block_num_rows,
    block_schema,
    concat_blocks,
    rows_of,
    slice_block,
)

logger = logging.getLogger("ray_tpu_torch.data")


@ray_tpu_torch.remote(num_cpus=0.05)
def _block_num_rows_task(block):
    return block_num_rows(block)


@ray_tpu_torch.remote(num_cpus=0.05)
def _slice_block_task(block, start: int, end: int):
    return slice_block(block, start, end)


class Dataset:
    def __init__(self, source_refs: List[Any],
                 operators: Optional[List[MapOperator]] = None,
                 extra_legs: Optional[List["Dataset"]] = None):
        self._source_refs = list(source_refs)
        self._operators = list(operators or [])
        # union() legs: independent (refs, ops) plans appended lazily
        self._extra_legs: List["Dataset"] = list(extra_legs or [])

    # ---------------------------------------------------------- transforms

    def _with_op(self, op) -> "Dataset":
        return Dataset(
            self._source_refs, self._operators + [op],
            [leg._with_op(op) for leg in self._extra_legs],
        )

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        concurrency: Optional[int] = None,
        fn_constructor_args: tuple = (),
        num_cpus: float = 1.0,
        max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
    ) -> "Dataset":
        """Apply fn to whole blocks (reference: Dataset.map_batches). A class
        fn runs on an actor pool of `concurrency` actors; a plain function
        runs as tasks. batch_size=None maps entire blocks (recommended — the
        executor already sizes blocks)."""
        is_class = isinstance(fn, type)
        op = MapOperator(
            fn,
            is_batch_fn=True,
            compute_actors=(concurrency or 2) if is_class else 0,
            fn_constructor_args=fn_constructor_args,
            num_cpus=num_cpus,
            max_in_flight=(concurrency or max_in_flight)
            if not is_class else max_in_flight,
            name=getattr(fn, "__name__", "MapBatches"),
        )
        ds = self
        if batch_size is not None:
            from ray_tpu_torch.data._streaming import RechunkOperator

            ds = ds._with_op(RechunkOperator(batch_size))
        return ds._with_op(op)

    def map(self, fn: Callable, *, num_cpus: float = 1.0,
            max_in_flight: int = DEFAULT_MAX_IN_FLIGHT) -> "Dataset":
        return self._with_op(MapOperator(
            fn, is_batch_fn=False, num_cpus=num_cpus,
            max_in_flight=max_in_flight, name="Map",
        ))

    def flat_map(self, fn: Callable) -> "Dataset":
        def batch_fn(block):
            out = []
            for row in rows_of(block):
                out.extend(fn(row))
            from ray_tpu_torch.data._streaming import _rows_to_block

            return _rows_to_block(out)

        return self._with_op(
            MapOperator(batch_fn, is_batch_fn=True, name="FlatMap")
        )

    def filter(self, fn: Callable) -> "Dataset":
        def batch_fn(block):
            if isinstance(block, dict):
                keep = [i for i, row in enumerate(rows_of(block)) if fn(row)]
                return {k: np.asarray(v)[keep] for k, v in block.items()}
            return [r for r in block if fn(r)]

        return self._with_op(
            MapOperator(batch_fn, is_batch_fn=True, name="Filter")
        )

    # --------------------------------------------------------- re-chunking

    def repartition(self, num_blocks: int) -> "Dataset":
        """Materializing re-chunk into num_blocks equal-ish blocks."""
        blocks = [ray_tpu_torch.get(r) for r in self._iter_block_refs()]
        whole = concat_blocks(blocks)
        n = block_num_rows(whole)
        per = max(1, (n + num_blocks - 1) // num_blocks)
        refs = [
            ray_tpu_torch.put(slice_block(whole, i * per, min(n, (i + 1) * per)))
            for i in range(min(num_blocks, (n + per - 1) // per))
        ]
        return Dataset(refs)

    def repartition_by_rows(self, rows_per_block: int) -> "Dataset":
        return self.repartition(
            max(1, (self.count() + rows_per_block - 1) // rows_per_block)
        )

    def random_shuffle(self, seed: Optional[int] = None, *,
                       num_parts: Optional[int] = None) -> "Dataset":
        """Distributed two-stage shuffle (reference: Dataset.random_shuffle
        via the shuffle exchange): scatter tasks split every block's rows
        uniformly across partitions, merge tasks permute within each — the
        driver only routes refs, never block data. `num_parts` sets the
        output block count (default: input block count, capped) — raise it
        for very large datasets so each merge task's partition stays
        worker-memory-sized."""
        from ray_tpu_torch.data._exchange import distributed_random_shuffle

        refs = list(self._iter_block_refs())
        return Dataset(distributed_random_shuffle(refs, seed,
                                                  num_parts=num_parts))

    def split(self, n: int, equal: bool = True) -> List["Dataset"]:
        """Ref-level row-exact split (reference: Dataset.split, which
        plans over block metadata and never materializes on the driver).
        The driver sees only per-block ROW COUNTS; whole blocks move into
        shards by reference, and only the blocks straddling a shard
        boundary are re-sliced — by tasks, where the data lives.
        equal=True gives identical shard sizes, dropping up to n-1
        trailing rows (like the reference); equal=False balances
        floor/ceil sizes with no rows dropped."""
        refs = list(self._iter_block_refs())
        counts = ray_tpu_torch.get([_block_num_rows_task.remote(r) for r in refs])
        total = sum(counts)
        if equal:
            per = total // n
            if per == 0:
                raise ValueError(
                    f"cannot split {total} rows into {n} equal non-empty "
                    "shards"
                )
            sizes = [per] * n
        else:
            base, rem = divmod(total, n)
            sizes = [base + (1 if i < rem else 0) for i in range(n)]
        shards: List[Dataset] = []
        bi, offset = 0, 0  # cursor: current block, rows already consumed
        for size in sizes:
            parts, need = [], size
            while need > 0:
                avail = counts[bi] - offset
                take = min(avail, need)
                if take == counts[bi] and offset == 0:
                    parts.append(refs[bi])  # whole block: zero-copy move
                else:
                    parts.append(_slice_block_task.remote(
                        refs[bi], offset, offset + take))
                offset += take
                need -= take
                if offset == counts[bi]:
                    bi += 1
                    offset = 0
            shards.append(Dataset(parts))
        return shards

    def split_blocks(self, n: int) -> List["Dataset"]:
        """Lazy block-granular split: shard i keeps source blocks i::n and
        the SAME pending operator chain, so per-shard streaming (and
        ingest/compute overlap) is preserved. Row counts are equal only up
        to block granularity — the Train ingest path uses this (reference:
        streaming_split keeps sharding lazy the same way)."""
        leg_shards = [leg.split_blocks(n) for leg in self._extra_legs]
        shards: List[Dataset] = []
        for i in range(n):
            shard = Dataset(self._source_refs[i::n], self._operators)
            for per_leg in leg_shards:
                shard = shard.union(per_leg[i])
            shards.append(shard)
        return shards

    def union(self, other: "Dataset") -> "Dataset":
        """Lazy concatenation: both plans stay pending until consumption."""
        return Dataset(
            self._source_refs, self._operators,
            self._extra_legs + [other],
        )

    def limit(self, n: int) -> "Dataset":
        """Materializing head-n (reference: Dataset.limit)."""
        rows = self.take(n)
        from ray_tpu_torch.data._streaming import _rows_to_block

        return Dataset([ray_tpu_torch.put(_rows_to_block(rows))] if rows else [])

    def sort(self, key: Union[str, Callable, None] = None,
             descending: bool = False) -> "Dataset":
        """Distributed sample-sort (reference: Dataset.sort via
        data/_internal/planner/exchange/sort_task_spec.py): sample keys →
        range-partition map tasks → per-partition sort-merge tasks. The
        driver handles only key samples and boundary values, so datasets
        larger than driver memory sort fine."""
        from ray_tpu_torch.data._exchange import distributed_sort

        refs = list(self._iter_block_refs())
        return Dataset(distributed_sort(refs, key, descending))

    def unique(self, column: str) -> List[Any]:
        vals = set()
        for block in self.iter_batches(batch_size=None):
            if isinstance(block, dict):
                vals.update(np.asarray(block[column]).tolist())
            else:
                vals.update(r[column] for r in block)
        return sorted(vals)

    def zip(self, other: "Dataset") -> "Dataset":
        """Materializing columnar zip of equal-length datasets
        (reference: Dataset.zip)."""
        a = concat_blocks([ray_tpu_torch.get(r) for r in self._iter_block_refs()])
        b = concat_blocks([ray_tpu_torch.get(r) for r in other._iter_block_refs()])
        if block_num_rows(a) != block_num_rows(b):
            raise ValueError("zip requires equal row counts")
        if block_num_rows(a) == 0:
            return Dataset([])
        if not (isinstance(a, dict) and isinstance(b, dict)):
            raise TypeError("zip requires column blocks")
        merged = dict(a)
        for k, v in b.items():
            merged[k if k not in merged else f"{k}_1"] = v
        return Dataset([ray_tpu_torch.put(merged)])

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def to_arrow(self):
        """Materialize as a list of pyarrow Tables, one per block
        (reference: Dataset.to_arrow_refs — the Arrow bridge out)."""
        import pyarrow as pa

        out = []
        for ref in self._iter_block_refs():
            block = ray_tpu_torch.get(ref)
            if isinstance(block, dict):
                out.append(pa.table({k: np.asarray(v) for k, v in block.items()}))
            else:
                out.append(pa.Table.from_pylist(list(block)))
        return out

    # ---------------------------------------------------- simple aggregates

    def _column(self, column: str) -> np.ndarray:
        parts = [
            np.asarray(b[column])
            for b in self.iter_batches(batch_size=None)
            if block_num_rows(b)
        ]
        return np.concatenate(parts) if parts else np.array([])

    def sum(self, column: str):
        return self._column(column).sum().item()

    def mean(self, column: str):
        return self._column(column).mean().item()

    def min(self, column: str):
        return self._column(column).min().item()

    def max(self, column: str):
        return self._column(column).max().item()

    def std(self, column: str, ddof: int = 1):
        return self._column(column).std(ddof=ddof).item()

    # -------------------------------------------------------------- writes

    def _column_blocks(self):
        for i, ref in enumerate(self._iter_block_refs()):
            block = ray_tpu_torch.get(ref)
            if not isinstance(block, dict):
                from ray_tpu_torch.data._streaming import _rows_to_block

                block = _rows_to_block(list(rows_of(block)))
                if not isinstance(block, dict):
                    block = {"value": np.asarray(block, dtype=object)}
            yield i, block

    def write_parquet(self, path: str) -> List[str]:
        """One file per block under `path`
        (reference: Dataset.write_parquet)."""
        import os

        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        out = []
        for i, block in self._column_blocks():
            fp = os.path.join(path, f"part-{i:05d}.parquet")
            pq.write_table(pa.table(dict(block)), fp)
            out.append(fp)
        return out

    def write_csv(self, path: str) -> List[str]:
        import os

        import pyarrow as pa
        import pyarrow.csv as pcsv

        os.makedirs(path, exist_ok=True)
        out = []
        for i, block in self._column_blocks():
            fp = os.path.join(path, f"part-{i:05d}.csv")
            pcsv.write_csv(pa.table(dict(block)), fp)
            out.append(fp)
        return out

    def write_json(self, path: str) -> List[str]:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        out = []
        for i, ref in enumerate(self._iter_block_refs()):
            fp = os.path.join(path, f"part-{i:05d}.json")
            with open(fp, "w") as f:
                for row in rows_of(ray_tpu_torch.get(ref)):
                    if isinstance(row, dict):
                        row = {
                            k: v.item() if isinstance(v, np.generic) else v
                            for k, v in row.items()
                        }
                    f.write(json.dumps(row) + "\n")
            out.append(fp)
        return out

    def to_pandas(self):
        import pandas as pd

        whole = concat_blocks(
            [ray_tpu_torch.get(r) for r in self._iter_block_refs()]
        )
        if isinstance(whole, dict):
            return pd.DataFrame(dict(whole))
        return pd.DataFrame({"value": list(whole)})

    # ---------------------------------------------------------- consumption

    def _iter_block_refs(self) -> Iterator[Any]:
        import itertools

        return itertools.chain(
            execute_plan(self._source_refs, self._operators),
            *(leg._iter_block_refs() for leg in self._extra_legs),
        )

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     prefetch_blocks: int = 2) -> Iterator[Block]:
        """Streaming iteration: upstream map stages keep working while the
        consumer processes the current batch (ingest/compute overlap)."""
        return iter_batches_from_stream(
            self._iter_block_refs(), batch_size, prefetch_blocks
        )

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_batches(batch_size=None):
            yield from rows_of(block)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device=None, mesh=None,
                           drop_last: bool = False,
                           prefetch_blocks: int = 2) -> "TorchBatchIterator":
        """iter_batches as dicts of torch tensors on a device: the port's
        counterpart of the reference's ``iter_jax_batches`` and, with
        ``device="cpu"``, of its CPU-only ``iter_torch_batches``.

        ``device=None`` is the card: ``train.torch.get_device()`` inside a
        train worker that leased one, else the current CUDA device. It
        raises without CUDA and never gives CPU tensors unless asked for
        ``device="cpu"``. On the card each column goes through pinned host
        memory to a ``non_blocking`` copy on a side stream, one batch
        ahead, so the copy of the next batch is in flight while the
        caller's step runs on this one (the counterpart of
        ``jax.device_put``'s asynchronous transfer). ``dtypes`` maps a
        column to a torch dtype, applied on the host as the reference does.

        ``mesh`` (a ``parallel.mesh`` DeviceMesh) keeps this rank's part of
        each global batch through ``mesh.batch_sharding``, as
        ``TrainStep.shard_batch`` does: rows by the rank's dp x fsdp
        coordinate, and the second dimension of a wider column by its sp
        coordinate. A batch whose rows do not split over the data axes
        raises, or with ``drop_last=True`` is skipped, as in the
        reference."""
        return TorchBatchIterator(
            self.iter_batches(batch_size=batch_size,
                              prefetch_blocks=prefetch_blocks),
            dtypes=dtypes, device=device, mesh=mesh, drop_last=drop_last)

    def streaming_split(self, n: int) -> List["Dataset"]:
        """Reference-named alias of split_blocks: n lazy shards that keep
        streaming through the pending operator chain (reference:
        Dataset.streaming_split — Train ingest path)."""
        return self.split_blocks(n)

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        if not self._operators and not self._extra_legs:
            if not self._source_refs:
                return 0
            return sum(
                block_num_rows(b)
                for b in ray_tpu_torch.get(list(self._source_refs))
            )
        return sum(
            block_num_rows(b) for b in self.iter_batches(batch_size=None)
        )

    def schema(self):
        for r in self._iter_block_refs():
            return block_schema(ray_tpu_torch.get(r))
        return None

    def materialize(self) -> "Dataset":
        """Run the plan now; the result holds only materialized blocks."""
        return Dataset(list(self._iter_block_refs()))

    def num_blocks(self) -> int:
        return len(self._source_refs) + sum(
            leg.num_blocks() for leg in self._extra_legs
        )

    def __repr__(self):
        ops = " -> ".join(op.name for op in self._operators) or "source"
        return (f"Dataset(num_blocks={len(self._source_refs)}, "
                f"plan={ops})")


def _consumer_device(device):
    """The device ``iter_torch_batches`` places batches on: the one asked
    for, else this train worker's leased card, else the current CUDA
    device; never the CPU unless asked."""
    import torch

    from ray_tpu_torch._private.device import resolve_device

    if device is not None:
        return resolve_device(device)
    from ray_tpu_torch.train._session import get_session

    if get_session() is not None:
        from ray_tpu_torch.train.torch import get_device

        dev = get_device()
        if dev.type == "cuda":
            return dev
    resolve_device(None)   # raises without CUDA
    return torch.device("cuda", torch.cuda.current_device())


class TorchBatchIterator:
    """The iterator :meth:`Dataset.iter_torch_batches` returns.

    On the card, batch i + 1's columns are copied into pinned host
    buffers and issued as ``non_blocking`` copies on a side stream before
    batch i is handed out. Handing out a batch makes the caller's current
    stream wait on its copy's event and ``record_stream``s each tensor on
    that stream, so no batch is read before its copy lands and the
    allocator reuses none of its memory while the caller's work on it is
    pending. Each pinned buffer is held until its copy's event has
    completed; ``copy_ms`` then gets that copy's time (CUDA events on the
    copy stream around the batch's copies)."""

    def __init__(self, blocks: Iterator[Block], *, dtypes=None, device=None,
                 mesh=None, drop_last: bool = False):
        import torch

        self.device = _consumer_device(device)
        self.copy_ms: List[float] = []
        self._host = self._host_batches(blocks, dtypes or {}, mesh, drop_last)
        self._on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._on_card else None
        self._staged = None     # the next batch on the card, its copy in flight
        self._error = None      # a bad next batch, raised when it is asked for
        self._held: "collections.deque" = collections.deque()  # (start, done, pinned)

    @staticmethod
    def _host_batches(blocks, dtypes, mesh, drop_last):
        """Column blocks as dicts of CPU tensors: this rank's part under a
        mesh, each column cast to its ``dtypes`` entry."""
        import torch

        parts = 1
        if mesh is not None:
            from ray_tpu_torch.parallel import mesh as _mesh

            parts = math.prod(_mesh.axis_size(mesh, a) for a in _mesh.DATA_AXES)
        for block in blocks:
            if not isinstance(block, dict):
                raise TypeError("iter_torch_batches requires column blocks")
            rows = block_num_rows(block)
            if rows % parts:
                # a partial final batch can't be laid out on the data axes
                if drop_last:
                    continue
                raise ValueError(
                    f"final batch of {rows} rows is not divisible by the "
                    f"{parts}-way sharding; pass drop_last=True (or a "
                    "batch_size divisible by the mesh's data axes)"
                )
            out = {}
            for k, v in block.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if k in dtypes:
                    t = t.to(dtypes[k])
                if mesh is not None:
                    wide = t.dim() > 1
                    keep, cols = _mesh.batch_sharding(
                        mesh, (rows, t.shape[1] if wide else 0))
                    t = t[keep, cols] if wide else t[keep]
                out[k] = t
            yield out

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        if not self._on_card:
            return next(self._host)
        if self._error is not None:
            raise self._error
        current = self._staged or self._stage(next(self._host))
        self._staged = None
        upcoming = None
        try:
            upcoming = next(self._host, None)
        except (TypeError, ValueError) as e:   # raised in its turn, as on the CPU
            self._error = e
        if upcoming is not None:   # in flight while the caller's step runs
            self._staged = self._stage(upcoming)
        else:
            self._retire(wait=True)
        return self._hand_out(*current)

    def _stage(self, host: Dict[str, Any]):
        import torch

        pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v)
                  for k, v in host.items()}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record(self._stream)
            out = {k: p.to(self.device, non_blocking=True) for k, p in pinned.items()}
            done.record(self._stream)
        self._held.append((start, done, pinned))
        return out, done

    def _hand_out(self, out: Dict[str, Any], done) -> Dict[str, Any]:
        import torch

        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in out.values():
            t.record_stream(stream)
        self._retire()
        return out

    def _retire(self, wait: bool = False) -> None:
        """Release the pinned buffers of every copy that has landed (with
        ``wait``, of every copy, after waiting for it)."""
        while self._held:
            start, done, _ = self._held[0]
            if wait:
                done.synchronize()
            elif not done.query():
                return
            self.copy_ms.append(start.elapsed_time(done))
            self._held.popleft()

    def __del__(self):
        # an abandoned iterator still holds its buffers until their copies land
        try:
            self._retire(wait=True)
        except Exception:  # interpreter teardown: CUDA may be gone already
            pass


class GroupedData:
    """Group aggregation over the distributed sample-sort exchange
    (reference: python/ray/data/grouped_data.py over
    exchange/sort_task_spec.py): range-partitioning by the group key puts
    every row of a key into exactly one partition, so per-partition
    aggregation tasks are exact and nothing materializes on the driver."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, column: Optional[str], how: str) -> Dataset:
        from ray_tpu_torch.data._exchange import distributed_group_agg

        refs = list(self._ds._iter_block_refs())
        if not refs:
            name = f"{how}({column})" if column else f"{how}()"
            return Dataset([ray_tpu_torch.put({
                self._key: np.array([]), name: np.array([]),
            })])
        return Dataset(
            distributed_group_agg(refs, self._key, column, how)
        )

    def count(self) -> Dataset:
        return self._agg(None, "count")

    def sum(self, column: str) -> Dataset:
        return self._agg(column, "sum")

    def mean(self, column: str) -> Dataset:
        return self._agg(column, "mean")

    def min(self, column: str) -> Dataset:
        return self._agg(column, "min")

    def max(self, column: str) -> Dataset:
        return self._agg(column, "max")

    def std(self, column: str) -> Dataset:
        return self._agg(column, "std")

    def map_groups(self, fn: Callable) -> Dataset:
        """Apply fn to each group's sub-block; concat per partition
        (groups never split across partitions)."""
        from ray_tpu_torch.data._exchange import distributed_group_map

        refs = list(self._ds._iter_block_refs())
        if not refs:
            return Dataset([])
        return Dataset(distributed_group_map(refs, self._key, fn))
