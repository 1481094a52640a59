"""Streaming executor: pull-based operator pipeline with bounded in-flight
work per stage (reference: data/_internal/execution/streaming_executor.py:48,
physical_operator.py:139, backpressure_policy/).

Each map stage keeps at most ``max_in_flight`` block tasks outstanding and
yields output refs as they complete, pulling from its upstream lazily — so a
downstream consumer (e.g. a training loop) overlaps ingest with compute and
memory stays bounded at stage_depth x block_size instead of dataset_size.

A copy of ``ray_tpu/data/_streaming.py`` over this package's tasks and
actors. Map tasks run in CPU workers on numpy blocks; nothing here imports
torch.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_num_rows, concat_blocks, slice_block

logger = logging.getLogger("ray_tpu_torch.data")

DEFAULT_MAX_IN_FLIGHT = 8


@ray_tpu_torch.remote
def _map_block_task(fn_payload, block, *, is_batch_fn: bool):
    import cloudpickle

    fn = cloudpickle.loads(fn_payload)
    return _apply(fn, block, is_batch_fn)


def _apply(fn, block: Block, is_batch_fn: bool) -> Block:
    from ray_tpu_torch.data.block import rows_of

    if is_batch_fn:
        return fn(block)
    out = [fn(r) for r in rows_of(block)]
    return _rows_to_block(out)


def _rows_to_block(rows: List[Any]) -> Block:
    import numpy as np

    if rows and isinstance(rows[0], dict) and all(
        isinstance(r, dict) for r in rows
    ):
        keys = rows[0].keys()
        if all(r.keys() == keys for r in rows):
            try:
                return {k: np.asarray([r[k] for r in rows]) for k in keys}
            except Exception:
                return rows
    return rows


class MapOperator:
    """One logical map_batches/map/filter stage."""

    def __init__(self, fn: Callable, *, is_batch_fn: bool,
                 compute_actors: int = 0, fn_constructor_args: tuple = (),
                 num_cpus: float = 1.0,
                 max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
                 name: str = "Map"):
        self.fn = fn
        self.is_batch_fn = is_batch_fn
        self.compute_actors = compute_actors
        self.fn_constructor_args = fn_constructor_args
        self.num_cpus = num_cpus
        self.max_in_flight = max_in_flight
        self.name = name

    # ------------------------------------------------------------- execution

    def stream(self, upstream: Iterator[Any]) -> Iterator[Any]:
        if self.compute_actors:
            yield from self._stream_actors(upstream)
        else:
            yield from self._stream_tasks(upstream)

    def _stream_tasks(self, upstream: Iterator[Any]) -> Iterator[Any]:
        import collections

        import cloudpickle

        from ray_tpu_torch.data.backpressure import DataContext

        payload = cloudpickle.dumps(self.fn)
        policies = DataContext.get_current().backpressure_policies
        # Yield in INPUT order (completion order would make block order — and
        # therefore take()/iter_batches contents — nondeterministic): block
        # on the oldest outstanding task whenever the policy chain (default:
        # the max_in_flight window; optionally object-store pressure) holds
        # the next launch.
        in_flight: "collections.deque" = collections.deque()
        # carry the logical stage name into the task spec: the timeline /
        # task events then show "Data[MapBatches(fn)+Filter]" instead of an
        # anonymous _map_block_task (reference: data tasks named per op)
        task = _map_block_task.options(
            num_cpus=self.num_cpus, name=f"Data[{self.name}]"
        )

        def may_launch():
            return all(p.can_add_input(self, len(in_flight)) for p in policies)

        for ref in upstream:
            while in_flight and not may_launch():
                yield in_flight.popleft()
            if not in_flight and not may_launch():
                # resource-pressure hold with an empty window: give the
                # consumer/spiller a bounded drain window, then proceed
                # (progress beats a perfect cap)
                import time as _time

                deadline = _time.time() + 10
                while not may_launch() and _time.time() < deadline:
                    _time.sleep(0.05)
            in_flight.append(
                task.remote(payload, ref, is_batch_fn=self.is_batch_fn)
            )
        while in_flight:
            yield in_flight.popleft()

    def _stream_actors(self, upstream: Iterator[Any]) -> Iterator[Any]:
        """Class-based UDF on a pool of actors (reference: ActorPoolStrategy).
        The callable is constructed once per actor and reused per block."""

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self, fn_payload, ctor_args):
                import cloudpickle

                cls = cloudpickle.loads(fn_payload)
                self.callable = cls(*ctor_args)

            def apply(self, block, is_batch_fn):
                return _apply(self.callable, block, is_batch_fn)

        import cloudpickle

        payload = cloudpickle.dumps(self.fn)
        pool = [
            _MapWorker.options(num_cpus=self.num_cpus).remote(
                payload, self.fn_constructor_args
            )
            for _ in range(self.compute_actors)
        ]
        import collections

        from ray_tpu_torch.data.backpressure import DataContext

        policies = DataContext.get_current().backpressure_policies
        per_actor_cap = max(2, self.max_in_flight // len(pool))
        in_flight: "collections.deque" = collections.deque()  # (ref, idx)
        load = [0] * len(pool)

        def may_launch():
            # the actor path honors the same policy chain as the task
            # path (memory pressure etc.); the pool window is an
            # additional per-actor cap
            return all(
                p.can_add_input(self, sum(load)) for p in policies
            )

        produced: List[Any] = []
        try:
            for ref in upstream:
                while in_flight and not may_launch():
                    done_ref, done_idx = in_flight.popleft()
                    load[done_idx] -= 1
                    yield done_ref
                while sum(load) >= per_actor_cap * len(pool):
                    done_ref, done_idx = in_flight.popleft()
                    load[done_idx] -= 1
                    yield done_ref  # input order preserved
                idx = min(range(len(pool)), key=lambda i: load[i])
                out = pool[idx].apply.remote(ref, self.is_batch_fn)
                in_flight.append((out, idx))
                load[idx] += 1
                produced.append(out)
                if len(produced) >= 32:
                    # prune resolved refs: holding every output ref for the
                    # stage's lifetime would pin the stage's entire output
                    # in the store (the streaming window must stay bounded)
                    _, produced = ray_tpu_torch.wait(
                        produced, num_returns=len(produced), timeout=0
                    )
            while in_flight:
                done_ref, done_idx = in_flight.popleft()
                load[done_idx] -= 1
                yield done_ref
        finally:
            # The stage yields refs as soon as they're submitted; a
            # downstream stage may not have RESOLVED them yet. Wait until
            # every produced block is computed before killing the pool, or
            # consumers see ActorDiedError on perfectly good refs.
            if produced:
                try:
                    # only still-unresolved refs remain after pruning
                    ray_tpu_torch.wait(produced, num_returns=len(produced),
                                 timeout=60)
                except Exception:
                    pass
            for a in pool:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass


def rechunk_blocks(blocks: Iterator[Block], rows: int) -> Iterator[Block]:
    """Re-chunk a stream of blocks to exactly `rows` per block (short tail),
    with bounded memory: the current accumulation plus one upstream block."""
    pending: Optional[Block] = None
    for block in blocks:
        if pending is not None:
            block = concat_blocks([pending, block])
            pending = None
        n = block_num_rows(block)
        off = 0
        while n - off >= rows:
            yield slice_block(block, off, off + rows)
            off += rows
        if off < n:
            pending = slice_block(block, off, n)
    if pending is not None and block_num_rows(pending):
        yield pending


class RechunkOperator:
    """Lazy in-stream re-chunking to a fixed rows-per-block. Used by
    map_batches(batch_size=N) so the plan is never executed twice."""

    def __init__(self, rows_per_block: int):
        self.rows = rows_per_block
        self.name = f"Rechunk({rows_per_block})"

    def stream(self, upstream: Iterator[Any]) -> Iterator[Any]:
        blocks = (ray_tpu_torch.get(r) for r in upstream)
        for out in rechunk_blocks(blocks, self.rows):
            yield ray_tpu_torch.put(out)


class FusedMapOperator(MapOperator):
    """Several adjacent task-based map stages collapsed into one task per
    block (reference: data/_internal/logical/rules/operator_fusion.py —
    MapFusionRule): a map->filter->map chain costs one task launch and one
    block materialization instead of three."""

    def __init__(self, ops: List[MapOperator]):
        chain = [(op.fn, op.is_batch_fn) for op in ops]

        def fused(block, _chain=chain):
            for fn, is_batch in _chain:
                block = _apply(fn, block, is_batch)
            return block

        super().__init__(
            fused,
            is_batch_fn=True,
            num_cpus=max(op.num_cpus for op in ops),
            max_in_flight=min(op.max_in_flight for op in ops),
            name="+".join(op.name for op in ops),
        )


def fuse_operators(operators: List[Any]) -> List[Any]:
    """Plan rewrite: merge runs of adjacent task-based MapOperators.
    Actor-pool stages (stateful UDF construction) and Rechunk stages
    (block-shape barriers) break a run."""
    out: List[Any] = []
    run: List[MapOperator] = []

    def flush():
        if len(run) > 1:
            out.append(FusedMapOperator(run))
        elif run:
            out.append(run[0])
        run.clear()

    for op in operators:
        fusable = (
            isinstance(op, MapOperator)
            and not isinstance(op, FusedMapOperator)
            and not op.compute_actors
        )
        if fusable:
            run.append(op)
        else:
            flush()
            out.append(op)
    flush()
    return out


def execute_plan(source_refs: List[Any],
                 operators: List[MapOperator]) -> Iterator[Any]:
    """Chain the stages into one lazy pull pipeline of block refs (after
    the fusion rewrite)."""
    stream: Iterator[Any] = iter(source_refs)
    for op in fuse_operators(operators):
        stream = op.stream(stream)
    return stream


def iter_batches_from_stream(
    ref_stream: Iterator[Any],
    batch_size: Optional[int],
    prefetch_blocks: int = 2,
) -> Iterator[Block]:
    """Materialize blocks with bounded prefetch and re-chunk to batch_size."""
    import collections

    window: "collections.deque" = collections.deque()

    def blocks():
        while True:
            while len(window) < max(1, prefetch_blocks):
                try:
                    window.append(next(ref_stream))
                except StopIteration:
                    break
            if not window:
                return
            yield ray_tpu_torch.get(window.popleft())

    if batch_size is None:
        yield from blocks()
        return
    yield from rechunk_blocks(blocks(), batch_size)
