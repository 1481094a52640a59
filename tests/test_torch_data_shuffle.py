"""The port's distributed random shuffle and operator fusion against
``ray_tpu.data``: the counterparts of tests/test_data_shuffle.py.

Each program runs under ``ray_tpu``, then under ``ray_tpu_torch``, one
runtime session per package for this file (``tests/_torch_data.py``). The
seeded shuffle draws as the reference does, so the rows come out in the
same order under both packages, bitwise; the fused plan, its task count
(from the GCS's task events) and its rows are equal too.
"""

import os
import sys
import time

import numpy as np
import pytest

from _torch_data import result, run_both, same


def p_random_shuffle_preserves_rows(rt, rd, tmp):
    ds = rd.range(2000, override_num_blocks=8)
    return {seed: [int(r["id"]) for r in ds.random_shuffle(seed=seed).take_all()]
            for seed in (7, 8)} | {
        "again": [int(r["id"]) for r in ds.random_shuffle(seed=7).take_all()]}


def p_random_shuffle_mixes_across_blocks(rt, rd, tmp):
    ds = rd.range(4000, override_num_blocks=8)
    out_blocks = list(ds.random_shuffle(seed=0)._iter_block_refs())
    return len(out_blocks), np.asarray(rt.get(out_blocks[0])["id"]).tolist()


def p_random_shuffle_driver_memory_ceiling(rt, rd, tmp):
    """The shuffle routes refs only: blocks are built by map tasks and the
    driver never materializes them."""
    import psutil

    block = __import__(f"{rt.__name__}.data.block", fromlist=["block_num_rows"])

    @rt.remote
    def rows(b):
        return block.block_num_rows(b)

    row_bytes = 40_000
    n_rows = 2_000  # ~80 MB total, built by map tasks (never in the driver)

    def expand(batch):
        n = len(batch["id"])
        return {
            "id": batch["id"],
            "payload": np.ones((n, row_bytes // 8), np.float64),
        }

    ds = rd.range(n_rows, override_num_blocks=8).map_batches(expand)
    refs = list(ds._iter_block_refs())  # materialize worker-side
    proc = psutil.Process(os.getpid())
    rss_before = proc.memory_info().rss
    shuffled_refs = list(rd.Dataset(refs).random_shuffle(seed=3)._iter_block_refs())
    grew = proc.memory_info().rss - rss_before
    counts = rt.get([rows.remote(r) for r in shuffled_refs])
    return {"grew": grew, "total": n_rows * row_bytes, "counts": counts}


def p_operator_fusion_plan(rt, rd, tmp):
    st = __import__(f"{rt.__name__}.data._streaming", fromlist=["MapOperator"])

    mk = lambda name: st.MapOperator(  # noqa: E731
        lambda b: b, is_batch_fn=True, name=name
    )
    actor_op = st.MapOperator(lambda b: b, is_batch_fn=True, compute_actors=2,
                              name="Actors")
    ops = [mk("A"), mk("B"), st.RechunkOperator(10), mk("C"), mk("D"),
           actor_op, mk("E")]
    fused = st.fuse_operators(ops)
    kinds = [type(op).__name__ for op in fused]
    return kinds, [op.name for op in fused], fused[3] is actor_op


def p_operator_fusion_task_count_and_results(rt, rd, tmp):
    """A 3-op chain over K blocks launches K tasks, counted from the GCS
    task-event sink; row/batch semantics survive fusion."""
    worker = __import__(f"{rt.__name__}._private.worker", fromlist=["get_global_worker"])
    ds = (
        rd.range(400, override_num_blocks=4)
        .map(lambda r: {"id": r["id"], "x": r["id"] * 2})
        .filter(lambda r: r["x"] % 4 == 0)
        .map_batches(lambda b: {"x": np.asarray(b["x"]) + 1})
    )
    out = [int(r["x"]) for r in ds.take_all()]

    tag = f"fusion_probe_{time.time_ns()}"

    def tagged(batch):
        return batch

    tagged.__name__ = tag
    (rd.range(400, override_num_blocks=4)
     .map_batches(tagged)
     .map(lambda r: r)
     .filter(lambda r: True)).take_all()

    def tagged_tasks():
        events = worker.get_global_worker().gcs.call(
            "GetTaskEvents", {"limit": 10_000})["events"]
        return {e["task_id"]: e["name"] for e in events if tag in e.get("name", "")}

    deadline = time.time() + 15
    names = {}
    while time.time() < deadline:
        names = tagged_tasks()
        if names:
            time.sleep(1.5)   # events flush asynchronously; settle briefly
            names = tagged_tasks()
            break
        time.sleep(0.5)
    return out, len(names), sorted(set(n.replace(tag, "<tag>") for n in names.values()))


PROGRAMS = {name[2:]: f for name, f in dict(globals()).items() if name.startswith("p_")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(sys.modules[__name__], PROGRAMS, tmp_path_factory.mktemp("shuffle"))


def test_random_shuffle_preserves_rows(results):
    out = same(results, "random_shuffle_preserves_rows")
    rows = out[7]
    assert sorted(rows) == list(range(2000))
    # actually permuted (probability of identity is ~0)
    assert rows != list(range(2000))
    # deterministic under the same seed; a different seed, a different order
    assert out["again"] == rows
    assert out[8] != rows


def test_random_shuffle_mixes_across_blocks(results):
    n_blocks, ids = same(results, "random_shuffle_mixes_across_blocks")
    assert n_blocks >= 2
    # input block b held ids [b*500, (b+1)*500): a well-mixed partition
    # draws from nearly all 8 source blocks
    source_blocks = {i // 500 for i in ids}
    assert len(source_blocks) >= 6, source_blocks


def test_random_shuffle_driver_memory_ceiling(results):
    ref, got = (result(results, "random_shuffle_driver_memory_ceiling", 0),
                result(results, "random_shuffle_driver_memory_ceiling"))
    assert got["counts"] == ref["counts"]
    for run in (ref, got):
        assert run["grew"] < run["total"] // 2, (
            f"driver RSS grew {run['grew'] / 1e6:.0f} MB shuffling a "
            f"{run['total'] / 1e6:.0f} MB dataset — looks driver-materializing"
        )
        assert sum(run["counts"]) == 2_000


def test_operator_fusion_plan(results):
    kinds, names, actor_passes = same(results, "operator_fusion_plan")
    # A+B fuse; Rechunk barrier; C+D fuse; actor stage passes through; E solo
    assert kinds == ["FusedMapOperator", "RechunkOperator", "FusedMapOperator",
                     "MapOperator", "MapOperator"]
    assert names[0] == "A+B" and names[2] == "C+D" and names[4] == "E"
    assert actor_passes


def test_operator_fusion_task_count_and_results(results):
    out, n_tasks, names = same(results, "operator_fusion_task_count_and_results")
    assert sorted(out) == [x * 2 + 1 for x in range(400) if (x * 2) % 4 == 0]
    # 4 blocks -> exactly 4 fused tasks (the tagged stage's name appears in
    # the fused task name); without fusion the chain would launch 12
    assert n_tasks == 4, f"expected 4 fused tasks, saw {n_tasks}"
    assert names == ["Data[<tag>+Map+Filter]"]
