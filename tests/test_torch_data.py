"""The port's ``data`` package against ``ray_tpu.data``: the counterparts of
tests/test_data.py.

Every program runs under ``ray_tpu``, then under ``ray_tpu_torch``
(``tests/_torch_data.py``: one runtime session per package for this file,
never both at once); each test holds the port's result equal to the JAX
package's (rows, and their order wherever the reference fixes one: a
seeded shuffle, a split, a rechunk) and then asserts what the reference
test asserts. The trainer's ingest runs through ``JaxTrainer`` under the
JAX package and ``TorchTrainer`` under the port. Also: importing
``ray_tpu_torch.data`` loads no torch, and a map stage's CPU worker never
has torch in ``sys.modules``.
"""

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from _torch_data import result, run_both, same

REPO = Path(__file__).resolve().parents[1]


def p_from_items_take_count(rt, rd, tmp):
    ds = rd.from_items(list(range(100)), override_num_blocks=4)
    return ds.count(), ds.take(5), ds.num_blocks()


def p_range_schema(rt, rd, tmp):
    ds = rd.range(1000, override_num_blocks=4)
    return ds.count(), ds.schema()


def p_map_batches_numpy(rt, rd, tmp):
    ds = rd.range(100, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"] * 2}
    )
    return [r["id"] for r in ds.take_all()]


def p_map_filter_flat_map(rt, rd, tmp):
    ds = rd.from_items(list(range(20)), override_num_blocks=2)
    return (
        ds.map(lambda x: x + 1)
        .filter(lambda x: x % 2 == 0)
        .flat_map(lambda x: [x, -x])
        .take_all()
    )


def p_iter_batches_rechunk(rt, rd, tmp):
    ds = rd.range(1000, override_num_blocks=7)
    return [b["id"].tolist() for b in ds.iter_batches(batch_size=128)]


def p_split_disjoint_equal(rt, rd, tmp):
    ds = rd.range(90, override_num_blocks=3)
    return [[r["id"] for r in sh.take_all()] for sh in ds.split(3, equal=True)]


def p_random_shuffle(rt, rd, tmp):
    ds = rd.range(500, override_num_blocks=4).random_shuffle(seed=7)
    return [r["id"] for r in ds.take_all()]


def p_read_parquet_roundtrip(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    for i in range(3):
        t = pa.table({"x": np.arange(i * 10, (i + 1) * 10),
                      "y": np.arange(10) * 0.5})
        pq.write_table(t, os.path.join(tmp, f"part-{i}.parquet"))
    ds = rd.read_parquet(str(tmp))
    doubled = ds.map_batches(lambda b: {"x2": b["x"] * 2}).take_all()
    return (ds.count(), [(r["x"], r["y"]) for r in ds.take_all()],
            [r["x2"] for r in doubled])


def p_map_batches_actor_pool(rt, rd, tmp):
    class AddConst:
        def __init__(self, k):
            self.k = k

        def __call__(self, block):
            return {"id": block["id"] + self.k}

    ds = rd.range(200, override_num_blocks=8).map_batches(
        AddConst, fn_constructor_args=(1000,), concurrency=2,
    )
    return [r["id"] for r in ds.take_all()]


def p_streaming_overlap(rt, rd, tmp):
    def slow_map(block):
        time.sleep(0.1)
        return block

    ds = rd.range(800, override_num_blocks=8).map_batches(slow_map)
    t0 = time.perf_counter()
    it = ds.iter_batches(batch_size=None, prefetch_blocks=2)
    first = next(it)
    t_first = time.perf_counter() - t0
    rest = list(it)
    t_all = time.perf_counter() - t0
    return {"first": first["id"].tolist(), "rest": [b["id"].tolist() for b in rest],
            "t_first": t_first, "t_all": t_all}


def _ingest_loop(config):
    """Reads this worker's shard with a 30 ms "step" per batch."""
    train = importlib.import_module(config["pkg"] + ".train")
    shard = train.get_dataset_shard("train")
    total, ids = 0, []
    t0 = time.perf_counter()
    for batch in shard.iter_batches(batch_size=64, prefetch_blocks=4):
        time.sleep(0.03)  # the "train step"
        total += len(batch["id"])
        ids += batch["id"].tolist()
    wall = time.perf_counter() - t0
    train.report({"rows": total, "wall": wall, "ids": ids})


def p_trainer_ingest_overlap(rt, rd, tmp):
    train = importlib.import_module(f"{rt.__name__}.train")

    def slow_map(block):
        time.sleep(0.06)
        return block

    n_blocks = 8
    ds = rd.range(n_blocks * 64, override_num_blocks=n_blocks).map_batches(
        slow_map
    )
    if rt.__name__ == "ray_tpu":
        trainer_cls, scaling = train.JaxTrainer, train.ScalingConfig(num_workers=1)
    else:
        trainer_cls = train.TorchTrainer
        scaling = train.ScalingConfig(num_workers=1, use_gpu=False)
    trainer = trainer_cls(
        _ingest_loop,
        train_loop_config={"pkg": rt.__name__},
        scaling_config=scaling,
        run_config=train.RunConfig(name="ingest", storage_path=str(tmp)),
        datasets={"train": ds},
    )
    m = trainer.fit().metrics
    return {"rows": m["rows"], "ids": m["ids"], "wall": m["wall"]}


def p_split_edge_cases(rt, rd, tmp):
    ds = rd.range(10, override_num_blocks=2)
    out = {"equal": [s.count() for s in ds.split(4, equal=True)],
           "unequal": [s.count() for s in ds.split(4, equal=False)]}
    try:
        rd.range(3, override_num_blocks=1).split(4, equal=True)
    except ValueError as e:
        out["too_few"] = type(e).__name__
    out["empty_items"] = rd.from_items([]).count()
    out["empty_range"] = rd.range(0).take_all()
    return out


def p_lazy_union_and_block_split(rt, rd, tmp):
    a = rd.range(40, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"] + 1}
    )
    b = rd.from_numpy(np.arange(1000, 1020), column="id")
    u = a.union(b)
    return u.count(), [[r["id"] for r in sh.take_all()] for sh in u.split_blocks(2)]


def p_map_batches_fixed_batch_size_stays_lazy(rt, rd, tmp):
    def counting(block):
        return {"id": block["id"], "n": np.full(len(block["id"]), len(block["id"]))}

    ds = rd.range(100, override_num_blocks=4).map_batches(
        counting, batch_size=30
    )
    return [int(b["n"][0]) for b in ds.iter_batches(batch_size=None)]


def p_map_worker_never_imports_torch(rt, rd, tmp):
    ds = rd.range(64, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"], "torch": np.asarray(
            [any(m.split(".")[0] == "torch" for m in sys.modules)] * len(b["id"]))}
    )
    rows = ds.take_all()
    return [r["id"] for r in rows], [bool(r["torch"]) for r in rows]


PROGRAMS = {name[2:]: f for name, f in dict(globals()).items()
            if name.startswith("p_") and name != "p_map_worker_never_imports_torch"}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(sys.modules[__name__], PROGRAMS, tmp_path_factory.mktemp("data"),
                    port_only={"map_worker_never_imports_torch":
                               p_map_worker_never_imports_torch})


def test_from_items_take_count(results):
    assert same(results, "from_items_take_count") == (100, [0, 1, 2, 3, 4], 4)


def test_range_schema(results):
    count, schema = same(results, "range_schema")
    assert count == 1000
    assert "id" in schema


def test_map_batches_numpy(results):
    ids = same(results, "map_batches_numpy")
    assert sorted(ids) == [2 * i for i in range(100)]


def test_map_filter_flat_map(results):
    out = same(results, "map_filter_flat_map")
    expect = []
    for x in range(20):
        if (x + 1) % 2 == 0:
            expect.extend([x + 1, -(x + 1)])
    assert sorted(out) == sorted(expect)


def test_iter_batches_rechunk(results):
    sizes = [len(b) for b in same(results, "iter_batches_rechunk")]
    assert sum(sizes) == 1000
    assert all(s == 128 for s in sizes[:-1])


def test_split_disjoint_equal(results):
    shards = same(results, "split_disjoint_equal")
    assert [len(ids) for ids in shards] == [30, 30, 30]
    assert sorted(i for ids in shards for i in ids) == list(range(90))


def test_random_shuffle(results):
    ids = same(results, "random_shuffle")   # the same seed, the same order
    assert sorted(ids) == list(range(500))
    assert ids != list(range(500))


def test_read_parquet_roundtrip(results):
    count, rows, doubled = same(results, "read_parquet_roundtrip")
    assert count == 30
    assert sorted(x for x, _ in rows) == list(range(30))
    assert sorted(doubled) == [2 * i for i in range(30)]


def test_map_batches_actor_pool(results):
    ids = same(results, "map_batches_actor_pool")
    assert sorted(ids) == [1000 + i for i in range(200)]


def test_streaming_overlap(results):
    """Consumption starts before the full plan finishes: with 8 blocks of
    100ms map work on 8 CPUs and a slow consumer, the first batch must
    arrive in ~1 block-time, not ~all-blocks-time (under both packages)."""
    ref, got = result(results, "streaming_overlap", 0), result(results, "streaming_overlap")
    assert (got["first"], got["rest"]) == (ref["first"], ref["rest"])
    for run in (ref, got):
        assert len(run["first"]) == 100
        assert run["t_first"] < 0.7 * run["t_all"], (run["t_first"], run["t_all"])


def test_trainer_ingest_overlap(results):
    """The trainer trains from a Dataset shard with streaming ingest: a
    60ms map stage and a 30ms step overlap, so the wall clock beats the
    serial sum (JaxTrainer under the JAX package, TorchTrainer under the
    port, the same rows in the same order)."""
    ref, got = (result(results, "trainer_ingest_overlap", 0),
                result(results, "trainer_ingest_overlap"))
    assert got["ids"] == ref["ids"] == list(range(8 * 64))
    serial = 8 * (0.06 + 0.03)
    for run in (ref, got):
        assert run["rows"] == 8 * 64
        assert run["wall"] < serial * 0.9, (run["wall"], serial)


def test_split_edge_cases(results):
    assert same(results, "split_edge_cases") == {
        "equal": [2, 2, 2, 2], "unequal": [3, 3, 2, 2], "too_few": "ValueError",
        "empty_items": 0, "empty_range": []}


def test_lazy_union_and_block_split(results):
    count, shards = same(results, "lazy_union_and_block_split")
    assert count == 60
    assert sorted(i for ids in shards for i in ids) == sorted(
        [i + 1 for i in range(40)] + list(range(1000, 1020))
    )


def test_map_batches_fixed_batch_size_stays_lazy(results):
    assert same(results, "map_batches_fixed_batch_size_stays_lazy") == [30, 30, 30, 10]


def test_map_worker_never_imports_torch(results):
    ids, torch_seen = result(results, "map_worker_never_imports_torch")
    assert sorted(ids) == list(range(64))
    assert not any(torch_seen)


def test_data_import_leaves_torch_out_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import data\n"
        "import ray_tpu_torch.data.preprocessors, ray_tpu_torch.data._exchange\n"
        "import ray_tpu_torch.data.backpressure\n"
        "data.Dataset, data.from_items, data.range, data.read_parquet\n"
        "data.dataset.TorchBatchIterator, data.backpressure.DataContext\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
