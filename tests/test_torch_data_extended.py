"""The port's wider ``data`` surface against ``ray_tpu.data``: file IO,
sort / groupby / aggregates / zip, preprocessors, the device iterator and
backpressure; the counterparts of tests/test_data_extended.py.

Each program runs under ``ray_tpu``, then under ``ray_tpu_torch``, one
runtime session per package for this file (``tests/_torch_data.py``); the
results must be equal: rows and their order after a sort, aggregates, and
the preprocessors' outputs (floats within 1e-6 relative). The JAX
package's ``iter_jax_batches`` becomes the port's
``iter_torch_batches(device="cpu")``; its sharded form, over a 4-device
mesh, becomes ``iter_torch_batches(device="cpu", mesh=...)`` in four gloo
train workers on ``make_mesh({"dp": 4})``, each rank holding the rows the
JAX array holds on the device of the same mesh coordinate. Also (port
only): ``iter_torch_batches()`` with no device raises without CUDA, and
``ObjectStoreMemoryBackpressurePolicy`` reads the port's plasma store and
holds a launch above its fraction.
"""

import sys
import time

import numpy as np
import pytest

from _torch_data import result, run_both, same


def _pre(rt):
    return __import__(f"{rt.__name__}.data.preprocessors", fromlist=["Chain"])


def p_parquet_roundtrip(rt, rd, tmp):
    ds = rd.range(100, override_num_blocks=3)
    files = ds.write_parquet(str(tmp / "pq"))
    back = rd.read_parquet(str(tmp / "pq"))
    return ([f.rsplit("/", 1)[-1] for f in files], back.count(),
            [r["id"] for r in back.take_all()])


def p_csv_roundtrip(rt, rd, tmp):
    ds = rd.from_items(
        [{"a": i, "b": float(i) * 0.5} for i in range(50)],
        override_num_blocks=2,
    )
    ds.write_csv(str(tmp / "csv"))
    back = rd.read_csv(str(tmp / "csv"))
    return back.count(), back.sum("a"), [(r["a"], r["b"]) for r in back.take_all()]


def p_json_roundtrip(rt, rd, tmp):
    ds = rd.from_items([{"x": i} for i in range(30)], override_num_blocks=2)
    ds.write_json(str(tmp / "js"))
    back = rd.read_json(str(tmp / "js"))
    return back.count(), back.max("x"), [r["x"] for r in back.take_all()]


def p_read_text(rt, rd, tmp):
    p = tmp / "a.txt"
    p.write_text("hello\nworld\n")
    return [r["text"] for r in rd.read_text(str(p)).take_all()]


def p_from_to_pandas(rt, rd, tmp):
    import pandas as pd

    df = pd.DataFrame({"a": [3, 1, 2], "b": ["x", "y", "z"]})
    out = rd.from_pandas(df).to_pandas()
    return list(out["a"]), list(out["b"])


def p_sort_limit_unique(rt, rd, tmp):
    ds = rd.from_items([{"v": x} for x in [5, 3, 8, 1, 9, 3]])
    s = ds.sort("v")
    return ([r["v"] for r in s.take_all()],
            [r["v"] for r in ds.sort("v", descending=True).take_all()],
            [r["v"] for r in s.limit(2).take_all()], ds.unique("v"))


def p_aggregates(rt, rd, tmp):
    ds = rd.range(10)
    return ds.sum("id"), ds.mean("id"), ds.min("id"), ds.max("id"), ds.std("id")


def p_groupby(rt, rd, tmp):
    ds = rd.from_items(
        [{"k": i % 3, "v": i} for i in range(12)], override_num_blocks=3
    )
    g = ds.groupby("k")
    return (g.count().take_all(), g.sum("v").take_all(), g.mean("v").take_all())


def p_map_groups(rt, rd, tmp):
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(8)])
    out = ds.groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "n": np.asarray([len(g["v"])])}
    )
    return [(r["k"], r["n"]) for r in out.take_all()]


def p_zip(rt, rd, tmp):
    a = rd.range(5)
    b = rd.from_items([{"sq": i * i} for i in range(5)])
    return a.zip(b).take_all()


def p_standard_scaler(rt, rd, tmp):
    ds = rd.from_items([{"x": float(i)} for i in range(100)])
    sc = _pre(rt).StandardScaler(["x"])
    out = sc.fit_transform(ds)
    return [r["x"] for r in out.take_all()], [float(v) for v in sc.stats_["x"]]


def p_minmax_label_onehot(rt, rd, tmp):
    pre = _pre(rt)
    ds = rd.from_items(
        [{"x": float(i), "cat": ["a", "b", "c"][i % 3]} for i in range(9)]
    )
    mm = pre.MinMaxScaler(["x"]).fit_transform(ds)
    le = pre.LabelEncoder("cat").fit_transform(ds)
    oh = pre.OneHotEncoder(["cat"]).fit_transform(ds)
    return {"minmax": [r["x"] for r in mm.take_all()],
            "label": [r["cat"] for r in le.take_all()],
            "onehot": [{k: float(v) if k != "cat" else v for k, v in r.items()}
                       for r in oh.take_all()]}


def p_concatenator_chain(rt, rd, tmp):
    pre = _pre(rt)
    ds = rd.from_items(
        [{"a": float(i), "b": float(-i), "y": i % 2} for i in range(20)]
    )
    pipe = pre.Chain(pre.StandardScaler(["a", "b"]), pre.Concatenator(["a", "b"]))
    rows = pipe.fit_transform(ds).take_all()
    return {"keys": sorted(rows[0]), "shape": rows[0]["features"].shape,
            "dtype": str(rows[0]["features"].dtype),
            "features": [r["features"].tolist() for r in rows],
            "y": [r["y"] for r in rows]}


def p_iter_jax_batches(rt, rd, tmp):
    ds = rd.range(100, override_num_blocks=4)
    if rt.__name__ == "ray_tpu":
        import jax.numpy as jnp

        batches = list(ds.iter_jax_batches(batch_size=32))
        kinds = {isinstance(b["id"], jnp.ndarray) for b in batches}
    else:
        import torch

        batches = list(ds.iter_torch_batches(batch_size=32, device="cpu"))
        kinds = {isinstance(b["id"], torch.Tensor) and b["id"].device.type == "cpu"
                 for b in batches}
    return kinds, [np.asarray(b["id"]).tolist() for b in batches]


def _sharded_loop(config):
    """Every rank reads the whole dataset through the mesh; rank r keeps its
    rows. Each reports what every rank saw."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": dist.get_world_size()}, device="cpu")
    mine = {"batches": [b["id"].tolist() for b in config["ds"].iter_torch_batches(
                batch_size=32, device="cpu", mesh=mesh)],
            "dropped": [b["id"].tolist() for b in config["ragged"].iter_torch_batches(
                batch_size=32, device="cpu", mesh=mesh, drop_last=True)]}
    try:
        list(config["ragged"].iter_torch_batches(batch_size=32, device="cpu", mesh=mesh))
    except ValueError as e:
        mine["ragged"] = type(e).__name__
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    train.report({"ranks": every})


def p_iter_jax_batches_sharded(rt, rd, tmp):
    """Per batch, the rows of each mesh coordinate of {"dp": 4}; a ragged
    final batch (70 rows at 32: 6) skipped with drop_last, else refused."""
    ds = rd.range(64, override_num_blocks=2)
    ragged = rd.range(70, override_num_blocks=2)
    if rt.__name__ == "ray_tpu":
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ray_tpu.parallel.mesh import make_mesh

        mesh = make_mesh({"dp": 4}, devices=jax.devices()[:4])
        sh = NamedSharding(mesh, P("dp"))

        def parts(it):
            out = []
            for b in it:
                assert len(b["id"].sharding.device_set) == 4
                shards = sorted(b["id"].addressable_shards,
                                key=lambda s: s.index[0].start)
                out.append([np.asarray(s.data).tolist() for s in shards])
            return out

        got = {"batches": parts(ds.iter_jax_batches(batch_size=32, sharding=sh)),
               "dropped": parts(ragged.iter_jax_batches(batch_size=32, sharding=sh,
                                                        drop_last=True))}
        try:
            list(ragged.iter_jax_batches(batch_size=32, sharding=sh))
        except ValueError as e:
            got["ragged"] = type(e).__name__
        return got
    from ray_tpu_torch import train

    every = train.TorchTrainer(
        _sharded_loop, train_loop_config={"ds": ds, "ragged": ragged},
        scaling_config=train.ScalingConfig(num_workers=4, use_gpu=False),
        run_config=train.RunConfig(name="sharded", storage_path=str(tmp)),
    ).fit().metrics["ranks"]
    return {"batches": [[r["batches"][i] for r in every]
                        for i in range(len(every[0]["batches"]))],
            "dropped": [[r["dropped"][i] for r in every]
                        for i in range(len(every[0]["dropped"]))],
            "ragged": every[0].get("ragged")}


def p_iter_torch_batches(rt, rd, tmp):
    import torch

    ds = rd.from_items([{"x": float(i)} for i in range(50)])
    kw = {} if rt.__name__ == "ray_tpu" else {"device": "cpu"}
    out = []
    for b in ds.iter_torch_batches(batch_size=16, dtypes={"x": torch.float32}, **kw):
        out.append((type(b["x"]).__name__, str(b["x"].dtype), str(b["x"].device),
                    b["x"].tolist()))
    return out


def p_streaming_split_alias(rt, rd, tmp):
    shards = rd.range(100, override_num_blocks=4).streaming_split(2)
    return [[r["id"] for r in s.take_all()] for s in shards]


def _task_names(rt):
    worker = __import__(f"{rt.__name__}._private.worker", fromlist=["get_global_worker"])
    events = worker.get_global_worker().gcs.call(
        "GetTaskEvents", {"limit": 10_000})["events"]
    return {e.get("name", "") for e in events}


def p_distributed_sort_exchange(rt, rd, tmp):
    """Sample-sort never materializes blocks on the driver: the driver
    fetches only key samples; partition/merge run as tasks (their names in
    the GCS's task events)."""
    n = 20_000
    rng = np.random.default_rng(7)
    vals = rng.permutation(n)
    ds = rd.from_items(
        [{"v": int(x), "payload": float(x) * 0.5} for x in vals],
        override_num_blocks=8,
    )
    fetched = {"bytes": 0}
    real_get = rt.get

    def counting_get(refs, **kw):
        out = real_get(refs, **kw)
        items = out if isinstance(refs, list) else [out]
        for it in items:
            fetched["bytes"] += sum(
                getattr(v, "nbytes", sys.getsizeof(v))
                for v in (it.values() if isinstance(it, dict) else [it])
            )
        return out

    rt.get = counting_get    # the exchange's module reads the package's get
    try:
        sorted_ds = ds.sort("v")
    finally:
        rt.get = real_get
    out = [r["v"] for r in sorted_ds.take_all()]
    out_d = [r["v"] for r in ds.sort("v", descending=True).take_all()]
    wanted = ("_sample_block", "_range_partition", "_sort_merge")
    deadline, seen = time.time() + 15, set()
    while time.time() < deadline:
        seen = {w for w in wanted for name in _task_names(rt) if w in name}
        if len(seen) == len(wanted):
            break
        time.sleep(0.5)
    return {"fetched": fetched["bytes"], "out": out, "out_d": out_d,
            "vals": vals.tolist(), "tasks": sorted(seen)}


def p_distributed_groupby_exchange(rt, rd, tmp):
    ds = rd.from_items(
        [{"k": i % 7, "v": float(i)} for i in range(10_000)],
        override_num_blocks=6,
    )
    g = ds.groupby("k")
    mg = g.map_groups(
        lambda sub: {"k": sub["k"][:1], "n": np.asarray([len(sub["v"])])}
    )
    return {"sums": g.sum("v").take_all(), "counts": g.count().take_all(),
            "means": g.mean("v").take_all(), "map_groups": mg.take_all()}


def p_sort_callable_tuple_key(rt, rd, tmp):
    rows = [{"a": i % 3, "b": -i} for i in range(30)]
    ds = rd.from_items(rows, override_num_blocks=4)
    out = ds.sort(key=lambda r: (r["a"], r["b"])).take_all()
    return [(r["a"], r["b"]) for r in out]


def p_parquet_filter_pushdown_and_arrow_bridge(rt, rd, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.table({"x": list(range(1000)), "y": [i * 2.0 for i in range(1000)]})
    path = tmp / "t.parquet"
    pq.write_table(t, path, row_group_size=100)
    rows = rd.read_parquet(str(path), columns=["x"], filter=[("x", ">=", 900)]).take_all()
    merged = pa.concat_tables(rd.from_arrow(t).to_arrow())
    return (rows, merged.num_rows, merged.column("y").to_pylist())


def p_backpressure_policy_plugin(rt, rd, tmp):
    """A custom policy throttles per-operator concurrency."""
    bp = __import__(f"{rt.__name__}.data.backpressure", fromlist=["DataContext"])
    ctx = bp.DataContext.get_current()
    saved = list(ctx.backpressure_policies)

    class CapOne(bp.BackpressurePolicy):
        def __init__(self):
            self.max_seen = 0

        def can_add_input(self, op, in_flight):
            self.max_seen = max(self.max_seen, in_flight)
            return in_flight < 1

    probe = CapOne()
    try:
        ctx.backpressure_policies = [probe]
        out = rd.range(40, override_num_blocks=8).map_batches(
            lambda b: {"id": b["id"] * 2}, max_in_flight=8
        ).take_all()
    finally:
        ctx.backpressure_policies = saved
    return ([r["id"] for r in out], probe.max_seen,
            [type(p).__name__ for p in bp.DataContext.get_current().backpressure_policies])


def p_memory_backpressure_reads_the_store(rt, rd, tmp):
    """ObjectStoreMemoryBackpressurePolicy against this process's plasma
    store: a launch is held once usage is above the policy's fraction."""
    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.data.backpressure import ObjectStoreMemoryBackpressurePolicy

    plasma = get_global_worker().plasma
    before = plasma.stats()
    ref = rt.put(np.ones(8 << 20, np.uint8))   # 8 MiB: a plasma object
    after = plasma.stats()
    cap = after["capacity_bytes"]
    below = ObjectStoreMemoryBackpressurePolicy(after["used_bytes"] / cap / 2)
    above = ObjectStoreMemoryBackpressurePolicy((after["used_bytes"] + (1 << 20)) / cap)
    decisions = (below.can_add_input(None, 0), above.can_add_input(None, 0))
    del ref
    return before, after, decisions


def p_iter_torch_batches_without_cuda_raises(rt, rd, tmp):
    import torch

    it_ds = rd.range(10)
    try:
        next(iter(it_ds.iter_torch_batches(batch_size=4)))
    except RuntimeError as e:
        return torch.cuda.is_available(), str(e)
    return torch.cuda.is_available(), None


PORT_ONLY = ("memory_backpressure_reads_the_store", "iter_torch_batches_without_cuda_raises")
PROGRAMS = {name[2:]: f for name, f in dict(globals()).items() if name.startswith("p_")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(sys.modules[__name__],
                    {k: f for k, f in PROGRAMS.items() if k not in PORT_ONLY},
                    tmp_path_factory.mktemp("extended"),
                    port_only={k: PROGRAMS[k] for k in PORT_ONLY})


def test_parquet_roundtrip(results):
    files, count, ids = same(results, "parquet_roundtrip")
    assert len(files) == 3
    assert count == 100
    assert sorted(ids) == list(range(100))


def test_csv_roundtrip(results):
    count, total, _ = same(results, "csv_roundtrip")
    assert count == 50
    assert total == sum(range(50))


def test_json_roundtrip(results):
    count, top, _ = same(results, "json_roundtrip")
    assert count == 30
    assert top == 29


def test_read_text(results):
    assert same(results, "read_text") == ["hello", "world"]


def test_from_to_pandas(results):
    assert same(results, "from_to_pandas") == ([3, 1, 2], ["x", "y", "z"])


def test_sort_limit_unique(results):
    asc, desc, head, uniq = same(results, "sort_limit_unique")
    assert asc == [1, 3, 3, 5, 8, 9]
    assert desc == [9, 8, 5, 3, 3, 1]
    assert head == [1, 3]
    assert uniq == [1, 3, 5, 8, 9]


def test_aggregates(results):
    total, mean, lo, hi, std = same(results, "aggregates")
    assert total == 45
    assert mean == pytest.approx(4.5)
    assert lo == 0
    assert hi == 9
    assert std == pytest.approx(np.std(np.arange(10), ddof=1))


def test_groupby(results):
    counts, sums, means = same(results, "groupby")
    assert {r["k"]: r["count()"] for r in counts} == {0: 4, 1: 4, 2: 4}
    assert {r["k"]: r["sum(v)"] for r in sums} == {
        0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}
    assert means[0]["mean(v)"] == pytest.approx(4.5)


def test_map_groups(results):
    assert sorted(same(results, "map_groups")) == [(0, 4), (1, 4)]


def test_zip(results):
    rows = same(results, "zip")
    assert len(rows) == 5
    assert all(r["sq"] == r["id"] ** 2 for r in rows)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-6, atol=0)


def test_standard_scaler(results):
    (vals, stats), (ref_vals, ref_stats) = (result(results, "standard_scaler"),
                                            result(results, "standard_scaler", 0))
    _close(vals, ref_vals)
    _close(stats, ref_stats)
    vals = np.asarray(vals)
    assert abs(vals.mean()) < 1e-9
    assert vals.std() == pytest.approx(1.0, abs=1e-9)


def test_minmax_label_onehot(results):
    got, ref = result(results, "minmax_label_onehot"), result(results, "minmax_label_onehot", 0)
    _close(got["minmax"], ref["minmax"])
    assert got["label"] == ref["label"]
    assert [sorted(r) for r in got["onehot"]] == [sorted(r) for r in ref["onehot"]]
    for row, ref_row in zip(got["onehot"], ref["onehot"]):
        _close([row[k] for k in sorted(row)], [ref_row[k] for k in sorted(row)])
    assert min(got["minmax"]) == 0.0 and max(got["minmax"]) == 1.0
    assert set(got["label"]) == {0, 1, 2}
    assert {"cat_a", "cat_b", "cat_c"} <= set(got["onehot"][0])


def test_concatenator_chain(results):
    got, ref = result(results, "concatenator_chain"), result(results, "concatenator_chain", 0)
    assert {k: got[k] for k in ("keys", "shape", "dtype", "y")} == \
        {k: ref[k] for k in ("keys", "shape", "dtype", "y")}
    _close(got["features"], ref["features"])
    assert got["shape"] == (2,)
    assert "a" not in got["keys"] and "b" not in got["keys"] and "y" in got["keys"]


def test_iter_jax_batches(results):
    (kinds, batches), (ref_kinds, ref_batches) = (result(results, "iter_jax_batches"),
                                                  result(results, "iter_jax_batches", 0))
    assert kinds == ref_kinds == {True}
    assert batches == ref_batches
    assert sum(len(b) for b in batches) == 100


@pytest.mark.timeout(170)
def test_iter_jax_batches_sharded(results):
    got = same(results, "iter_jax_batches_sharded")
    assert len(got["batches"]) == 2
    assert all(len(parts) == 4 and all(len(p) == 8 for p in parts)
               for parts in got["batches"])
    assert got["dropped"][-1][-1] == list(range(56, 64))
    assert got["ragged"] == "ValueError"


def test_iter_torch_batches(results):
    batches = same(results, "iter_torch_batches")
    assert {(kind, dtype, device) for kind, dtype, device, _ in batches} == {
        ("Tensor", "torch.float32", "cpu")}
    assert sum(len(x) for *_, x in batches) == 50


def test_streaming_split_alias(results):
    shards = same(results, "streaming_split_alias")
    assert len(shards) == 2
    assert sum(len(s) for s in shards) == 100


def test_distributed_sort_exchange(results):
    got = result(results, "distributed_sort_exchange")
    ref = result(results, "distributed_sort_exchange", 0)
    assert (got["out"], got["out_d"], got["tasks"]) == (ref["out"], ref["out_d"], ref["tasks"])
    for run in (ref, got):
        # driver saw only samples: a few KB, not the ~500KB dataset
        assert run["fetched"] < 50_000, run["fetched"]
        assert run["out"] == sorted(run["vals"])
        assert run["out_d"] == sorted(run["vals"], reverse=True)
        assert run["tasks"] == ["_range_partition", "_sample_block", "_sort_merge"]


def test_distributed_groupby_exchange(results):
    out = same(results, "distributed_groupby_exchange")
    sums = {r["k"]: r["sum(v)"] for r in out["sums"]}
    expect = {}
    for i in range(10_000):
        expect[i % 7] = expect.get(i % 7, 0.0) + float(i)
    assert sums == expect
    counts = {r["k"]: r["count()"] for r in out["counts"]}
    assert all(v in (1428, 1429) for v in counts.values())
    means = {r["k"]: r["mean(v)"] for r in out["means"]}
    for k, s in expect.items():
        assert abs(means[k] - s / counts[k]) < 1e-6
    assert {r["k"]: r["n"] for r in out["map_groups"]} == counts


def test_sort_callable_tuple_key(results):
    rows = [{"a": i % 3, "b": -i} for i in range(30)]
    expect = sorted(rows, key=lambda r: (r["a"], r["b"]))
    assert same(results, "sort_callable_tuple_key") == [(r["a"], r["b"]) for r in expect]


def test_parquet_filter_pushdown_and_arrow_bridge(results):
    rows, n, ys = same(results, "parquet_filter_pushdown_and_arrow_bridge")
    assert len(rows) == 100
    assert all(r["x"] >= 900 for r in rows)
    assert "y" not in rows[0]
    assert n == 1000
    assert ys[:3] == [0.0, 2.0, 4.0]


def test_backpressure_policy_plugin(results):
    ids, max_seen, default_chain = same(results, "backpressure_policy_plugin")
    assert len(ids) == 40
    assert max_seen <= 1   # never more than 1 in flight
    # the default chain caps at the operator's window
    assert default_chain[0] == "ConcurrencyCapBackpressurePolicy"


def test_memory_backpressure_reads_the_store(results):
    before, after, (below, above) = result(results, "memory_backpressure_reads_the_store")
    assert after["capacity_bytes"] > 0
    assert after["used_bytes"] >= before["used_bytes"] + (8 << 20)
    assert below is False   # usage above the fraction: the launch is held
    assert above is True


def test_iter_torch_batches_without_cuda_raises(results):
    cuda, error = result(results, "iter_torch_batches_without_cuda_raises")
    assert not cuda
    assert error is not None and "device='cpu'" in error
