"""The port's ``Dataset.split`` and its binary and image readers against
``ray_tpu.data``: the counterparts of tests/test_data_split.py.

Each program runs under ``ray_tpu``, then under ``ray_tpu_torch``, one
runtime session per package for this file (``tests/_torch_data.py``); the
results must be equal: each shard's rows in order, the row counts, the
files' bytes and the decoded images' pixels. The split's driver-memory
ceiling is asserted under both packages.
"""

import os
import sys

import numpy as np
import pytest

from _torch_data import result, run_both, same


def _rows_task(rt):
    block = __import__(f"{rt.__name__}.data.block", fromlist=["block_num_rows"])

    @rt.remote
    def rows(b):
        return block.block_num_rows(b)

    return rows


def p_split_row_exact_and_block_aligned(rt, rd, tmp):
    rows = _rows_task(rt)
    out = {}
    shards = rd.range(1000, override_num_blocks=7).split(4)
    out["sizes"] = [sum(rt.get([rows.remote(r) for r in s._iter_block_refs()]))
                    for s in shards]
    out["shards"] = [[int(v) for b in s.iter_batches(batch_size=None)
                      for v in np.asarray(b["id"])] for s in shards]
    shards = rd.range(10, override_num_blocks=3).split(3, equal=False)
    out["unequal"] = [sum(rt.get([rows.remote(r) for r in s._iter_block_refs()]))
                      for s in shards]
    try:
        rd.range(2).split(3)
    except ValueError as e:
        out["too_few"] = type(e).__name__
    return out


def p_split_driver_memory_ceiling(rt, rd, tmp):
    """split moves whole blocks by reference and slices stragglers in
    tasks: the driver sees counts, not data."""
    import psutil

    rows = _rows_task(rt)
    row_bytes = 40_000
    n_rows = 2_000  # ~80 MB total, built worker-side

    def expand(batch):
        n = len(batch["id"])
        return {
            "id": batch["id"],
            "payload": np.ones((n, row_bytes // 8), np.float64),
        }

    ds = rd.range(n_rows, override_num_blocks=8).map_batches(expand)
    refs = list(ds._iter_block_refs())
    proc = psutil.Process(os.getpid())
    rss_before = proc.memory_info().rss
    shards = rd.Dataset(refs).split(3, equal=False)
    shard_refs = [list(s._iter_block_refs()) for s in shards]
    grew = proc.memory_info().rss - rss_before
    counts = [sum(rt.get([rows.remote(r) for r in refs_])) for refs_ in shard_refs]
    return {"grew": grew, "total": n_rows * row_bytes, "counts": counts}


def p_read_binary_files(rt, rd, tmp):
    (tmp / "a.bin").write_bytes(b"alpha")
    (tmp / "b.bin").write_bytes(b"bravo" * 100)
    (tmp / "skip.txt").write_text("nope")
    ds = rd.read_binary_files(str(tmp), include_paths=True, file_extensions=["bin"])
    rows = {}
    for batch in ds.iter_batches(batch_size=None):
        for path, payload in zip(batch["path"], batch["bytes"]):
            rows[str(path).rsplit("/", 1)[-1]] = bytes(payload)
    return rows


def p_read_images(rt, rd, tmp):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(6):
        arr = rng.integers(0, 255, (8 + i, 10, 3), np.uint8)
        Image.fromarray(arr).save(tmp / f"img{i}.png")
    # resized decode stacks dense
    resized = []
    for batch in rd.read_images(str(tmp), size=(16, 12), mode="RGB").iter_batches(
            batch_size=None):
        resized.append(np.asarray(batch["image"]))
    # native-size decode keeps per-image arrays
    native = []
    for batch in rd.read_images(str(tmp)).iter_batches(batch_size=None):
        native += [np.asarray(img) for img in batch["image"]]
    return {"resized": [(a.shape, a.tobytes()) for a in resized],
            "native": [(a.shape, a.tobytes()) for a in native]}


PROGRAMS = {name[2:]: f for name, f in dict(globals()).items() if name.startswith("p_")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(sys.modules[__name__], PROGRAMS, tmp_path_factory.mktemp("split"),
                    num_cpus=4)


def test_split_row_exact_and_block_aligned(results):
    out = same(results, "split_row_exact_and_block_aligned")
    assert out["sizes"] == [250, 250, 250, 250]   # block boundaries straddled
    assert sorted(v for ids in out["shards"] for v in ids) == list(range(1000))
    assert sorted(out["unequal"]) == [3, 3, 4]    # unequal: no rows dropped
    assert out["too_few"] == "ValueError"


def test_split_driver_memory_ceiling(results):
    ref, got = (result(results, "split_driver_memory_ceiling", 0),
                result(results, "split_driver_memory_ceiling"))
    assert got["counts"] == ref["counts"]
    for run in (ref, got):
        assert run["grew"] < run["total"] // 2, (
            f"driver RSS grew {run['grew'] / 1e6:.0f} MB splitting a "
            f"{run['total'] / 1e6:.0f} MB dataset — looks driver-materializing"
        )
        assert sum(run["counts"]) == 2_000
        assert max(run["counts"]) - min(run["counts"]) <= 1


def test_read_binary_files(results):
    assert same(results, "read_binary_files") == {"a.bin": b"alpha",
                                                  "b.bin": b"bravo" * 100}


def test_read_images(results):
    out = same(results, "read_images")
    assert all(shape[1:] == (16, 12, 3) for shape, _ in out["resized"])
    assert sum(shape[0] for shape, _ in out["resized"]) == 6
    shapes = {shape for shape, _ in out["native"]}
    assert (8, 10, 3) in shapes and (13, 10, 3) in shapes
