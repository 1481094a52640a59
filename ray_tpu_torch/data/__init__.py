"""ray_tpu_torch.data — streaming datasets over the distributed object store.

The port of ``ray_tpu/data``, over this package's tasks, actors and plasma
store. Blocks are dicts of numpy arrays (or lists of rows) wherever they
are made, mapped, shuffled or read, so the CPU workers that do that never
import torch; torch enters only in the consumer, inside
``Dataset.iter_torch_batches``, which places each batch on the CUDA card
(or, with ``device="cpu"``, gives CPU tensors). Importing this package
loads no torch. The readers import pyarrow, pandas or PIL inside their
tasks, as the reference does: a worker without those packages cannot run
them.

Reference: python/ray/data (the streaming-executor subset per SURVEY.md §2.3:
read/from_items → map_batches → iter_batches with operator pools and
backpressure). Blocks are plasma objects; map stages are task/actor pools;
iteration overlaps ingest with downstream compute.
"""

from __future__ import annotations

import builtins
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block  # noqa: F401
from ray_tpu_torch.data.dataset import Dataset

DEFAULT_BLOCK_ROWS = 1024


def from_items(items: List[Any], *, override_num_blocks: Optional[int] = None
               ) -> Dataset:
    """Create a dataset from a python list (reference: data.from_items)."""
    from ray_tpu_torch.data._streaming import _rows_to_block

    n = len(items)
    if n == 0:
        return Dataset([])
    nblocks = override_num_blocks or max(1, min(32, n // DEFAULT_BLOCK_ROWS or 1))
    per = max(1, (n + nblocks - 1) // nblocks)
    refs = []
    for i in builtins.range(0, n, per):
        chunk = list(items[i:i + per])
        refs.append(ray_tpu_torch.put(_rows_to_block(chunk)))
    return Dataset(refs)


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    if n == 0:
        return Dataset([])
    nblocks = override_num_blocks or max(1, min(32, n // DEFAULT_BLOCK_ROWS or 1))
    per = max(1, (n + nblocks - 1) // nblocks)
    refs = [
        ray_tpu_torch.put({"id": np.arange(i, min(n, i + per), dtype=np.int64)})
        for i in builtins.range(0, n, per)
    ]
    return Dataset(refs)


def from_numpy(arr, column: str = "data",
               override_num_blocks: Optional[int] = None) -> Dataset:
    arr = np.asarray(arr)
    if len(arr) == 0:
        return Dataset([])
    nblocks = override_num_blocks or max(1, min(32, len(arr) // DEFAULT_BLOCK_ROWS or 1))
    per = max(1, (len(arr) + nblocks - 1) // nblocks)
    refs = [
        ray_tpu_torch.put({column: arr[i:i + per]})
        for i in builtins.range(0, len(arr), per)
    ]
    return Dataset(refs)


@ray_tpu_torch.remote
def _read_parquet_task(path: str, columns, filters):
    import pyarrow.parquet as pq

    # columns + filters push down into the parquet reader: row groups
    # whose statistics exclude the predicate never leave disk
    # (reference: datasource/parquet_datasource filter pushdown)
    table = pq.read_table(path, columns=columns, filters=filters)
    return {
        name: table.column(name).to_numpy(zero_copy_only=False)
        for name in table.column_names
    }


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 filter: Optional[list] = None) -> Dataset:
    """One block per parquet file, read in parallel by tasks
    (reference: data.read_parquet / datasource/parquet_datasource).
    `filter` takes pyarrow DNF filters, e.g. [("x", ">", 5)] — pushed
    down to row-group pruning."""
    refs = [
        _read_parquet_task.remote(f, columns, filter)
        for f in _expand_files(paths, ".parquet")
    ]
    return Dataset(refs)


@ray_tpu_torch.remote
def _read_csv_task(path: str):
    import pyarrow.csv as pcsv

    table = pcsv.read_csv(path)
    return {
        name: table.column(name).to_numpy(zero_copy_only=False)
        for name in table.column_names
    }


def read_csv(paths) -> Dataset:
    refs = [_read_csv_task.remote(f) for f in _expand_files(paths, ".csv")]
    return Dataset(refs)


def _expand_files(paths, suffix: str) -> List[str]:
    import glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, f"*{suffix}"))))
        else:
            files.extend(sorted(glob.glob(p)) or [p])
    if not files:
        raise FileNotFoundError(f"no {suffix} files under {paths}")
    return files


@ray_tpu_torch.remote
def _read_json_task(path: str):
    import pyarrow.json as pjson

    table = pjson.read_json(path)
    return {
        name: table.column(name).to_numpy(zero_copy_only=False)
        for name in table.column_names
    }


def read_json(paths) -> Dataset:
    """Newline-delimited JSON, one block per file
    (reference: data.read_json / datasource/json_datasource)."""
    refs = [_read_json_task.remote(f) for f in _expand_files(paths, ".json")]
    return Dataset(refs)


@ray_tpu_torch.remote
def _read_text_task(path: str):
    with open(path) as f:
        return {"text": np.asarray([ln.rstrip("\n") for ln in f], dtype=object)}


def read_text(paths) -> Dataset:
    """One row per line (reference: data.read_text)."""
    refs = [_read_text_task.remote(f) for f in _expand_files(paths, ".txt")]
    return Dataset(refs)


@ray_tpu_torch.remote
def _read_binary_task(path: str, include_paths: bool):
    with open(path, "rb") as f:
        data = f.read()
    block = {"bytes": np.asarray([data], dtype=object)}
    if include_paths:
        block["path"] = np.asarray([path], dtype=object)
    return block


def _expand_by_extensions(paths, extensions: List[str]) -> List[str]:
    """Expand paths and keep only real FILES with one of the extensions
    (applied to explicit paths and glob matches too, not just directory
    listings — and a bare '*' listing must never hand a subdirectory to a
    reader task)."""
    import os

    exts = tuple(
        e if e.startswith(".") else "." + e for e in extensions)
    files: List[str] = []
    for ext in exts:
        try:
            files.extend(_expand_files(paths, ext))
        except FileNotFoundError:
            pass
    files = [f for f in sorted(set(files))
             if f.endswith(exts) and os.path.isfile(f)]
    if not files:
        raise FileNotFoundError(f"no {list(exts)} files under {paths}")
    return files


def read_binary_files(paths, *, include_paths: bool = False,
                      file_extensions: Optional[List[str]] = None) -> Dataset:
    """One row per file with its raw bytes (reference: data.
    read_binary_files / datasource/binary_datasource)."""
    import os

    if file_extensions:
        files = _expand_by_extensions(paths, file_extensions)
    else:
        files = [f for f in _expand_files(paths, "") if os.path.isfile(f)]
        if not files:
            raise FileNotFoundError(f"no files under {paths}")
    refs = [_read_binary_task.remote(f, include_paths) for f in files]
    return Dataset(refs)


@ray_tpu_torch.remote
def _read_image_task(paths: List[str], size, mode):
    from PIL import Image

    images = []
    for path in paths:
        img = Image.open(path)
        if mode:
            img = img.convert(mode)
        if size:
            img = img.resize((size[1], size[0]))
        images.append(np.asarray(img))
    if size:
        arr = np.stack(images)
    else:
        # a 1-D object array of per-image ndarrays — np.asarray(...,
        # dtype=object) on same-shaped images would instead box every
        # PIXEL as a Python object (an ~8x memory blow-up)
        arr = np.empty(len(images), dtype=object)
        arr[:] = images
    return {"image": arr, "path": np.asarray(paths, dtype=object)}


IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def read_images(paths, *, size=None, mode: Optional[str] = None,
                files_per_block: int = 64) -> Dataset:
    """Decode images into an "image" ndarray column (reference:
    data.read_images / datasource/image_datasource — PIL decode in tasks).
    `size=(h, w)` resizes so blocks stack dense; `mode` converts e.g.
    "RGB"/"L" (with `size` it defaults to "RGB" — mixed channel counts
    cannot stack)."""
    if size and not mode:
        mode = "RGB"
    files = _expand_by_extensions(paths, list(IMAGE_EXTENSIONS))
    refs = [
        _read_image_task.remote(files[i:i + files_per_block], size, mode)
        for i in builtins.range(0, len(files), files_per_block)
    ]
    return Dataset(refs)


def from_pandas(dfs) -> Dataset:
    """One block per DataFrame (reference: data.from_pandas)."""
    if not isinstance(dfs, (list, tuple)):
        dfs = [dfs]
    refs = [
        ray_tpu_torch.put({c: df[c].to_numpy() for c in df.columns}) for df in dfs
    ]
    return Dataset(refs)


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    refs = [
        ray_tpu_torch.put({
            name: t.column(name).to_numpy(zero_copy_only=False)
            for name in t.column_names
        })
        for t in tables
    ]
    return Dataset(refs)
