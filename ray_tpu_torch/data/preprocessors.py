"""Fit/transform preprocessors over Datasets
(reference: python/ray/data/preprocessors/ — scaler/encoder/concatenator
subset). A preprocessor computes its statistics with one aggregation pass
(`fit`), then `transform` is a stateless map_batches stage that streams
through the executor like any other operator.

A copy of ``ray_tpu/data/preprocessors.py``: numpy in CPU tasks, no torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.dataset import Dataset


class Preprocessor:
    """Base: fit(ds) -> self; transform(ds) -> Dataset; fit_transform."""

    _fitted = False

    def fit(self, ds: Dataset) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds: Dataset) -> Dataset:
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return ds.map_batches(self._transform_block)

    def fit_transform(self, ds: Dataset) -> Dataset:
        return self.fit(ds).transform(ds)

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds: Dataset):
        raise NotImplementedError

    def _transform_block(self, block):
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds: Dataset):
        for c in self.columns:
            v = ds._column(c).astype(np.float64)
            std = v.std()
            self.stats_[c] = (v.mean(), std if std > 0 else 1.0)

    def _transform_block(self, block):
        out = dict(block)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = (np.asarray(block[c], dtype=np.float64) - mean) / std
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds: Dataset):
        for c in self.columns:
            v = ds._column(c).astype(np.float64)
            lo, hi = v.min(), v.max()
            self.stats_[c] = (lo, (hi - lo) if hi > lo else 1.0)

    def _transform_block(self, block):
        out = dict(block)
        for c in self.columns:
            lo, span = self.stats_[c]
            out[c] = (np.asarray(block[c], dtype=np.float64) - lo) / span
        return out


class LabelEncoder(Preprocessor):
    """Map category values to dense int codes
    (reference: preprocessors/encoder.py OrdinalEncoder/LabelEncoder)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Optional[np.ndarray] = None

    def _fit(self, ds: Dataset):
        self.classes_ = np.asarray(ds.unique(self.label_column))

    def _transform_block(self, block):
        out = dict(block)
        vals = np.asarray(block[self.label_column])
        codes = np.searchsorted(self.classes_, vals)
        bad = (codes >= len(self.classes_)) | (self.classes_[
            np.minimum(codes, len(self.classes_) - 1)] != vals)
        if bad.any():
            raise ValueError(
                f"unseen {self.label_column!r} categories: "
                f"{sorted(set(np.asarray(vals)[bad].tolist()))[:5]}"
            )
        out[self.label_column] = codes.astype(np.int64)
        return out


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.classes_: Dict[str, np.ndarray] = {}

    def _fit(self, ds: Dataset):
        for c in self.columns:
            self.classes_[c] = np.asarray(ds.unique(c))

    def _transform_block(self, block):
        out = dict(block)
        for c in self.columns:
            classes = self.classes_[c]
            vals = np.asarray(block[c])
            codes = np.searchsorted(classes, vals)
            bad = (codes >= len(classes)) | (classes[
                np.minimum(codes, len(classes) - 1)] != vals)
            if bad.any():
                raise ValueError(
                    f"unseen {c!r} categories: "
                    f"{sorted(set(vals[bad].tolist()))[:5]}"
                )
            eye = np.eye(len(classes), dtype=np.float32)
            del out[c]
            hot = eye[codes]
            for j, cls in enumerate(classes):
                out[f"{c}_{cls}"] = hot[:, j]
        return out


class Concatenator(Preprocessor):
    """Pack multiple numeric columns into one feature matrix column
    (reference: preprocessors/concatenator.py) — the usual last stage before
    ``Dataset.iter_torch_batches``, so the train loop sees one (B, F) tensor."""

    def __init__(self, columns: List[str], output_column: str = "features",
                 dtype=np.float32):
        self.columns = columns
        self.output_column = output_column
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds: Dataset):
        pass

    def _transform_block(self, block):
        out = {k: v for k, v in block.items() if k not in self.columns}
        mats = [np.asarray(block[c], dtype=self.dtype).reshape(
            len(np.asarray(block[c])), -1) for c in self.columns]
        out[self.output_column] = np.concatenate(mats, axis=1)
        return out


class Chain(Preprocessor):
    """Apply preprocessors in sequence (reference: preprocessors/chain.py)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = stages

    def fit(self, ds: Dataset) -> "Chain":
        for st in self.stages:
            ds = st.fit_transform(ds)
        self._fitted = True
        return self

    def transform(self, ds: Dataset) -> Dataset:
        for st in self.stages:
            ds = st.transform(ds)
        return ds

    def fit_transform(self, ds: Dataset) -> Dataset:
        for st in self.stages:
            ds = st.fit_transform(ds)
        return ds
