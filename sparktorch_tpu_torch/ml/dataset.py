"""A minimal columnar DataFrame for the JVM-free pipeline layer.

The reference operates on Spark DataFrames of ``(label, DenseVector)``
rows (``tests/test_sparktorch.py:21-26``). Without a JVM, the host
data structure is a plain columnar frame backed by numpy object/value
arrays — enough surface for the Estimator/Transformer contract:
column access, withColumn, take/collect, count, repartition (a
partition-count *hint* here; sharding is decided by the mesh).

Interop: ``LocalDataFrame.from_any`` accepts a dict of columns, a list
of row-dicts, a pandas DataFrame, or another LocalDataFrame.

The port's own copy of ``sparktorch_tpu/ml/dataset.py`` (which cannot
be imported without jax).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np


class LocalDataFrame:
    def __init__(self, columns: Dict[str, Any], npartitions: int = 1):
        if not columns:
            raise ValueError("LocalDataFrame needs at least one column")
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            arr = np.asarray(values, dtype=object) if _is_ragged(values) else np.asarray(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column {name!r} has {len(arr)} rows, expected {n}"
                )
            self._cols[name] = arr
        self._n = int(n or 0)
        self.npartitions = npartitions

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_any(data) -> "LocalDataFrame":
        if isinstance(data, LocalDataFrame):
            return data
        if isinstance(data, dict):
            return LocalDataFrame(data)
        if hasattr(data, "to_dict") and hasattr(data, "columns"):  # pandas
            return LocalDataFrame({c: data[c].to_numpy() for c in data.columns})
        if isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
            keys = list(data[0].keys())
            return LocalDataFrame({k: [row[k] for row in data] for k in keys})
        raise TypeError(f"cannot build LocalDataFrame from {type(data)}")

    # -- inspection ---------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def count(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def column_matrix(self, name: str, dtype=np.float32) -> np.ndarray:
        """Stack a (possibly object-array-of-vectors) column into a
        dense 2-D+ float matrix — the analog of the reference's per-row
        ``row[input_col].toArray()`` (``torch_distributed.py:43-55``),
        vectorized."""
        col = self._cols[name]
        if col.dtype == object:
            return np.stack([np.asarray(v, dtype=dtype) for v in col])
        return col.astype(dtype, copy=False)

    # -- transformation -----------------------------------------------------

    def with_column(self, name: str, values) -> "LocalDataFrame":
        cols = dict(self._cols)
        arr = np.asarray(values, dtype=object) if _is_ragged(values) else np.asarray(values)
        if len(arr) != self._n:
            raise ValueError(f"column {name!r}: {len(arr)} rows != {self._n}")
        cols[name] = arr
        return LocalDataFrame(cols, self.npartitions)

    withColumn = with_column  # Spark spelling

    def select(self, *names: str) -> "LocalDataFrame":
        return LocalDataFrame({n: self._cols[n] for n in names}, self.npartitions)

    def repartition(self, n: int) -> "LocalDataFrame":
        return LocalDataFrame(dict(self._cols), npartitions=n)

    # -- row access ---------------------------------------------------------

    def take(self, n: int) -> List[dict]:
        n = min(n, self._n)
        return [
            {name: col[i] for name, col in self._cols.items()} for i in range(n)
        ]

    def collect(self) -> List[dict]:
        return self.take(self._n)

    def iter_rows(self) -> Iterable[dict]:
        for i in range(self._n):
            yield {name: col[i] for name, col in self._cols.items()}


def _is_ragged(values) -> bool:
    if isinstance(values, np.ndarray):
        return values.dtype == object
    try:
        first = values[0]
    except (IndexError, TypeError, KeyError):
        return False
    if np.isscalar(first) or isinstance(first, (int, float, np.number)):
        return False
    try:
        shapes = {np.asarray(v).shape for v in values}
        return len(shapes) > 1
    except Exception:
        return True
