"""Python API over the native CSV/row packer — the port of ``sparktorch_tpu/native/rowpack.py``.

Wraps the repository's unchanged ``native/rowpack.cpp``, built with g++
into ``sparktorch_tpu_torch/_build/`` by :mod:`.build`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from sparktorch_tpu_torch.native.build import load_library


def _lib():
    lib = load_library("rowpack")
    lib.rowpack_count.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
    ]
    lib.rowpack_parse.restype = ctypes.c_long
    lib.rowpack_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    return lib


def read_csv(
    path: str,
    label_col: Optional[int] = None,
    nthreads: int = 0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Parse a numeric CSV into (features float32 matrix, labels).

    The native ingestion path for MNIST-style files (the reference's
    examples load ``examples/mnist_train.csv`` through Spark's CSV
    reader and then convert row-by-row, torch_distributed.py:43-55).
    Header rows are auto-detected. ``label_col`` extracts one column
    as labels; the rest become the feature matrix.
    """
    lib = _lib()
    rows = ctypes.c_long()
    cols = ctypes.c_int()
    rc = lib.rowpack_count(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise FileNotFoundError(path)
    n, c = rows.value, cols.value
    if n == 0:
        empty_c = c - (1 if label_col is not None else 0)
        return (np.zeros((0, max(empty_c, 0)), np.float32),
                np.zeros((0,), np.float32) if label_col is not None else None)

    lc = -1 if label_col is None else int(label_col)
    feat_cols = c - (1 if lc >= 0 else 0)
    out = np.empty((n, feat_cols), np.float32)
    labels = np.empty((n,), np.float32) if lc >= 0 else None
    parsed = lib.rowpack_parse(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        c,
        lc,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if labels is not None
        else None,
        nthreads,
    )
    if parsed < 0:
        raise IOError(f"rowpack failed on {path}")
    return out, labels
