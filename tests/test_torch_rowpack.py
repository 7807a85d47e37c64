"""The port's native CSV packer (``sparktorch_tpu_torch.native.rowpack``) against the JAX package's.

Both wrap the repository's unchanged ``native/rowpack.cpp``; the port
builds its own copy into ``sparktorch_tpu_torch/_build/``. Each case of
``tests/test_native.py`` is read by both packages and the arrays must be
equal.
"""

import numpy as np
import pytest

from sparktorch_tpu_torch.native.rowpack import read_csv


def _labelled(path):
    rng = np.random.default_rng(0)
    data = rng.normal(0, 1, (500, 10)).astype(np.float32).round(4)
    labels = rng.integers(0, 10, (500,))
    with open(path, "w") as f:
        f.write("label," + ",".join(f"f{i}" for i in range(10)) + "\n")
        for i in range(500):
            f.write(f"{labels[i]}," + ",".join(f"{v}" for v in data[i]) + "\n")
    return dict(label_col=0, nthreads=4)


def _plain(path):
    with open(path, "w") as f:
        for i in range(10):
            f.write(",".join(str(float(i * 10 + j)) for j in range(4)) + "\n")
    return {}


def _gaps(path):
    rows = [[float(i * 10 + j) for j in range(4)] for i in range(12)]
    with open(path, "w") as f:
        f.write("a,b,c,d\n")
        for i, r in enumerate(rows):
            f.write(",".join(str(v) for v in r) + "\n")
            if i in (2, 3, 7):
                f.write("\n")
            if i == 5:
                f.write("\r\n")
    return dict(nthreads=4)


def _short(path):
    with open(path, "w") as f:
        f.write("1.0,2.0,3.0,4.0\n5.0,6.0\n7.0,8.0,9.0,10.0\n")
    return {}


def _no_newline(path):
    with open(path, "w") as f:
        f.write("1.0,2.0\n3.0,4.0")
    return {}


def _header_only(path):
    with open(path, "w") as f:
        f.write("label,a,b\n")
    return dict(label_col=0)


@pytest.mark.parametrize("write", [_labelled, _plain, _gaps, _short,
                                   _no_newline, _header_only])
def test_read_csv_equals_the_jax_package(tmp_path, write):
    from sparktorch_tpu.native.rowpack import read_csv as jax_read_csv

    path = str(tmp_path / "data.csv")
    kw = write(path)
    x, y = read_csv(path, **kw)
    want_x, want_y = jax_read_csv(path, **kw)
    assert x.dtype == want_x.dtype == np.float32
    np.testing.assert_array_equal(x, want_x)
    if want_y is None:
        assert y is None
    else:
        np.testing.assert_array_equal(y, want_y)


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        read_csv("/nonexistent/file.csv")
