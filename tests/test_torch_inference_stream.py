"""Batch inference beyond ``predict``: on-device pre/postprocessing,
device-resident inputs, ``predict_device``, ``predict_stream``,
``update_params`` and Parquet streaming, in the port and the JAX package.

A small MLP serves the same weights in both (the Flax variables carried
across with ``convert.state_dict_from_flax``). The Parquet files are
interchangeable: each package streams the file the other wrote.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
from sparktorch_tpu import inference as jax_inference
from sparktorch_tpu.models import simple as jax_simple
from sparktorch_tpu_torch import BatchPredictor
from sparktorch_tpu_torch import inference
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import simple as torch_simple

TOL = 1e-5  # f32 on both sides


def _same_rows(got, want):
    """Rows computed in batches of other sizes: f32 summation order only
    (tests/test_inference.py's tolerance)."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _mlp(seed):
    jax_model = jax_simple.MnistMLP(hidden=(16,), n_classes=4)
    variables = jax.device_get(
        jax_model.init(jax.random.key(seed), np.zeros((1, 10), np.float32)))
    module = torch_simple.MnistMLP(hidden=(16,), n_classes=4, in_features=10)
    module.load_state_dict(state_dict_from_flax(variables, module))
    return jax_model, variables["params"], module


@pytest.fixture(scope="module")
def served():
    return _mlp(0)


@pytest.fixture(scope="module")
def raw():
    return np.random.default_rng(1).integers(0, 256, (500, 10),
                                             dtype=np.uint8)


def _port(module, **kw):
    return BatchPredictor(module, device="cpu", **kw)


def test_uint8_preprocess_and_argmax_postprocess_match_jax(served, raw):
    jax_model, params, module = served
    want = jax_pkg.BatchPredictor(
        jax_model, params, chunk=128,
        preprocess=lambda x: x.astype(jnp.float32) / 255.0).predict(raw)
    got = _port(module, chunk=128,
                preprocess=lambda x: x.float() / 255).predict(raw)
    assert got.dtype == np.float32 and got.shape == (500, 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    want_cls = jax_pkg.BatchPredictor(
        jax_model, params, chunk=128,
        preprocess=lambda x: x.astype(jnp.float32) / 255.0,
        postprocess=lambda y: jnp.argmax(y, -1).astype(jnp.int32),
    ).predict(raw)
    cls = _port(module, chunk=128, preprocess=lambda x: x.float() / 255,
                postprocess=lambda y: y.argmax(-1)).predict(raw)
    np.testing.assert_array_equal(cls, np.asarray(want_cls))
    np.testing.assert_array_equal(cls, got.argmax(-1))


def test_device_resident_input_equals_numpy_path(served):
    # On the CPU predictor a CPU tensor is the device-resident input.
    *_, module = served
    pred = _port(module, chunk=64)
    x = np.random.default_rng(2).normal(0, 1, (200, 10)).astype(np.float32)
    want = pred.predict(x)
    np.testing.assert_array_equal(pred.predict(torch.from_numpy(x)), want)
    assert pred.predict(torch.from_numpy(x[:0])).shape == (0, 4)


@pytest.mark.parametrize("in_flight", [1, 3])
def test_predict_device_returns_one_device_tensor(served, raw, in_flight):
    *_, module = served
    pred = _port(module, chunk=96, preprocess=lambda x: x.float() / 255)
    out = pred.predict_device(raw, in_flight=in_flight)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), pred.predict(raw))
    assert pred.predict_device(raw[:0]).shape == (0, 4)
    one = pred.predict_device(raw[:7])
    _same_rows(one.numpy(), pred.predict(raw)[:7])


def test_predict_stream_yields_per_batch(served, raw):
    *_, module = served
    pred = _port(module, chunk=64, preprocess=lambda x: x.float() / 255)
    batches = [raw[:100], raw[100:101], raw[101:300]]
    outs = list(pred.predict_stream(iter(batches)))
    assert [o.shape[0] for o in outs] == [100, 1, 199]
    _same_rows(np.concatenate(outs), pred.predict(raw[:300]))


def test_update_params_swaps_whole_weights(served, raw):
    *_, module = served
    _, _, other = _mlp(3)
    x = raw.astype(np.float32) / 255
    pred = _port(module, chunk=64)
    old = pred.predict(x)
    new = _port(other, chunk=64).predict(x)
    assert not np.allclose(old, new)
    before = pred.module
    pred.update_params(other.state_dict())
    assert pred.module is not before  # a fresh copy, installed whole
    np.testing.assert_array_equal(pred.predict(x), new)
    # A predict racing the swaps serves the old or the new weights whole.
    pred.update_params(module.state_dict())
    outs, stop = [], threading.Event()

    def serve():
        while not stop.is_set():
            outs.append(pred.predict(x[:64]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=serve)
    try:
        t.start()
        for i in range(20):
            pred.update_params((other if i % 2 == 0 else module).state_dict())
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not t.is_alive() and outs
    for out in outs:
        assert (np.array_equal(out, old[:64])
                or np.array_equal(out, new[:64]))


def _write_both(tmp_path, raw):
    ours, theirs = str(tmp_path / "port.parquet"), str(tmp_path / "jax.parquet")
    assert inference.write_rows_parquet(ours, [raw[:300], raw[300:]],
                                        rows_per_group=64) == 500
    assert jax_inference.write_rows_parquet(theirs, [raw[:300], raw[300:]],
                                            rows_per_group=64) == 500
    return ours, theirs


def test_parquet_files_cross_between_packages(tmp_path, served, raw):
    jax_model, params, module = served
    ours, theirs = _write_both(tmp_path, raw)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    jax_pred = jax_pkg.BatchPredictor(
        jax_model, params, chunk=96,
        preprocess=lambda x: x.astype(jnp.float32) / 255.0)
    pred = _port(module, chunk=96, preprocess=lambda x: x.float() / 255)
    want = pred.predict(raw)
    # The JAX package streams the port's file ...
    outs = []
    stats = jax_inference.stream_parquet_predict(
        jax_pred, ours, row_shape=(10,), batch_rows=64, drain=outs.append)
    assert stats["n_rows"] == 500
    np.testing.assert_allclose(np.concatenate(outs), want, atol=TOL, rtol=TOL)
    # ... and the port streams the JAX package's, with the same stats.
    outs = []
    stats = inference.stream_parquet_predict(
        pred, theirs, row_shape=(10,), batch_rows=64, drain=outs.append)
    assert set(stats) == {"n_rows", "n_batches", "wall_s", "rows_per_sec",
                          "read_busy_s", "predict_busy_s", "overlap_factor"}
    assert stats["n_rows"] == 500 and stats["n_batches"] == 8
    assert stats["rows_per_sec"] > 0
    _same_rows(np.concatenate(outs), want)
    # device_outputs: the drain gets device tensors, nothing read back.
    outs = []
    inference.stream_parquet_predict(pred, theirs, row_shape=(10,),
                                     device_outputs=True, drain=outs.append)
    assert all(isinstance(o, torch.Tensor) for o in outs)
    _same_rows(torch.cat(outs).numpy(), want)


# tests/test_inference.py's windows: mid-batch skip and limit (64-row
# groups; 100 and 137 land inside a batch), whole-batch skip, zero
# limit, over-read.
@pytest.mark.parametrize("skip,limit", [
    (0, 137), (100, 137), (128, 64), (499, 10), (0, None), (500, None),
    (77, 0),
])
def test_parquet_skip_and_limit_windows(tmp_path, served, raw, skip, limit):
    *_, module = served
    path, _ = _write_both(tmp_path, raw)
    pred = _port(module, chunk=96, preprocess=lambda x: x.float() / 255)
    want = pred.predict(raw)
    outs = []
    stats = inference.stream_parquet_predict(
        pred, path, row_shape=(10,), batch_rows=64, drain=outs.append,
        skip_rows=skip, max_rows=limit)
    got = np.concatenate(outs) if outs else np.zeros((0, 4), np.float32)
    end = 500 if limit is None else min(500, skip + limit)
    assert stats["n_rows"] == got.shape[0] == end - min(skip, 500)
    _same_rows(got, want[skip:end])


def test_parquet_windows_stitch_to_the_whole_run(tmp_path, served, raw):
    *_, module = served
    path, _ = _write_both(tmp_path, raw)
    pred = _port(module, chunk=96, preprocess=lambda x: x.float() / 255)
    parts = []
    for skip, limit in [(0, 190), (190, 190), (380, None)]:
        inference.stream_parquet_predict(
            pred, path, row_shape=(10,), batch_rows=64, drain=parts.append,
            skip_rows=skip, max_rows=limit)
    _same_rows(np.concatenate(parts), pred.predict(raw))


def test_reader_errors_surface(tmp_path, served, raw):
    *_, module = served
    pred = _port(module, chunk=64, preprocess=lambda x: x.float() / 255)
    with pytest.raises(FileNotFoundError):
        inference.stream_parquet_predict(pred, str(tmp_path / "none.parquet"),
                                         row_shape=(10,))

    def broken():
        yield raw[:64]
        raise ValueError("torn row group")

    seen = []
    with pytest.raises(ValueError, match="torn row group"):
        inference._stream_predict(pred, broken(), drain=seen.append)
    assert len(seen) == 1

