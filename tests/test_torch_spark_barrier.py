"""The port's barrier deploy mode (``SparkTorch(deployMode="barrier")``) over gloo worlds of executor processes, against the JAX package's N-device mesh.

Each barrier task is a separate process (``python -m
sparktorch_tpu_torch.spark._executor``) that joins the native gang on
the driver, then a gloo process group on a port the driver picked, and
trains its partition with ``train_distributed_multihost``. The JAX
package trains the concatenated rows with ``train_distributed`` on
``build_mesh(MeshConfig(), jax.devices()[:N])`` from the same Flax
weights; both full batch. The world of 3 has two rows, so one partition
is empty and its task still enters every collective. The port's pyspark
shim is swapped in for this module (see ``test_torch_spark_adapter.py``),
and each spawned task is limited to 120 s.
"""

import contextlib
import functools
import sys

import numpy as np
import pytest
import torch

import sparktorch_tpu_torch as port
from sparktorch_tpu_torch.models import simple
from sparktorch_tpu_torch.spark import localsession

FEATURES, CLASSES = 12, 3
ITERS = 4
# world: rows of the frame (the localspark split of 2 rows over 3
# partitions leaves the first empty).
ROWS = {2: 48, 3: 2}


@contextlib.contextmanager
def _shim(install):
    saved = localsession.pyspark_entries()
    for name in saved:
        del sys.modules[name]
    try:
        assert install()
        yield
    finally:
        for name in localsession.pyspark_entries():
            del sys.modules[name]
        sys.modules.update(saved)


@pytest.fixture(scope="module", autouse=True)
def port_shim():
    timeout = localsession._EXECUTOR_TIMEOUT_S
    localsession._EXECUTOR_TIMEOUT_S = 120.0
    try:
        with _shim(localsession.install):
            yield
    finally:
        localsession._EXECUTOR_TIMEOUT_S = timeout


@pytest.fixture(scope="module")
def spark(port_shim):
    s = localsession.SparkSession.builder.master("local[2]").getOrCreate()
    yield s
    s.stop()


def _data(n, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, CLASSES, n)
    x = rng.standard_normal((n, FEATURES)).astype(np.float32)
    x[np.arange(n), y] += 3.0
    return x, y


@functools.lru_cache(maxsize=None)
def _pair(optimizer, lr):
    """(JAX payload, port payload, port module) from the JAX init for
    key 0."""
    import jax
    import jax.numpy as jnp
    import sparktorch_tpu as jax_pkg
    from sparktorch_tpu.models import simple as jax_simple

    from sparktorch_tpu_torch.convert import state_dict_from_flax

    jax_model = jax_simple.MnistMLP(hidden=(16,), n_classes=CLASSES)
    model = simple.MnistMLP(hidden=(16,), n_classes=CLASSES,
                            in_features=FEATURES)
    variables = jax.device_get(jax_model.init(jax.random.key(0),
                                              jnp.zeros((1, FEATURES))))
    model.load_state_dict(state_dict_from_flax(variables, model))
    kw = dict(criterion="cross_entropy", optimizer=optimizer,
              optimizer_params={"lr": lr}, input_shape=(FEATURES,))
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(model, **kw), model)


def _barrier_fit(spark, obj, x, y, world):
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    rows = [(float(y[i]), localsession.DenseVector(x[i])) for i in range(len(x))]
    frame = spark.createDataFrame(rows, ["label", "features"])
    est = SparkTorch(inputCol="features", labelCol="label", torchObj=obj,
                     iters=ITERS, device="cpu", deployMode="barrier",
                     partitions=world)
    model = est.fit(frame)
    return est._last_metrics, model.getPytorchModel()["params"], model, frame


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("optimizer,lr,tol", [("sgd", 0.1, 1e-5),
                                              ("adam", 1e-2, 1e-4)])
def test_barrier_fit_matches_the_jax_mesh(spark, world, optimizer, lr, tol):
    import jax
    from sparktorch_tpu.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu.train.sync import train_distributed

    from sparktorch_tpu_torch.convert import state_dict_from_flax

    jax_obj, obj, model = _pair(optimizer, lr)
    x, y = _data(ROWS[world])
    metrics, params, fitted, frame = _barrier_fit(spark, obj, x, y, world)
    want = train_distributed(jax_obj, x, labels=y, iters=ITERS, seed=0,
                             mesh=build_mesh(MeshConfig(),
                                             jax.devices()[:world]))
    assert len(metrics) == len(want.metrics) == ITERS
    for key in ("loss", "grad_norm", "examples"):
        np.testing.assert_allclose([m[key] for m in metrics],
                                   [m[key] for m in want.metrics],
                                   atol=tol, rtol=tol, err_msg=key)
    expected = state_dict_from_flax(
        {"params": want.params, **jax.device_get(want.model_state)}, model)
    assert set(params) == set(expected)
    for key, value in params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=tol, rtol=tol, err_msg=key)
    preds = [r["predictions"] for r in fitted.transform(frame).collect()]
    assert len(preds) == len(x) and set(preds) <= set(range(CLASSES))


def test_barrier_world_of_one_equals_the_estimator_fit(spark):
    # One executor process, no process group: the fit equals the
    # in-process estimator's bit for bit.
    _, obj, _ = _pair("adam", 1e-2)
    x, y = _data(40)
    metrics, params, _, _ = _barrier_fit(spark, obj, x, y, 1)
    plain = port.SparkTorch(inputCol="features", labelCol="label",
                            torchObj=obj, iters=ITERS, device="cpu")
    want = plain.fit({"features": list(x),
                      "label": y.astype(np.float32)}).getModel().params
    assert [m["loss"] for m in metrics] == [
        m["loss"] for m in plain._last_metrics]
    for key, value in want.items():
        assert torch.equal(params[key], value), key
