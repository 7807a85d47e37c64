"""The port's Spark adapter (``sparktorch_tpu_torch.spark.torch_distributed``) on the localspark runtime, against the JAX package.

Executor tasks run in separate processes (``python -m
sparktorch_tpu_torch.spark._executor``), so the hogwild HTTP wire and
the gloo world of ``setMesh`` are real. Both packages start from the
same Flax weights (``convert.state_dict_from_flax``). The port's pyspark
shim is swapped in for this module and the modules that were there are
put back afterwards (the JAX adapter's test module installs the JAX
shim at collection); each spawned task is limited to 120 s. Executors
import this module to unpickle its closures, so jax is imported inside
the test functions only.
"""

import contextlib
import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

import sparktorch_tpu_torch as port
from sparktorch_tpu_torch.ml.estimator import _encode_bundle
from sparktorch_tpu_torch.models import simple
from sparktorch_tpu_torch.spark import localsession
from sparktorch_tpu_torch.utils.serde import deserialize_model

FEATURES, CLASSES, ROWS = 12, 3, 48
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparktorch_tpu")


@contextlib.contextmanager
def _shim(install):
    """Run a block with the shim that ``install`` registers as
    ``pyspark``, then put back the ``pyspark*`` modules that were there."""
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


def _jax_install():
    from sparktorch_tpu.spark import localsession as jax_localsession

    return jax_localsession.install()


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


def _data(n=ROWS, seed=1):
    """Normal rows with 3 added to the feature that names their class,
    so a few steps learn."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, CLASSES, n)
    x = rng.standard_normal((n, FEATURES)).astype(np.float32)
    x[np.arange(n), y] += 3.0
    return x, y


def _frame(spark, x, y):
    rows = [(float(y[i]), localsession.DenseVector(x[i])) for i in range(len(x))]
    return spark.createDataFrame(rows, ["label", "features"])


def _pair(kind="mlp", optimizer="sgd", lr=0.1):
    """(JAX payload, port payload, port module, Flax variables) from the
    JAX init for key 0."""
    import jax
    import jax.numpy as jnp
    import sparktorch_tpu as jax_pkg
    from sparktorch_tpu.models import simple as jax_simple

    from sparktorch_tpu_torch.convert import state_dict_from_flax

    if kind == "mlp":
        jax_model = jax_simple.MnistMLP(hidden=(16,), n_classes=CLASSES)
        model = simple.MnistMLP(hidden=(16,), n_classes=CLASSES,
                                in_features=FEATURES)
    else:
        jax_model, model = jax_simple.Net(), simple.Net(in_features=FEATURES)
    variables = jax.device_get(jax_model.init(jax.random.key(0),
                                              jnp.zeros((1, FEATURES))))
    model.load_state_dict(state_dict_from_flax(variables, model))
    kw = dict(criterion="cross_entropy" if kind == "mlp" else "mse",
              optimizer=optimizer, optimizer_params={"lr": lr},
              input_shape=(FEATURES,))
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(model, **kw), model, variables)


def _port_obj():
    torch.manual_seed(0)
    return port.serialize_torch_obj(
        simple.MnistMLP(hidden=(16,), n_classes=CLASSES, in_features=FEATURES),
        criterion="cross_entropy", optimizer="sgd",
        optimizer_params={"lr": 0.1}, input_shape=(FEATURES,))


def _estimator(obj, **kw):
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    return SparkTorch(inputCol="features", labelCol="label", torchObj=obj,
                      device="cpu", **kw)


@pytest.mark.parametrize("mode", ["synchronous", "hogwild"])
def test_driver_mode_equals_the_estimator_fit(spark, mode):
    x, y = _data()
    obj = _port_obj()
    est = _estimator(obj, iters=4, mode=mode)
    model = est.fit(_frame(spark, x, y))
    plain = port.SparkTorch(inputCol="features", labelCol="label",
                            torchObj=obj, iters=4, mode=mode, device="cpu")
    fitted = plain.fit({"features": list(x), "label": y.astype(np.float32)})
    assert ([r["loss"] for r in est._last_metrics]
            == [r["loss"] for r in plain._last_metrics])
    want = fitted.getModel().params
    got = model.getPytorchModel()["params"]
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("kind,vector", [("net", False), ("mlp", False),
                                         ("mlp", True)])
def test_transform_matches_the_jax_spark_model(spark, kind, vector):
    # The float column (one output), the argmax column and the raw
    # output vectors, each from the same Flax weights.
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorchModel

    jax_obj, obj, model, variables = _pair(kind)
    x, y = _data(n=37)
    with _shim(_jax_install):
        from sparktorch_tpu.ml.estimator import _encode_bundle as jax_encode
        from sparktorch_tpu.spark import localsession as jax_localsession
        from sparktorch_tpu.spark.torch_distributed import (
            SparkTorchModel as JaxSparkTorchModel,
        )
        from sparktorch_tpu.utils.serde import (
            deserialize_model as jax_deserialize,
        )

        jax_spark = jax_localsession.SparkSession.builder.getOrCreate()
        jax_rows = [(float(y[i]), jax_localsession.DenseVector(x[i]))
                    for i in range(len(x))]
        jax_frame = jax_spark.createDataFrame(jax_rows, ["label", "features"])
        params = dict(variables)
        jax_model = JaxSparkTorchModel(
            inputCol="features", useVectorOut=vector,
            modStr=jax_encode(jax_deserialize(jax_obj), params.pop("params"),
                              params))
        want = [r["predictions"] for r in jax_model.transform(jax_frame).collect()]
        jax_spark.stop()
    stm = SparkTorchModel(
        inputCol="features", useVectorOut=vector, device="cpu",
        modStr=_encode_bundle(deserialize_model(obj), model.state_dict()))
    got = [r["predictions"] for r in stm.transform(_frame(spark, x, y)).collect()]
    assert len(got) == len(want) == 37
    if vector:
        assert all(len(v) == CLASSES for v in got)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    elif kind == "mlp":
        assert set(got) <= set(range(CLASSES))
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _mesh_predict(port_no, obj, state, x, chunk):
    """On every rank of a gloo world of 2: a sharded BatchPredictor and a
    SparkTorchModel.setMesh transform of all of ``x``."""

    def run(iterator):
        import torch.distributed as dist
        from pyspark import BarrierTaskContext

        from sparktorch_tpu_torch.inference import BatchPredictor
        from sparktorch_tpu_torch.ml.estimator import SparkTorchModel
        from sparktorch_tpu_torch.parallel.mesh import build_mesh

        list(iterator)
        rank = BarrierTaskContext.get().partitionId()
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_no}",
                                rank=rank, world_size=2)
        try:
            mesh = build_mesh()
            module = deserialize_model(obj).make_module()
            predictor = BatchPredictor(module, state, device="cpu",
                                       chunk=chunk, mesh=mesh)
            stm = SparkTorchModel(inputCol="features", modStr=_encode_bundle(
                deserialize_model(obj), state))
            stm.setDevice("cpu").setMesh(mesh)
            out = {"rank": rank, "chunk": predictor.chunk,
                   "rows": predictor.predict(x),
                   "few": predictor.predict(x[:3]),
                   "none": predictor.predict(x[:0]),
                   "argmax": stm.transform({"features": list(x)})["predictions"]}
        finally:
            dist.destroy_process_group()
        yield out

    return run


def test_set_mesh_over_a_gloo_world_of_two_matches_the_jax_sharded_predictor(spark):
    import jax
    from sparktorch_tpu.inference import BatchPredictor as JaxBatchPredictor
    from sparktorch_tpu.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu.utils.serde import deserialize_model as jax_deserialize

    from sparktorch_tpu_torch.spark.torch_distributed import _free_port

    jax_obj, obj, model, variables = _pair("mlp")
    x, y = _data(n=13)
    params = dict(variables)
    jax_module = jax_deserialize(jax_obj).make_module()
    mesh = build_mesh(MeshConfig(), jax.devices()[:2])
    jax_pred = JaxBatchPredictor(jax_module, params.pop("params"), params,
                                 mesh=mesh, chunk=5)
    assert jax_pred.chunk == 6
    want, want_few = jax_pred.predict(x), jax_pred.predict(x[:3])

    rdd = _frame(spark, x[:2], y[:2]).rdd.repartition(2).barrier()
    out = rdd.mapPartitions(_mesh_predict(_free_port(), obj, model.state_dict(),
                                          x, 5)).collect()
    assert [o["rank"] for o in out] == [0, 1]
    plain = port.BatchPredictor(model, device="cpu").predict(x)
    for o in out:
        # 13 rows in chunks of 6 (5 rounded up to the world), the last
        # padded; 3 rows as one chunk padded to 4; every rank gets all.
        assert o["chunk"] == 6
        np.testing.assert_allclose(o["rows"], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(o["few"], want_few, atol=1e-5, rtol=1e-5)
        assert o["none"].shape == (0, CLASSES)
        np.testing.assert_array_equal(o["argmax"], plain.argmax(1))


def test_hogwild_executors_one_worker_match_jax_train_async(spark):
    # The executor path with one partition, full batch and f32 pushes
    # (compress=False) is the JAX package's one-worker train_async: each
    # POST /update.bin returns after its apply, so every pull sees the
    # worker's own last push, as the local transport's waited push does;
    # the rows' order (train_async shuffles them) moves only the
    # summation order of the full-batch mean.
    import jax
    from sparktorch_tpu.train.hogwild import train_async as jax_train_async

    from sparktorch_tpu_torch.convert import state_dict_from_flax

    jax_obj, obj, model, _ = _pair("mlp")
    x, y = _data()
    want = jax_train_async(jax_obj, x, labels=y, iters=5, partitions=1)
    est = _estimator(obj, iters=5, mode="hogwild", deployMode="barrier",
                     partitions=1, compress=False)
    fitted = est.fit(_frame(spark, x, y))
    (summary,) = est._last_hogwild_summaries
    assert summary["versions"] == list(range(5))
    assert summary["pushes"] == est._last_hogwild_applied == 5
    np.testing.assert_allclose(summary["losses"],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(
        {"params": jax.device_get(want.params),
         **jax.device_get(want.model_state)}, model)
    got = fitted.getPytorchModel()["params"]
    assert list(got) == list(model.state_dict())
    for key, value in got.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


def test_hogwild_executors_two_workers_push_windows(spark):
    x, y = _data(n=64)
    est = _estimator(_port_obj(), iters=8, mode="hogwild",
                     deployMode="barrier", partitions=2, pushEvery=2)
    fitted = est.fit(_frame(spark, x, y))
    summaries = est._last_hogwild_summaries
    assert len(summaries) == 2
    assert summaries[0]["worker"] != summaries[1]["worker"]
    # 8 iterations in windows of 2: 4 pushes a worker, each applied.
    assert [s["pushes"] for s in summaries] == [4, 4]
    assert est._last_hogwild_applied == 8
    for s in summaries:
        losses = s["losses"]
        assert len(losses) == 8 and np.isfinite(losses).all()
        assert np.mean(losses[-2:]) < np.mean(losses[:2])
    preds = np.asarray([r["predictions"] for r in
                        fitted.transform(_frame(spark, x, y)).collect()])
    assert np.mean(preds == y) > 0.8


def test_run_hogwild_worker_against_the_server(tmp_path):
    # One worker process's loop against a server over HTTP equals the
    # in-process one-worker train_async (full batch, f32 pushes).
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )
    from sparktorch_tpu_torch.train.hogwild import (
        run_hogwild_worker,
        train_async,
    )

    x, y = _data()
    obj = _port_obj()
    want = train_async(obj, x, labels=y, iters=4, partitions=1, device="cpu")
    np.savez(tmp_path / "shard.npz", x=x, y=y)
    server = ParameterServer(obj, window_len=1, device="cpu")
    http = ParamServerHttp(server).start()
    records = tmp_path / "records.jsonl"
    try:
        out = run_hogwild_worker(obj, http.url, str(tmp_path / "shard.npz"),
                                 iters=4, compress=False,
                                 records_path=str(records), device="cpu")
        params, _ = server.final_state()
    finally:
        http.stop()
        server.stop()
    assert out["records"] == 4 and server.applied_updates == 4
    lines = [json.loads(line) for line in records.read_text().splitlines()]
    assert [r["iter"] for r in lines] == [0, 1, 2, 3]
    assert [r["version"] for r in lines] == [0, 1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in lines],
                               [r["loss"] for r in want.metrics],
                               atol=1e-6, rtol=1e-6)
    assert out["final_loss"] == lines[-1]["loss"]
    assert not list(tmp_path.glob(".hogwild_records.*"))
    for key, value in params.items():
        np.testing.assert_allclose(value.numpy(), want.params[key].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=key)
    # ctx.telemetry is ported (tests/test_torch_obs_hooks.py); the
    # heartbeat and cancel contexts wait for the ft supervisor.
    for ctx in (types.SimpleNamespace(heartbeat=object()),
                types.SimpleNamespace(cancel=threading.Event())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_hogwild_worker(obj, "http://127.0.0.1:1", (x, y), ctx=ctx,
                               device="cpu")


def test_supervise_raises(spark):
    x, y = _data(n=4)
    est = _estimator(_port_obj(), deployMode="barrier", supervise=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        est.fit(_frame(spark, x, y))


def test_an_executor_imports_no_jax(spark):
    def probe(iterator):
        import sys

        import sparktorch_tpu_torch.spark.torch_distributed  # noqa: F401
        import sparktorch_tpu_torch.train.hogwild  # noqa: F401
        import sparktorch_tpu_torch.train.sync  # noqa: F401

        list(iterator)
        yield sorted(m for m in sys.modules
                     if m.split(".")[0] in FORBIDDEN)

    x, y = _data(n=4)
    out = _frame(spark, x, y).rdd.repartition(2).barrier().mapPartitions(
        probe).collect()
    assert out == [[], []]
