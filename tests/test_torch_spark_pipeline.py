"""The carrier format and pipeline persistence of the port's ``spark/`` tier, against the JAX package's.

The port's pyspark shim (``sparktorch_tpu_torch.spark.localsession``)
and the JAX package's share the module names ``pyspark*``: the JAX
adapter's test module installs its shim when it is collected. So every
test here runs with the port's shim swapped in by a module-scoped
fixture, which puts back what was there afterwards; JAX-side parity runs
with the JAX shim swapped in the same way (``_shim``).
"""

import contextlib
import os
import subprocess
import sys
import zlib
from pathlib import Path

import dill
import numpy as np
import pytest
import torch

import sparktorch_tpu_torch as port
from sparktorch_tpu_torch.ml.estimator import _encode_bundle
from sparktorch_tpu_torch.models import simple
from sparktorch_tpu_torch.spark import localsession
from sparktorch_tpu_torch.utils.serde import deserialize_model

REPO = Path(__file__).resolve().parent.parent


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
    with _shim(localsession.install):
        yield


@pytest.fixture(scope="module")
def spark(port_shim):
    s = localsession.SparkSession.builder.master("local[2]").getOrCreate()
    yield s
    s.stop()


@pytest.fixture(scope="module")
def frame(spark):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (40, 12))
    y = rng.integers(0, 3, 40)
    rows = [(float(y[i]), localsession.DenseVector(x[i])) for i in range(40)]
    return spark.createDataFrame(rows, ["label", "features"])


def _estimator(iters=3, **kw):
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    torch.manual_seed(0)
    obj = port.serialize_torch_obj(
        simple.MnistMLP(hidden=(16,), n_classes=3, in_features=12),
        criterion="cross_entropy", optimizer="sgd",
        optimizer_params={"lr": 0.1}, input_shape=(12,))
    return SparkTorch(inputCol="features", labelCol="label", torchObj=obj,
                      iters=iters, device="cpu", **kw)


def _predictions(model, frame):
    return np.asarray([r["predictions"] for r in model.transform(frame).collect()])


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": [1.5, "x"]},
    b"\x00\x01\xff" * 300,
    np.arange(1000, dtype=np.float32),
])
def test_payload_strings_match_the_jax_carrier_byte_for_byte(obj):
    from sparktorch_tpu_torch.spark import pipeline_util

    with _shim(_jax_install):
        from sparktorch_tpu.spark import pipeline_util as jax_pipeline_util

        want = jax_pipeline_util._payload_strings(obj)
    got = pipeline_util._payload_strings(obj)
    assert got[1] == want[1] == pipeline_util.CARRIER_GUID
    assert got[0].endswith(",")
    assert got[0].encode() == want[0].encode()
    payload = zlib.compress(dill.dumps(obj))
    assert pipeline_util._decimal_bytes(got[0]) == payload
    # The reference's reader: split(',')[0:-1].
    assert bytes(int(t) for t in got[0].split(",")[0:-1]) == payload


def test_multi_block_payloads_are_one_zlib_stream_the_jax_reader_inflates(
        monkeypatch):
    # A payload of several blocks is deflated, rendered and parsed block
    # by block on threads: one zlib stream in the reference's decimal
    # rendering, which the JAX package's reader decodes.
    from sparktorch_tpu_torch.spark import pipeline_util

    monkeypatch.setattr(pipeline_util, "_BLOCK", 1000)
    obj = np.random.default_rng(3).standard_normal(5000)
    words = pipeline_util._payload_strings(obj)
    payload = pipeline_util._decimal_bytes(words[0])
    assert len(payload) > 4 * pipeline_util._BLOCK
    assert words[0] == "".join(f"{b}," for b in payload)
    assert payload == pipeline_util._compress(dill.dumps(obj))
    assert zlib.decompress(payload) == dill.dumps(obj)
    carrier = localsession.StopWordsRemover(inputCol="u", outputCol="u_out")
    carrier.setStopWords(words)
    np.testing.assert_array_equal(
        pipeline_util.decode_carrier_stage(carrier), obj)
    with _shim(_jax_install):
        from sparktorch_tpu.spark import pipeline_util as jax_pipeline_util

        np.testing.assert_array_equal(
            jax_pipeline_util.decode_carrier_stage(carrier), obj)


@pytest.mark.parametrize("size", [0, 1, 999, 1000, 1001, 4000])
def test_compress_of_one_block_is_zlib_compress(monkeypatch, size):
    # Up to one block the stream is zlib.compress's, byte for byte; past
    # it, a stream that zlib.decompress reads back.
    from sparktorch_tpu_torch.spark import pipeline_util

    monkeypatch.setattr(pipeline_util, "_BLOCK", 1000)
    data = np.random.default_rng(size).integers(0, 8, size, np.uint8).tobytes()
    got = pipeline_util._compress(data)
    assert zlib.decompress(got) == data
    assert (got == zlib.compress(data)) == (size <= 1000)


def test_decimal_parse_rejects_what_is_not_decimal_bytes():
    from sparktorch_tpu_torch.spark.pipeline_util import _decimal_bytes

    assert _decimal_bytes("1,22,255,") == bytes([1, 22, 255])
    assert _decimal_bytes("1,22,255") == bytes([1, 22, 255])
    assert _decimal_bytes("") == b""
    for bad in ("256,", "1,2x,", "1234,", "-1,", "7,,8", "1.5,"):
        with pytest.raises(ValueError):
            _decimal_bytes(bad)


def test_jax_carrier_loads_in_the_port(tmp_path):
    # A carrier stage written by the JAX package's encoder (the
    # reference's file format) decodes with the port's reader.
    from sparktorch_tpu_torch.spark.pipeline_util import (
        decode_carrier_stage,
        is_carrier,
    )

    with _shim(_jax_install):
        from sparktorch_tpu.spark import pipeline_util as jax_pipeline_util

        words = jax_pipeline_util._payload_strings({"stage": [1, 2, 3]})
    carrier = localsession.StopWordsRemover(inputCol="u", outputCol="u_out")
    carrier.setStopWords(words)
    assert is_carrier(carrier)
    assert decode_carrier_stage(carrier) == {"stage": [1, 2, 3]}


def test_direct_stage_write_read_load(frame, tmp_path):
    from sparktorch_tpu_torch.spark.torch_distributed import (
        SparkTorch,
        SparkTorchModel,
    )

    est = _estimator(iters=4)
    epath = str(tmp_path / "est")
    est.write().overwrite().save(epath)
    loaded_est = SparkTorch.load(epath)
    assert isinstance(loaded_est, SparkTorch)
    assert loaded_est.getOrDefault(loaded_est.iters) == 4
    assert loaded_est.getOrDefault(loaded_est.device) == "cpu"

    model = loaded_est.fit(frame)
    mpath = str(tmp_path / "model")
    model.write().overwrite().save(mpath)
    loaded_model = SparkTorchModel.load(mpath)
    assert isinstance(loaded_model, SparkTorchModel)
    np.testing.assert_array_equal(_predictions(loaded_model, frame),
                                  _predictions(model, frame))
    with pytest.raises(FileExistsError):
        est.write().save(epath)
    with pytest.raises(TypeError, match="SparkTorchModel"):
        SparkTorchModel.load(epath)


def test_fitted_and_nested_pipelines_round_trip(frame, tmp_path):
    from pyspark.ml import Pipeline, PipelineModel

    from sparktorch_tpu_torch.spark.pipeline_util import (
        CARRIER_GUID,
        PysparkPipelineWrapper,
        is_carrier,
    )
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorchModel

    fitted = Pipeline(stages=[_estimator()]).fit(frame)
    want = _predictions(fitted, frame)
    path = str(tmp_path / "pipe")
    fitted.write().overwrite().save(path)
    raw = PipelineModel.load(path)
    assert is_carrier(raw.stages[0])
    assert raw.stages[0].getStopWords()[-1] == CARRIER_GUID
    loaded = PysparkPipelineWrapper.unwrap(raw)
    assert isinstance(loaded.stages[0], SparkTorchModel)
    np.testing.assert_array_equal(_predictions(loaded, frame), want)

    # A loaded pipeline inside a pipeline (the shim's writer persists
    # carrier stages only): unwrap recurses, and the port's ml.pipeline
    # wrapper hands a Spark pipeline to the adapter.
    raw_outer = PipelineModel([PipelineModel([fitted.stages[0]._to_carrier()])])
    unwrapped = port.PysparkPipelineWrapper.unwrap(raw_outer)
    assert isinstance(unwrapped.stages[0].stages[0], SparkTorchModel)
    np.testing.assert_array_equal(_predictions(unwrapped, frame), want)


def test_unfitted_pipeline_round_trip(frame, tmp_path):
    from pyspark.ml import Pipeline

    from sparktorch_tpu_torch.spark.pipeline_util import (
        PysparkPipelineWrapper,
        is_carrier,
    )
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    path = str(tmp_path / "unfitted")
    Pipeline(stages=[_estimator(iters=5, miniBatch=8)]).write().overwrite(
    ).save(path)
    raw = Pipeline.load(path)
    assert is_carrier(raw.getStages()[0])
    est = PysparkPipelineWrapper.unwrap(raw).getStages()[0]
    assert isinstance(est, SparkTorch)
    assert est.getOrDefault(est.iters) == 5
    assert est.getOrDefault(est.miniBatch) == 8
    assert _predictions(Pipeline(stages=[est]).fit(frame), frame).shape == (40,)


def test_to_java_gateway_round_trip(spark):
    from sparktorch_tpu_torch.spark.pipeline_util import (
        CARRIER_GUID,
        PythonStagePersistence,
    )
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    jobj = _estimator(iters=7)._to_java()
    words = jobj.getStopWords()
    assert words[-1] == CARRIER_GUID and words[0].endswith(",")
    back = PythonStagePersistence._from_java(jobj)
    assert isinstance(back, SparkTorch)
    assert back.getOrDefault(back.iters) == 7
    plain = localsession.StopWordsRemover(inputCol="a", outputCol="b")
    plain.setStopWords(["the", "and"])
    with pytest.raises(ValueError, match="carrier"):
        PythonStagePersistence._from_java(plain)


def test_native_pipelines_unwrap_to_themselves():
    model = simple.MnistMLP(hidden=(4,), n_classes=2, in_features=3)
    stm = port.SparkTorchModel(
        modStr=_encode_bundle(deserialize_model(port.serialize_torch_obj(
            model, input_shape=(3,))), model.state_dict()))
    pipe = port.PipelineModel([stm])
    assert port.PysparkPipelineWrapper.unwrap(pipe) is pipe


def test_the_port_shim_never_takes_the_jax_shim_for_pyspark():
    from sparktorch_tpu_torch.spark.localsession import MARKER, require_pyspark

    with _shim(_jax_install):
        jax_pyspark = sys.modules["pyspark"]
        jax_ml = sys.modules["pyspark.ml"]
        with pytest.raises(ImportError, match="install"):
            require_pyspark()
        # install() replaces the JAX shim whole instead of patching it.
        assert localsession.install()
        ours = sys.modules["pyspark"]
        assert ours is not jax_pyspark and getattr(ours, MARKER)
        assert not hasattr(ours, "__localspark__")
        assert not hasattr(jax_pyspark, MARKER)
        assert sys.modules["pyspark.ml"].Pipeline is localsession.Pipeline
        assert jax_ml.Pipeline is not localsession.Pipeline
        require_pyspark()


def test_jax_adapter_tests_pass_after_the_port_shim_in_one_process():
    # Both files are collected first (the JAX test module installs its
    # shim then); the port's test runs with its shim swapped in, and the
    # JAX adapter tests that resolve pyspark classes at run time follow.
    this = Path(__file__).relative_to(REPO)
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-p", "no:xdist", "-p", "no:randomly",
           f"{this}::test_to_java_gateway_round_trip",
           "tests/test_spark_adapter.py::test_pipeline_persistence_round_trip",
           "tests/test_spark_adapter.py::test_to_java_gateway_round_trip",
           "tests/test_spark_adapter.py::test_localsession_rdd_process_isolation"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "4 passed" in proc.stdout, proc.stdout[-2000:]
