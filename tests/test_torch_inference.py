"""The serving slice as a whole: ``SparkTorchModel.transform`` in both packages.

The JAX package's ``create_spark_torch_model(module, variables)`` and the
port's ``create_spark_torch_model(model).setDevice("cpu")`` serve the
same weights (a tiny flash-attention classifier in f32) over the same
frame of token ids.
"""

import dill
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import transformer as jax_tf
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import transformer as torch_tf
from sparktorch_tpu_torch.utils.serde import envelope_shapes

TOL = 1e-4  # f32 on both sides


@pytest.fixture(scope="module")
def served():
    cfg = dict(attn_impl="flash", dtype="float32")
    jax_cfg = jax_tf.tiny_transformer(**cfg)
    torch_cfg = torch_tf.tiny_transformer(**cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jax_cfg.vocab_size,
                       size=(40, jax_cfg.max_len)).astype(np.float32)
    jax_model = jax_tf.SequenceClassifier(jax_cfg)
    variables = jax.device_get(
        jax_model.init(jax.random.key(1), jnp.asarray(ids[:1])))
    model = torch_tf.SequenceClassifier(torch_cfg)
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               torch_cfg))
    return jax_model, variables, model, ids, torch_cfg


def _frame(ids):
    return {"features": ids}


def test_transform_argmax_and_vectors_match_jax(served):
    jax_model, variables, model, ids, _ = served
    want = jax_pkg.create_spark_torch_model(jax_model, variables).transform(
        _frame(ids))["predicted"]
    stm = port.create_spark_torch_model(model).setDevice("cpu")
    got = stm.transform(_frame(ids))["predicted"]
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)

    want_vec = jax_pkg.create_spark_torch_model(
        jax_model, variables, useVectorOut=True).transform(_frame(ids))
    got_vec = port.create_spark_torch_model(
        model, useVectorOut=True).setDevice("cpu").transform(_frame(ids))
    np.testing.assert_allclose(np.stack(got_vec["predicted"]),
                               np.stack(want_vec["predicted"]),
                               atol=TOL, rtol=TOL)


def test_batch_predictor_chunks_match_jax(served):
    jax_model, variables, model, ids, _ = served
    x = ids[:20]
    want = jax_pkg.BatchPredictor(jax_model, variables["params"],
                                  chunk=8).predict(x)
    pred = port.BatchPredictor(model, device="cpu", chunk=8)
    got = pred.predict(x)
    assert got.shape == want.shape == (20, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    # Chunking and padding do not change a row's output.
    np.testing.assert_allclose(pred.predict(x[17:20]), got[17:20],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("vector_out", [False, True])
def test_zero_row_frame(served, vector_out):
    *_, model, ids, _ = served
    stm = port.create_spark_torch_model(
        model, useVectorOut=vector_out).setDevice("cpu")
    out = stm.transform(_frame(ids[:0]))
    assert len(out["predicted"]) == 0
    assert out["predicted"].dtype == (object if vector_out else np.float64)
    assert port.BatchPredictor(model, device="cpu").predict(ids[:0]).shape \
        == (0, 2)


def test_pipeline_save_load_round_trip(served, tmp_path):
    *_, model, ids, _ = served
    stm = port.create_spark_torch_model(model).setDevice("cpu")
    before = stm.transform(_frame(ids))["predicted"]
    path = str(tmp_path / "pipe")
    port.PipelineModel([stm]).write().overwrite().save(path)
    loaded = port.PysparkPipelineWrapper.unwrap(port.PipelineModel.load(path))
    np.testing.assert_array_equal(loaded.transform(_frame(ids))["predicted"],
                                  before)
    # attach_model_to_pipeline appends the stage.
    attached = port.attach_model_to_pipeline(port.PipelineModel([]), stm)
    np.testing.assert_array_equal(
        attached.transform(_frame(ids))["predicted"], before)


def test_model_pickles_without_device_caches(served):
    *_, model, ids, _ = served
    stm = port.create_spark_torch_model(model).setDevice("cpu")
    stm.transform(_frame(ids[:4]))
    assert stm._forward_cache is not None
    clone = dill.loads(dill.dumps(stm))
    assert clone._forward_cache is None and clone._bundle_cache is None
    assert clone.getDevice() == "cpu"
    np.testing.assert_array_equal(clone.transform(_frame(ids[:4]))["predicted"],
                                  stm.transform(_frame(ids[:4]))["predicted"])


def test_envelope_shapes_match_state_dict(served):
    *_, model, _, cfg = served
    shapes = [list(t.shape) for t in model.state_dict().values()]
    eager = port.serialize_torch_obj(model, criterion="cross_entropy",
                                     optimizer="adam",
                                     optimizer_params={"lr": 1e-3})
    assert envelope_shapes(eager) == shapes
    spec = port.deserialize_model(eager)
    assert spec.optimizer == "adam" and spec.optimizer_params == {"lr": 1e-3}
    torch.testing.assert_close(spec.make_module().state_dict(),
                               model.state_dict())
    lazy = port.serialize_torch_obj_lazy(torch_tf.SequenceClassifier,
                                         model_parameters={"config": cfg})
    assert envelope_shapes(lazy) == shapes
    assert port.deserialize_model(lazy).is_lazy
