"""Synchronous training in both packages, from the same initial weights.

The JAX trainer initialises its model with ``jax.random.key(seed)`` on
``x[:1]``; the test builds the same Flax params, carries them into the
port's module with ``convert.state_dict_from_flax`` and packages that
module. Both trainers then run full-batch steps on the same numpy data
(JAX: on its 8-device CPU mesh, with the batch padded by weight-0 rows;
flash attention and the fused cross-entropy in Pallas interpret mode).
Minibatch sampling and shuffle rounds draw from different generators in
the two packages, so they are checked for their semantics only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import resnet as jax_resnet
from sparktorch_tpu.models import simple as jax_simple
from sparktorch_tpu.models import transformer as jax_tf
from sparktorch_tpu.parallel.mesh import build_mesh
from sparktorch_tpu.train import step as jax_step
from sparktorch_tpu.train.sync import train_distributed as jax_train
from sparktorch_tpu.utils import data as jax_data
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import resnet as torch_resnet
from sparktorch_tpu_torch.models import simple as torch_simple
from sparktorch_tpu_torch.models import transformer as torch_tf
from sparktorch_tpu_torch.train.step import train_step
from sparktorch_tpu_torch.train.sync import train_distributed
from sparktorch_tpu_torch.utils.data import (DataBatch, pad_batch,
                                             pad_to_multiple)
from sparktorch_tpu_torch.utils.early_stopper import EarlyStopping
from sparktorch_tpu_torch.utils.serde import resolve_optimizer

LM = dict(vocab_size=1024, d_model=64, n_heads=2, n_layers=2, d_ff=128,
          max_len=128, dtype="float32", attn_impl="flash")


def _lm_data(seed=0):
    ids = np.random.default_rng(seed).integers(0, LM["vocab_size"], (2, 129))
    return ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.int32)


def _pair(kind, cfg, x, seed=0):
    """The JAX module and the port's module holding the params the JAX
    trainer initialises for ``seed``."""
    jax_model = getattr(jax_tf, kind)(jax_tf.TransformerConfig(**cfg))
    variables = jax.device_get(jax_model.init(jax.random.key(seed),
                                              jnp.asarray(x[:1])))
    torch_cfg = torch_tf.TransformerConfig(**cfg)
    model = getattr(torch_tf, kind)(torch_cfg)
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               torch_cfg))
    return jax_model, model, torch_cfg


def _packages(jax_model, model, **kw):
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(model, **kw))


def _comparable(key, value):
    """The parameter as the comparison takes it. The key third of the
    qkv bias has a gradient of zero in exact arithmetic (adding a
    constant to every key's logit leaves each query's softmax as it is),
    so Adam turns f32 rounding noise into ±lr steps there, in each
    package its own: that third is left out."""
    if key.endswith("attn.qkv.bias"):
        return value.reshape(3, -1)[[0, 2]]
    return value


# (optimizer, params, loss tolerance, param tolerance): the losses and
# parameters agree to f32 summation order.
@pytest.mark.parametrize("optimizer,params,loss_tol,param_tol", [
    ("sgd", {"lr": 0.5}, 1e-5, 2e-5),
    ("adamw", {"lr": 3e-3}, 1e-5, 1e-4),
])
def test_lm_training_matches_jax(optimizer, params, loss_tol, param_tol):
    x, y = _lm_data()
    jax_model, model, cfg = _pair("CausalLM", LM, x)
    jax_obj, obj = _packages(jax_model, model, criterion="cross_entropy",
                             optimizer=optimizer, optimizer_params=params)
    want = jax_train(jax_obj, x, labels=y, iters=3, seed=0)
    got = train_distributed(obj, x, labels=y, iters=3, seed=0, device="cpu")

    assert [r["iter"] for r in got.metrics] == [0, 1, 2]
    for key in ("loss", "grad_norm", "examples"):
        np.testing.assert_allclose([r[key] for r in got.metrics],
                                   [r[key] for r in want.metrics],
                                   atol=loss_tol, rtol=loss_tol, err_msg=key)
    assert got.metrics[-1]["loss"] < got.metrics[0]["loss"]
    want_params = state_dict_from_flax(want.params, cfg)
    assert set(got.params) == set(want_params)
    for key, value in got.params.items():
        np.testing.assert_allclose(_comparable(key, value.numpy()),
                                   _comparable(key, want_params[key].numpy()),
                                   atol=param_tol, rtol=param_tol,
                                   err_msg=key)


CLS = dict(vocab_size=256, d_model=32, n_heads=2, n_layers=1, d_ff=64,
           max_len=16, dtype="float32")


def _cls_frame(n=24, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CLS["vocab_size"], (n, CLS["max_len"]))
    labels = rng.integers(0, 2, n).astype(np.float32)
    return {"features": list(ids.astype(np.float32)), "label": labels}


def test_classifier_fit_then_transform_matches_jax():
    frame = _cls_frame()
    x = np.stack(frame["features"])
    jax_model, model, _ = _pair("SequenceClassifier",
                                dict(CLS, attn_impl="flash"), x)
    jax_obj, obj = _packages(jax_model, model, criterion="cross_entropy",
                             optimizer="adam", optimizer_params={"lr": 1e-2})
    kw = dict(inputCol="features", labelCol="label", iters=4)
    jax_est = jax_pkg.SparkTorch(torchObj=jax_obj, **kw)
    est = port.SparkTorch(torchObj=obj, device="cpu", **kw)
    want = jax_est.fit(frame).transform(frame, {"useVectorOut": True})
    fitted = est.fit(frame)
    got = fitted.setDevice("cpu").transform(frame, {"useVectorOut": True})
    np.testing.assert_allclose([r["loss"] for r in est._last_metrics],
                               [r["loss"] for r in jax_est._last_metrics],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.stack(got["predictions"]),
                               np.stack(want["predictions"]),
                               atol=1e-4, rtol=1e-4)
    assert isinstance(fitted, port.SparkTorchModel)
    assert fitted.getModel().params.keys() == model.state_dict().keys()


def test_validation_and_early_stop_match_jax():
    frame = _cls_frame(n=40, seed=2)
    x = np.stack(frame["features"])
    y = np.asarray(frame["label"])
    jax_model, model, _ = _pair("SequenceClassifier",
                                dict(CLS, attn_impl="dense"), x[:1])
    jax_obj, obj = _packages(jax_model, model, criterion="cross_entropy",
                             optimizer="adam", optimizer_params={"lr": 3e-2})
    kw = dict(labels=y, iters=20, validation_pct=0.25,
              early_stop_patience=2, seed=0)
    want = jax_train(jax_obj, x, **kw)
    got = train_distributed(obj, x, device="cpu", **kw)
    assert len(want.metrics) < 20  # the stop fired
    assert len(got.metrics) == len(want.metrics)
    np.testing.assert_allclose([r["val_loss"] for r in got.metrics],
                               [r["val_loss"] for r in want.metrics],
                               atol=1e-4, rtol=1e-4)
    assert [r["examples"] for r in got.metrics] == [30.0] * len(got.metrics)


@pytest.mark.parametrize("signals,config", [
    ([1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.9, 0.91], dict(patience=3)),
    ([1.0, 1.0, 1.0, 1.0], dict(patience=2)),
    ([2.0, 1.5, float("nan"), 1.0], dict(patience=5)),
    ([1.0, 1.2, 1.25, 1.3], dict(mode="max", min_delta=0.1, patience=2)),
    ([-1.0, -1.005, -1.02, -1.03], dict(min_delta=1.0, percentage=True,
                                         patience=2)),
])
def test_early_stopper_matches_jax_on_device_rule(signals, config):
    # The port reads each step's signal back and stops on the host; the
    # JAX fused trainer decides on the device (_es_update). Same stop step.
    stopper = EarlyStopping(**config)
    got = [stopper.step(s) for s in signals]
    cfg, es = jax_step.EsConfig(**config), jax_step.init_es_state()
    want = []
    for s in signals:
        es = jax_step._es_update(cfg, es, jnp.float32(s))
        want.append(bool(es.stopped))
    first = lambda flags: flags.index(True) if True in flags else None  # noqa: E731
    assert first(got) == first(want)


def test_weight_zero_padding_rows_change_nothing():
    torch.manual_seed(0)
    model = torch_tf.SequenceClassifier(torch_tf.TransformerConfig(**CLS))
    twin = torch_tf.SequenceClassifier(torch_tf.TransformerConfig(**CLS))
    twin.load_state_dict(model.state_dict())
    frame = _cls_frame(n=6)
    batch = DataBatch(torch.from_numpy(np.stack(frame["features"])),
                      torch.from_numpy(frame["label"]).long(),
                      torch.ones(6))
    loss_fn = port.deserialize_model(port.serialize_torch_obj(
        model, criterion="cross_entropy")).loss_fn()
    metrics = []
    for module, b in ((model, batch), (twin, pad_batch(batch, 9))):
        opt = resolve_optimizer("sgd", {"lr": 0.1})(module.parameters())
        metrics.append(train_step(module, loss_fn, opt, b))
    for a, b in zip(*metrics):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    for (k, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=k)


@pytest.mark.parametrize("n,multiple", [(5, 8), (8, 8), (9, 4), (0, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, 5, n)
    want = jax_data.pad_to_multiple(
        jax_data.DataBatch(jnp.asarray(x), jnp.asarray(y), jnp.ones(n)),
        multiple)
    got = pad_to_multiple(
        DataBatch(torch.from_numpy(x), torch.from_numpy(y), torch.ones(n)),
        multiple)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("steps_per_call", [4, None])
def test_read_back_chunks_change_no_step(steps_per_call):
    # Chunking only moves the host read-back: every step is the same.
    frame = _cls_frame(n=8, seed=4)
    torch.manual_seed(0)
    model = torch_tf.SequenceClassifier(torch_tf.TransformerConfig(**CLS))
    obj = port.serialize_torch_obj(model, criterion="cross_entropy",
                                   optimizer="adam",
                                   optimizer_params={"lr": 1e-2})
    x, y = np.stack(frame["features"]), frame["label"]
    runs = [train_distributed(obj, x, labels=y, iters=6, device="cpu",
                              steps_per_call=n)
            for n in (1, steps_per_call)]
    for key in ("iter", "loss", "grad_norm", "examples"):
        assert ([r[key] for r in runs[0].metrics]
                == [r[key] for r in runs[1].metrics]), key
    for key, value in runs[0].params.items():
        torch.testing.assert_close(runs[1].params[key], value, atol=0, rtol=0)


def test_minibatch_and_shuffle_rounds_train():
    frame = _cls_frame(n=64, seed=3)
    torch.manual_seed(0)
    model = torch_tf.SequenceClassifier(torch_tf.TransformerConfig(**CLS))
    obj = port.serialize_torch_obj(model, criterion="cross_entropy",
                                   optimizer="adam",
                                   optimizer_params={"lr": 1e-2})
    est = port.SparkTorch(inputCol="features", labelCol="label",
                          torchObj=obj, iters=12, miniBatch=16,
                          partitionShuffles=2, device="cpu")
    est.fit(frame)
    records = est._last_metrics
    assert [r["round"] for r in records] == [0] * 12 + [1] * 12
    assert all(r["examples"] == 16.0 for r in records)
    losses = [r["loss"] for r in records]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])


# checkpointDir is ported (tests/test_torch_checkpoint.py); the ids of
# the cases that remain are kept.
@pytest.mark.parametrize("setting,match", [
    pytest.param(dict(mesh="dp"), "multi-GPU", id="setting1-multi-GPU"),
    pytest.param(dict(n_micro=8), "pipeline", id="setting2-pipeline"),
])
def test_unported_settings_name_the_roadmap(setting, match):
    model = torch_tf.SequenceClassifier(torch_tf.TransformerConfig(**CLS))
    est = port.SparkTorch(inputCol="features", labelCol="label",
                          torchObj=port.serialize_torch_obj(model),
                          device="cpu", **setting)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{match}"):
        est.fit(_cls_frame(n=4))


def _vision_pair(make_jax, make_port, x, seed=0):
    jax_model = make_jax()
    variables = jax.device_get(jax_model.init(jax.random.key(seed),
                                              jnp.asarray(x[:1])))
    module = make_port()
    module.load_state_dict(state_dict_from_flax(variables, module))
    return jax_model, module


def test_readme_quick_start_matches_jax():
    # README.md's quick start at 200 rows and 8 full-batch steps (the two
    # packages draw minibatch offsets from different generators).
    rng = np.random.default_rng(5)
    x = rng.random((200, 784)).astype(np.float32)
    y = rng.integers(0, 10, 200)
    df = {"features": list(x), "label": y.astype(np.float32)}
    jax_model, model = _vision_pair(jax_simple.MnistMLP,
                                    torch_simple.MnistMLP, x)
    jax_obj, obj = _packages(jax_model, model, criterion="cross_entropy",
                             optimizer="adam", optimizer_params={"lr": 1e-3},
                             input_shape=(784,))
    kw = dict(inputCol="features", labelCol="label",
              predictionCol="predictions", iters=8, validationPct=0.1,
              earlyStopPatience=10)
    jax_est = jax_pkg.SparkTorch(torchObj=jax_obj, **kw)
    est = port.SparkTorch(torchObj=obj, device="cpu", **kw)
    want = jax_pkg.Pipeline(stages=[jax_est]).fit(df).transform(df)
    fitted = port.Pipeline(stages=[est]).fit(df)
    fitted.stages[-1].setDevice("cpu")
    got = fitted.transform(df)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in est._last_metrics],
                                   [r[key] for r in jax_est._last_metrics],
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])


# Two stages of one block each: a plain block and a strided one with
# its projection.
TINY_RESNET = dict(stage_sizes=(1, 1), num_classes=3, width=4)


@pytest.mark.parametrize("optimizer,params,param_tol", [
    ("sgd", {"lr": 0.1}, 2e-5),
    ("adam", {"lr": 1e-2}, 1e-4),
])
def test_resnet_sync_steps_match_jax_on_one_device(optimizer, params,
                                                    param_tol):
    # One device: the JAX trainer's batch statistics are per shard, so
    # only a one-device mesh normalises over the batch the port does.
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 3, 16).astype(np.int32)
    jax_model, model = _vision_pair(
        lambda: jax_resnet.ResNet(block_cls=jax_resnet.ResNetBlock,
                                  compute_dtype=jnp.float32, **TINY_RESNET),
        lambda: torch_resnet.ResNet(block_cls=torch_resnet.ResNetBlock,
                                    compute_dtype="float32", **TINY_RESNET),
        x)
    jax_obj, obj = _packages(jax_model, model, criterion="cross_entropy",
                             optimizer=optimizer, optimizer_params=params)
    want = jax_train(jax_obj, x, labels=y, iters=3, seed=0,
                     mesh=build_mesh(devices=jax.devices()[:1]))
    got = train_distributed(obj, x, labels=y, iters=3, seed=0, device="cpu")
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(
        {"params": want.params, **jax.device_get(want.model_state)}, model)
    assert set(got.params) == set(expected)
    moved = 0
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=param_tol, rtol=param_tol,
                                   err_msg=key)
        moved += key.endswith("running_var") and not np.allclose(
            value.numpy(), 1.0)
    assert moved > 0


# ---------------------------------------------------------------------------
# The JAX signatures (F1, F3), the summary (F2), telemetry and chaos
# ---------------------------------------------------------------------------

def _mlp_pair(seed=0):
    """The JAX MnistMLP and the port's with its weights, packaged alike;
    with 32 rows of 12 features in 4 classes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (32, 12)).astype(np.float32)
    y = x[:, :4].argmax(1).astype(np.int32)
    jax_model = jax_simple.MnistMLP(hidden=(16,), n_classes=4)
    variables = jax.device_get(jax_model.init(jax.random.key(0), x[:1]))
    module = torch_simple.MnistMLP(hidden=(16,), n_classes=4, in_features=12)
    module.load_state_dict(state_dict_from_flax(variables, module))
    jax_obj, obj = _packages(jax_model, module, criterion="cross_entropy",
                             optimizer="sgd", optimizer_params={"lr": 0.1},
                             input_shape=(12,))
    return jax_obj, obj, x, y


@pytest.mark.parametrize("name", ["train_distributed",
                                  "train_distributed_streaming"])
def test_parameters_are_the_jax_ones_in_the_jax_order(name):
    import inspect

    from sparktorch_tpu.train import sync as jax_sync
    from sparktorch_tpu_torch.train import sync as port_sync

    want = list(inspect.signature(getattr(jax_sync, name)).parameters)
    got = list(inspect.signature(getattr(port_sync, name)).parameters)
    assert want[-1] == "telemetry"
    # The port's device follows the JAX parameters where the JAX
    # trainer has none; where it has one, it keeps its place.
    assert [p for p in got if p != "device" or "device" in want] == want
    assert "device" in got


def test_a_positional_call_for_the_reference_runs_alike():
    # train_distributed(obj, x, y, mesh, iters, partition_shuffles,
    # verbose, mini_batch, validation_pct, early_stop_patience, seed,
    # device): the same arguments in both packages.
    jax_obj, obj, x, y = _mlp_pair()
    want = jax_train(jax_obj, x, y, None, 3, 1, 0, None, 0.0, -1, 0, "cpu")
    got = train_distributed(obj, x, y, None, 3, 1, 0, None, 0.0, -1, 0,
                            "cpu")
    assert [r["iter"] for r in got.metrics] == [0, 1, 2]
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    # F2: the summary has the JAX key set, the per-chip rate included.
    assert set(got.summary) == set(want.summary)
    assert got.summary["examples_per_sec_per_chip"] == pytest.approx(
        got.summary["examples_per_sec"])


def test_streaming_positional_call_and_metrics_hook_run_alike():
    from sparktorch_tpu.train.sync import (
        train_distributed_streaming as jax_streaming,
    )
    from sparktorch_tpu_torch.train.sync import train_distributed_streaming

    # (obj, x, y, mesh, chunk_rows, epochs, steps_per_chunk, mini_batch,
    # verbose, seed, metrics_hook)
    jax_obj, obj, x, y = _mlp_pair()
    seen = {"jax": [], "port": []}
    want = jax_streaming(jax_obj, x, y, None, 16, 2, None, None, 0, 0,
                         seen["jax"].append)
    got = train_distributed_streaming(obj, x, y, None, 16, 2, None, None,
                                      0, 0, seen["port"].append,
                                      device="cpu")
    assert seen["port"] == got.metrics and seen["jax"] == want.metrics
    assert [(r["round"], r["iter"]) for r in got.metrics] == [
        (0, 0), (0, 1), (1, 2), (1, 3)]
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    assert set(got.summary) == set(want.summary)


# Names of modules the port has not ported yet (ROADMAP, Queue 1, item
# 10, step 4): the JAX trainers' health ledger, stack profiler and trace
# analyzer publish them, and the JAX request tracer samples 1% of wire
# requests by default.
UNPORTED = ("health.", "profile.", "xprof.", "rpctrace.")


def _named(snap):
    return {section: {k: (v["count"] if isinstance(v, dict) else v)
                      for k, v in snap[section].items()
                      if not k.startswith(UNPORTED)}
            for section in ("counters", "gauges", "histograms", "spans",
                            "info")}


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["resident", "streaming"])
def test_fit_telemetry_matches_jax(streaming):
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu.train.sync import (
        train_distributed_streaming as jax_streaming,
    )
    from sparktorch_tpu_torch import obs
    from sparktorch_tpu_torch.train.sync import train_distributed_streaming

    jax_obj, obj, x, y = _mlp_pair()
    jax_tele, tele = jax_obs.Telemetry(), obs.Telemetry()
    if streaming:
        kw = dict(labels=y, chunk_rows=16, epochs=2)
        want = jax_streaming(jax_obj, x, telemetry=jax_tele, **kw)
        got = train_distributed_streaming(obj, x, telemetry=tele,
                                          device="cpu", **kw)
    else:
        kw = dict(labels=y, iters=6, steps_per_call=3, partition_shuffles=2)
        want = jax_train(jax_obj, x, telemetry=jax_tele, **kw)
        got = train_distributed(obj, x, telemetry=tele, device="cpu", **kw)
    a, b = _named(tele.snapshot()), _named(jax_tele.snapshot())
    for section in ("counters", "histograms", "spans"):
        assert a[section] == b[section], section
    assert a["gauges"].keys() == b["gauges"].keys()
    prefix = "train_streaming" if streaming else "train"
    assert a["counters"][f"{prefix}.steps"] == len(got.metrics) == 4 + 8 * (
        not streaming)
    assert a["counters"][f"{prefix}.examples"] == sum(
        r["examples"] for r in want.metrics)
    assert set(got.summary) == set(want.summary)


def _kill(cfg):
    return cfg(kill_worker_at={0: 2})


def _poison(cfg):
    return cfg(poison_batch_at={0: 1})


def _straggle(cfg):
    return cfg(slow_rank_s={0: (1, 0.001)})


@pytest.mark.parametrize("make,site", [
    (_kill, "worker.step"), (_poison, "data.batch"), (_straggle, "train.rank"),
], ids=["worker.step", "data.batch", "train.rank"])
def test_chaos_sites_of_the_sync_fit_match_jax(make, site):
    from sparktorch_tpu import ft as jax_ft
    from sparktorch_tpu_torch import ft

    jax_obj, obj, x, y = _mlp_pair()
    out = {}
    for name, pkg, fit in (
            ("jax", jax_ft, lambda: jax_train(jax_obj, x, labels=y, iters=4,
                                              steps_per_call=1)),
            ("port", ft, lambda: train_distributed(obj, x, labels=y, iters=4,
                                                   steps_per_call=1,
                                                   device="cpu"))):
        with pkg.inject(make(pkg.ChaosConfig)) as inj:
            if site == "worker.step":
                with pytest.raises(pkg.ChaosKill):
                    fit()
                losses = None
            else:
                losses = [r["loss"] for r in fit().metrics]
        out[name] = (inj.events, losses)
    assert out["port"][0] == out["jax"][0]
    assert {e["site"] for e in out["port"][0]} == {site}
    if site == "data.batch":
        # The poisoned batch replaces the resident one from step 1 on.
        for losses in (out["port"][1], out["jax"][1]):
            assert np.isfinite(losses[0]) and np.isnan(losses[1:]).all()
    if site == "train.rank":
        assert [e["step"] for e in out["port"][0]] == [1, 2, 3]
        np.testing.assert_allclose(out["port"][1], out["jax"][1],
                                   atol=1e-5, rtol=1e-5)
