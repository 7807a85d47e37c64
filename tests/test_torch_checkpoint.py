"""Checkpoint / resume in the port, and against the JAX package.

The port's snapshots are torch files (``<dir>/<step>/state.pt``), the
JAX package's orbax directories; what must agree is what a resume does:
``iters`` counts the steps after the restored one, saved steps are
global, the shuffle generator restarts from its seed, and so 10 steps +
resume + 5 equal 15 straight steps on a full batch. The JAX trainer runs
on its 8-device CPU mesh; both start from the same Flax weights, carried
across with ``convert.state_dict_from_flax``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import simple as jax_simple
from sparktorch_tpu.train.sync import train_distributed as jax_train
from sparktorch_tpu.utils.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import simple as torch_simple
from sparktorch_tpu_torch.train.sync import train_distributed
from sparktorch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    latest_step,
    load_model,
    save_model,
)


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 10)).astype(np.float32)
    y = (x.mean(1) > 0).astype(np.float32)
    return x, y


def _pair(x, seed, optimizer, params):
    """The JAX and port payloads of ``Net`` holding the weights the JAX
    trainer initialises for ``seed``."""
    jax_model = jax_simple.Net()
    variables = jax.device_get(jax_model.init(jax.random.key(seed), x[:1]))
    module = torch_simple.Net()
    module.load_state_dict(state_dict_from_flax(variables, module))
    kw = dict(criterion="mse", optimizer=optimizer, optimizer_params=params,
              input_shape=(10,))
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(module, **kw), module)


def _payload(optimizer="sgd", params=None):
    torch.manual_seed(0)
    return port.serialize_torch_obj(torch_simple.Net(), criterion="mse",
                                    optimizer=optimizer,
                                    optimizer_params=params or {"lr": 1e-2},
                                    input_shape=(10,))


def _touch(path, name="state.pt"):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "wb") as f:
        f.write(b"x")


@pytest.mark.parametrize("layout,want", [
    ("missing", None),
    ("empty", None),
    ("tmp_only", None),
    ("torn_newest", 3),
    ("empty_newest", 3),
    ("not_a_step", 3),
    ("finalized", 12),
])
def test_latest_step_skips_tmp_torn_and_empty(tmp_path, layout, want):
    d = str(tmp_path / "ckpt")
    if layout != "missing":
        os.makedirs(d)
    if layout not in ("missing", "empty"):
        _touch(os.path.join(d, "5.tmp-123"))  # a save still being written
    if layout in ("torn_newest", "empty_newest", "not_a_step", "finalized"):
        _touch(os.path.join(d, "3"))
    if layout == "torn_newest":
        _touch(os.path.join(d, "7"), "state.pt.tmp-9")
    if layout == "empty_newest":
        os.makedirs(os.path.join(d, "9"))
    if layout == "not_a_step":
        _touch(os.path.join(d, "best"))
        with open(os.path.join(d, "11"), "wb") as f:  # a file, not a step
            f.write(b"x")
    if layout == "finalized":
        _touch(os.path.join(d, "12"))
    assert latest_step(d) == want
    if layout != "missing":
        assert CheckpointManager(d).latest_step() == want


def test_retention_interval_and_forced_saves(tmp_path):
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, max_to_keep=2, save_interval_steps=2)
    saved = [mgr.save(s, {"step": s, "w": torch.full((3,), float(s))})
             for s in range(1, 8)]
    assert saved == [False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6]
    assert sorted(os.listdir(d)) == ["4", "6"]  # no tmp left
    assert not mgr.save(6, {"step": 6})  # not past the newest
    assert mgr.save(6, {"step": 6, "w": torch.zeros(3)}, force=True)
    assert mgr.all_steps() == [4, 6]
    torch.testing.assert_close(mgr.restore()["w"], torch.zeros(3))
    assert mgr.restore(step=4)["step"] == 4
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore()


def test_save_model_load_model_round_trip(tmp_path):
    torch.manual_seed(0)
    module = torch_simple.Net()
    state = {"running": torch.arange(4.0)}
    save_model(str(tmp_path / "m"), module.state_dict(), state)
    params, model_state = load_model(str(tmp_path / "m"))
    twin = torch_simple.Net()
    twin.load_state_dict(params)
    x = torch.randn(5, 10)
    torch.testing.assert_close(twin(x), module(x), atol=0, rtol=0)
    torch.testing.assert_close(model_state["running"], state["running"])
    save_model(str(tmp_path / "bare"), module.state_dict())
    assert load_model(str(tmp_path / "bare"))[1] == {}


@pytest.mark.parametrize("iters,every,steps_per_call,want", [
    # An explicit chunk wins: saves at the boundaries at or past the
    # cadence (tests/test_checkpoint.py: 32 and 64).
    (64, 10, 32, [32, 64]),
    # A defaulted chunk never strides past the cadence.
    (30, 10, None, [10, 20, 30]),
])
def test_checkpoint_cadence(tmp_path, iters, every, steps_per_call, want):
    x, y = _data()
    d = str(tmp_path / "ckpt")
    train_distributed(_payload(), x, labels=y, iters=iters,
                      checkpoint_dir=d, checkpoint_every=every,
                      steps_per_call=steps_per_call, seed=1, device="cpu")
    assert CheckpointManager(d).all_steps() == want


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"lr": 1e-2}),
    ("adam", {"lr": 1e-2}),
])
def test_resume_exactness(tmp_path, optimizer, params):
    """15 straight steps == 10 + checkpoint + resume + 5, bit for bit."""
    x, y = _data()
    obj = _payload(optimizer, params)
    kw = dict(labels=y, steps_per_call=1, seed=7, device="cpu")
    straight = train_distributed(obj, x, iters=15, **kw)
    d = str(tmp_path / "ckpt")
    first = train_distributed(obj, x, iters=10, checkpoint_dir=d, **kw)
    assert latest_step(d) == 10
    resumed = train_distributed(obj, x, iters=5, checkpoint_dir=d,
                                resume=True, **kw)
    assert latest_step(d) == 15
    assert [r["iter"] for r in resumed.metrics] == list(range(5))
    assert ([r["loss"] for r in first.metrics + resumed.metrics]
            == [r["loss"] for r in straight.metrics])
    for key, value in straight.params.items():
        torch.testing.assert_close(resumed.params[key], value, atol=0,
                                   rtol=0, msg=key)


@pytest.mark.parametrize("optimizer,params,tol", [
    ("sgd", {"lr": 1e-2}, 2e-5),
    ("adam", {"lr": 1e-2}, 1e-4),
])
def test_resume_matches_jax(tmp_path, optimizer, params, tol):
    x, y = _data(seed=2)
    jax_obj, obj, module = _pair(x, 7, optimizer, params)
    kw = dict(labels=y, steps_per_call=1, seed=7)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train(jax_obj, x, iters=10, checkpoint_dir=jax_dir, **kw)
    want = jax_train(jax_obj, x, iters=5, checkpoint_dir=jax_dir,
                     resume=True, **kw)
    train_distributed(obj, x, iters=10, checkpoint_dir=port_dir,
                      device="cpu", **kw)
    got = train_distributed(obj, x, iters=5, checkpoint_dir=port_dir,
                            resume=True, device="cpu", **kw)
    assert latest_step(port_dir) == 15
    with JaxCheckpointManager(jax_dir) as mgr:
        assert mgr.latest_step() == 15
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=tol, rtol=tol)
    expected = state_dict_from_flax(want.params, module)
    assert set(got.params) == set(expected)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=tol, rtol=tol, err_msg=key)


@pytest.mark.parametrize("directory", ["empty", "torn", "finalized"])
def test_estimator_resume_over_directories(tmp_path, directory):
    """``resume=True`` resumes only from a finalized snapshot; over an
    empty or torn directory it trains from scratch."""
    x, y = _data(seed=3)
    frame = {"features": list(x), "label": y}
    obj = _payload("adam", {"lr": 1e-2})
    d = str(tmp_path / "ckpt")
    os.makedirs(d)

    def fit(iters, **kw):
        est = port.SparkTorch(inputCol="features", labelCol="label",
                              torchObj=obj, iters=iters, device="cpu", **kw)
        model = est.fit(frame)
        return est._last_metrics, model.getModel().params

    if directory == "torn":
        _touch(os.path.join(d, "4"), "state.pt.tmp-77")
    if directory == "finalized":
        fit(10, checkpointDir=d, checkpointEvery=5)
        assert CheckpointManager(d).all_steps() == [5, 10]
    metrics, params = fit(5, checkpointDir=d, checkpointEvery=5, resume=True)
    done = 10 if directory == "finalized" else 0
    assert latest_step(d) == done + 5
    straight_metrics, straight = fit(done + 5)
    assert ([r["loss"] for r in metrics]
            == [r["loss"] for r in straight_metrics[done:]])
    for key, value in straight.items():
        torch.testing.assert_close(params[key], value, atol=0, rtol=0,
                                   msg=key)
