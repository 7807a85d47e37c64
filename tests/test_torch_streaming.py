"""The streaming trainer (``train_distributed_streaming``) in the port and the JAX package.

Both walk host data in fixed-size chunks in one numpy permutation per
epoch from ``np.random.default_rng(seed + 1 + restored_step)``, pad the
last chunk with weight-0 rows and take full-chunk steps by default, so
on the same weights their losses agree step for step. Minibatch offsets
come from different generators in the two packages, so a minibatch run
is checked for its step count and a falling loss only.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import simple as jax_simple
from sparktorch_tpu.train.sync import (
    train_distributed_streaming as jax_streaming,
)
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import simple as torch_simple
from sparktorch_tpu_torch.train.sync import train_distributed_streaming
from sparktorch_tpu_torch.utils.checkpoint import latest_step
from sparktorch_tpu_torch.utils.serde import ModelSpec


def _classes(n, d=12, k=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = (x[:, :k].argmax(1)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("optimizer,params,param_tol", [
    ("sgd", {"lr": 0.1}, 2e-5),
    ("adam", {"lr": 1e-2}, 1e-4),
])
def test_streaming_matches_jax(optimizer, params, param_tol):
    # 60 rows in chunks of 24: 24, 24 and a ragged 12 (+12 weight-0 rows).
    x, y = _classes(60)
    jax_model = jax_simple.MnistMLP(hidden=(16,), n_classes=4)
    variables = jax.device_get(jax_model.init(jax.random.key(0), x[:1]))
    module = torch_simple.MnistMLP(hidden=(16,), n_classes=4, in_features=12)
    module.load_state_dict(state_dict_from_flax(variables, module))
    kw = dict(criterion="cross_entropy", optimizer=optimizer,
              optimizer_params=params, input_shape=(12,))
    run = dict(labels=y, chunk_rows=24, epochs=2, seed=0)
    want = jax_streaming(jax_pkg.serialize_torch_obj(jax_model, **kw), x,
                         **run)
    got = train_distributed_streaming(port.serialize_torch_obj(module, **kw),
                                      x, device="cpu", **run)
    assert [(r["round"], r["iter"]) for r in got.metrics] == \
        [(r["round"], r["iter"]) for r in want.metrics] == \
        [(e, i) for i, e in enumerate([0, 0, 0, 1, 1, 1])]
    assert [r["examples"] for r in got.metrics] == [24.0, 24.0, 12.0] * 2
    assert all(r["grad_norm"] is None and r["val_loss"] is None
               for r in got.metrics)
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(want.params, module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=param_tol, rtol=param_tol,
                                   err_msg=key)


def test_streaming_checkpoint_resume_step_counts(tmp_path):
    # tests/test_checkpoint.py's streaming case: saves at chunk
    # boundaries, and a resume lands on the straight run's step count.
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (512, 784)).astype(np.float32)
    y = rng.integers(0, 10, (512,)).astype(np.int32)
    torch.manual_seed(0)
    spec = ModelSpec(module=torch_simple.MnistMLP(), loss="cross_entropy",
                     optimizer="adam", optimizer_params={"lr": 1e-3},
                     input_shape=(784,))
    d = str(tmp_path / "stream_ckpt")
    kw = dict(labels=y, chunk_rows=256, checkpoint_dir=d,
              checkpoint_every=1, device="cpu")
    r1 = train_distributed_streaming(spec, x, epochs=2, **kw)
    saved = latest_step(d)
    assert saved == len(r1.metrics) == 4
    r2 = train_distributed_streaming(spec, x, epochs=1, resume=True, **kw)
    assert latest_step(d) == saved + len(r2.metrics) == 6


def test_streaming_minibatch_steps_and_falling_loss():
    x, y = _classes(96, seed=1)
    torch.manual_seed(1)
    obj = port.serialize_torch_obj(
        torch_simple.MnistMLP(hidden=(32,), n_classes=4, in_features=12),
        criterion="cross_entropy", optimizer="adam",
        optimizer_params={"lr": 1e-2}, input_shape=(12,))
    # 96 rows in chunks of 40 (40, 40, 16 + 24 padding), 16-row minibatch
    # steps: ceil(40 / 16) = 3 a chunk, 9 an epoch.
    r = train_distributed_streaming(obj, (x, y), chunk_rows=40, mini_batch=16,
                                    epochs=6, seed=2, device="cpu")
    assert len(r.metrics) == 6 * 9
    assert [r_["round"] for r_ in r.metrics] == sorted(list(range(6)) * 9)
    losses = [r_["loss"] for r_ in r.metrics]
    assert np.isfinite(losses).all()
    assert all(0 <= r_["examples"] <= 16 for r_ in r.metrics)
    assert np.mean(losses[-9:]) < np.mean(losses[:9])
    # steps_per_chunk overrides the default pass.
    r = train_distributed_streaming(obj, (x, y), chunk_rows=40, mini_batch=16,
                                    steps_per_chunk=2, seed=2, device="cpu")
    assert len(r.metrics) == 3 * 2


SEEN = []


class _Recorder(nn.Module):
    """A linear model that keeps a copy of every input it is given."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(2, 1)

    def forward(self, x):
        SEEN.append(x.detach().cpu().clone())
        return self.Dense_0(x)


@pytest.mark.parametrize("resume_from", [0, 3])
def test_chunks_follow_the_reference_permutation(tmp_path, resume_from):
    # Row i holds (i, -i): each chunk a step sees is the host chunk of
    # default_rng(seed + 1 + restored_step)'s permutation, the tail of
    # the last one zero.
    n, rows, seed = 11, 4, 5
    x = np.stack([np.arange(n), -np.arange(n)], 1).astype(np.float32)
    y = np.zeros(n, np.float32)
    d = str(tmp_path / "ckpt")
    spec = ModelSpec(module=_Recorder(), loss="mse", optimizer="sgd",
                     optimizer_params={"lr": 0.0}, input_shape=(2,))
    kw = dict(labels=y, chunk_rows=rows, seed=seed, device="cpu",
              checkpoint_dir=d, checkpoint_every=1)
    if resume_from:
        train_distributed_streaming(spec, x, epochs=1, **kw)
        assert latest_step(d) == resume_from
    SEEN.clear()
    train_distributed_streaming(spec, x, epochs=2, resume=bool(resume_from),
                                **kw)
    rng = np.random.default_rng(seed + 1 + resume_from)
    want = []
    for _ in range(2):
        order = rng.permutation(n)
        for lo in range(0, n, rows):
            chunk = np.zeros((rows, 2), np.float32)
            idx = order[lo:lo + rows]
            chunk[:len(idx)] = x[idx]
            want.append(chunk)
    assert len(SEEN) == len(want)
    for seen, chunk in zip(SEEN, want):
        np.testing.assert_array_equal(seen.numpy(), chunk)
