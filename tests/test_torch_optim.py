"""Each ported optimizer name against the optax rule the JAX package resolves it to.

Three updates of a small parameter set from the same numpy start and
the same fixed numpy gradients, through ``resolve_optimizer`` of both
packages. The names follow optax's rules and defaults (AdamW's weight
decay 1e-4, RMSprop's decay 0.9 with eps inside the root, Adagrad's
initial accumulator 0.1 and eps 1e-7), not ``torch.optim``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparktorch_tpu.utils import serde as jax_serde
from sparktorch_tpu_torch.utils import serde

# f32 on both sides; the update rules are the same, rounded in another order.
ATOL, RTOL = 1e-6, 1e-5

CASES = [
    ("sgd", {"lr": 0.1}),
    ("SGD", {"lr": 0.1, "momentum": 0.9}),
    ("sgd", {"lr": 0.1, "momentum": 0.9, "nesterov": True}),
    ("adam", {}),
    ("Adam", {"lr": 1e-2, "b1": 0.8}),
    ("adamw", {"lr": 1e-2}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.1}),
    ("rmsprop", {}),
    ("RMSprop", {"lr": 1e-3, "momentum": 0.9, "nesterov": True}),
    ("adagrad", {}),
    ("Adagrad", {"lr": 0.1, "initial_accumulator_value": 0.0}),
    (None, {"lr": 0.05}),
]


def _start_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3), dtype=np.float32),
              "b": rng.standard_normal((3,), dtype=np.float32)}
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32)
              for k, v in params.items()} for _ in range(3)]
    grads[1]["b"][0] = 0.0  # a zero gradient entry
    return params, grads


@pytest.mark.parametrize("name,kwargs", CASES)
def test_optimizer_matches_optax(name, kwargs):
    params, grads = _start_and_grads()

    tx = jax_serde.resolve_optimizer(name, kwargs)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)

    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = serde.resolve_optimizer(name, kwargs)(list(tensors.values()))
    for g in grads:
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", ["adafactor", "lamb", "lion"])
def test_optax_only_optimizers_name_the_roadmap(name):
    factory = serde.resolve_optimizer(name, {"lr": 1e-3})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory([torch.nn.Parameter(torch.zeros(2))])


def test_unknown_optimizer_and_callables():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        serde.resolve_optimizer("adadelta")
    w = torch.nn.Parameter(torch.ones(2))
    opt = serde.resolve_optimizer(torch.optim.SGD, {"lr": 0.5})([w])
    w.grad = torch.ones(2)
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), [0.5, 0.5])
