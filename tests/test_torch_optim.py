"""Each ported optimizer name against the optax rule the JAX package resolves it to.

Three updates of a small parameter set from the same numpy start and
the same fixed numpy gradients, through ``resolve_optimizer`` of both
packages. The names follow optax's rules and defaults (AdamW's weight
decay 1e-4, RMSprop's decay 0.9 with eps inside the root, Adagrad's
initial accumulator 0.1 and eps 1e-7, Adafactor's factored moments and
no learning rate, Lion's weight decay 1e-3), not ``torch.optim``'s. The
parameter set holds a 2-D and a 3-D tensor with two dims of at least
128, which Adafactor factors; then Adafactor steps a small transformer,
whose fused attention weights Flax holds at another rank. Then the
optax-only names train a small net through both packages'
``train_distributed``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparktorch_tpu.utils import serde as jax_serde
from sparktorch_tpu_torch.utils import optim, serde

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
    ("rmsprop", {"centered": True}),
    ("rmsprop", {"bias_correction": True}),
    ("rmsprop", {"centered": True, "eps_in_sqrt": False}),
    # At the first step a centered, bias-corrected ν̂ − μ̂² is g² − g²,
    # zero up to each package's rounding: eps 0.1 keeps that rounding
    # (and optax's root of it) from ruling the step.
    ("RMSprop", {"lr": 1e-3, "centered": True, "bias_correction": True,
                 "momentum": 0.9, "eps": 0.1}),
    ("adafactor", {"lr": 0.1}),
    ("adafactor", {"lr": 1e-2, "momentum": 0.9, "weight_decay_rate": 1e-3}),
    ("adafactor", {"lr": 0.1, "factored": False, "clipping_threshold": None}),
    ("lamb", {"lr": 1e-2}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.1}),
    ("lion", {"lr": 1e-3}),
    ("lion", {"lr": 1e-3, "b1": 0.8, "weight_decay": 0.0}),
]


def _start_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3), dtype=np.float32),
              "b": rng.standard_normal((3,), dtype=np.float32),
              "m": rng.standard_normal((130, 128), dtype=np.float32),
              "e": rng.standard_normal((3, 128, 140), dtype=np.float32)}
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
    # Ported now: each name resolves to its optax rule. lamb and lion
    # have no torch.optim default learning rate, so without one they
    # raise as optax's constructors do; adafactor needs none.
    w = torch.nn.Parameter(torch.ones(2))
    opt = serde.resolve_optimizer(name, {"lr": 1e-3})([w])
    assert type(opt).__name__.lower() == name
    w.grad = torch.ones(2)
    opt.step()
    assert bool((w < 1).all())
    if name == "adafactor":
        serde.resolve_optimizer(name)([w]).step()
        with pytest.raises(TypeError):
            jax_serde.resolve_optimizer(name, {"learning_rate": None,
                                               "bogus": 1})
    else:
        with pytest.raises(TypeError, match="learning_rate"):
            jax_serde.resolve_optimizer(name)
        with pytest.raises(TypeError, match="learning_rate"):
            serde.resolve_optimizer(name)([w])


# A transformer's fused weights have another rank in Flax: qkv (d, 3, h,
# hd) and its bias (3, h, hd), proj (h, hd, d). At hd = 64 optax factors
# neither fused kernel (its second-largest dim is below 128); at hd = 128
# it factors both, over other axes than the port's 2-D (3·h·hd, d) and
# (d, h·hd) weights would give.
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("kwargs", [
    {}, {"lr": 1e-2, "momentum": 0.9, "weight_decay_rate": 1e-3}])
def test_adafactor_on_a_transformer_matches_optax(head_dim, kwargs):
    from sparktorch_tpu.models import transformer as jax_tf
    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        TransformerConfig,
    )

    cfg = dict(vocab_size=64, d_model=2 * head_dim, n_heads=2, n_layers=2,
               d_ff=256, max_len=16, dtype="float32")
    jax_model = jax_tf.CausalLM(jax_tf.TransformerConfig(**cfg))
    ids = jnp.zeros((1, 16), jnp.int32)
    params = jax.device_get(jax_model.init(jax.random.key(0), ids))["params"]
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: rng.standard_normal(
        a.shape, dtype=np.float32), params) for _ in range(3)]

    tx = jax_serde.resolve_optimizer("adafactor", kwargs)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)

    module = CausalLM(TransformerConfig(**cfg))
    module.load_state_dict(state_dict_from_flax(params, module))
    spec = serde.ModelSpec(module=module, loss="cross_entropy",
                           optimizer="adafactor", optimizer_params=kwargs)
    named = dict(module.named_parameters())
    opt = spec.make_optimizer(named.values(), optim.flax_shapes(module))
    for g in grads:
        for key, value in state_dict_from_flax(g, module).items():
            named[key].grad = value
        opt.step()
    want = state_dict_from_flax(jax.device_get(p), module)
    for key, value in named.items():
        np.testing.assert_allclose(value.detach().numpy(), want[key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


# Adafactor trains MnistCNN at width 128: its second convolution's kernel
# (3, 3, 128, 256) in Flax, (256, 128, 3, 3) in the port, and its first
# Dense (12544, 128) are factored; the rest are not. The others train a
# 784-32-10 MnistMLP: Lion's sign and Lamb's Adam moments turn a
# gradient entry at rounding level into a whole step, and a net of
# 25,000 weights holds (almost surely) no such entry.
TRAIN_CASES = [
    ("cnn", "adafactor", {}),
    ("cnn", "adafactor", {"lr": 1e-2}),
    ("mlp", "lamb", {"lr": 1e-2}),
    ("mlp", "lion", {"lr": 1e-3}),
    ("mlp", "rmsprop", {"lr": 1e-3, "centered": True}),
    ("mlp", "rmsprop", {"lr": 1e-3, "bias_correction": True}),
]


@pytest.fixture(scope="module")
def nets():
    from sparktorch_tpu.models import simple as jax_simple
    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.models import simple as torch_simple

    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 784)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    pairs = {
        "cnn": (jax_simple.MnistCNN(width=128, compute_dtype=jnp.float32),
                torch_simple.MnistCNN(width=128, compute_dtype="float32")),
        "mlp": (jax_simple.MnistMLP(hidden=(32,)),
                torch_simple.MnistMLP(hidden=(32,))),
    }
    for jax_model, module in pairs.values():
        variables = jax.device_get(jax_model.init(jax.random.key(0),
                                                  jnp.asarray(x[:1])))
        module.load_state_dict(state_dict_from_flax(variables, module))
    return pairs, x, y


@pytest.mark.parametrize("net,name,kwargs", TRAIN_CASES)
def test_optax_only_optimizers_train_like_jax(nets, net, name, kwargs):
    import sparktorch_tpu as jax_pkg
    import sparktorch_tpu_torch as port
    from sparktorch_tpu.train.sync import train_distributed as jax_train
    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.train.sync import train_distributed

    pairs, x, y = nets
    jax_model, module = pairs[net]
    kw = dict(criterion="cross_entropy", optimizer=name,
              optimizer_params=kwargs, input_shape=(784,))
    want = jax_train(jax_pkg.serialize_torch_obj(jax_model, **kw), x,
                     labels=y, iters=3, seed=0)
    got = train_distributed(port.serialize_torch_obj(module, **kw), x,
                            labels=y, iters=3, seed=0, device="cpu")
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(want.params, module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    moved = max(float((got.params[k] - v).abs().max())
                for k, v in module.state_dict().items())
    assert moved > 1e-4


def test_unknown_optimizer_and_callables():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        serde.resolve_optimizer("adadelta")
    w = torch.nn.Parameter(torch.ones(2))
    opt = serde.resolve_optimizer(torch.optim.SGD, {"lr": 0.5})([w])
    w.grad = torch.ones(2)
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), [0.5, 0.5])
