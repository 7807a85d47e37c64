"""The small nets and the ResNets in both packages, on the same weights.

Each JAX model is initialised from a seed; its variables are carried
into the port's module with ``convert.state_dict_from_flax``
(BatchNorm scales and running statistics first set to seeded non-trivial
values, so a zero-initialised scale or a unit variance hides nothing).
Both forwards then run on the same seeded numpy input.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.models import resnet as jax_resnet
from sparktorch_tpu.models import simple as jax_simple
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import resnet, simple


def _init(jax_model, x, seed=0):
    return jax.device_get(jax_model.init(jax.random.key(seed),
                                         jnp.asarray(x)))


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(variables, module))
    return module


def _roughen_batchnorm(variables, seed):
    """Seeded BatchNorm scales in [0.5, 1.5], running means N(0, 0.1²)
    and running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
    for path, value in flat.items():
        if path[-1] in ("scale", "var"):
            flat[path] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif path[-1] == "mean":
            flat[path] = (0.1 * rng.standard_normal(value.shape)
                          ).astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _assert_close(got, want, rel):
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


SIMPLE = {
    "MLP": (lambda: jax_simple.MLP(features=(20, 1)),
            lambda: simple.MLP(features=(20, 1), in_features=10), (10,)),
    "Net": (jax_simple.Net, simple.Net, (10,)),
    "AutoEncoder": (jax_simple.AutoEncoder, simple.AutoEncoder, (10,)),
    "ClassificationNet": (jax_simple.ClassificationNet,
                          simple.ClassificationNet, (10,)),
    "NetworkWithParameters": (
        lambda: jax_simple.NetworkWithParameters(hidden_size=12,
                                                 output_size=3),
        lambda: simple.NetworkWithParameters(hidden_size=12, output_size=3),
        (10,)),
    "MnistMLP": (jax_simple.MnistMLP, simple.MnistMLP, (784,)),
    "MnistCNN": (lambda: jax_simple.MnistCNN(compute_dtype=jnp.float32),
                 lambda: simple.MnistCNN(compute_dtype=torch.float32),
                 (784,)),
}


@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_simple_nets_match_jax_in_f32(name):
    make_jax, make_port, shape = SIMPLE[name]
    x = np.random.default_rng(1).standard_normal((6, *shape)
                                                 ).astype(np.float32)
    jax_model = make_jax()
    variables = _init(jax_model, x)
    module = _port(make_port(), variables).eval()
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["flat", "nhw", "nhwc"])
def test_mnist_cnn_bf16_matches_jax(layout):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 784)).astype(np.float32)
    x_in = {"flat": x, "nhw": x.reshape(5, 28, 28),
            "nhwc": x.reshape(5, 28, 28, 1)}[layout]
    jax_model = jax_simple.MnistCNN()
    variables = _init(jax_model, x)
    module = _port(simple.MnistCNN(), variables).eval()
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x_in)))
    with torch.no_grad():
        got = module(torch.from_numpy(x_in)).numpy()
    assert got.dtype == np.float32 and got.shape == (5, 10)
    _assert_close(got, want, 2e-2)


RESNETS = {
    # name: (constructor, image size, flax kwargs)
    "resnet18-cifar": ("resnet18", 32, {}),
    "resnet18-stem7": ("resnet18", 64, {"small_images": False}),
    "resnet50-cifar": ("resnet50", 32, {"small_images": True}),
    "resnet50-stem7": ("resnet50", 64, {}),
}


def _resnet_pair(name, dtype, seed=3):
    ctor, hw, kw = RESNETS[name]
    jax_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = np.random.default_rng(seed).standard_normal((4, hw, hw, 3)
                                                    ).astype(np.float32)
    jax_model = getattr(jax_resnet, ctor)(num_classes=10, width=8,
                                          compute_dtype=jax_dtype, **kw)
    variables = _roughen_batchnorm(_init(jax_model, x, seed), seed)
    module = getattr(resnet, ctor)(num_classes=10, width=8,
                                   compute_dtype=dtype, **kw)
    return jax_model, _port(module, variables), variables, x


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_eval_matches_jax(name, dtype, rel):
    jax_model, module, variables, x = _resnet_pair(name, dtype)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 10)
    _assert_close(got, want, rel)


def test_resnet_flat_rows_need_input_hw():
    x = np.random.default_rng(4).standard_normal((2, 8 * 8 * 3)
                                                 ).astype(np.float32)
    jax_model = jax_resnet.resnet18(width=8, input_hw=(8, 8, 3),
                                    compute_dtype=jnp.float32)
    variables = _roughen_batchnorm(_init(jax_model, x), 4)
    module = _port(resnet.resnet18(width=8, input_hw=(8, 8, 3),
                                   compute_dtype="float32"), variables)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="input_hw"):
        resnet.resnet18(width=8)(torch.from_numpy(x))


def test_resnet_training_forward_updates_running_stats_as_flax():
    jax_model, module, variables, x = _resnet_pair("resnet18-stem7",
                                                   "float32")
    want, state = jax_model.apply(variables, jnp.asarray(x),
                                  mutable=["batch_stats"])
    with torch.no_grad():
        got = module.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    new = state_dict_from_flax(
        {"params": variables["params"],
         "batch_stats": jax.device_get(state["batch_stats"])}, module)
    moved = 0
    for key, value in module.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), new[key].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=key)
            moved += not np.allclose(value.numpy(),
                                     _port_key(variables, key))
    assert moved > 0


def _port_key(variables, key):
    """The value of the port's ``key`` in the Flax ``variables``
    before the training forward."""
    *parts, leaf = key.split(".")
    node = variables["batch_stats"]
    for p in parts:
        node = node[p]
    return np.asarray(node[{"running_mean": "mean",
                            "running_var": "var"}[leaf]])


def test_same_pads_match_xla():
    assert simple.same_pads(32, 3, 2) == (0, 1)
    assert simple.same_pads(224, 7, 2) == (2, 3)
    assert simple.same_pads(112, 3, 2) == (0, 1)
    assert simple.same_pads(32, 3, 1) == (1, 1)
    assert simple.same_pads(32, 1, 2) == (0, 0)
