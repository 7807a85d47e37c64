"""The port's transformer against the JAX package's, on the same weights.

The Flax module is initialised, its params carried over by
``sparktorch_tpu_torch.convert``, and both models run the same numpy
token ids. JAX's flash attention runs its Pallas kernel in interpret
mode on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.models import transformer as jax_tf
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import transformer as torch_tf

# f32: both sides compute the same math in f32. bf16: the frameworks
# round at different places, so outputs are compared in f32 at bf16's
# resolution.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}

KINDS = {
    "classifier": ("SequenceClassifier", {}),
    "lm_untied": ("CausalLM", {}),
    "lm_tied": ("CausalLM", {"tie_embeddings": True}),
}


def _pair(kind, attn_impl, dtype, seed=0):
    name, extra = KINDS[kind]
    cfg = dict(attn_impl=attn_impl, dtype=dtype, **extra)
    jax_cfg = jax_tf.tiny_transformer(**cfg)
    torch_cfg = torch_tf.tiny_transformer(**cfg)
    ids = np.random.default_rng(seed).integers(
        0, jax_cfg.vocab_size, size=(2, jax_cfg.max_len)).astype(np.int32)
    jax_model = getattr(jax_tf, name)(jax_cfg)
    variables = jax.device_get(jax_model.init(jax.random.key(seed),
                                              jnp.asarray(ids)))
    model = getattr(torch_tf, name)(torch_cfg)
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               torch_cfg))
    return jax_model, variables, model, ids, torch_cfg


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
@pytest.mark.parametrize("kind,dtype", [
    ("classifier", "float32"),
    ("lm_untied", "float32"),
    ("lm_tied", "float32"),
    ("classifier", "bfloat16"),
])
def test_model_matches_jax(kind, dtype, attn_impl):
    jax_model, variables, model, ids, _ = _pair(kind, attn_impl, dtype)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(ids)),
                      dtype=np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32  # heads compute in f32
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_float_ids_are_cast():
    _, _, model, ids, _ = _pair("classifier", "dense", "float32")
    with torch.inference_mode():
        a = model(torch.from_numpy(ids))
        b = model(torch.from_numpy(ids.astype(np.float32)))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_convert_rejects_bad_params(fault):
    cfg = jax_tf.tiny_transformer(dtype="float32")
    variables = jax.device_get(jax_tf.SequenceClassifier(cfg).init(
        jax.random.key(0), jnp.zeros((1, cfg.max_len), jnp.int32)))
    params = jax.tree.map(np.asarray, variables["params"])
    params = {k: dict(v) for k, v in params.items()}
    if fault == "missing":
        del params["pooler"]["bias"]
    elif fault == "extra":
        params["pooler"]["extra"] = np.zeros(3, np.float32)
    else:
        params["pooler"]["bias"] = np.zeros(cfg.d_model + 1, np.float32)
    error = ValueError if fault == "shape" else KeyError
    with pytest.raises(error):
        state_dict_from_flax(params, torch_tf.tiny_transformer(dtype="float32"))


def test_moe_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_tf.SequenceClassifier(torch_tf.tiny_transformer(n_experts=4))
