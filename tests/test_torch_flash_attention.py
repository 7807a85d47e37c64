"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain version; the
JAX side runs the Pallas kernel in interpret mode (blocks of 128), as
``tests/test_kernels.py`` does. Both get the same numpy inputs. The
Hopper kernel itself is held to the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.ops.attention import dense_attention as jax_dense
from sparktorch_tpu.ops.flash_attention import _flash_impl
from sparktorch_tpu.ops.flash_attention import flash_attention as jax_flash
from sparktorch_tpu_torch.ops.attention import dense_attention
from sparktorch_tpu_torch.ops.flash_attention import flash_attention

# f32 on both sides; the two differ only in summation order.
ATOL = RTOL = 2e-5


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32)
            for _ in range(3)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_pallas(causal, d, s):
    q, k, v = _qkv(2, s, 2, d, seed=s + d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal, 128, 128)
    before = flash_attention.launches
    got = flash_attention(*_torch(q, k, v), causal)
    assert flash_attention.launches == before  # CPU: plain version, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_lse_matches_jax(causal):
    b, s, h, d = 2, 256, 2, 64
    q, k, v = _qkv(b, s, h, d, seed=7)
    out, lse3 = _flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, 128, 128, with_lse=True)
    want_lse = np.asarray(lse3)[..., 0].reshape(b, h, s)
    got, lse = flash_attention(*_torch(q, k, v), causal, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ragged_matches_jax_dense_fallback(causal):
    # s=100 does not tile on the TPU, so the JAX wrapper falls back to
    # dense attention; the port masks the ragged end instead.
    q, k, v = _qkv(2, 100, 2, 64, seed=3)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got = flash_attention(*_torch(q, k, v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(2, 96, 3, 32, seed=11)
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    got = dense_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_flash_rejects_mismatched_shapes():
    q, k, v = _torch(*_qkv(1, 64, 2, 32))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v.to(torch.float64))
