"""The port's fused cross-entropy against the JAX package's.

On the CPU the port runs the plain versions of its two kernels under
its ``torch.autograd.Function``; the JAX side runs ``_ce_kernel`` and
``_ce_bwd_kernel`` in Pallas interpret mode where tokens and vocab
divide its blocks (256 × 512), and its dense fallback elsewhere. Both
get the same numpy logits, labels and loss cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.ops import fused_ce as jax_ce
from sparktorch_tpu_torch.ops.fused_ce import (
    fused_ce_backward,
    fused_ce_forward,
    fused_cross_entropy,
    fused_cross_entropy_loss,
)

# f32 on both sides; the two differ in summation order (running vs
# one-shot logsumexp).
ATOL = RTOL = 1e-5


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    logits = 3 * rng.standard_normal(shape, dtype=np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    g = rng.random(shape[:-1], dtype=np.float32)
    return logits, labels, g


@pytest.mark.parametrize("v", [1024, 1000])  # kernel path; dense fallback
def test_fused_ce_loss_and_grad_match_jax(v):
    logits, labels, g = _data((256, v), seed=v)
    want, vjp = jax.vjp(lambda x: jax_ce.fused_cross_entropy(
        x, jnp.asarray(labels)), jnp.asarray(logits))
    want_grad, = vjp(jnp.asarray(g))

    x = torch.from_numpy(logits).requires_grad_()
    before = (fused_ce_forward.launches, fused_ce_backward.launches)
    loss = fused_cross_entropy(x, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    assert (fused_ce_forward.launches, fused_ce_backward.launches) == before
    assert loss.dtype == torch.float32 and loss.shape == (256,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=ATOL, rtol=RTOL)


def test_fused_ce_loss_3d_matches_jax():
    logits, labels, _ = _data((2, 256, 512), seed=3)
    w = np.array([1.0, 0.5], np.float32)

    def jax_objective(x):
        return jnp.sum(jax_ce.fused_cross_entropy_loss(
            x, jnp.asarray(labels)) * w)

    want, want_grad = jax.value_and_grad(jax_objective)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    per_example = fused_cross_entropy_loss(x, torch.from_numpy(labels))
    assert per_example.shape == (2,)
    (per_example * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(float((per_example.detach()
                                      * torch.from_numpy(w)).sum()),
                               float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=ATOL, rtol=RTOL)


def test_fused_ce_rejects_bad_shapes():
    logits = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fused_cross_entropy(logits, torch.zeros(5, dtype=torch.long))
    with pytest.raises(ValueError):
        fused_cross_entropy(logits[None], torch.zeros(4, dtype=torch.long))
