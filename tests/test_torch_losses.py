"""Every loss registry name of the port against the JAX package's function of the same name.

Both get the same numpy predictions and targets; each name runs on the
target kinds it takes (regression targets of matching or lower rank,
integer class labels for 2-D and LM-shaped 3-D logits, soft labels).
The per-example losses and their gradients with respect to the
predictions must agree in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.utils import losses as jax_losses
from sparktorch_tpu_torch.utils import losses

# f32 on both sides; the two differ only in summation order.
ATOL = RTOL = 1e-5

REGRESSION = ("same_rank", "lower_rank")
CLASSES = ("labels_2d", "labels_3d")
CASES = {
    "mse": REGRESSION, "l1": REGRESSION, "mae": REGRESSION,
    "huber": REGRESSION, "smooth_l1": REGRESSION,
    "bce_with_logits": REGRESSION,
    "MSELoss": REGRESSION, "L1Loss": REGRESSION, "SmoothL1Loss": REGRESSION,
    "BCEWithLogitsLoss": REGRESSION,
    "cross_entropy": CLASSES + ("soft",),
    "CrossEntropyLoss": CLASSES + ("soft",),
    "cross_entropy_dense": CLASSES + ("soft",),
    "cross_entropy_fused": CLASSES,
    "nll": CLASSES, "NLLLoss": CLASSES,
}


def _case(kind, log_probs, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "same_rank":
        return (rng.standard_normal((8, 3), dtype=np.float32),
                rng.random((8, 3), dtype=np.float32))
    if kind == "lower_rank":  # (batch, 1) predictions, (batch,) targets
        return (rng.standard_normal((8, 1), dtype=np.float32),
                rng.random((8,), dtype=np.float32))
    shape = {"labels_2d": (8, 5), "labels_3d": (2, 16, 32),
             "soft": (8, 5)}[kind]
    preds = 2 * rng.standard_normal(shape, dtype=np.float32)
    if log_probs:
        preds = preds - np.log(np.exp(preds).sum(-1, keepdims=True))
    if kind == "soft":
        t = rng.random(shape, dtype=np.float32)
        return preds, t / t.sum(-1, keepdims=True)
    return preds, rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)


def test_registry_names_match_jax():
    assert set(losses.LOSS_REGISTRY) == set(jax_losses.LOSS_REGISTRY)
    assert set(CASES) == set(losses.LOSS_REGISTRY)


@pytest.mark.parametrize("name,kind", [(n, k) for n, kinds in CASES.items()
                                       for k in kinds])
def test_loss_matches_jax(name, kind):
    preds, targets = _case(kind, log_probs=name in ("nll", "NLLLoss"))
    w = np.linspace(0.5, 1.5, preds.shape[0]).astype(np.float32)
    jax_fn = jax_losses.resolve_loss(name)
    want = jax_fn(jnp.asarray(preds), jnp.asarray(targets))
    want_grad = jax.grad(lambda p: jnp.sum(
        jax_fn(p, jnp.asarray(targets)) * w))(jnp.asarray(preds))

    x = torch.from_numpy(preds).requires_grad_()
    got = losses.resolve_loss(name)(x, torch.from_numpy(targets))
    assert got.shape == (preds.shape[0],)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=ATOL, rtol=RTOL)


def test_resolve_loss_passes_callables_and_rejects_unknown_names():
    fn = lambda p, t: (p - t).abs()  # noqa: E731
    assert losses.resolve_loss(fn) is fn
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.resolve_loss("hinge")
