"""Loss library — the port of ``sparktorch_tpu/utils/losses.py``.

Losses are functions ``(preds, targets) -> per-example loss (batch,)``,
unreduced, so the training step can apply example weights (weight-0
padding rows count for nothing). Each loss settles the target dtype
itself: regression losses cast targets to the prediction dtype and
rank-align them (:func:`_align`), classification losses cast labels to
int64.

``cross_entropy`` (and ``CrossEntropyLoss``) is :func:`cross_entropy_auto`:
LM-shaped integer-label logits (batch, seq, vocab) go to the fused
cross-entropy kernels (:mod:`sparktorch_tpu_torch.ops.fused_ce`),
everything else to the dense path. Under tensor parallelism the LM
head's vocab-split logits are gathered over tp at the head's exit
(:class:`~sparktorch_tpu_torch.parallel.tp.VocabParallelHead`), so the
loss, and the kernel, always see full rows, as the JAX kernel does
under GSPMD; a vocab-parallel cross entropy that skips the gather is a
speed lead (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

from sparktorch_tpu_torch.ops.fused_ce import fused_cross_entropy_loss

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _flatten_per_example(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims -> shape (batch,)."""
    if x.dim() <= 1:
        return x
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def _align(preds: torch.Tensor, targets: torch.Tensor):
    """Rank-align regression preds/targets so (batch,) vs (batch, 1)
    never broadcasts into a (batch, batch) matrix."""
    targets = targets.to(preds.dtype)
    if targets.dim() < preds.dim():
        targets = targets.reshape(targets.shape
                                  + (1,) * (preds.dim() - targets.dim()))
    elif preds.dim() < targets.dim():
        preds = preds.reshape(preds.shape + (1,) * (targets.dim() - preds.dim()))
    return preds, targets


def mse_loss(preds, targets):
    preds, targets = _align(preds, targets)
    return _flatten_per_example((preds - targets) ** 2)


def l1_loss(preds, targets):
    preds, targets = _align(preds, targets)
    return _flatten_per_example((preds - targets).abs())


def huber_loss(preds, targets, delta: float = 1.0):
    preds, targets = _align(preds, targets)
    err = (preds - targets).abs()
    quad = err.clamp_max(delta)
    return _flatten_per_example(0.5 * quad ** 2 + delta * (err - quad))


def _labels(preds, targets):
    """Integer class labels, with a trailing (…, 1) axis dropped."""
    labels = targets.long()
    if labels.dim() == preds.dim():
        labels = labels.reshape(labels.shape[:-1])
    return labels


def cross_entropy_loss(preds, targets):
    """Softmax cross entropy over the last axis of ``preds``. Integer
    targets are class indices; float targets of matching shape are soft
    labels."""
    logp = torch.log_softmax(preds, dim=-1)
    if targets.is_floating_point() and targets.shape == preds.shape:
        return -(targets * logp).sum(-1).reshape(preds.shape[0], -1).mean(-1)
    picked = logp.gather(-1, _labels(preds, targets)[..., None])[..., 0]
    return -picked.reshape(preds.shape[0], -1).mean(-1)


def cross_entropy_auto(preds, targets):
    """``cross_entropy`` registry entry: LM-shaped integer-label logits
    (batch, seq, vocab) go to the fused kernels, everything else to the
    dense path."""
    soft = targets.is_floating_point() and targets.shape == preds.shape
    if preds.dim() == 3 and not soft:
        return fused_cross_entropy_loss(preds, targets)
    return cross_entropy_loss(preds, targets)


def nll_loss(preds, targets):
    """Negative log-likelihood on already-log-probability inputs."""
    picked = preds.gather(-1, _labels(preds, targets)[..., None])[..., 0]
    return -picked.reshape(preds.shape[0], -1).mean(-1)


def bce_with_logits_loss(preds, targets):
    preds, targets = _align(preds, targets)
    return _flatten_per_example(F.binary_cross_entropy_with_logits(
        preds, targets, reduction="none"))


LOSS_REGISTRY: dict[str, LossFn] = {
    "mse": mse_loss,
    "l1": l1_loss,
    "mae": l1_loss,
    "huber": huber_loss,
    "smooth_l1": huber_loss,
    "cross_entropy": cross_entropy_auto,
    "cross_entropy_dense": cross_entropy_loss,
    "cross_entropy_fused": fused_cross_entropy_loss,
    "nll": nll_loss,
    "bce_with_logits": bce_with_logits_loss,
    # torch.nn criterion-class spellings.
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "SmoothL1Loss": huber_loss,
    "CrossEntropyLoss": cross_entropy_auto,
    "NLLLoss": nll_loss,
    "BCEWithLogitsLoss": bce_with_logits_loss,
}


def resolve_loss(loss: Union[str, LossFn]) -> LossFn:
    if callable(loss):
        return loss
    try:
        return LOSS_REGISTRY[loss]
    except KeyError:
        raise ValueError(
            f"Unknown loss {loss!r}; known: {sorted(LOSS_REGISTRY)} or pass "
            "a callable") from None
