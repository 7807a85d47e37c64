"""The data-parallel train step — the port of ``_dp_body`` (``sparktorch_tpu/train/step.py:292``).

One step: take the batch (or a sampled minibatch of it), run the module,
and back-propagate the example-weighted loss SUM, then divide the
gradients and the loss by the weight sum — the JAX step's reduction:

    num = Σ w·ℓ,   den = Σ w,   grads = ∇num / max(den, 1),
    loss = num / max(den, 1).

The division is its own step after the backward: a multi-GPU world
all-reduces (num, den, grads) as sums right there, which keeps padding
rows (weight 0) and ragged shards exact; it is not DDP's
divide-by-world-size. Every parameter that got no gradient gets a zero
one, so optimizers that act without a gradient (AdamW's decay) act on
it as optax does. Nothing here reads a value back to the host: the step
returns its metrics as device scalars.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from sparktorch_tpu_torch.utils.data import DataBatch, sample_minibatch


class StepMetrics(NamedTuple):
    loss: torch.Tensor       # weighted-mean train loss
    examples: torch.Tensor   # real (weight > 0 sum) examples this step
    grad_norm: torch.Tensor  # global L2 norm of the averaged gradients


def train_step(module: nn.Module, loss_fn: Callable,
               optimizer: torch.optim.Optimizer, batch: DataBatch,
               mini_batch: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> StepMetrics:
    """One optimizer step on ``batch`` (or a ``mini_batch``-row block of
    it, its offset drawn from the host-side ``generator``)."""
    mb = batch
    if mini_batch is not None and mini_batch < batch.size:
        mb = sample_minibatch(batch, generator, mini_batch)
    optimizer.zero_grad(set_to_none=True)
    per = loss_fn(module(mb.x), mb.y)
    num = (per * mb.w).sum()
    den = mb.w.sum()
    num.backward()

    safe_den = den.clamp_min(1.0)
    grads = []
    for p in module.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    torch._foreach_div_(grads, safe_den)
    grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    optimizer.step()
    return StepMetrics(loss=num.detach() / safe_den, examples=den,
                       grad_norm=grad_norm)


@torch.no_grad()
def eval_step(module: nn.Module, loss_fn: Callable,
              batch: DataBatch) -> torch.Tensor:
    """Weighted-mean loss of ``batch`` with the module in eval mode —
    the JAX package's ``make_eval_step``."""
    was_training = module.training
    module.eval()
    try:
        per = loss_fn(module(batch.x), batch.y)
    finally:
        module.train(was_training)
    return (per * batch.w).sum() / batch.w.sum().clamp_min(1.0)
