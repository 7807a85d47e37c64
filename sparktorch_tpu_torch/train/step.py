"""The data-parallel train step — the port of ``_dp_body`` (``sparktorch_tpu/train/step.py:292``).

One step: take the batch (or a sampled minibatch of it), run the module,
and back-propagate the example-weighted loss SUM, then divide the
gradients and the loss by the weight sum — the JAX step's reduction:

    num = Σ w·ℓ,   den = Σ w,   grads = ∇num / max(den, 1),
    loss = num / max(den, 1).

The division is its own step after the backward. Given a process
``group`` (the data-parallel trainers pass their mesh's), the step makes
ONE coalesced ``all_reduce(SUM)`` right there, over a flat buffer of
num, den, every gradient and the BatchNorm running statistics — the
psums and the pmean of the JAX step (``sparktorch_tpu/train/step.py:
327-346``) — and divides by the global weight sum. That keeps padding
rows (weight 0), ragged and empty shards exact, which DDP's
divide-by-world-size would not; the running statistics are then
averaged over the ranks. Without a group the step makes no collective
call. Every parameter that got no gradient gets a zero one, so
optimizers that act without a gradient (AdamW's decay) act on it as
optax does, and every rank reduces the same layout. Nothing here reads
a value back to the host: the step returns its metrics as device
scalars.

Mixture-of-experts models: a module whose ``forward`` takes
``example_w`` gets the batch's weights (MoE routing masks the weight-0
rows out), and the forward runs inside
:func:`~sparktorch_tpu_torch.models.transformer.collect_moe`. The
layers' load-balance losses join the objective as the JAX step adds its
sown losses, ``num = Σ w·ℓ + aux·den``, and their (dropped, routed)
counts ride in the same all-reduce; ``drop_fraction`` is dropped /
max(routed, 1), None for a model without MoE layers.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from sparktorch_tpu_torch.models.transformer import collect_moe
from sparktorch_tpu_torch.utils.data import DataBatch, sample_minibatch


class StepMetrics(NamedTuple):
    loss: torch.Tensor       # weighted-mean train loss
    examples: torch.Tensor   # real (weight > 0 sum) examples this step
    grad_norm: torch.Tensor  # global L2 norm of the averaged gradients
    # dropped / routed MoE token-choices; None without MoE layers
    drop_fraction: Optional[torch.Tensor] = None


def accepts_example_w(module: nn.Module) -> bool:
    """Whether ``module.forward`` takes per-example weights
    (``example_w``), the hook MoE models use to mask weight-0 rows out
    of routing (the JAX step's ``_accepts_example_w``)."""
    try:
        return "example_w" in inspect.signature(module.forward).parameters
    except (TypeError, ValueError):
        return False


def forward(module: nn.Module, x: torch.Tensor, w: torch.Tensor):
    """``module(x)``, with ``example_w=w`` where the module takes it."""
    return module(x, example_w=w) if accepts_example_w(module) else module(x)


def batchnorm_stats(module: nn.Module) -> List[torch.Tensor]:
    """The floating-point BatchNorm running statistics of ``module``
    (``running_mean``, ``running_var``); integer buffers such as
    ``num_batches_tracked`` are left out."""
    return [b for name, b in module.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")
            and b.is_floating_point()]


@torch.no_grad()
def all_reduce_sums(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` in place over ``group`` with one ``all_reduce``
    of a flat buffer (in their common dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def train_step(module: nn.Module, loss_fn: Callable,
               optimizer: torch.optim.Optimizer, batch: DataBatch,
               mini_batch: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               group=None) -> StepMetrics:
    """One optimizer step on ``batch`` (or a ``mini_batch``-row block of
    it, its offset drawn from the host-side ``generator``). With a
    process ``group``, ``batch`` is this rank's shard and the step is
    data-parallel over the group (module docstring)."""
    mb = batch
    if mini_batch is not None and mini_batch < batch.size:
        mb = sample_minibatch(batch, generator, mini_batch)
    optimizer.zero_grad(set_to_none=True)
    # The block closes before the backward, so a remat layer recomputed
    # there records nothing a second time.
    with collect_moe() as moe:
        preds = forward(module, mb.x, mb.w)
    per = loss_fn(preds, mb.y)
    den = mb.w.sum()
    num = (per * mb.w).sum()
    aux = moe.aux_total()
    if aux is not None:
        num = num + aux.to(num.dtype) * den
    num.backward()

    grads = []
    for p in module.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    num = num.detach()
    counts = moe.counts()  # (dropped, routed), f32
    if group is not None:
        sums = torch.stack([num, den.to(num.dtype)])
        stats = batchnorm_stats(module) if module.training else []
        extra = [] if counts is None else [counts]
        all_reduce_sums([sums, *extra, *grads, *stats], group)
        num, den = sums[0], sums[1].to(den.dtype)
        if stats:
            torch._foreach_div_(stats, float(dist.get_world_size(group)))
    safe_den = den.clamp_min(1.0)
    torch._foreach_div_(grads, safe_den)
    grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    optimizer.step()
    return StepMetrics(
        loss=num / safe_den, examples=den, grad_norm=grad_norm,
        drop_fraction=None if counts is None
        else counts[0] / counts[1].clamp_min(1.0))


@torch.no_grad()
def eval_step(module: nn.Module, loss_fn: Callable,
              batch: DataBatch, group=None) -> torch.Tensor:
    """Weighted-mean loss of ``batch`` with the module in eval mode —
    the JAX package's ``make_eval_step``; with a process ``group`` the
    weighted sums are reduced over it first (the global mean)."""
    was_training = module.training
    module.eval()
    try:
        # Weight-0 rows stay out of MoE routing; no aux loss is added.
        per = loss_fn(forward(module, batch.x, batch.w), batch.y)
    finally:
        module.train(was_training)
    num = (per * batch.w).sum()
    sums = torch.stack([num, batch.w.sum().to(num.dtype)])
    if group is not None:
        all_reduce_sums([sums], group)
    return sums[0] / sums[1].clamp_min(1.0)
