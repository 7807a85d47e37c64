"""Tensor parallelism over the mesh's ``tp`` axis: the transformer laid out Megatron-style on local shards.

The JAX package lays its parameters out by the sharding rules
(``sparktorch_tpu/parallel/sharding_rules.py:62-80``) and lets GSPMD
insert the collectives; its pipeline trainer writes them by hand as an
f/g pair (``sparktorch_tpu/train/pipeline.py:107-135``). The port does
the latter for the sharded trainer. Each rank holds plain tensors, its
own shards, and three autograd functions carry the traffic over the tp
group:

- :func:`tp_enter` (f): identity forward, all-reduce backward. It
  enters a tp-parallel region, so the replicated stream's cotangent
  comes back whole (summed over every head or column slice) and equal
  on every tp peer;
- :func:`tp_reduce` (g): all-reduce forward, identity backward. It
  leaves a row-parallel region;
- :func:`tp_gather`: all-gather over the last dimension forward, this
  rank's slice backward. It gathers vocab-split logits, which the loss
  then reads whole on every peer (so the fused cross-entropy kernel runs
  on full rows, as the JAX kernel does under GSPMD).

:func:`parallelize` swaps each split module's class for its tp twin and
keeps only this rank's shard of each split leaf:

- ``attn.qkv`` column-parallel by heads (each of q, k and v keeps rows
  of heads ``r·h/tp .. (r+1)·h/tp``), ``attn.proj`` row-parallel;
  the flash kernels then run on the rank's h/tp heads;
- ``mlp_in`` column-parallel, ``mlp_out`` row-parallel;
- row-parallel biases are replicated and added once, after the
  reduction;
- ``tok_embed`` vocab-parallel: each rank looks up the ids it owns, the
  rows are summed over tp, and only an id outside the whole vocabulary
  reads NaN (the unsharded ``Embed``'s rule);
- ``lm_head`` vocab-parallel: local logits, gathered, then the
  replicated bias.

Every replicated leaf (LayerNorm, the row-parallel biases, the position
table, a classifier head) gets its whole gradient on every tp peer, with
no 1/tp factor. A ``remat`` layer's recompute repeats its forward
collectives in the backward, in the same order on every peer (each runs
the same graph). Which leaves split follows the placements of
:func:`~sparktorch_tpu_torch.parallel.sharding_rules.shard_params`: a
layer whose heads (or d_ff, or vocabulary) tp does not divide stays
whole. Mixture-of-experts layers are not split over tp (ROADMAP, Queue
1, step 6 part 4).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sparktorch_tpu_torch.models.transformer import (
    Dense,
    Embed,
    EncoderLayer,
    MoEFFN,
    MultiHeadAttention,
)
from sparktorch_tpu_torch.parallel.mesh import AXIS_TP, Mesh


def _on_tp(spec) -> bool:
    return any(AXIS_TP in (a if isinstance(a, tuple) else (a,))
               for a in spec if a is not None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_gather(x: torch.Tensor, group, rank: int, size: int
                ) -> torch.Tensor:
    """(size, *x.shape): every peer's ``x``, stacked in tp order. Gloo
    has no all-gather of CUDA tensors, so there the peers' slices are
    summed into zeros (an exact sum: one term is nonzero)."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        out = x.new_zeros((size,) + tuple(x.shape))
        out[rank] = x
        dist.all_reduce(out, group=group)
        return out
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view((size,) + tuple(x.shape))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.n = rank, x.shape[-1]
        full = _all_gather(x, group, rank, size)
        return full.movedim(0, -2).reshape(*x.shape[:-1], size * x.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.n, ctx.n), None, None, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """f: identity forward, all-reduce of the cotangent backward."""
    return _Enter.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """g: all-reduce forward, identity backward."""
    return _Reduce.apply(x, group)


def tp_gather(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """The peers' last dimensions concatenated in tp order; the backward
    keeps this rank's slice (the loss after it is the same on every
    peer)."""
    return _Gather.apply(x, group, rank, size)


def shard_tensor(full: torch.Tensor, dim: int, factor: int, rank: int,
                 size: int) -> torch.Tensor:
    """This rank's tp shard of ``full`` along ``dim``: the dimension
    viewed as ``factor`` equal blocks (3 for the fused qkv: q, k, v),
    each split ``size`` ways, and the rank's part of each kept."""
    shape = full.shape
    blocks = full.reshape(*shape[:dim], factor, size,
                          shape[dim] // (factor * size), *shape[dim + 1:])
    part = blocks.select(dim + 1, rank)
    return part.reshape(*shape[:dim], shape[dim] // size, *shape[dim + 1:])


def gather_tensor(local: torch.Tensor, dim: int, factor: int, group,
                  rank: int, size: int) -> torch.Tensor:
    """The full tensor of every peer's :func:`shard_tensor` (a
    collective over the tp group)."""
    full = _all_gather(local, group, rank, size)  # (size, *local.shape)
    shape = local.shape
    blocks = full.reshape(size, *shape[:dim], factor,
                          shape[dim] // factor, *shape[dim + 1:])
    blocks = blocks.movedim(0, dim + 1)  # (..., factor, size, chunk, ...)
    return blocks.reshape(*shape[:dim], shape[dim] * size, *shape[dim + 1:])


class _TpModule:
    """What a split module knows of its tp group, and which of its
    leaves are split on which dimension (name → (dim, factor))."""

    tp_group = None
    tp_rank = 0
    tp_size = 1
    tp_leaves: Dict[str, Tuple[int, int]] = {}

    def _split(self, group, rank: int, size: int,
               leaves: Dict[str, Tuple[int, int]]) -> None:
        self.tp_group, self.tp_rank, self.tp_size = group, rank, size
        self.tp_leaves = leaves
        for name, (dim, factor) in leaves.items():
            full = getattr(self, name).detach()
            setattr(self, name, nn.Parameter(
                shard_tensor(full, dim, factor, rank, size).clone()))


class ColumnParallelDense(_TpModule, Dense):
    """This rank's output features (by heads, for the fused qkv); the
    input enters through f."""

    def forward(self, x):
        return Dense.forward(self, tp_enter(x, self.tp_group))


class RowParallelDense(_TpModule, Dense):
    """This rank's input features; the partial outputs are summed over
    tp (g), then the replicated bias is added once."""

    def forward(self, x):
        dt = self.compute_dtype
        y = tp_reduce(F.linear(x.to(dt), self.weight.to(dt)), self.tp_group)
        return y + self.bias.to(dt)


class VocabParallelEmbed(_TpModule, Embed):
    """This rank's rows of the table; ``num_embeddings`` stays the whole
    vocabulary."""

    def forward(self, ids):
        n = self.weight.shape[0]
        local = ids - self.tp_rank * n
        own = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), self.weight)
        rows = tp_reduce(rows.masked_fill(~own[..., None], 0.0),
                         self.tp_group)
        bad = (ids < 0) | (ids >= self.num_embeddings)
        return rows.masked_fill(bad[..., None], float("nan")).to(
            self.compute_dtype)

    def attend(self, x):
        local = tp_enter(x, self.tp_group).float() @ self.weight.float().T
        return tp_gather(local, self.tp_group, self.tp_rank, self.tp_size)


class VocabParallelHead(_TpModule, Dense):
    """This rank's vocabulary columns of the LM head: local logits,
    gathered over tp, then the replicated bias."""

    def forward(self, x):
        dt = self.compute_dtype
        local = F.linear(tp_enter(x, self.tp_group).to(dt),
                         self.weight.to(dt))
        return (tp_gather(local, self.tp_group, self.tp_rank, self.tp_size)
                + self.bias.to(dt))


def _swap(module: nn.Module, cls, mesh: Mesh,
          leaves: Dict[str, Tuple[int, int]]) -> None:
    module.__class__ = cls
    module._split(mesh.tp_group, mesh.tp_rank, mesh.tp, leaves)
    if isinstance(module, nn.Linear):
        module.out_features, module.in_features = module.weight.shape


def parallelize(module: nn.Module, mesh: Mesh, placements: Dict[str, tuple]
                ) -> Dict[str, Tuple[int, int]]:
    """Lay ``module`` out over the tp axis as ``placements`` (name →
    spec, :func:`~sparktorch_tpu_torch.parallel.sharding_rules.
    shard_params`) say, in place. Returns the split leaves (name →
    (dim, factor), :func:`tp_leaves`). A no-op at tp = 1."""
    if mesh.tp == 1:
        return {}
    if any(isinstance(m, MoEFFN) for m in module.modules()):
        raise NotImplementedError(
            "mixture-of-experts layers under tp > 1 are not ported yet "
            "(ROADMAP, Queue 1, step 6 part 4: ep, with the experts' tp "
            "split)")

    def split(name: str) -> bool:
        return _on_tp(placements[name])

    for prefix, sub in list(module.named_modules()):
        at = f"{prefix}." if prefix else ""
        if isinstance(sub, MultiHeadAttention) and split(f"{at}qkv.weight"):
            _swap(sub.qkv, ColumnParallelDense, mesh,
                  {"weight": (0, 3), "bias": (0, 3)})
            _swap(sub.proj, RowParallelDense, mesh, {"weight": (1, 1)})
        elif (isinstance(sub, EncoderLayer) and not sub.use_moe
              and split(f"{at}mlp_in.weight")):
            _swap(sub.mlp_in, ColumnParallelDense, mesh,
                  {"weight": (0, 1), "bias": (0, 1)})
            _swap(sub.mlp_out, RowParallelDense, mesh, {"weight": (1, 1)})
        elif isinstance(sub, Embed) and split(f"{at}weight"):
            _swap(sub, VocabParallelEmbed, mesh, {"weight": (0, 1)})
        elif (isinstance(sub, Dense) and prefix.endswith("lm_head")
              and split(f"{at}weight")):
            _swap(sub, VocabParallelHead, mesh, {"weight": (0, 1)})
    laid = tp_leaves(module)
    missed = [k for k, v in placements.items() if _on_tp(v) and k not in laid]
    if missed:
        raise NotImplementedError(
            f"no tp layout for {missed} (the port splits the transformer's "
            "attention, MLP, embedding and LM head)")
    return laid


def tp_leaves(module: nn.Module) -> Dict[str, Tuple[int, int]]:
    """The tp-split leaves of ``module``: name → (dim, factor), where
    ``factor`` blocks of the dimension are each split tp ways."""
    out = {}
    for prefix, sub in module.named_modules():
        for leaf, where in getattr(sub, "tp_leaves", {}).items():
            out[f"{prefix}.{leaf}" if prefix else leaf] = where
    return out
