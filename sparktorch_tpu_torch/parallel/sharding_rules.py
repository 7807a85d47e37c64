"""Parameter sharding rules: parameter name → placement — the port of ``sparktorch_tpu/parallel/sharding_rules.py``.

The rule table is the JAX package's, keyed on the port's parameter
names and matched in the Flax layout of each leaf (a Dense kernel is
(in, out) where the torch weight is (out, in); the fused qkv kernel
(d, 3, h, hd) is the weight (3·h·hd, d) here, its bias (3, h, hd) the
bias (3·h·hd,); the proj kernel (h, hd, d) is (d, h·hd)). First match
wins:

- qkv / mlp-in: column-parallel over ``tp`` (qkv by heads, in each of
  q, k and v);
- attention-out / mlp-out: row-parallel over ``tp`` (input dim);
- the token embedding: vocab over ``tp``, model dim over ``fsdp``;
- the LM head: vocab over ``tp``;
- the MoE expert weights: experts over ``ep``, the FFN's inner dim
  over ``tp``;
- everything else: ``fsdp``-sharded on the largest divisible dim of its
  Flax layout (:func:`~sparktorch_tpu_torch.parallel.mesh.
  fsdp_param_sharding`), else replicated.

As in the JAX package, a rule fits when each named axis divides the
Flax dimension it names: the qkv rule needs ``h % tp == 0``, not
``3·h·hd % tp == 0``. A matched rule that does not fit falls through
to ``fsdp_param_sharding``; one that fits is kept even when its axes
have size 1 (with ``tp`` = ``ep`` = 1 the qkv, proj, MLP, LM-head and
expert weights stay replicated, and do not fall back to ``fsdp``).

The placement is then written in the port's layout: each port dimension
carries the axes of the Flax dimensions it is made of. The qkv weight's
``("tp",)`` is thus a split of dimension 0 by heads, which
:mod:`~sparktorch_tpu_torch.parallel.tp` lays out.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple

from torch import nn

from sparktorch_tpu_torch.parallel.mesh import (
    AXIS_EP,
    AXIS_FSDP,
    AXIS_TP,
    Mesh,
    Spec,
    fsdp_param_sharding,
)

# (name regex, Flax spec builder taking the leaf's Flax ndim) — first
# match wins; the JAX package's table, row for row.
_TRANSFORMER_RULES = [
    (re.compile(r".*attn\.qkv\.weight$"),
     lambda nd: (None,) * (nd - 2) + (AXIS_TP, None)),
    (re.compile(r".*attn\.qkv\.bias$"),
     lambda nd: (None,) * (nd - 2) + (AXIS_TP, None) if nd >= 2 else ()),
    (re.compile(r".*attn\.proj\.weight$"),
     lambda nd: (AXIS_TP,) + (None,) * (nd - 1)),
    (re.compile(r".*mlp_in\.weight$"),
     lambda nd: (None,) * (nd - 1) + (AXIS_TP,)),
    (re.compile(r".*mlp_in\.bias$"), lambda nd: (AXIS_TP,) if nd == 1 else ()),
    (re.compile(r".*mlp_out\.weight$"),
     lambda nd: (AXIS_TP,) + (None,) * (nd - 1)),
    (re.compile(r".*tok_embed\.weight$"), lambda nd: (AXIS_TP, AXIS_FSDP)),
    (re.compile(r".*lm_head\.weight$"), lambda nd: (None, AXIS_TP)),
    (re.compile(r".*moe_w_in$"), lambda nd: (AXIS_EP, None, AXIS_TP)),
    (re.compile(r".*moe_b_in$"), lambda nd: (AXIS_EP, AXIS_TP)),
    (re.compile(r".*moe_w_out$"), lambda nd: (AXIS_EP, AXIS_TP, None)),
    (re.compile(r".*moe_b_out$"), lambda nd: (AXIS_EP, None)),
]

# The fused attention leaves: for each port dimension, the Flax
# dimensions it is made of (``MultiHeadAttention.flax_param_shapes``).
_FUSED_GROUPS = {"qkv.weight": ((1, 2, 3), (0,)), "qkv.bias": ((0, 1, 2),),
                 "proj.weight": ((2,), (0, 1))}

# A Flax layout: the leaf's Flax shape and, for each port dimension, the
# Flax dimensions it is made of.
Layout = Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]


def _strip(spec: Sequence) -> Spec:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def flax_layout(module: nn.Module, name: str,
                shape: Sequence[int]) -> Layout:
    """The Flax layout of the parameter ``name`` (of port shape
    ``shape``) of ``module``. A Linear weight (out, in) is the Flax
    kernel (in, out); a Conv2d weight OIHW is the kernel HWIO; the
    attention's fused leaves take the shapes their module declares;
    everything else (embeddings, norms, raw parameters) has one
    layout."""
    shape = tuple(shape)
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    parent_name, _, owner_leaf = owner_name.rpartition(".")
    declared = getattr(module.get_submodule(parent_name),
                       "flax_param_shapes", None) if owner_name else None
    fused = f"{owner_leaf}.{leaf}"
    if declared is not None and fused in _FUSED_GROUPS:
        return tuple(declared()[fused]), _FUSED_GROUPS[fused]
    if leaf == "weight" and isinstance(owner, nn.Linear) and len(shape) == 2:
        return (shape[1], shape[0]), ((1,), (0,))
    if leaf == "weight" and isinstance(owner, nn.Conv2d) and len(shape) == 4:
        return ((shape[2], shape[3], shape[1], shape[0]),
                ((3,), (2,), (0,), (1,)))
    return shape, tuple((d,) for d in range(len(shape)))


def _to_port(spec: Spec, layout: Layout) -> Spec:
    """A Flax-layout spec written in the port's layout."""
    flax_shape, groups = layout
    spec = tuple(spec) + (None,) * (len(flax_shape) - len(spec))
    out = []
    for dims in groups:
        axes = [spec[d] for d in dims if spec[d] is not None]
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    return _strip(out)


def transformer_rules(mesh: Mesh) -> Callable:
    """Rules callable: (name, Flax layout) → placement spec in the
    port's layout."""

    def rule(name: str, layout: Layout) -> Spec:
        flax_shape = layout[0]
        for pattern, builder in _TRANSFORMER_RULES:
            if pattern.match(name):
                spec = builder(len(flax_shape))
                if _spec_fits(spec, flax_shape, mesh):
                    return _to_port(spec, layout)
                break
        return _to_port(fsdp_param_sharding(mesh, flax_shape), layout)

    return rule


def _spec_fits(spec: Spec, shape: Sequence[int], mesh: Mesh) -> bool:
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is None:
            continue
        total = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            total *= mesh.shape[a]
        if total > 1 and dim % total != 0:
            return False
    return True


def shard_params(module: nn.Module, mesh: Mesh,
                 rules: Optional[Callable] = None) -> Dict[str, Spec]:
    """The placement of every parameter of ``module`` (name → spec, in
    ``named_parameters`` order). ``module`` may live on the ``meta``
    device."""
    rules = rules or transformer_rules(mesh)
    return {name: rules(name, flax_layout(module, name, p.shape))
            for name, p in module.named_parameters()}
