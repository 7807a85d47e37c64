"""Parameter sharding rules: parameter name → placement — the port of ``sparktorch_tpu/parallel/sharding_rules.py``.

The rule table is the JAX package's, keyed on the port's parameter
names and written in the port's layouts (a Flax Dense kernel is
(in, out) where the torch weight is (out, in); the fused qkv kernel
(d, 3, h, hd) is the weight (3·h·hd, d) here, its heads in dimension 0;
the proj kernel (h, hd, d) is (d, h·hd)). First match wins:

- qkv / mlp-in: column-parallel over ``tp`` (output dim);
- attention-out / mlp-out: row-parallel over ``tp`` (input dim);
- the token embedding: vocab over ``tp``, model dim over ``fsdp``;
- the LM head: vocab over ``tp``;
- the MoE expert weights: experts over ``ep``, the FFN's inner dim
  over ``tp``;
- everything else: ``fsdp``-sharded on the largest divisible dim of its
  Flax layout (:func:`~sparktorch_tpu_torch.parallel.mesh.
  fsdp_param_sharding`), else replicated.

As in the JAX package, a matched rule whose spec fits the mesh is kept
even when its axes have size 1: with ``tp`` = ``ep`` = 1 the qkv, proj,
MLP, LM-head and expert weights stay replicated, and do not fall back
to ``fsdp``. The port's mesh has tp = 1 (``MeshConfig``), so a spec
fits exactly when it fits the Flax layout.
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

# (name regex, spec builder taking the leaf's ndim) — first match wins.
_TRANSFORMER_RULES = [
    (re.compile(r".*attn\.qkv\.weight$"), lambda nd: (AXIS_TP, None)),
    (re.compile(r".*attn\.qkv\.bias$"), lambda nd: (AXIS_TP,)),
    (re.compile(r".*attn\.proj\.weight$"), lambda nd: (None, AXIS_TP)),
    (re.compile(r".*mlp_in\.weight$"), lambda nd: (AXIS_TP, None)),
    (re.compile(r".*mlp_in\.bias$"), lambda nd: (AXIS_TP,) if nd == 1 else ()),
    (re.compile(r".*mlp_out\.weight$"), lambda nd: (None, AXIS_TP)),
    (re.compile(r".*tok_embed\.weight$"), lambda nd: (AXIS_TP, AXIS_FSDP)),
    (re.compile(r".*lm_head\.weight$"), lambda nd: (AXIS_TP, None)),
    (re.compile(r".*moe_w_in$"), lambda nd: (AXIS_EP, None, AXIS_TP)),
    (re.compile(r".*moe_b_in$"), lambda nd: (AXIS_EP, AXIS_TP)),
    (re.compile(r".*moe_w_out$"), lambda nd: (AXIS_EP, AXIS_TP, None)),
    (re.compile(r".*moe_b_out$"), lambda nd: (AXIS_EP, None)),
]


def _strip(spec: Sequence) -> Spec:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def flax_dims(module: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """For the parameter ``name`` of ``module``: the port dimension of
    each dimension of its Flax layout. A Linear weight (out, in) is the
    Flax kernel (in, out); a Conv2d weight OIHW is the kernel HWIO;
    everything else (embeddings, norms, raw parameters) has one
    layout."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    if leaf == "weight" and isinstance(owner, nn.Linear) and ndim == 2:
        return (1, 0)
    if leaf == "weight" and isinstance(owner, nn.Conv2d) and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def transformer_rules(mesh: Mesh) -> Callable:
    """Rules callable: (name, shape, flax_dims) → placement spec in the
    port's layout."""

    def rule(name: str, shape: Sequence[int],
             dims: Sequence[int]) -> Spec:
        nd = len(shape)
        for pattern, builder in _TRANSFORMER_RULES:
            if pattern.match(name):
                spec = builder(nd)
                if _spec_fits(spec, shape, mesh):
                    return _strip(spec)
                break
        flax = fsdp_param_sharding(mesh, [shape[d] for d in dims])
        port = [None] * nd
        for i, axis in enumerate(flax):
            port[dims[i]] = axis
        return _strip(port)

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
    return {name: rules(name, tuple(p.shape), flax_dims(module, name, p.ndim))
            for name, p in module.named_parameters()}
