"""Carry the JAX package's weights into the port.

:func:`state_dict_from_flax` turns Flax variables (numpy arrays, as
``jax.device_get`` gives them) of a ``SequenceClassifier``, a
``CausalLM``, a small net (``models/simple.py``) or a ResNet
(``models/resnet.py``) into the ``state_dict`` of the port's module,
whose submodules carry the Flax names. The layouts:

- ``qkv.kernel`` (d, 3, h, hd) → (d, 3·h·hd), transposed;
  ``qkv.bias`` (3, h, hd) → flat;
- ``proj.kernel`` (h, hd, d) → (h·hd, d), transposed;
- every other Dense ``kernel`` (in, out) → ``weight`` (out, in);
- Conv ``kernel`` HWIO → ``weight`` OIHW;
- LayerNorm and BatchNorm ``scale``/``bias`` → ``weight``/``bias``;
- ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``;
- ``embedding`` → ``weight``; ``pos_embed`` as it is;
- ``layer_<i>`` → ``layers.<i>``;
- an MoE layer's ``router`` kernel as every Dense kernel; its
  ``moe_w_in``, ``moe_b_in``, ``moe_w_out`` and ``moe_b_out`` (no
  ``kernel`` leaves) as they are.

The write-only collections an MoE model sows (``losses``,
``moe_metrics``; ``init`` returns them) hold no weights and are left
out.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from torch import nn

from sparktorch_tpu_torch.models.transformer import (
    CausalLM,
    SequenceClassifier,
    TransformerConfig,
)


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


_STATS = {"mean": "running_mean", "var": "running_var"}
_SOWN = ("losses", "moe_metrics", "intermediates")


def _convert_leaf(collection: str, path: tuple, value) -> tuple:
    arr = np.asarray(value, dtype=np.float32)
    module, leaf = path[-2] if len(path) > 1 else "", path[-1]
    parts = ["layers." + p[len("layer_"):] if p.startswith("layer_") else p
             for p in path[:-1]]
    if collection == "batch_stats":
        leaf = _STATS[leaf]
    elif leaf == "kernel":
        if module == "qkv":
            arr = arr.reshape(arr.shape[0], -1)
        elif module == "proj":
            arr = arr.reshape(-1, arr.shape[-1])
        # Dense (in, out) → (out, in); Conv HWIO → OIHW.
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        leaf = "weight"
    elif leaf == "bias" and module == "qkv":
        arr = arr.reshape(-1)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts + [leaf]), np.ascontiguousarray(arr)


def state_dict_from_flax(variables: Mapping, target: Union[
        nn.Module, TransformerConfig]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``target`` for the Flax ``variables``
    (``{"params": ..., "batch_stats": ...}``, or bare params) of its
    JAX counterpart. ``target`` is a port module, or the
    ``TransformerConfig`` of a SequenceClassifier (params
    ``backbone``/``pooler``/``classifier``) or a CausalLM (``backbone``
    with ``lm_head`` or a tied ``tok_embed``). Raises on a missing or
    extra key and on a shape mismatch."""
    if "params" not in variables:
        variables = {"params": variables}
    if isinstance(target, TransformerConfig):
        params = variables["params"]
        is_lm = "lm_head" in params or "tok_embed" in params
        with torch.device("meta"):
            target = (CausalLM if is_lm else SequenceClassifier)(target)
    expected = {k: tuple(v.shape) for k, v in target.state_dict().items()}
    out = {}
    for collection, tree in variables.items():
        if collection in _SOWN:
            continue
        for path, value in _flatten(tree).items():
            key, arr = _convert_leaf(collection, path, value)
            if key not in expected:
                raise KeyError(f"flax {collection} {'/'.join(path)} -> "
                               f"{key}: no such key in the port's "
                               f"{type(target).__name__}")
            if arr.shape != expected[key]:
                raise ValueError(f"{key}: shape {arr.shape} from flax, "
                                 f"expected {expected[key]}")
            out[key] = torch.tensor(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax variables lack {missing}")
    return out


def load_full_state_dict(module: nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a full ``state_dict`` (every rank holds all of it, as
    :func:`state_dict_from_flax` gives it) into ``module``, laid out over
    tp (:mod:`~sparktorch_tpu_torch.parallel.tp`), by ``fully_shard``,
    both or neither: each tp-split entry takes this rank's tp shard of
    the full tensor, each DTensor entry its own shard of that, with no
    communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from sparktorch_tpu_torch.parallel import tp

    split = tp.tp_leaves(module)
    with torch.no_grad():
        for key, t in module.state_dict().items():
            src = state_dict[key]
            if key in split:
                owner = module.get_submodule(key.rpartition(".")[0])
                src = tp.shard_tensor(src, *split[key], owner.tp_rank,
                                      owner.tp_size)
            if isinstance(t, DTensor):
                src = distribute_tensor(src.to(t.device, t.dtype),
                                        t.device_mesh, t.placements,
                                        src_data_rank=None).to_local()
                t = t.to_local()
            t.copy_(src)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of ``module`` on the CPU, DTensor entries
    gathered over fsdp and tp-split ones over tp (a collective: every
    rank of the mesh calls it)."""
    from torch.distributed.tensor import DTensor

    from sparktorch_tpu_torch.parallel import tp

    split = tp.tp_leaves(module)
    out = {}
    for k, v in module.state_dict().items():
        v = (v.full_tensor() if isinstance(v, DTensor) else v).detach()
        if k in split:
            owner = module.get_submodule(k.rpartition(".")[0])
            v = tp.gather_tensor(v, *split[k], owner.tp_group,
                                 owner.tp_rank, owner.tp_size)
        out[k] = v.cpu()
    return out
