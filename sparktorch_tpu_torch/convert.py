"""Carry the JAX package's transformer weights into the port.

:func:`state_dict_from_flax` turns a Flax ``params`` tree (numpy
arrays, as ``jax.device_get`` gives them) of a ``SequenceClassifier``
or ``CausalLM`` into the ``state_dict`` of the port's module of the
same config. The layouts:

- ``qkv.kernel`` (d, 3, h, hd) → (d, 3·h·hd), transposed;
  ``qkv.bias`` (3, h, hd) → flat;
- ``proj.kernel`` (h, hd, d) → (h·hd, d), transposed;
- every other Dense ``kernel`` (in, out) → transposed;
- LayerNorm ``scale``/``bias`` → ``weight``/``bias``;
- ``embedding`` → ``weight``; ``pos_embed`` as it is;
- ``layer_<i>`` → ``layers.<i>``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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


def _convert_leaf(path: tuple, value) -> tuple:
    arr = np.asarray(value, dtype=np.float32)
    module, leaf = path[-2] if len(path) > 1 else "", path[-1]
    parts = ["layers." + p[len("layer_"):] if p.startswith("layer_") else p
             for p in path[:-1]]
    if leaf == "kernel":
        if module == "qkv":
            arr = arr.reshape(arr.shape[0], -1)
        elif module == "proj":
            arr = arr.reshape(-1, arr.shape[-1])
        arr, leaf = arr.T, "weight"
    elif leaf == "bias" and module == "qkv":
        arr = arr.reshape(-1)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts + [leaf]), arr


def state_dict_from_flax(params: Mapping,
                         config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the Flax ``params`` of a
    SequenceClassifier (keys ``backbone``/``pooler``/``classifier``) or
    a CausalLM (``backbone`` with ``lm_head`` or a tied ``tok_embed``)
    built from ``config``. Raises on a missing or extra key and on a
    shape mismatch."""
    params = params.get("params", params)
    is_lm = "lm_head" in params or "tok_embed" in params
    with torch.device("meta"):
        target = (CausalLM if is_lm else SequenceClassifier)(config)
    expected = {k: tuple(v.shape) for k, v in target.state_dict().items()}
    out = {}
    for path, value in _flatten(params).items():
        key, arr = _convert_leaf(path, value)
        if key not in expected:
            raise KeyError(f"flax param {'/'.join(path)} -> {key}: no such "
                           f"key in the port's {type(target).__name__}")
        if arr.shape != expected[key]:
            raise ValueError(f"{key}: shape {arr.shape} from flax, "
                             f"expected {expected[key]}")
        out[key] = torch.tensor(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax params lack {missing}")
    return out
