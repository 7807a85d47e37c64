"""Model packaging — the port of ``sparktorch_tpu/utils/serde.py``.

A :class:`ModelSpec` ships a torch module eagerly (the module object,
weights included, as the reference sparktorch's ``serialize_torch_obj``
did) or lazily (its class and constructor kwargs, so the module is
first built where it runs). The JSON envelope keeps the JAX package's
fields: ``torch_obj`` (base64 dill of the spec), ``shapes`` (parameter
shapes), ``version`` and ``framework``. Shapes come from the module
built on the ``meta`` device — no weights allocated — the counterpart
of ``jax.eval_shape``.

Loss and optimizer travel as names and params only; resolving them
belongs to the training slice, which is not ported yet.
"""

from __future__ import annotations

import codecs
import copy
import dataclasses
import json
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import dill
import torch
from torch import nn

ENVELOPE_VERSION = 1
FRAMEWORK = "sparktorch_tpu_torch"


def meta_copy(module: nn.Module) -> nn.Module:
    """A weight-free copy of ``module``: same structure, every
    parameter and buffer on the ``meta`` device. Shared tensors stay
    shared."""
    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        meta = t.detach().to("meta")
        memo[id(t)] = (nn.Parameter(meta, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else meta)
    return copy.deepcopy(module, memo)


@dataclasses.dataclass
class ModelSpec:
    """The unit of model shipment. Exactly one of ``module`` (eager) or
    ``module_cls`` (lazy) is set."""

    module: Any = None
    module_cls: Optional[type] = None
    module_kwargs: dict = dataclasses.field(default_factory=dict)
    loss: Union[str, Callable] = "mse"
    optimizer: Union[str, Callable, None] = "sgd"
    optimizer_params: dict = dataclasses.field(default_factory=dict)
    input_shape: Optional[Tuple[int, ...]] = None  # per-example, no batch dim
    input_dtype: str = "float32"
    is_lazy: bool = False
    param_shapes: Optional[list] = None  # recorded at serialize time

    def make_module(self) -> nn.Module:
        if self.module is not None:
            return self.module
        if self.module_cls is None:
            raise ValueError("ModelSpec has neither module nor module_cls")
        return self.module_cls(**self.module_kwargs)

    def abstract_module(self) -> nn.Module:
        """The module on the ``meta`` device: shapes and dtypes, no
        weights, no initialisation work."""
        if self.module is not None:
            return meta_copy(self.module)
        with torch.device("meta"):
            return self.make_module()


def spec_encoder(obj: Any) -> str:
    """dill -> base64 str."""
    return codecs.encode(dill.dumps(obj), "base64").decode()


def spec_decoder(s: str) -> Any:
    """base64 str -> object."""
    if isinstance(s, str):
        s = s.encode()
    return dill.loads(codecs.decode(s, "base64"))


def _envelope(spec: ModelSpec) -> str:
    spec.param_shapes = [list(t.shape) for t in
                         spec.abstract_module().state_dict().values()]
    return json.dumps(
        {
            "torch_obj": spec_encoder(spec),
            "shapes": spec.param_shapes,
            "version": ENVELOPE_VERSION,
            "framework": FRAMEWORK,
        }
    )


def serialize_model(
    model: nn.Module,
    criterion: Union[str, Callable] = "mse",
    optimizer: Union[str, Callable, None] = "sgd",
    optimizer_params: Optional[Mapping[str, Any]] = None,
    input_shape: Optional[Sequence[int]] = None,
    input_dtype: str = "float32",
) -> str:
    """Eagerly package a torch module (with its weights) + loss and
    optimizer names."""
    spec = ModelSpec(
        module=model,
        loss=criterion,
        optimizer=optimizer,
        optimizer_params=dict(optimizer_params or {}),
        input_shape=tuple(input_shape) if input_shape is not None else None,
        input_dtype=input_dtype,
        is_lazy=False,
    )
    return _envelope(spec)


def serialize_model_lazy(
    model: type,
    criterion: Union[str, Callable] = "mse",
    optimizer: Union[str, Callable, None] = "sgd",
    optimizer_params: Optional[Mapping[str, Any]] = None,
    model_parameters: Optional[Mapping[str, Any]] = None,
    input_shape: Optional[Sequence[int]] = None,
    input_dtype: str = "float32",
) -> str:
    """Package a module *class* + constructor kwargs; the module is
    built where it runs, so the sender never holds weights."""
    spec = ModelSpec(
        module_cls=model,
        module_kwargs=dict(model_parameters or {}),
        loss=criterion,
        optimizer=optimizer,
        optimizer_params=dict(optimizer_params or {}),
        input_shape=tuple(input_shape) if input_shape is not None else None,
        input_dtype=input_dtype,
        is_lazy=True,
    )
    return _envelope(spec)


def deserialize_model(payload: Union[str, ModelSpec]) -> ModelSpec:
    """Envelope/b64 string -> ModelSpec. Accepts the JSON envelope, a
    bare base64 dill string, or an already-decoded ModelSpec."""
    if isinstance(payload, ModelSpec):
        return payload
    text = payload.strip()
    if text.startswith("{"):
        env = json.loads(text)
        spec = spec_decoder(env["torch_obj"])
        spec.param_shapes = env.get("shapes")
        return spec
    return spec_decoder(text)


def envelope_shapes(payload: str) -> Optional[list]:
    """Read param shapes from the envelope without unpickling."""
    text = payload.strip()
    if not text.startswith("{"):
        return None
    return json.loads(text).get("shapes")


# Reference-compatible export names.
serialize_torch_obj = serialize_model
serialize_torch_obj_lazy = serialize_model_lazy
