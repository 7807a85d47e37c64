"""Model packaging — the port of ``sparktorch_tpu/utils/serde.py``.

A :class:`ModelSpec` ships a torch module eagerly (the module object,
weights included, as the reference sparktorch's ``serialize_torch_obj``
did) or lazily (its class and constructor kwargs, so the module is
first built where it runs). The JSON envelope keeps the JAX package's
fields: ``torch_obj`` (base64 dill of the spec), ``shapes`` (parameter
shapes), ``version`` and ``framework``. Shapes come from the module
built on the ``meta`` device — no weights allocated — the counterpart
of ``jax.eval_shape``.

Loss and optimizer travel as names (or callables) and params; the
training step resolves them with :meth:`ModelSpec.loss_fn` and
:meth:`ModelSpec.make_optimizer`. The optimizer names keep the JAX
package's meaning: they resolve to the optax update rules and defaults
(``sparktorch_tpu/utils/serde.py:56-125``), which are not always
``torch.optim``'s.
"""

from __future__ import annotations

import codecs
import copy
import dataclasses
import json
from typing import (Any, Callable, Iterable, Mapping, Optional, Sequence,
                    Tuple, Union)

import dill
import torch
from torch import nn

from sparktorch_tpu_torch.utils import optim
from sparktorch_tpu_torch.utils.losses import LossFn, resolve_loss

ENVELOPE_VERSION = 1
FRAMEWORK = "sparktorch_tpu_torch"

# ---------------------------------------------------------------------------
# Optimizer registry: name -> factory(params, **optax-named kwargs). The
# torch spelling ``lr`` is accepted as in the JAX package; every other
# kwarg takes its optax name (``weight_decay`` is the same in both).
# ---------------------------------------------------------------------------

# torch.optim constructor default learning rates for the names torch.optim
# has (the JAX package applies the same table).
_TORCH_DEFAULT_LR: dict[str, float] = {
    "adam": 1e-3, "Adam": 1e-3, "adamw": 1e-3, "AdamW": 1e-3,
    "rmsprop": 1e-2, "RMSprop": 1e-2, "adagrad": 1e-2, "Adagrad": 1e-2,
}

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def _map_opt_kwargs(kwargs: Mapping[str, Any]) -> dict:
    """torch's ``lr`` under optax's name ``learning_rate``."""
    return {("learning_rate" if k == "lr" else k): v
            for k, v in kwargs.items()}


def _sgd(params, learning_rate=0.01, momentum=0.0, nesterov=False, **kw):
    # optax sgd: trace t ← g + m·t (Nesterov: g + m·t), then −lr — the
    # rule torch.optim.SGD applies with dampening 0. Extra kwargs are
    # ignored, as the JAX package's _sgd ignores them.
    momentum = momentum or 0.0
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           nesterov=bool(nesterov and momentum))


def _adam(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    # optax adam = torch.optim.Adam's rule: m̂ / (√v̂ + ε).
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps)


def _adamw(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
           weight_decay=1e-4):
    # optax adamw decays every parameter by lr·wd·p beside the Adam step,
    # as torch.optim.AdamW does; optax's default weight_decay is 1e-4
    # (torch's is 1e-2).
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


def _rmsprop(params, learning_rate, **kw):
    return optim.RMSprop(params, lr=learning_rate, **kw)


def _adagrad(params, learning_rate, **kw):
    return optim.Adagrad(params, lr=learning_rate, **kw)


def _adafactor(params, learning_rate=None, **kw):
    # optax's adafactor takes no learning rate by default (the update is
    # then scaled by the parameter's RMS alone).
    return optim.Adafactor(params, lr=learning_rate, **kw)


# lamb and lion have no torch.optim default learning rate: a missing one
# raises a TypeError, as optax's constructors do.
def _lamb(params, learning_rate, **kw):
    return optim.Lamb(params, lr=learning_rate, **kw)


def _lion(params, learning_rate, **kw):
    return optim.Lion(params, lr=learning_rate, **kw)


OPTIMIZER_REGISTRY: dict[str, Callable[..., torch.optim.Optimizer]] = {
    "sgd": _sgd,
    "adam": _adam,
    "adamw": _adamw,
    "rmsprop": _rmsprop,
    "adagrad": _adagrad,
    "adafactor": _adafactor,
    "lamb": _lamb,
    "lion": _lion,
    # torch.optim class-name spellings.
    "SGD": _sgd,
    "Adam": _adam,
    "AdamW": _adamw,
    "RMSprop": _rmsprop,
    "Adagrad": _adagrad,
}


def resolve_optimizer(
    optimizer: Union[str, Callable, None],
    optimizer_params: Optional[Mapping[str, Any]] = None,
) -> OptimizerFactory:
    """Bind an optimizer spec to a factory ``params -> torch.optim.Optimizer``.

    A registry name follows the optax rule and defaults of the same name
    in the JAX package; ``None`` is plain SGD at lr 0.01; any other
    callable (a ``torch.optim`` class, say) is called as
    ``optimizer(params, **optimizer_params)``.
    """
    if optimizer is not None and not isinstance(optimizer, str):
        kwargs = dict(optimizer_params or {})
        return lambda params: optimizer(params, **kwargs)
    kwargs = _map_opt_kwargs(optimizer_params or {})
    if optimizer is None:
        lr = kwargs.pop("learning_rate", 0.01)
        return lambda params: torch.optim.SGD(params, lr=lr)
    try:
        build = OPTIMIZER_REGISTRY[optimizer]
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {optimizer!r}; known: "
            f"{sorted(OPTIMIZER_REGISTRY)}") from None
    if optimizer in _TORCH_DEFAULT_LR:
        kwargs.setdefault("learning_rate", _TORCH_DEFAULT_LR[optimizer])
    return lambda params: build(params, **kwargs)


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
    loss: Union[str, LossFn] = "mse"
    optimizer: Union[str, Callable, None] = "sgd"
    optimizer_params: dict = dataclasses.field(default_factory=dict)
    input_shape: Optional[Tuple[int, ...]] = None  # per-example, no batch dim
    input_dtype: str = "float32"
    is_lazy: bool = False
    param_shapes: Optional[list] = None  # recorded at serialize time

    def make_module(self) -> nn.Module:
        if self.module is not None:
            return self._sized(self.module)
        if self.module_cls is None:
            raise ValueError("ModelSpec has neither module nor module_cls")
        return self._sized(self.module_cls(**self.module_kwargs))

    def _sized(self, module: nn.Module, device=None) -> nn.Module:
        """``module`` with its lazy layers (``nn.LazyLinear``: a port
        ``MLP`` given no ``in_features``) sized by one forward of a
        zero ``input_shape`` example, as Flax sizes a layer at init."""
        lazy = any(isinstance(p, nn.parameter.UninitializedParameter)
                   for p in module.parameters())
        if lazy and self.input_shape is not None:
            x = torch.zeros((1, *self.input_shape), device=device,
                            dtype=getattr(torch, self.input_dtype))
            with torch.no_grad():
                module(x)
        return module

    def loss_fn(self) -> LossFn:
        return resolve_loss(self.loss)

    def make_optimizer(self, params: Iterable[torch.Tensor],
                       flax_shapes: Optional[Mapping[torch.Tensor,
                                                     Sequence[int]]] = None
                       ) -> torch.optim.Optimizer:
        """The spec's optimizer over ``params``. ``flax_shapes``
        (:func:`~sparktorch_tpu_torch.utils.optim.flax_shapes` of the
        module) gives Adafactor the Flax shape of each parameter whose
        layout differs, so it factors as optax does."""
        opt = resolve_optimizer(self.optimizer, self.optimizer_params)(params)
        if isinstance(opt, optim.Adafactor) and flax_shapes:
            opt.flax_shapes.update(flax_shapes)
        return opt

    def abstract_module(self) -> nn.Module:
        """The module on the ``meta`` device: shapes and dtypes, no
        weights, no initialisation work."""
        if self.module is not None:
            return meta_copy(self.make_module())
        with torch.device("meta"):
            module = self.module_cls(**self.module_kwargs)
        return self._sized(module, device="meta")


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
