"""Optimizers with optax's update rules where ``torch.optim`` has other ones, or none.

The JAX package resolves ``"rmsprop"``, ``"adagrad"``, ``"adafactor"``,
``"lamb"`` and ``"lion"`` to optax (0.2.6), whose rules and defaults are
these:

- optax ``rmsprop``: ν ← decay·ν + (1 − decay)·g², update = g/√(ν + ε)
  (ε inside the root; torch adds it outside, with alpha 0.99), then the
  learning rate, then an optional momentum trace t ← u + m·t (Nesterov:
  u + m·t). ``centered`` also keeps μ ← decay·μ + (1 − decay)·g and
  divides by √(ν − μ² + ε); ``bias_correction`` divides μ and ν by
  1 − decayᵗ first.
- optax ``adagrad``: Σ ← Σ + g² from an initial 0.1 (torch: 0), update =
  g/√(Σ + ε) with ε 1e-7 (torch: 1e-10 outside the root).
- optax ``adafactor`` (not ``torch.optim.Adafactor``): factored second
  moments over the two largest dims of each parameter's Flax layout
  (:func:`flax_shapes`, :func:`to_flax`), the decay 1 − (t + 1)^−0.8, the
  update clipped to an RMS of 1.0, the learning rate (none by default),
  then scaled by the parameter's RMS (at least 1e-3).
- optax ``lamb``: Adam's moments (ε 1e-6), decoupled weight decay (0 by
  default), then each tensor's trust ratio ‖p‖/‖u‖ (1 where either norm
  is 0), then the learning rate.
- optax ``lion``: sign((1 − b1)·g + b1·m), m ← b2·m + (1 − b2)·g, then
  weight decay 1e-3 on every parameter, then the learning rate.

The updates are written with ``torch._foreach_*`` over the parameter
group, in place, one pass per step, where the rule is elementwise, and
per tensor where it takes a norm or a mean.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


class _OptaxRule(torch.optim.Optimizer):
    def _group_tensors(self, group, *names):
        """Params with a gradient, their gradients and their state
        tensors ``names`` (created by ``_init_state`` at first use)."""
        params, grads = [], []
        state = {name: [] for name in names}
        for p in group["params"]:
            if p.grad is None:
                continue
            st = self.state[p]
            if not st:
                self._init_state(st, p, group)
            params.append(p)
            grads.append(p.grad)
            for name in names:
                state[name].append(st[name])
        return params, grads, state

    def _init_state(self, st, p, group):
        raise NotImplementedError

    def _count(self, params) -> int:
        """Advance every parameter's step count; the group's count (they
        step together, as optax's one ``count`` does)."""
        for p in params:
            self.state[p]["step"] += 1
        return self.state[params[0]]["step"]

    @staticmethod
    def _momentum(group, updates, traces):
        """optax ``trace``: t ← u + m·t; the update is t (or u + m·t
        with Nesterov)."""
        m = group["momentum"]
        torch._foreach_mul_(traces, m)
        torch._foreach_add_(traces, updates)
        if group["nesterov"]:
            return torch._foreach_add(updates, traces, alpha=m)
        return traces


def _zeros(p):
    return torch.zeros_like(p, memory_format=torch.preserve_format)


class RMSprop(_OptaxRule):
    """optax ``rmsprop``, with its ``centered`` and ``bias_correction``."""

    def __init__(self, params, lr=1e-2, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False, bias_correction=False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale,
                                      eps_in_sqrt=eps_in_sqrt,
                                      centered=centered, momentum=momentum,
                                      nesterov=nesterov,
                                      bias_correction=bias_correction))

    def _init_state(self, st, p, group):
        st["step"] = 0
        st["nu"] = torch.full_like(p, group["initial_scale"],
                                   memory_format=torch.preserve_format)
        if group["centered"]:
            st["mu"] = _zeros(p)
        if group["momentum"] is not None:
            st["trace"] = _zeros(p)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            names = ("nu",) + ("mu",) * group["centered"] + (
                ("trace",) if group["momentum"] is not None else ())
            params, grads, state = self._group_tensors(group, *names)
            if not params:
                continue
            nu, decay, eps = state["nu"], group["decay"], group["eps"]
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
            if group["centered"]:
                mu = state["mu"]
                torch._foreach_mul_(mu, decay)
                torch._foreach_add_(mu, grads, alpha=1.0 - decay)
            if group["bias_correction"]:
                correction = 1.0 - decay ** self._count(params)
                nu = torch._foreach_div(nu, correction)
                if group["centered"]:
                    mu = torch._foreach_div(mu, correction)
            if group["centered"]:
                # ν̂ − μ̂²
                nu = torch._foreach_addcmul(nu, mu, mu, value=-1.0)
            if group["eps_in_sqrt"]:
                denom = torch._foreach_sqrt(torch._foreach_add(nu, eps))
            else:
                denom = torch._foreach_add(torch._foreach_sqrt(nu), eps)
            updates = torch._foreach_div(grads, denom)
            torch._foreach_mul_(updates, -group["lr"])
            if group["momentum"] is not None:
                updates = self._momentum(group, updates, state["trace"])
            torch._foreach_add_(params, updates)
        return loss


class Adagrad(_OptaxRule):
    """optax ``adagrad``."""

    def __init__(self, params, lr=1e-2, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    def _init_state(self, st, p, group):
        st["sum_of_squares"] = torch.full_like(
            p, group["initial_accumulator_value"],
            memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params, grads, state = self._group_tensors(group, "sum_of_squares")
            if not params:
                continue
            sums = state["sum_of_squares"]
            torch._foreach_addcmul_(sums, grads, grads)
            for p, g, s in zip(params, grads, sums):
                # optax: where(Σ > 0, g/√(Σ + ε), 0).
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
                p.add_(g * scale, alpha=-group["lr"])
        return loss


def flax_shapes(module: torch.nn.Module,
                params: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Dict[torch.Tensor, Tuple[int, ...]]:
    """The Flax shape of each parameter whose Flax layout is not the one
    its rank implies (:func:`to_flax`), keyed by the tensor: the
    transformer's fused qkv and proj weights, which submodules declare
    by a ``flax_param_shapes()`` method (local name → shape). ``params``
    (name → tensor, ``module.named_parameters()`` by default) names the
    tensors to key by, e.g. a parameter server's master copies."""
    if params is None:
        params = dict(module.named_parameters())
    out = {}
    for prefix, sub in module.named_modules():
        declared = getattr(sub, "flax_param_shapes", None)
        if declared is None:
            continue
        for name, shape in declared().items():
            key = f"{prefix}.{name}" if prefix else name
            if key in params:
                out[params[key]] = tuple(shape)
    return out


def to_flax(t: torch.Tensor, shape: Optional[Sequence[int]] = None
            ) -> torch.Tensor:
    """``t`` in the Flax layout: a 2-D weight (out, in) transposed to
    (in, out), a 4-D convolution kernel OIHW permuted to HWIO, other
    ranks as they are; then reshaped to ``shape`` where the Flax
    parameter has another rank (the fused qkv kernel (d, 3, h, hd),
    its bias (3, h, hd), the proj kernel (h, hd, d))."""
    if t.ndim == 2:
        t = t.T
    elif t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    return t if shape is None else t.reshape(shape)


def from_flax(t: torch.Tensor, port_shape: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`to_flax` for a parameter of ``port_shape``."""
    if len(port_shape) == 2:
        return t.reshape(port_shape[1], port_shape[0]).T
    if len(port_shape) == 4:
        o, i, h, w = port_shape
        return t.reshape(h, w, i, o).permute(3, 2, 0, 1)
    return t.reshape(port_shape)


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """optax's ``_factored_dims`` of a Flax-layout ``shape``: the axes
    (d1, d0) of the second-largest and the largest dims, or None when
    the second-largest is below ``min_dim_size_to_factor``."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _rms(t: torch.Tensor) -> torch.Tensor:
    return t.square().mean().sqrt()


class Adafactor(_OptaxRule):
    """optax ``adafactor`` (module docstring). ``lr=None`` applies no
    learning rate, as optax's default does: the step is then the clipped
    update times the parameter's RMS.

    The update is computed on each parameter in its Flax layout
    (:func:`to_flax`), where optax picks the factored dims, and the
    moments are kept in that layout. ``flax_shapes`` (parameter → Flax
    shape, from :func:`flax_shapes`) names the parameters whose Flax
    rank differs: the transformer's fused qkv and proj weights, which
    optax factors (or not) over their 4-D and 3-D axes."""

    def __init__(self, params, lr: Optional[float] = None,
                 min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0,
                 multiply_by_parameter_scale=True, clipping_threshold=1.0,
                 momentum=None, weight_decay_rate=None, eps=1e-30,
                 factored=True, flax_shapes=None):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored))
        self.flax_shapes = dict(flax_shapes or {})

    def _flax(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return to_flax(t, self.flax_shapes.get(p))

    def _init_state(self, st, p, group):
        st["step"] = 0
        flax_p = self._flax(p, p)
        shape = flax_p.shape
        dims = _factored_dims(shape, group["factored"],
                              group["min_dim_size_to_factor"])
        if dims is not None:
            d1, d0 = dims
            st["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            st["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        else:
            st["v"] = p.new_zeros(shape)
        if group["momentum"] is not None:
            st["ema"] = p.new_zeros(shape)

    def _scaled(self, g, st, dims, decay, eps):
        """The gradient over the (factored) RMS estimate; updates the
        moments in place."""
        grad_sqr = g.square() + eps
        if dims is None:
            st["v"].mul_(decay).add_(grad_sqr, alpha=1.0 - decay)
            return g * st["v"].rsqrt()
        d1, d0 = dims
        v_row, v_col = st["v_row"], st["v_col"]
        v_row.mul_(decay).add_(grad_sqr.mean(d0), alpha=1.0 - decay)
        v_col.mul_(decay).add_(grad_sqr.mean(d1), alpha=1.0 - decay)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
        return g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params, grads, _ = self._group_tensors(group)
            if not params:
                continue
            count = self._count(params) - 1  # optax's count before the step
            t = float(count - group["decay_offset"] + 1)
            decay = 1.0 - t ** -group["decay_rate"]
            for p, g in zip(params, grads):
                st = self.state[p]
                flax_p, g = self._flax(p, p), self._flax(g, p)
                dims = _factored_dims(flax_p.shape, group["factored"],
                                      group["min_dim_size_to_factor"])
                u = self._scaled(g, st, dims, decay, group["eps"])
                if group["clipping_threshold"] is not None:
                    u = u / torch.clamp_min(
                        _rms(u) / group["clipping_threshold"], 1.0)
                if group["lr"] is not None:
                    u = u * group["lr"]
                if group["multiply_by_parameter_scale"]:
                    rms = _rms(p)
                    u = u * torch.where(rms <= 1e-3, 1e-3, rms)
                if group["momentum"] is not None:
                    ema = st["ema"]
                    ema.mul_(group["momentum"]).add_(
                        u, alpha=1.0 - group["momentum"])
                    u = ema
                if group["weight_decay_rate"] is not None:
                    u = u + group["weight_decay_rate"] * flax_p
                p.sub_(from_flax(u, p.shape))
        return loss


class Lamb(_OptaxRule):
    """optax ``lamb`` (module docstring)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    def _init_state(self, st, p, group):
        st["step"] = 0
        st["mu"] = _zeros(p)
        st["nu"] = _zeros(p)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params, grads, state = self._group_tensors(group, "mu", "nu")
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            count = self._count(params)
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            mu_hat = torch._foreach_div(mu, 1.0 - b1 ** count)
            nu_hat = torch._foreach_div(nu, 1.0 - b2 ** count)
            denom = torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_add(nu_hat, group["eps_root"])), group["eps"])
            updates = torch._foreach_div(mu_hat, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params,
                                    alpha=group["weight_decay"])
            p_norms = torch._foreach_norm(params)
            u_norms = torch._foreach_norm(updates)
            for p, u, pn, un in zip(params, updates, p_norms, u_norms):
                ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
                p.sub_(u * (ratio * group["lr"]))
        return loss


class Lion(_OptaxRule):
    """optax ``lion`` (module docstring); its default weight decay 1e-3
    applies to every parameter."""

    def __init__(self, params, lr, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    def _init_state(self, st, p, group):
        st["mu"] = _zeros(p)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params, grads, state = self._group_tensors(group, "mu")
            if not params:
                continue
            b1, b2, mu = group["b1"], group["b2"], state["mu"]
            interp = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(interp, mu, alpha=b1)
            updates = torch._foreach_sign(interp)
            torch._foreach_mul_(mu, b2)
            torch._foreach_add_(mu, grads, alpha=1.0 - b2)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params,
                                    alpha=group["weight_decay"])
            torch._foreach_add_(params, updates, alpha=-group["lr"])
        return loss
