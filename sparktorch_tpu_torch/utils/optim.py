"""Optimizers with optax's update rules where ``torch.optim`` has other ones.

The JAX package resolves ``"rmsprop"`` and ``"adagrad"`` to optax, whose
rules differ from ``torch.optim.RMSprop``/``Adagrad``:

- optax ``rmsprop``: ν ← decay·ν + (1 − decay)·g², update = g/√(ν + ε)
  (ε inside the root; torch adds it outside, with alpha 0.99), then the
  learning rate, then an optional momentum trace t ← u + m·t (Nesterov:
  u + m·t).
- optax ``adagrad``: Σ ← Σ + g² from an initial 0.1 (torch: 0), update =
  g/√(Σ + ε) with ε 1e-7 (torch: 1e-10 outside the root).

The updates are written with ``torch._foreach_*`` over the parameter
group, in place, one pass per step.
"""

from __future__ import annotations

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


class RMSprop(_OptaxRule):
    """optax ``rmsprop`` (not centered, no bias correction)."""

    def __init__(self, params, lr=1e-2, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, momentum=None,
                 nesterov=False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale,
                                      eps_in_sqrt=eps_in_sqrt,
                                      momentum=momentum, nesterov=nesterov))

    def _init_state(self, st, p, group):
        st["nu"] = torch.full_like(p, group["initial_scale"],
                                   memory_format=torch.preserve_format)
        if group["momentum"] is not None:
            st["trace"] = torch.zeros_like(p,
                                           memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            names = ("nu",) if group["momentum"] is None else ("nu", "trace")
            params, grads, state = self._group_tensors(group, *names)
            if not params:
                continue
            nu, decay, eps = state["nu"], group["decay"], group["eps"]
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
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
