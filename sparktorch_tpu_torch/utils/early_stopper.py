"""Patience-based early stopping — the port's own copy of ``sparktorch_tpu/utils/early_stopper.py``.

Best-metric tracker with min/max mode, absolute or percentage delta, NaN
→ immediate stop, and the patience-0 mode that never stops. The first
signal only seeds the best value. The trainer feeds it the global mean
loss (or validation loss) once per step.
"""

from __future__ import annotations

import math
from typing import Optional


class EarlyStopping:
    def __init__(self, mode: str = "min", min_delta: float = 0.0,
                 patience: int = 10, percentage: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r} is unknown")
        self.mode = mode
        self.min_delta = min_delta
        self.patience = patience
        self.percentage = percentage
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        metric = float(metric)
        if self.patience == 0:
            return False  # degenerate mode: never stop
        if self.best is None:
            self.best = metric
            return False
        if math.isnan(metric):
            return True
        if self._is_better(metric):
            self.num_bad_epochs = 0
            self.best = metric
        else:
            self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience

    def _is_better(self, metric: float) -> bool:
        # Percentage mode scales by the SIGNED best, as the reference does.
        delta = (self.best * self.min_delta / 100.0 if self.percentage
                 else self.min_delta)
        if self.mode == "min":
            return metric < self.best - delta
        return metric > self.best + delta

    def reset(self) -> None:
        self.best = None
        self.num_bad_epochs = 0
