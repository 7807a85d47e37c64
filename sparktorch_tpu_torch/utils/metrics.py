"""Per-step training records and their roll-up — the part of ``sparktorch_tpu/utils/metrics.py`` the trainer uses.

The JAX package's recorder also mirrors every record into its telemetry
bus; the port has no telemetry yet (ROADMAP, Queue 1: ``obs/``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np


class MetricsRecorder:
    """Collects per-step record dicts and rolls them up: examples/s,
    mean/p50/p99 step time, first and final loss."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        # Wall time is measured over the records' own stamps, so time
        # spent before the first step (build, warm-up) is not charged.
        self._stamps: List[float] = []

    def record(self, rec: Dict[str, Any]) -> None:
        self._stamps.append(time.perf_counter())
        self.records.append(rec)

    def _wall_s(self) -> float:
        """Last stamp minus first, plus the first step's own duration
        (the first stamp lands after step 0 completed)."""
        if not self._stamps:
            return 0.0
        first_dt = self.records[0].get("step_time_s") or 0.0
        return self._stamps[-1] - self._stamps[0] + float(first_dt)

    def summary(self) -> Dict[str, Any]:
        if not self.records:
            return {"steps": 0}
        times = np.asarray([r["step_time_s"] for r in self.records
                            if r.get("step_time_s")])
        examples = float(sum(r.get("examples", 0.0) for r in self.records))
        wall = self._wall_s()
        losses = [r["loss"] for r in self.records if r.get("loss") is not None]
        out = {
            "steps": len(self.records),
            "total_examples": examples,
            "wall_time_s": round(wall, 4),
            "examples_per_sec": round(examples / wall, 2) if wall > 0 else None,
            "first_loss": losses[0] if losses else None,
            "final_loss": losses[-1] if losses else None,
        }
        if times.size:
            out.update(
                step_time_mean_s=round(float(times.mean()), 6),
                step_time_p50_s=round(float(np.percentile(times, 50)), 6),
                step_time_p99_s=round(float(np.percentile(times, 99)), 6),
            )
        return out
