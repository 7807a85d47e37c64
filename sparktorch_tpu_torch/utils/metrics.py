"""Per-step training records and their roll-up — the port of ``sparktorch_tpu/utils/metrics.py``.

The structured replacement for the reference's ``verbose`` prints,
shaped around the BASELINE numbers: examples/sec/chip, mean/p50/p99
step time, loss curves. The recorder is a thin adapter over the
telemetry bus (:mod:`sparktorch_tpu_torch.obs`): every ``record()``
also bumps the run's counters and step-time histogram, so the same
numbers surface on ``/metrics`` and in the JSONL dumps, under the JAX
package's names.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np


class MetricsRecorder:
    """Collects per-step record dicts; rolls them up into the
    BASELINE.md protocol numbers.

    ``telemetry`` (optional): a :class:`sparktorch_tpu_torch.obs.Telemetry`
    to mirror into — counters ``<prefix>.steps`` / ``<prefix>.examples``
    and histogram ``<prefix>.step_s`` — so a run's recorder and its
    ``/metrics`` view share one source of truth.
    """

    def __init__(self, n_chips: int = 1, telemetry=None,
                 prefix: str = "train"):
        self.n_chips = max(1, n_chips)
        self.records: List[Dict[str, Any]] = []
        self.telemetry = telemetry
        self.prefix = prefix
        # Per-record wall-clock stamps (perf_counter). Wall time is
        # last-first over THESE, not construction-to-summary: a
        # recorder built before compilation/warmup must not charge
        # that dead time to throughput (the old behavior inflated
        # wall_time_s and deflated examples_per_sec).
        self._stamps: List[float] = []

    def record(self, rec: Dict[str, Any]) -> None:
        self._stamps.append(time.perf_counter())
        self.records.append(rec)
        tele = self.telemetry
        if tele is not None:
            tele.counter(f"{self.prefix}.steps")
            examples = rec.get("examples")
            if examples:
                tele.counter(f"{self.prefix}.examples", float(examples))
            dt = rec.get("step_time_s")
            if dt:
                tele.observe(f"{self.prefix}.step_s", float(dt))
            loss = rec.get("loss")
            if loss is not None and np.isfinite(loss):
                tele.gauge(f"{self.prefix}.loss", float(loss))

    # -- roll-ups (the BASELINE.md protocol numbers) -----------------------

    def _wall_s(self) -> float:
        """Measured span of the recorded steps: last-stamp minus
        first-stamp, plus the first step's own duration (the first
        stamp lands AFTER step 0 completed, so last-first alone would
        exclude it — and would be 0 for a single-record run)."""
        if not self._stamps:
            return 0.0
        wall = self._stamps[-1] - self._stamps[0]
        first_dt = self.records[0].get("step_time_s") or 0.0
        return wall + float(first_dt)

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
            "examples_per_sec_per_chip": round(examples / wall / self.n_chips, 2)
            if wall > 0 else None,
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

    def to_jsonl(self, path: str, append: bool = False) -> None:
        """Write per-step records + a summary line. Parent directories
        are created; ``append=True`` accumulates across phases instead
        of clobbering earlier records (multi-phase runs: warmup then
        measure, resumed jobs, shuffle rounds)."""
        from sparktorch_tpu_torch.obs.sinks import write_jsonl

        write_jsonl(
            path,
            [*self.records, {"summary": self.summary()}],
            append=append,
        )
