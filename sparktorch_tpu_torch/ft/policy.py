"""Declarative fault-tolerance policies — a copy of ``sparktorch_tpu/ft/policy.py``.

Restart budgets with exponential backoff and deterministic jitter,
straggler thresholds on cross-rank step skew, and liveness deadlines
for workers that are alive-but-wedged. In the port the serving tier
acts on them: the router spaces re-admission probes by
``RestartPolicy.delay_s`` and evicts a replica whose heartbeat ages
past ``BarrierPolicy.deadline_s``; ``InferenceTier`` restarts a dead
replica under the same backoff; the gang supervisor
(:mod:`~sparktorch_tpu_torch.ft.supervisor`) and the elastic controller
restart workers under them. The seeded ``FtPolicy.rng()`` gives the JAX package's backoff
sequences for the same seed.

Policies are plain frozen dataclasses so they dill/pickle cleanly and
so a test can assert on exactly the policy a run used.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Restart-on-death: exponential backoff + jitter under a budget.

    ``max_restarts`` is PER WORKER (each supervised rank gets its own
    budget); a worker that exhausts it fails the run. Jitter is drawn
    from the supervisor's seeded RNG — two supervisors with the same
    policy seed replay identical delays, which keeps chaos tests
    deterministic."""

    max_restarts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 5.0
    jitter: float = 0.2  # +- fraction of the delay

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before restart ``attempt`` (0-based: the delay
        before the first restart is the base)."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** max(0, attempt)))
        if self.jitter <= 0:
            return base
        return max(0.0, base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0)))


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Cross-rank step-skew thresholds, read from the heartbeat table
    (``obs.heartbeat.gang_report``'s ``step_skew``): WARN once per
    lagging episode at ``warn_skew_steps``, PREEMPT (kill + restart,
    charged to the worker's restart budget) at ``preempt_skew_steps``.
    ``preempt_skew_steps <= 0`` disables preemption (warn-only)."""

    warn_skew_steps: int = 50
    preempt_skew_steps: int = 0
    min_ranks: int = 2  # skew needs at least two step reports


@dataclasses.dataclass(frozen=True)
class BarrierPolicy:
    """Deadlines for workers that are alive but not progressing.

    ``deadline_s`` bounds a rank's heartbeat AGE: a process that stops
    publishing beats for this long while its handle still looks alive
    (frozen in a wedged collective, a hung barrier) is treated as dead
    and preempted. Needs a heartbeat source wired into the supervisor;
    without one, only process/thread death is detectable."""

    deadline_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class FtPolicy:
    """The full declarative policy the supervisor applies.

    ``seed`` drives the jitter RNG (determinism); ``rejoin_grace_s``
    is forwarded to the native gang coordinator as its re-registration
    grace window, so a supervisor-restarted rank can rejoin a failed
    gang (generation bump) instead of being refused forever."""

    restart: RestartPolicy = dataclasses.field(
        default_factory=RestartPolicy)
    straggler: Optional[StragglerPolicy] = dataclasses.field(
        default_factory=StragglerPolicy)
    barrier: BarrierPolicy = dataclasses.field(
        default_factory=BarrierPolicy)
    seed: int = 0
    rejoin_grace_s: float = 30.0

    def rng(self) -> random.Random:
        return random.Random(self.seed)
