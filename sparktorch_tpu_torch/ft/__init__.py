"""sparktorch_tpu_torch.ft — the fault-tolerance subsystem, less the supervisor.

Declarative policies (:mod:`ft.policy`) and the seeded
chaos-injection harness that makes the recovery paths testable
(:mod:`ft.chaos`), both copies of the JAX package's. Neither imports
anything from the rest of the package, so the injection points in
``serve/`` and ``obs/`` import them without cycles.

The gang supervisor (``Supervisor``, ``ThreadWorker``,
``ProcessWorker``, ``WorkerFailed``, ``WorkerPreempted``,
``supervise_run``) is not ported yet: reaching it raises
``NotImplementedError`` (ROADMAP, Queue 1, item 9).
"""

from sparktorch_tpu_torch.ft.chaos import (
    ChaosConfig,
    ChaosInjector,
    ChaosKill,
    ChaosServerError,
    inject,
)
# Re-bind the submodule under its own name: the from-import above
# must not leave `ft.chaos` pointing at anything but the module.
from sparktorch_tpu_torch.ft import chaos  # noqa: F401  (module, not symbol)
from sparktorch_tpu_torch.ft.policy import (
    BarrierPolicy,
    FtPolicy,
    RestartPolicy,
    StragglerPolicy,
)

_SUPERVISOR = ("Supervisor", "ThreadWorker", "ProcessWorker", "WorkerFailed",
               "WorkerPreempted", "supervise_run")


def __getattr__(name):
    if name in _SUPERVISOR:
        raise NotImplementedError(
            f"ft.{name}: the gang supervisor (ft/supervisor.py) is not "
            "ported yet (ROADMAP, Queue 1, item 9)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ChaosConfig",
    "ChaosInjector",
    "ChaosKill",
    "ChaosServerError",
    "inject",
    "BarrierPolicy",
    "FtPolicy",
    "RestartPolicy",
    "StragglerPolicy",
]
