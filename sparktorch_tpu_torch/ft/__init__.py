"""sparktorch_tpu_torch.ft — the fault-tolerance subsystem, a copy of ``sparktorch_tpu/ft/``.

Three parts: declarative policies (:mod:`ft.policy`), the gang
supervisor that acts on heartbeats and process liveness
(:mod:`ft.supervisor`), and the seeded chaos-injection harness that
makes the recovery paths testable (:mod:`ft.chaos`).

``policy`` and ``chaos`` import nothing from the rest of the package,
so the injection points in ``net/``, ``serve/``, ``obs/`` and
``train/`` import them without cycles; the supervisor (which needs
``obs``) loads lazily through the module's ``__getattr__``.
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

_LAZY = ("Supervisor", "ThreadWorker", "ProcessWorker", "WorkerFailed",
         "WorkerPreempted", "supervise_run")


def __getattr__(name):
    if name in _LAZY:
        from sparktorch_tpu_torch.ft import supervisor

        return getattr(supervisor, name)
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
    *_LAZY,
]
