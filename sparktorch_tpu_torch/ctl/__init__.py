"""sparktorch_tpu_torch.ctl — the elastic gang control plane, a copy of ``sparktorch_tpu/ctl/``.

Process workers with non-cooperative preemption (:mod:`ctl.proc`), one
entry for every worker kind (:mod:`ctl.worker`), an elastic controller
that shrinks and grows the world instead of failing the run
(:mod:`ctl.elastic`), and the control route (``POST /ctl``) that lets
the controller manage ranks it holds no local handle on
(:mod:`ctl.route`).
"""

from sparktorch_tpu_torch.ctl.elastic import (
    ELASTIC_SECTION,
    ElasticController,
    round_robin_assign,
)
from sparktorch_tpu_torch.ctl.proc import (
    EXIT_FAILED,
    EXIT_OK,
    EXIT_PREEMPTED,
    ProcessWorker,
    spawn_worker,
    worker_ctl_url,
)
from sparktorch_tpu_torch.ctl.route import (
    CTL_TOKEN_ENV,
    CtlRefused,
    CtlRegistry,
    ctl_request,
)

__all__ = [
    "ELASTIC_SECTION",
    "ElasticController",
    "round_robin_assign",
    "EXIT_FAILED",
    "EXIT_OK",
    "EXIT_PREEMPTED",
    "ProcessWorker",
    "spawn_worker",
    "worker_ctl_url",
    "CTL_TOKEN_ENV",
    "CtlRefused",
    "CtlRegistry",
    "ctl_request",
]
