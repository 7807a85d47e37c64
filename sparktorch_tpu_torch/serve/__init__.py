"""Serving: the hogwild parameter server (``param_server.py``), its sharded fleet (``fleet.py``) and the online tier (``infer.py``, ``router.py``) — the ports of ``sparktorch_tpu/serve/``."""

from sparktorch_tpu_torch.serve.param_server import (
    ParameterServer,
    ParamServerHttp,
)

__all__ = ["ParameterServer", "ParamServerHttp", "ParamServerFleet",
           "ParamShardServer", "InferenceReplica", "InferenceTier",
           "Router", "WeightPuller", "Overloaded", "DeadlineExceeded",
           "ReplicaStopped", "NoReplicasAvailable"]

_INFER = ("InferenceReplica", "WeightPuller", "Overloaded",
          "DeadlineExceeded", "ReplicaStopped")
_ROUTER = ("InferenceTier", "Router", "NoReplicasAvailable")


def __getattr__(name):
    # Lazy: the fleet and the inference tier pull in more of the
    # package; the base import stays light and free of cycles.
    if name in ("ParamServerFleet", "ParamShardServer"):
        from sparktorch_tpu_torch.serve import fleet

        return getattr(fleet, name)
    if name in _INFER:
        from sparktorch_tpu_torch.serve import infer

        return getattr(infer, name)
    if name in _ROUTER:
        from sparktorch_tpu_torch.serve import router

        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
