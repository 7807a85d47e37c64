"""Multi-host bring-up: gang rendezvous, then the process group — the port of ``sparktorch_tpu/parallel/launch.py:40-217``.

1. rank 0 starts the native :class:`~sparktorch_tpu_torch.native.gang.GangCoordinator`;
2. every rank registers (rank, its address) and enters barrier 0: nobody
   proceeds until the world is complete;
3. the rank-0 address from the peer table seeds
   ``torch.distributed.init_process_group`` (NCCL on CUDA, gloo on the
   CPU), where the JAX package calls ``jax.distributed.initialize``;
4. heartbeats keep running, and the trainers call :func:`check_gang`
   between steps: a dead host raises ``GangFailure`` on the survivors
   instead of wedging them in the next collective.

A world of one short-circuits all of it. ``telemetry=`` reaches the
gang worker: the gang's run id lands on the bus, and with a heartbeat
directory (``SPARKTORCH_TPU_HEARTBEAT_DIR``) each rank publishes its
attributed heartbeat file, on which :func:`notify_gang_step` records
the trainers' progress. Not ported yet (ROADMAP, Queue 1): ``ft_policy``
and ``controller`` (item 9, step 3).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

DEFAULT_DIST_PORT = 8476
DEFAULT_GANG_PORT = 8475

# This process's gang worker for the current multi-host run, if any.
_ACTIVE_WORKER = None


def register_gang_worker(worker) -> None:
    global _ACTIVE_WORKER
    _ACTIVE_WORKER = worker


def check_gang() -> None:
    """Raise ``GangFailure`` if this process's gang has failed; no-op
    without an active gang. A worker that was ``close()``d is dropped
    here, so a later single-host run in the same process does not trip
    over a stale dead gang."""
    global _ACTIVE_WORKER
    worker = _ACTIVE_WORKER
    if worker is None:
        return
    if worker.closed:
        _ACTIVE_WORKER = None
        return
    worker.check()


def notify_gang_step(step: int) -> None:
    """Publish this process's training progress on its gang heartbeat
    (rank- and host-attributed, ``obs/heartbeat.py``), so any process
    sharing the heartbeat directory can read per-rank step skew. No-op
    without an active gang or a heartbeat directory. The trainers call
    it beside :func:`check_gang`, once per dispatched chunk: a file
    write only when heartbeats are on."""
    worker = _ACTIVE_WORKER
    if worker is None or worker.closed:
        return
    hb = getattr(worker, "heartbeat", None)
    if hb is not None:
        hb.notify_step(step)


def _local_ip() -> str:
    env = os.environ.get("SPARK_LOCAL_IP")
    if env:
        return env
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, Queue 1: "
                               f"{item})")


def bringup_multihost(
    rank: int,
    world_size: int,
    coordinator_host: Optional[str] = None,
    gang_port: int = DEFAULT_GANG_PORT,
    dist_port: int = DEFAULT_DIST_PORT,
    heartbeat_timeout_ms: int = 30_000,
    start_coordinator: Optional[bool] = None,
    run_id: Optional[str] = None,
    ft_policy=None,
    telemetry=None,
    controller=None,
    backend: Optional[str] = None,
):
    """Rendezvous the gang and join the process group.

    Returns (coordinator or None, worker or None): keep the worker alive
    for the life of training (its heartbeat is the liveness signal) and
    ``close()`` both at the end. Rank 0 hosts the coordinator unless
    ``start_coordinator`` says otherwise (an external process already
    runs one). ``dist_port`` is where rank 0 serves the process group's
    TCP store (NCCL with a card, gloo without, unless ``backend``
    names one). ``telemetry`` is this rank's bus: the gang worker stamps
    the gang's run id on it and mirrors its heartbeats there.
    """
    if ft_policy is not None or controller:
        raise _not_ported("ft_policy and controller",
                          "the ft supervisor and ctl/, item 9")
    if world_size <= 1:
        return None, None

    from sparktorch_tpu_torch.native.gang import GangCoordinator, GangWorker
    from sparktorch_tpu_torch.parallel.mesh import initialize_distributed

    if start_coordinator is None:
        start_coordinator = rank == 0
    coord = None
    if start_coordinator:
        coord = GangCoordinator(
            world_size=world_size, port=gang_port,
            heartbeat_timeout_ms=heartbeat_timeout_ms,
            run_id=run_id or (f"gang-{time.strftime('%Y%m%dT%H%M%S')}-"
                              f"{os.urandom(3).hex()}"))
        gang_port = coord.port
        coordinator_host = coordinator_host or _local_ip()
    elif coordinator_host is None:
        coordinator_host = os.environ.get("SPARKTORCH_TPU_GANG_HOST",
                                          "127.0.0.1")

    worker = GangWorker(coordinator_host, gang_port, rank,
                        f"{_local_ip()}:{dist_port}", telemetry=telemetry)
    worker.barrier(0)  # the whole gang is here
    peers = worker.world()
    initialize_distributed(peers[0], num_processes=world_size,
                           process_id=rank, backend=backend)
    register_gang_worker(worker)
    return coord, worker
