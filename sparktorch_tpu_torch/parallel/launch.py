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
the trainers' progress. ``ft_policy`` arms the fault-tolerant bring-up
(a rejoin grace window on the coordinator, registration retried under
the policy's backoff), and ``controller`` serves this rank's metrics and
``POST /ctl`` (``kill``, ``drain``) for the elastic controller.
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
    ctl_port: int = 0,
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

    ``ft_policy`` (an :class:`~sparktorch_tpu_torch.ft.FtPolicy`) arms
    the fault-tolerant bring-up: the coordinator opens a rejoin grace
    window (``rejoin_grace_s``: a supervisor-restarted rank rejoins a
    failed gang on a fresh generation instead of being refused), and
    registration retries under the policy's backoff, since a restarted
    rank may dial before the new generation opens.

    ``controller`` (``True`` or a
    :class:`~sparktorch_tpu_torch.ctl.CtlRegistry`) starts a
    :class:`~sparktorch_tpu_torch.native.gang.GangMetricsExporter` on
    ``ctl_port`` (0: ephemeral) serving this rank's metrics and
    heartbeats and ``POST /ctl`` with ``kill`` and ``drain`` verbs, so an
    :class:`~sparktorch_tpu_torch.ctl.ElasticController` can manage the
    rank with no process handle. It rides the returned worker as
    ``worker.ctl_exporter``; ``drain`` sets ``worker.drain_requested``
    (training loops may poll it), and ``kill`` replies, then exits the
    process hard.
    """
    if world_size <= 1:
        return None, None

    from sparktorch_tpu_torch.native.gang import (
        GangCoordinator,
        GangFailure,
        GangWorker,
    )
    from sparktorch_tpu_torch.obs.collector import mint_run_id
    from sparktorch_tpu_torch.parallel.mesh import initialize_distributed

    if start_coordinator is None:
        start_coordinator = rank == 0
    coord = None
    if start_coordinator:
        grace_ms = (int(ft_policy.rejoin_grace_s * 1000)
                    if ft_policy is not None else 0)
        coord = GangCoordinator(
            world_size=world_size, port=gang_port,
            heartbeat_timeout_ms=heartbeat_timeout_ms,
            rejoin_grace_ms=grace_ms, run_id=run_id or mint_run_id())
        gang_port = coord.port
        coordinator_host = coordinator_host or _local_ip()
    elif coordinator_host is None:
        coordinator_host = os.environ.get("SPARKTORCH_TPU_GANG_HOST",
                                          "127.0.0.1")

    my_addr = f"{_local_ip()}:{dist_port}"
    rng = ft_policy.rng() if ft_policy is not None else None
    attempt = 0
    while True:
        try:
            worker = GangWorker(coordinator_host, gang_port, rank, my_addr,
                                telemetry=telemetry)
            break
        except GangFailure:
            if (ft_policy is None
                    or attempt >= ft_policy.restart.max_restarts):
                raise
            time.sleep(ft_policy.restart.delay_s(attempt, rng))
            attempt += 1
    worker.barrier(0)  # the whole gang is here
    peers = worker.world()
    initialize_distributed(peers[0], num_processes=world_size,
                           process_id=rank, backend=backend)
    register_gang_worker(worker)
    if controller:
        import threading

        from sparktorch_tpu_torch.ctl.route import CtlRegistry
        from sparktorch_tpu_torch.ctl.worker import _hard_exit_soon
        from sparktorch_tpu_torch.native.gang import GangMetricsExporter

        ctl = CtlRegistry() if controller is True else controller
        drain = threading.Event()
        worker.drain_requested = drain
        # kill: reply, then die (the 200 must reach the controller
        # before the process vanishes, or the kill reads as a transport
        # error).
        ctl.register("kill", lambda code=86: _hard_exit_soon(int(code)))
        ctl.register("drain", lambda: (drain.set(), True)[1])
        ctl.register("ping", lambda: {"rank": rank, "pid": os.getpid(),
                                      "addr": my_addr})
        worker.ctl_exporter = GangMetricsExporter(
            coordinator=coord, telemetry=telemetry, port=ctl_port,
            ctl=ctl).start()
    return coord, worker
