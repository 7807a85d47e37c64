"""The port's gang: its build of ``native/gang.cpp``, rendezvous, barrier epochs, failure detection.

The cases of ``tests/test_native.py`` this slice covers, run against the
port's bindings, a port worker against a JAX coordinator and the
reverse (one line protocol), and a trainer that must raise
``GangFailure`` when a peer host dies.
"""

import socket
import threading
import time

import numpy as np
import pytest

from sparktorch_tpu_torch.native import build
from sparktorch_tpu_torch.native.gang import (
    GangCoordinator,
    GangFailure,
    GangWorker,
)
from sparktorch_tpu_torch.parallel import launch


def _enter_together(workers, epoch):
    """Every worker enters barrier ``epoch`` on its own thread; returns
    the ranks released, in order of release."""
    released = []
    threads = [threading.Thread(target=lambda w=w: (w.barrier(epoch),
                                                    released.append(w.rank)))
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return released


@pytest.mark.parametrize("world,host", [(1, "localhost"), (2, "127.0.0.1"),
                                        (4, "127.0.0.1")])
def test_rendezvous_barrier_epochs_and_peer_table(world, host):
    with GangCoordinator(world_size=world) as coord:
        workers = [GangWorker(host, coord.port, r, f"10.0.0.{r}:8476")
                   for r in range(world)]
        try:
            if world > 1:
                # Gang semantics: nobody proceeds until the last arrives.
                early = []
                threads = [threading.Thread(
                    target=lambda w=w: (w.barrier(0), early.append(w.rank)))
                    for w in workers[:-1]]
                for t in threads:
                    t.start()
                time.sleep(0.3)
                assert early == []
                workers[-1].barrier(0)
                for t in threads:
                    t.join(timeout=10)
                assert sorted(early) == list(range(world - 1))
            else:
                workers[0].barrier(0)
            for epoch in (1, 2):
                assert sorted(_enter_together(workers, epoch)) == list(
                    range(world))
            assert workers[0].world() == [f"10.0.0.{r}:8476"
                                          for r in range(world)]
        finally:
            for w in workers:
                w.close()


@pytest.mark.parametrize("how", ["heartbeat_stops", "coordinator_stops"])
def test_a_failed_gang_releases_the_barrier_with_an_error(how):
    coord = GangCoordinator(world_size=2, heartbeat_timeout_ms=400)
    w0 = GangWorker("127.0.0.1", coord.port, 0, "a:1",
                    heartbeat_interval_s=0.1)
    w1 = GangWorker("127.0.0.1", coord.port, 1, "b:1",
                    heartbeat_interval_s=0.1)
    err = []

    def waiter():
        try:
            w0.barrier(0)  # rank 1 never arrives
        except GangFailure as e:
            err.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    if how == "heartbeat_stops":
        w1.suspend_heartbeat()
    else:
        time.sleep(0.3)
        coord.stop()
    t.join(timeout=10)
    try:
        assert not t.is_alive(), "barrier hung despite a failed gang"
        assert err, "expected GangFailure"
        if how == "heartbeat_stops":
            assert coord.failed and coord.dead_rank == 1
            deadline = time.time() + 10
            while not w0.failed and time.time() < deadline:
                time.sleep(0.05)
            with pytest.raises(GangFailure):
                w0.check()
            # The dead slot cannot be registered again.
            with pytest.raises(GangFailure):
                GangWorker("127.0.0.1", coord.port, 1, "b:1")
    finally:
        coord.stop()
        w0.close()
        w1.close()
    # The state reads after stop() come from the last snapshot.
    assert coord.failed == (how == "heartbeat_stops")


@pytest.mark.parametrize("coordinator_from", ["jax", "port"])
def test_port_and_jax_gangs_speak_one_protocol(coordinator_from):
    from sparktorch_tpu.native import gang as jax_gang

    coord_cls, worker_cls = (
        (jax_gang.GangCoordinator, GangWorker) if coordinator_from == "jax"
        else (GangCoordinator, jax_gang.GangWorker))
    with coord_cls(world_size=2, run_id="cross-1") as coord:
        mine = GangWorker("127.0.0.1", coord.port, 0, "a:1")
        theirs = worker_cls("127.0.0.1", coord.port, 1, "b:1")
        try:
            assert mine.run_id == theirs.run_id == "cross-1"
            assert mine.generation == theirs.generation == 0
            for epoch in range(2):
                assert sorted(_enter_together([mine, theirs], epoch)) == [0, 1]
            assert mine.world() == theirs.world() == ["a:1", "b:1"]
            assert coord.registered == 2
        finally:
            mine.close()
            theirs.close()


def test_trainer_aborts_when_peer_host_dies():
    # The survivor's trainer checks the gang between chunks and must
    # raise GangFailure promptly instead of running on (or wedging in
    # the next collective).
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.train.sync import train_distributed
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    with GangCoordinator(world_size=2, heartbeat_timeout_ms=400) as coord:
        survivor = GangWorker("127.0.0.1", coord.port, 0, "a:1",
                              heartbeat_interval_s=0.1)
        peer = GangWorker("127.0.0.1", coord.port, 1, "b:1",
                          heartbeat_interval_s=0.1)
        launch.register_gang_worker(survivor)
        try:
            rng = np.random.default_rng(0)
            x = rng.normal(0, 1, (64, 784)).astype(np.float32)
            y = rng.integers(0, 10, (64,)).astype(np.int32)
            spec = ModelSpec(module=MnistMLP(), loss="cross_entropy",
                             optimizer="sgd", optimizer_params={"lr": 1e-2},
                             input_shape=(784,))
            killed = threading.Event()

            def hook(record):
                if not killed.is_set():
                    peer.suspend_heartbeat()
                    killed.set()
                time.sleep(0.01)

            t0 = time.perf_counter()
            with pytest.raises(GangFailure):
                train_distributed(spec, x, labels=y, iters=100_000,
                                  steps_per_call=1, metrics_hook=hook,
                                  device="cpu")
            assert killed.is_set()
            assert time.perf_counter() - t0 < 60
        finally:
            launch.register_gang_worker(None)
            survivor.close()
            peer.close()
    launch.check_gang()  # no active gang: a no-op


def _ft_rank(rank, world, coord_port, dist_port, queue):
    """One rank of a fault-tolerant bring-up with the control route:
    publish the exporter's URL, then wait for the ``drain`` verb."""
    import os
    import traceback

    import torch.distributed as dist

    from sparktorch_tpu_torch.ft import FtPolicy, RestartPolicy

    os.environ["SPARK_LOCAL_IP"] = "127.0.0.1"
    worker = None
    try:
        _, worker = launch.bringup_multihost(
            rank, world, "127.0.0.1", gang_port=coord_port,
            dist_port=dist_port, start_coordinator=False, backend="gloo",
            ft_policy=FtPolicy(restart=RestartPolicy(
                max_restarts=20, backoff_base_s=0.05, backoff_max_s=0.2)),
            controller=True)
        queue.put((rank, True, worker.ctl_exporter.url))
        assert worker.drain_requested.wait(60)
        dist.barrier()
        queue.put((rank, True, "drained"))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if worker is not None:
            worker.ctl_exporter.stop()
            worker.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def test_bringup_of_a_world_of_one_and_the_unported_options():
    # A world of one short-circuits every option; a world of two with
    # ft_policy and controller registers under the policy's backoff
    # (here before the coordinator exists) and serves the control route,
    # which each package's client drives.
    import multiprocessing as mp

    from sparktorch_tpu.ctl import ctl_request as jax_ctl_request
    from sparktorch_tpu_torch.ctl import ctl_request
    from sparktorch_tpu_torch.ft import FtPolicy
    from sparktorch_tpu_torch.obs import Telemetry

    assert launch.bringup_multihost(0, 1) == (None, None)
    assert launch.bringup_multihost(0, 1, telemetry=Telemetry(),
                                    ft_policy=FtPolicy(),
                                    controller=True) == (None, None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord_port = s.getsockname()[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dist_port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_ft_rank,
                         args=(r, 2, coord_port, dist_port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    coord = None
    try:
        time.sleep(0.3)  # the ranks dial first and retry
        coord = GangCoordinator(world_size=2, port=coord_port,
                                rejoin_grace_ms=30_000)
        urls = {}
        for _ in range(2):
            rank, ok, payload = queue.get(timeout=90)
            assert ok, payload
            urls[rank] = payload
        for rank, url in urls.items():
            for request in (ctl_request, jax_ctl_request):
                pong = request(url, "ping")["result"]
                assert pong["rank"] == rank
                assert pong["addr"] == f"127.0.0.1:{dist_port}"
            assert request(url, "drain")["result"] is True
        done = [queue.get(timeout=60) for _ in range(2)]
        assert sorted(done) == [(0, True, "drained"), (1, True, "drained")]
        assert coord.rejoin_grace_ms == 30_000 and coord.registered == 2
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        if coord is not None:
            coord.stop()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_CACHE", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="exit 1"):
        build.load_library("gang")
    assert not list(tmp_path.iterdir())


def test_the_library_builds_into_the_ports_build_dir():
    lib = build.load_library("gang")
    assert build.load_library("gang") is lib
    built = list(build.BUILD_DIR.glob("libgang_*.so"))
    assert built and all(p.parent.name == "_build" for p in built)
    # A listening socket proves the coordinator really serves.
    with GangCoordinator(world_size=1) as coord, socket.create_connection(
            ("127.0.0.1", coord.port), timeout=5):
        pass
