"""The port's control plane (``sparktorch_tpu_torch/ctl/``) against the JAX package's.

The same inputs go through both packages: ``round_robin_assign``
layouts, the ``/ctl`` route (each package's ``ctl_request`` against the
port's exporter), and an elastic shrink-then-grow through a real gang
coordinator, whose ``ctl.*`` and ``ft_*`` names, labels and event kinds
must agree. Spawned ``ctl.worker`` children run the port only: a
callable child SIGKILLed by ``kill_process_at`` and restarted with
exact partition records, a SIGTERM drain, and an HTTP ``kill`` verb.

A spawned child imports this module to unpickle its callable, so every
JAX import sits inside a test function.
"""

import os
import threading
import time
import types

import pytest

from sparktorch_tpu_torch.ctl import (
    EXIT_OK,
    CtlRefused,
    CtlRegistry,
    ElasticController,
    ctl_request,
    round_robin_assign,
    spawn_worker,
)
from sparktorch_tpu_torch import ft
from sparktorch_tpu_torch.ft import ChaosConfig, inject
from sparktorch_tpu_torch.ft.supervisor import (
    Supervisor,
    ThreadWorker,
    WorkerFailed,
)
from sparktorch_tpu_torch.native.gang import (
    GangCoordinator,
    GangMetricsExporter,
    GangWorker,
)
from sparktorch_tpu_torch.obs import Telemetry


def _fast_policy(max_restarts=1, pkg=ft):
    return pkg.FtPolicy(restart=pkg.RestartPolicy(
        max_restarts=max_restarts, backoff_base_s=0.02, backoff_max_s=0.05,
        jitter=0.0))


def _names(tele, prefixes=("ctl.", "ft_", "goodput.")):
    """The bus's counter keys (name and labels) under ``prefixes``."""
    return {k for k in tele.snapshot()["counters"] if k.startswith(prefixes)}


# ---------------------------------------------------------------------------
# Assignment and the /ctl route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks,parts", [
    ([2, 0, 1], ["a", "b", "c", "d", "e"]),
    ([5], list(range(7))),
    ([3, 1], []),
    ([0, 1, 2, 3], list(range(3))),
])
def test_round_robin_assign_matches_jax(ranks, parts):
    from sparktorch_tpu.ctl import round_robin_assign as jax_assign

    got = round_robin_assign(ranks, parts)
    assert got == jax_assign(ranks, parts)
    assert got == round_robin_assign(sorted(ranks), parts)


def test_ctl_route_with_both_packages_clients():
    from sparktorch_tpu.ctl import CtlRefused as JaxCtlRefused
    from sparktorch_tpu.ctl import ctl_request as jax_ctl_request

    reg = CtlRegistry(token="s3cret")
    reg.register("echo", lambda **kw: kw)
    assert reg.verbs() == ["echo"]
    assert reg.check_token("s3cret") and not reg.check_token("nope")
    assert CtlRegistry(token="").check_token(None)  # unguarded
    with GangMetricsExporter(telemetry=Telemetry(run_id="ctl"),
                             ctl=reg) as exporter:
        for request in (ctl_request, jax_ctl_request):
            reply = request(exporter.url, "echo", token="s3cret", x=1)
            assert reply == {"ok": True, "verb": "echo",
                             "result": {"x": 1}}
        for request, refused in ((ctl_request, CtlRefused),
                                 (jax_ctl_request, JaxCtlRefused)):
            with pytest.raises(refused, match="403"):
                request(exporter.url, "echo", token="bad")
            with pytest.raises(refused, match="400"):
                request(exporter.url, "nope", token="s3cret")
    # A route without a registry answers 404.
    with GangMetricsExporter() as bare:
        with pytest.raises(CtlRefused, match="404"):
            ctl_request(bare.url, "echo")


def test_exporter_serves_the_jax_routes(tmp_path):
    """The port's exporter and the JAX one over the same heartbeat
    directory, coordinator state and bus: the same Prometheus series
    and the same ``/heartbeats`` table."""
    from sparktorch_tpu.native.gang import (
        GangMetricsExporter as JaxExporter,
    )
    from sparktorch_tpu.obs import Telemetry as JaxTelemetry
    from sparktorch_tpu.obs.collector import scrape_json as jax_scrape_json
    from sparktorch_tpu.obs.prom import parse_prometheus as jax_parse
    from sparktorch_tpu_torch.obs import (
        HeartbeatEmitter,
        parse_prometheus,
        scrape_json,
        scrape_text,
    )

    hb = str(tmp_path / "hb")
    for rank, step in ((0, 5), (1, 2)):
        em = HeartbeatEmitter(hb, rank)
        em.notify_step(step)
    coord = GangCoordinator(world_size=2, port=0)
    try:
        tele, jtele = Telemetry(run_id="e"), JaxTelemetry(run_id="e")
        for t in (tele, jtele):
            t.counter("ft_restarts_total", labels={"worker": "0"})
        with GangMetricsExporter(heartbeat_dir=hb, coordinator=coord,
                                 telemetry=tele) as ours, \
                JaxExporter(heartbeat_dir=hb, coordinator=coord,
                            telemetry=jtele) as theirs:
            got = parse_prometheus(scrape_text(ours.url + "/metrics"))
            want = jax_parse(scrape_text(theirs.url + "/metrics"))
            assert set(got) == set(want)
            ages = [k for k in got if "last_seen_age" in k]
            assert ages
            for k in set(got) - set(ages):
                assert got[k] == want[k], k
            table = scrape_json(ours.url + "/heartbeats")
            jtable = jax_scrape_json(theirs.url + "/heartbeats")
            assert table["step_skew"] == jtable["step_skew"] == 3
            assert sorted(table["ranks"]) == sorted(jtable["ranks"])
            snap = scrape_json(ours.url + "/telemetry")
            assert snap["gauges"]["gang.coordinator_world_size"] == 2.0
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# Elastic controller: shrink then grow through a real coordinator
# ---------------------------------------------------------------------------


def _elastic_run(pkg, ctl_mod, gang_mod, obs_mod, out_dir, n_parts=9):
    """Rank 1 always crashes and spends its budget (a shrink); the
    first launch of generation 1 asks rank 3 to join (a grow)."""
    os.makedirs(out_dir, exist_ok=True)
    work = [f"part{i}" for i in range(n_parts)]

    def completed(p):
        return os.path.exists(os.path.join(out_dir, p + ".done"))

    coord = gang_mod.GangCoordinator(world_size=3, port=0,
                                     heartbeat_timeout_ms=5000)
    tele = obs_mod.Telemetry(run_id="elastic")
    ctl = ctl_mod.ElasticController(work, completed,
                                    policy=_fast_policy(pkg=pkg),
                                    telemetry=tele, coordinator=coord,
                                    min_world=1)
    grown = []
    generations = []

    def start_fn(rank, attempt, generation, assignment):
        generations.append(generation)
        if generation == 1 and not grown:
            grown.append(rank)
            ctl.grow(3, start_fn)

        def run():
            for p in assignment:
                if rank == 1:
                    raise RuntimeError("rank1 boom")
                if completed(p):
                    continue
                tmp = os.path.join(out_dir, p + ".tmp")
                with open(tmp, "w") as f:
                    f.write(f"{rank}:{generation}")
                os.replace(tmp, os.path.join(out_dir, p + ".done"))
                time.sleep(0.01)

        return pkg.ThreadWorker(f"rank{rank}", run)

    try:
        for r in range(3):
            ctl.add_rank(r, start_fn)
        summary = ctl.run(poll_interval_s=0.01, deadline_s=60)
        coord_state = (coord.generation, coord.world_size)
    finally:
        coord.stop()
    assert all(completed(p) for p in work)
    return summary, ctl, tele, coord_state, sorted(set(generations))


def test_elastic_shrink_then_grow_matches_jax(tmp_path):
    from sparktorch_tpu import ctl as jax_ctl
    from sparktorch_tpu import ft as jax_ft
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu.native import gang as jax_gang
    from sparktorch_tpu_torch import ctl, obs
    from sparktorch_tpu_torch.native import gang

    got = _elastic_run(ft, ctl, gang, obs, str(tmp_path / "port"))
    want = _elastic_run(jax_ft, jax_ctl, jax_gang, jax_obs,
                        str(tmp_path / "jax"))
    (summary, controller, tele, coord_state, gens) = got
    assert gens == [0, 1, 2]
    assert summary["generation"] == 2 and coord_state == (2, 3)
    assert summary["resizes"] == {"shrink": 1, "grow": 1}
    assert summary["removed"] == [1]
    assert controller.active_ranks() == [0, 2, 3]
    for key in ("generation", "resizes", "removed", "work_total",
                "work_pending", "restarts", "world_size"):
        assert summary[key] == want[0][key], key
    # Which members finish an assignment before a resize drains them
    # (``member_done``, ``relaunch``) depends on the threads' pace; every
    # other transition and counter this schedule makes in any timing.
    paced = ("ctl.member_done", "ctl.relaunch")

    def fixed(names):
        return {n for n in names if not n.startswith(paced)}

    assert fixed(_names(tele)) == fixed(_names(want[2]))
    assert {"ctl.shrink_total", "ctl.grow_total",
            "ctl.resizes_total{kind=shrink}", "ctl.resizes_total{kind=grow}",
            "ft_restarts_total{worker=rank1}"} <= _names(tele)
    kinds = [h["kind"] for h in controller.history]
    assert fixed(f"ctl.{k}" for k in kinds) == fixed(
        f"ctl.{h['kind']}" for h in want[1].history)
    assert kinds[0] == "start" and kinds[-1] == "finish"
    shrink = next(h for h in controller.history if h["kind"] == "shrink")
    assert shrink["generation"] == 1 and shrink["rank"] == 1
    section = tele.get_section("elastic")
    assert section.keys() == want[2].get_section("elastic").keys()
    assert section["members"]["1"]["state"] == "removed"


def test_elastic_min_world_floor_and_unported_collector(tmp_path):
    work = ["a", "b"]
    ctl = ElasticController(work, lambda p: False,
                            policy=_fast_policy(0),
                            min_world=2)

    def start_fn(rank, attempt, generation, assignment):
        def run():
            if rank == 0:
                raise RuntimeError("boom")
            time.sleep(0.2)

        return ThreadWorker(f"rank{rank}", run)

    ctl.add_rank(0, start_fn)
    ctl.add_rank(1, start_fn)
    with pytest.raises(WorkerFailed, match="min_world"):
        ctl.run(poll_interval_s=0.01, deadline_s=30)
    # The fleet collector is ported: the controller reads its /gang view.
    view = {"ranks": {}, "heartbeats": {"ranks": {}}}
    collector = types.SimpleNamespace(gang_view=lambda: view)
    assert ElasticController(work, lambda p: True,
                             collector=collector)._gang_view() is view
    with pytest.raises(ValueError):
        ElasticController(work, lambda p: True).add_rank(0)


def test_native_resize_releases_waiters_and_reregisters():
    coord = GangCoordinator(world_size=2, port=0, heartbeat_timeout_ms=5000)
    workers = []
    try:
        w0 = GangWorker("127.0.0.1", coord.port, 0, "a:1")
        w1 = GangWorker("127.0.0.1", coord.port, 1, "b:1")
        workers += [w0, w1]
        ts = [threading.Thread(target=w.barrier, args=(0,))
              for w in (w0, w1)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        assert coord.registered == 2 and coord.generation == 0
        assert coord.resize(1) == 1 and coord.world_size == 1
        w2 = GangWorker("127.0.0.1", coord.port, 0, "a:2")
        workers.append(w2)
        w2.barrier(1)
        assert w2.generation == 1
        with pytest.raises(ValueError):
            coord.resize(0)
    finally:
        for w in workers:
            w.close()
        coord.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        coord.resize(2)
    assert coord.generation == 1  # read after stop from the saved state


# ---------------------------------------------------------------------------
# Spawned ctl.worker children (the port only)
# ---------------------------------------------------------------------------


def _partition_work(out_dir, n=4, sleep=0.0):
    """A dill-shipped callable: idempotent partition outputs (a rerun
    skips what exists), progress on the heartbeat, drain on cancel."""

    def work(ctx):
        for step in range(n):
            if ctx.should_stop():
                return
            ctx.notify_step(step)
            path = os.path.join(out_dir, f"p{step}.done")
            if os.path.exists(path):
                continue
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{ctx.name}:{step}")
            os.replace(tmp, path)
            time.sleep(sleep)

    return work


def test_kill_process_at_sigkills_a_child_and_records_stay_exact(tmp_path):
    """The ``ctl.process`` site: the supervisor's own liveness poll
    SIGKILLs rank 0's child once its heartbeat reports step 2; the
    restarted child skips the finished partitions, so each partition
    is written exactly once, some by each attempt."""
    out, hb = str(tmp_path / "out"), str(tmp_path / "hb")
    os.makedirs(out)
    tele = Telemetry(run_id="chaos-proc")
    n_parts = 6

    def start_fn(attempt):
        return spawn_worker(_partition_work(out, n=n_parts, sleep=0.2),
                            rank=0, heartbeat_dir=hb,
                            name=f"victim-a{attempt}", telemetry=tele)

    sup = Supervisor(policy=_fast_policy(2), telemetry=tele,
                     name="chaos-proc")
    sup.add("victim", start_fn, rank=0)
    with inject(ChaosConfig(seed=7, kill_process_at={0: 2}),
                telemetry=tele) as inj:
        summary = sup.run(poll_interval_s=0.05, deadline_s=90)
    assert summary["restarts"] == {"victim": 1}, summary
    assert inj.events == [{"site": "ctl.process", "rank": 0, "step": 2}]
    assert sorted(os.listdir(out)) == sorted(
        f"p{i}.done" for i in range(n_parts))
    writers = {open(os.path.join(out, f"p{i}.done")).read().split(":")[0]
               for i in range(n_parts)}
    assert writers == {"victim-a0", "victim-a1"}
    counters = tele.snapshot()["counters"]
    assert counters.get("ft_restarts_total{worker=victim}") == 1
    hist = tele.histogram("ft_recovery_latency_s",
                          labels={"worker": "victim"})
    assert hist["count"] == 1 and 0 < hist["max"] < 30
    with open(os.path.join(hb, "gang_hb_rank0.json")) as f:
        assert '"alive": false' in f.read()  # the rerun closed cleanly


def test_child_drains_on_sigterm_and_dies_on_the_kill_verb(tmp_path):
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(out_a)
    os.makedirs(out_b)
    drained = spawn_worker(_partition_work(out_a, n=500, sleep=0.05),
                           rank=1, name="pw1", grace_s=30.0)
    killed = spawn_worker(_partition_work(out_b, n=500, sleep=0.05),
                          rank=2, name="pw2", ctl_port=0)
    try:
        deadline = time.time() + 60
        while not os.listdir(out_a) and time.time() < deadline:
            time.sleep(0.02)
        drained.kill()
        url = killed.ctl_url(timeout_s=60)
        assert url, "the child never published its ctl url"
        pong = ctl_request(url, "ping")
        assert pong["result"] == {"name": "pw2", "rank": 2,
                                  "pid": killed.pid}
        ctl_request(url, "kill")  # reply, then die
        drained.join(60)
        killed.join(60)
        # A healthy worker honours SIGTERM through its cancel event and
        # returns early: a drain, never a SIGKILL.
        assert drained.process.returncode == EXIT_OK
        assert drained.preempted and not drained.sigkilled
        assert killed.process.returncode == 86
        assert isinstance(killed.error, WorkerFailed)
        assert "exit code 86" in str(killed.error)
    finally:
        drained.cleanup()
        killed.cleanup()
    assert not os.path.exists(killed.payload_path)
    with pytest.raises(CtlRefused):
        ctl_request(url, "ping", timeout=1.0)
