"""The port's ft supervisor (``sparktorch_tpu_torch/ft/supervisor.py``) against the JAX package's.

Each scenario runs through both packages on the same inputs: the same
``FtPolicy`` seed must give the same restart delays, the same chaos
schedule the same ``ft_*`` counter names, labels and event kinds, the
same heartbeat table the same straggler verdicts, and a death the same
postmortem keys. Then the supervised entry points: ``train_async``
under ``kill_worker_at`` beside the JAX one (one full-batch SGD worker,
so the applies are deterministic), a cancelled hogwild window, and
``supervise_run`` resuming a checkpointed fit.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from sparktorch_tpu import ft as jax_ft
from sparktorch_tpu import obs as jax_obs
from sparktorch_tpu.ft import supervisor as jax_sup
from sparktorch_tpu_torch import ft, obs
from sparktorch_tpu_torch.ft import supervisor as sup_mod

PACKAGES = {"port": (ft, sup_mod, obs), "jax": (jax_ft, jax_sup, jax_obs)}


def _policy(pkg, max_restarts=3, jitter=0.3, seed=5, **kw):
    return pkg.FtPolicy(restart=pkg.RestartPolicy(
        max_restarts=max_restarts, backoff_base_s=0.01, backoff_max_s=0.04,
        jitter=jitter), seed=seed, **kw)


def _bus_names(tele):
    snap = tele.snapshot()
    return ({k for k in snap["counters"] if k.startswith(("ft_", "goodput."))},
            {k for k in snap["histograms"] if k.startswith("ft_")})


def _flaky_run(which, fails=(2, 1), max_restarts=3):
    """Two workers that die ``fails[i]`` times each, then finish."""
    pkg, sup, o = PACKAGES[which]
    tele = o.Telemetry(run_id="flaky")
    events = []
    tele.add_sink(events.append)
    supervisor = sup.Supervisor(policy=_policy(pkg, max_restarts),
                                telemetry=tele, name="flaky")

    def make(i):
        def start(attempt):
            def target():
                if attempt < fails[i]:
                    raise RuntimeError(f"w{i} boom {attempt}")
            return sup.ThreadWorker(f"w{i}", target)
        return start

    for i in range(len(fails)):
        supervisor.add(f"w{i}", make(i), rank=i)
    summary = supervisor.run(poll_interval_s=0.005, deadline_s=30)
    return summary, tele, events


def test_restart_delays_counters_and_events_match_jax():
    got, tele, events = _flaky_run("port")
    want, jtele, jevents = _flaky_run("jax")
    assert got["restarts"] == want["restarts"] == {"w0": 2, "w1": 1}
    assert got["failed"] == want["failed"] == []

    def delays(evs):
        return [e["delay_s"] for e in evs
                if e.get("kind") == "ft_restart_scheduled"]

    assert len(delays(events)) == len(delays(jevents)) == 3
    # One worker dying three times draws the seeded jitter in one order:
    # the same delays, in the same order, in both packages.
    one = delays(_flaky_run("port", fails=(3,))[2])
    assert one == delays(_flaky_run("jax", fails=(3,))[2])
    assert len(one) == 3 and len(set(one)) == 3
    assert _bus_names(tele) == _bus_names(jtele)
    assert ({e["kind"] for e in events if e["kind"].startswith("ft_")}
            == {e["kind"] for e in jevents if e["kind"].startswith("ft_")})
    hist = tele.histogram("ft_recovery_latency_s", labels={"worker": "w0"})
    assert hist["count"] == 2 and hist["max"] > 0


@pytest.mark.parametrize("which", ["port", "jax"])
def test_budget_exhaustion_fails_or_is_absorbed(which):
    pkg, sup, o = PACKAGES[which]

    def start(attempt):
        def target():
            raise RuntimeError("always")
        return sup.ThreadWorker("w", target)

    tele = o.Telemetry(run_id="budget")
    s = sup.Supervisor(policy=_policy(pkg, 2), telemetry=tele)
    s.add("w", start)
    with pytest.raises(sup.WorkerFailed, match="restart budget"):
        s.run(poll_interval_s=0.005)
    assert tele.counter_value("ft_restarts_total",
                              labels={"worker": "w"}) == 2
    absorbed = []
    s = sup.Supervisor(policy=_policy(pkg, 1), telemetry=tele,
                       on_exhausted=lambda name, rank, err:
                       (absorbed.append((name, rank)), True)[1])
    s.add("d", start, rank=3)
    assert s.run(poll_interval_s=0.005)["failed"] == []
    assert absorbed == [("d", 3)]
    assert tele.counter_value("ft_budget_absorbed_total",
                              labels={"worker": "d"}) == 1


def test_straggler_episodes_match_jax(tmp_path):
    """The same heartbeat table through both supervisors: a warning per
    lagging episode, blamed on the laggard, and a preemption past the
    preempt threshold."""
    from sparktorch_tpu_torch.obs import HeartbeatEmitter

    d = str(tmp_path / "hb")
    fast, slow = HeartbeatEmitter(d, rank=0), HeartbeatEmitter(d, rank=1)
    fast.notify_step(100)
    slow.notify_step(3)
    sups = {}
    for which, (pkg, sup, o) in PACKAGES.items():
        tele = o.Telemetry(run_id=f"strag-{which}")
        s = sup.Supervisor(policy=pkg.FtPolicy(
            restart=pkg.RestartPolicy(max_restarts=0),
            straggler=pkg.StragglerPolicy(warn_skew_steps=50)),
            telemetry=tele, heartbeat_dir=d)
        for rank in (0, 1):
            s.add(str(rank), lambda attempt: None, rank=rank)
        sups[which] = (s, tele)

    def tick():
        for s, _ in sups.values():
            s._apply_skew_policies()

    tick()
    tick()  # still lagging: latched, no second warning
    slow.notify_step(95)  # caught up: the episode ends
    tick()
    fast.notify_step(300)  # a second episode
    tick()
    for s, tele in sups.values():
        assert tele.counter_value("ft_straggler_warnings_total",
                                  labels={"worker": "1"}) == 2
        assert tele.counter_value("ft_straggler_warnings_total",
                                  labels={"worker": "0"}) == 0
    assert _bus_names(sups["port"][1]) == _bus_names(sups["jax"][1])

    class Handle:
        killed = False

        def is_alive(self):
            return True

        def kill(self):
            self.killed = True

    s = sup_mod.Supervisor(policy=ft.FtPolicy(
        restart=ft.RestartPolicy(max_restarts=1),
        straggler=ft.StragglerPolicy(warn_skew_steps=50,
                                     preempt_skew_steps=100)),
        telemetry=obs.Telemetry(run_id="preempt"), heartbeat_dir=d)
    for rank in (0, 1):
        s.add(str(rank), lambda attempt: Handle(), rank=rank)
    for w in s._workers:
        w.handle = w.start_fn(0)
    s._apply_skew_policies()  # skew 205 >= 100: preempt the laggard
    assert [w.handle.killed for w in s._workers] == [False, True]
    assert s.telemetry.counter_value("ft_straggler_preemptions_total",
                                     labels={"worker": "1"}) == 1


def _broken_exporter(mode):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if mode == "http500":
                self.send_response(500)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = (b'{"ranks": {' if mode == "torn"
                    else b'{"ranks": {"not-a-rank": {"alive": true}}}')
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.mark.parametrize("mode", ["http500", "torn", "junk_keys"])
def test_exporter_scrape_failures_degrade(mode):
    httpd = _broken_exporter(mode)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for which, (pkg, sup, o) in PACKAGES.items():
            tele = o.Telemetry(run_id=f"scrape-{which}")
            s = sup.Supervisor(policy=pkg.FtPolicy(
                restart=pkg.RestartPolicy(max_restarts=0),
                straggler=pkg.StragglerPolicy(warn_skew_steps=5)),
                telemetry=tele, exporter_url=url)
            assert s._report() is None
            assert tele.counter_value("ft_scrape_errors_total",
                                      labels={"source": "exporter"}) == 1
            s.add("w", lambda attempt: sup.ThreadWorker(
                "w", lambda: time.sleep(0.05)), rank=0)
            assert s.run(poll_interval_s=0.01)["failed"] == []
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_exporter_happy_path_feeds_the_skew_policies(tmp_path):
    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.obs import HeartbeatEmitter

    d = str(tmp_path)
    HeartbeatEmitter(d, rank=0).notify_step(50)
    HeartbeatEmitter(d, rank=1).notify_step(7)
    with GangMetricsExporter(heartbeat_dir=d) as exporter:
        reports = [sup.Supervisor(policy=pkg.FtPolicy(),
                                  telemetry=o.Telemetry(run_id="ok"),
                                  exporter_url=exporter.url)._report()
                   for pkg, sup, o in PACKAGES.values()]
    for report in reports:
        assert report["ranks"][0]["step"] == 50  # re-keyed to int
        assert report["step_skew"] == 43


def test_postmortem_on_death_has_the_jax_keys(tmp_path):
    docs = {}
    for which, (pkg, sup, o) in PACKAGES.items():
        out = tmp_path / which
        tele = o.Telemetry(run_id="pm")
        s = sup.Supervisor(policy=_policy(pkg, 2, jitter=0.0),
                           telemetry=tele, postmortem_dir=str(out))

        def start(attempt, tele=tele):
            def target():
                with tele.span("work/chunk"):
                    pass
                if attempt == 0:
                    raise RuntimeError("first attempt dies")
            return sup.ThreadWorker(f"w-{attempt}", target)

        s.add("w", start)
        s.run(poll_interval_s=0.005)
        (bundle,) = [f for f in os.listdir(out)
                     if f.startswith("postmortem_")]
        read = (obs.read_postmortem if which == "port"
                else jax_obs.read_postmortem)
        docs[which] = read(str(out / bundle))
        assert tele.counter_value("ft_postmortems_total") == 1
    got, want = docs["port"], docs["jax"]
    assert got.keys() == want.keys()
    assert "first attempt dies" in got["reason"]
    assert any(e.get("kind") == "span" for e in got["events"])
    assert got["health"] is None and want["health"] is None


def test_supervise_run_restarts_and_resumes(tmp_path):
    """A crash before any snapshot restarts from scratch; a crash
    after one resumes from it. The same calls and restart counters in
    both packages."""
    from sparktorch_tpu_torch.utils import checkpoint

    calls = {}
    for which, (pkg, sup, o) in PACKAGES.items():
        d = tmp_path / which
        seen = calls[which] = []
        tele = o.Telemetry(run_id="sr")

        def fn(attempt, resume, d=d, seen=seen):
            seen.append((attempt, resume))
            if attempt == 1:
                (d / "2").mkdir(parents=True)
                (d / "2" / "state.pt").write_bytes(b"x")
            if attempt < 2:
                raise RuntimeError(f"died {attempt}")
            return "ok"

        assert sup.supervise_run(fn, policy=_policy(pkg, 3), telemetry=tele,
                                 checkpoint_dir=str(d), name="g") == "ok"
        assert tele.counter_value("ft_restarts_total",
                                  labels={"worker": "g"}) == 2
        with pytest.raises(RuntimeError, match="died 0"):
            sup.supervise_run(fn, policy=_policy(pkg, 0), telemetry=tele,
                              name="g0")  # no budget: the error stands
        assert seen.pop() == (0, False)
    assert checkpoint.latest_step(str(tmp_path / "port")) == 2
    assert calls["port"] == [(0, False), (1, False), (2, True)]
    assert calls["port"] == calls["jax"]


def test_supervise_run_resumes_a_killed_checkpointed_fit(tmp_path):
    """A seeded kill interrupts a checkpointed fit at step 4; the
    restarted attempt finds the step-4 snapshot and trains on from it
    to the same parameters as an unkilled fit."""
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import simple
    from sparktorch_tpu_torch.train.sync import train_distributed
    from sparktorch_tpu_torch.utils.checkpoint import latest_step

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64, 10)).astype(np.float32)
    y = (x.mean(1) > 0).astype(np.float32)
    torch.manual_seed(0)
    obj = serialize_torch_obj(simple.Net(), criterion="mse",
                              optimizer="sgd", optimizer_params={"lr": 1e-2},
                              input_shape=(10,))

    def fit(ckpt_dir, resume, iters):
        return train_distributed(obj, x, labels=y, iters=iters,
                                 steps_per_call=1, checkpoint_dir=ckpt_dir,
                                 checkpoint_every=2, resume=resume, seed=3,
                                 device="cpu")

    ckpt = str(tmp_path / "ckpt")
    tele = obs.Telemetry(run_id="chaos_sync")
    with ft.inject(ft.ChaosConfig(kill_worker_at={0: 4}, seed=0),
                   telemetry=tele):
        result = sup_mod.supervise_run(
            lambda attempt, resume: fit(ckpt, resume, 8 - 4 * resume),
            policy=_policy(ft, 2), telemetry=tele,
            retry_on=(ft.ChaosKill,), checkpoint_dir=ckpt, name="sync_gang")
    assert tele.counter_value("ft_restarts_total",
                              labels={"worker": "sync_gang"}) == 1
    assert latest_step(ckpt) == 8
    straight = fit(str(tmp_path / "straight"), False, 8)
    assert len(result.metrics) == 4
    for key, value in result.params.items():
        np.testing.assert_allclose(value.numpy(),
                                   straight.params[key].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=key)


def test_cancel_preempts_a_hogwild_window_and_flushes_nothing():
    from sparktorch_tpu_torch.train.hogwild import (
        _worker_loop,
        make_grad_step,
    )
    from sparktorch_tpu_torch.utils.data import DataBatch

    class SlowTransport:
        stats = None
        pulls = 0

        def pull(self, have_version):
            self.pulls += 1
            time.sleep(0.05)
            return (0, {"weight": torch.zeros(1, 4)}) if have_version < 0 \
                else None

        def push(self, grads):
            pass

    module = torch.nn.Linear(4, 1, bias=False)
    rng = np.random.default_rng(0)
    shard = DataBatch(torch.from_numpy(rng.normal(size=(32, 4))
                                       .astype(np.float32)),
                      torch.zeros(32), torch.ones(32))
    grad_step = make_grad_step(
        lambda preds, y: (preds[:, 0] - y) ** 2)
    transport = SlowTransport()
    errors, records = [], []

    def target(cancel):
        _worker_loop(0, transport, module, grad_step, shard, None, 200, 0,
                     False, 0, records, errors, cancel=cancel)

    t0 = time.perf_counter()
    w = sup_mod.ThreadWorker("slow", target, pass_cancel=True)
    while transport.pulls < 2 and time.perf_counter() - t0 < 5:
        time.sleep(0.01)
    w.kill()
    w.join(timeout=5)
    assert not w.is_alive()
    assert time.perf_counter() - t0 < 5.0
    assert errors and isinstance(errors[0], ft.WorkerPreempted)
    assert records == []


def test_supervised_train_async_under_a_kill_matches_jax():
    """One full-batch SGD worker killed at iteration 3 in each package:
    one restart, the rerun's 6 records, 3 + 6 applies, and the same
    parameters."""
    from sparktorch_tpu.train.hogwild import train_async as jax_train_async
    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.train.hogwild import train_async
    from test_torch_hogwild import MODELS, _data, _flax_state, _pair

    jax_obj, obj, module = _pair("mlp", "sgd", {"lr": 0.1})
    x, y = _data(MODELS["mlp"][2])
    kw = dict(labels=y, iters=6, partitions=1, supervise=True)
    jtele = jax_obs.Telemetry(run_id="hw")
    with jax_ft.inject(jax_ft.ChaosConfig(kill_worker_at={0: 3}, seed=0),
                       telemetry=jtele):
        want = jax_train_async(jax_obj, x, ft_policy=_policy(jax_ft, 2),
                               telemetry=jtele, **kw)
    tele = obs.Telemetry(run_id="hw")
    with ft.inject(ft.ChaosConfig(kill_worker_at={0: 3}, seed=0),
                   telemetry=tele) as inj:
        got = train_async(obj, x, ft_policy=_policy(ft, 2), telemetry=tele,
                          device="cpu", **kw)
    assert inj.events == [{"site": "worker.step", "worker": 0, "step": 3}]
    assert got.summary["ft"]["restarts_total"] == 1
    assert want.summary["ft"]["restarts_total"] == 1
    assert len(got.metrics) == len(want.metrics) == 6
    assert [r["version"] for r in got.metrics] == list(range(3, 9))
    assert got.summary["server_applied"] == 9
    assert _bus_names(tele) == _bus_names(jtele)
    expected = state_dict_from_flax(_flax_state(want), module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
