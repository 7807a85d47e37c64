"""The port's ft policies and chaos harness against the JAX package's.

``RestartPolicy`` backoff from ``FtPolicy.rng()`` must give the same
sequences for the same seed, and an installed ``ChaosInjector`` must
give the same verdicts (action, raise, nothing) and record the same
events at the same scripted site calls in both packages.
"""

import time

import numpy as np
import pytest
import torch

from sparktorch_tpu import ft as jax_ft
from sparktorch_tpu.ft import chaos as jax_chaos
from sparktorch_tpu.obs import Telemetry as JaxTelemetry
from sparktorch_tpu.utils.data import DataBatch as JaxDataBatch
from sparktorch_tpu_torch import ft
from sparktorch_tpu_torch.ft import chaos
from sparktorch_tpu_torch.obs import Telemetry
from sparktorch_tpu_torch.utils.data import DataBatch


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_restart_backoff_sequences_match(seed):
    kw = dict(max_restarts=5, backoff_base_s=0.02, backoff_max_s=0.5,
              jitter=0.3)
    got_rng = ft.FtPolicy(restart=ft.RestartPolicy(**kw), seed=seed).rng()
    want_rng = jax_ft.FtPolicy(restart=jax_ft.RestartPolicy(**kw),
                               seed=seed).rng()
    got = [ft.RestartPolicy(**kw).delay_s(a, got_rng) for a in range(12)]
    want = [jax_ft.RestartPolicy(**kw).delay_s(a, want_rng)
            for a in range(12)]
    assert got == want
    assert max(got) <= 0.5 * 1.3 and len(set(got)) > 1
    # No jitter: the plain doubling, capped.
    assert [ft.RestartPolicy(jitter=0.0).delay_s(a, got_rng)
            for a in range(8)] == [min(5.0, 0.05 * 2 ** a) for a in range(8)]


def test_policies_keep_the_jax_defaults():
    import dataclasses

    for name in ("RestartPolicy", "StragglerPolicy", "BarrierPolicy",
                 "FtPolicy"):
        got = dataclasses.asdict(getattr(ft, name)())
        want = dataclasses.asdict(getattr(jax_ft, name)())
        assert got == want, name


CONFIG = dict(
    seed=3, kill_worker_at={0: 2, 1: 5}, kill_times=1,
    freeze_heartbeat_at={2: 4, 3: 0}, drop_connections=2,
    server_error_pushes=1, truncate_pull_frames=2,
    kill_shard_at={"1": 3}, slow_shard_s={"0": 0.01},
    kill_replica_at={1: 3}, slow_replica_s={"0": 0.02},
    poison_batch_at={0: 1}, slow_rank_s={1: (2, 0.05)},
    kill_process_at={4: 6},
)

# (site, context) in order; each package must answer each the same way.
CALLS = (
    [("worker.step", dict(worker=w, step=s)) for s in range(7)
     for w in (0, 1)]
    + [("heartbeat.beat", dict(rank=r, step=s)) for s in (None, 3, 4, 9)
       for r in (2, 3, 5)]
    + [("transport.request", dict(route="/parameters.bin"))] * 3
    + [("param_server.update", dict(version=v)) for v in range(3)]
    + [("param_server.pull", dict(version=v)) for v in range(3)]
    + [("fleet.shard", dict(shard=s, route="/x")) for _ in range(4)
       for s in (0, "1", 2)]
    + [("data.batch", dict(worker=w, step=s)) for s in range(3)
       for w in (0, 1)]
    + [("train.rank", dict(rank=r, step=s)) for s in range(4)
       for r in (0, 1)]
    + [("ctl.process", dict(rank=4, step=s)) for s in (None, 5, 6, 7)]
    + [("serve.replica", dict(replica=r)) for _ in range(4)
       for r in ("0", "1", "2")]
    + [("unknown.site", {})]
)


def _verdicts(pkg_chaos, cfg, tele):
    out = []
    with pkg_chaos.inject(cfg, telemetry=tele) as inj:
        for site, ctx in CALLS:
            try:
                out.append(("ok", pkg_chaos.fire(site, **ctx)))
            except Exception as e:  # noqa: BLE001 - the verdict is the type
                out.append(("raise", type(e).__name__))
    assert pkg_chaos.active() is None  # uninstalled on exit
    return out, inj.events


def test_chaos_fires_the_same_verdicts_at_the_same_site_calls():
    tele, jax_tele = Telemetry(), JaxTelemetry()
    got, got_events = _verdicts(chaos, ft.ChaosConfig(**CONFIG), tele)
    want, want_events = _verdicts(jax_chaos, jax_ft.ChaosConfig(**CONFIG),
                                  jax_tele)
    assert got == want
    assert got_events == want_events
    assert tele.snapshot()["counters"] == jax_tele.snapshot()["counters"]
    kinds = {v for v, _ in got}
    assert kinds == {"ok", "raise"}
    assert ("raise", "ChaosKill") in got and \
        ("raise", "ChaosServerError") in got
    assert chaos.fire("serve.replica", replica="1") is None  # none installed


def test_an_injector_instance_installs_as_is():
    inj = chaos.ChaosInjector(ft.ChaosConfig(kill_replica_at={"7": 1}))
    with ft.inject(inj) as active:
        assert active is inj and chaos.active() is inj
        assert chaos.fire("serve.replica", replica=7) == {"die": True}
        assert chaos.fire("serve.replica", replica=7) is None  # one-shot
    assert inj.events == [{"site": "serve.replica", "replica": "7"}]


def test_straggle_sleeps_the_injected_delay():
    with ft.inject(ft.ChaosConfig(slow_rank_s={0: (1, 0.05)})):
        assert chaos.straggle(0, 0) == 0.0
        t0 = time.perf_counter()
        assert chaos.straggle(0, 1) == 0.05
        assert time.perf_counter() - t0 >= 0.05
    assert chaos.straggle(0, 5) == 0.0


def test_poison_batch_returns_a_new_batch():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    batch = DataBatch(torch.from_numpy(x.copy()), torch.zeros(3),
                      torch.ones(3))
    poisoned = chaos.poison_batch(batch)
    want = np.asarray(jax_chaos.poison_batch(
        JaxDataBatch(x, np.zeros(3), np.ones(3))).x)
    np.testing.assert_array_equal(poisoned.x.numpy(), want)
    assert torch.isnan(poisoned.x[0]).all()
    assert not torch.isnan(poisoned.x[1:]).any()
    np.testing.assert_array_equal(batch.x.numpy(), x)  # untouched
    assert poisoned.y is batch.y and poisoned.w is batch.w


def test_ft_exports_all_but_the_supervisor():
    supervisor = {"Supervisor", "ThreadWorker", "ProcessWorker",
                  "WorkerFailed", "WorkerPreempted", "supervise_run"}
    assert set(ft.__all__) == set(jax_ft.__all__) - supervisor
    for name in supervisor:
        with pytest.raises(NotImplementedError, match="item 9"):
            getattr(ft, name)
    with pytest.raises(AttributeError):
        ft.no_such_name
    assert ft.chaos is chaos
