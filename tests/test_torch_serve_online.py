"""The port's online serving tier on the CPU, against the JAX package's.

Twelve of the fifteen tests of ``tests/test_serve_online.py``, with the
port's replica, router and tier on the CPU and the Flax weights carried
over by ``convert.state_dict_from_flax``: continuous-batching admission
and coalescing, bucket padding, deadlines, 429 backpressure, live weight
pulls, load-aware routing, eviction and re-admission, the heartbeat
deadline, the chaos straggler and kill. Left out, with what they need:
``test_weight_puller_uses_gateway_deltas`` (the fleet),
``test_router_reads_collector_scraped_latency`` (the collector) and
``test_traced_request_waterfall_crosses_router_and_replica`` (in
``tests/test_torch_rpctrace.py`` beside the other traced paths).

Then both packages side by side: the deterministic coalescing case with
equal ``serve.*`` counters, ``batch_fill`` and rows within 1e-5; a tier
of each; a port puller against a JAX parameter server and a JAX puller
against the port's.
"""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from sparktorch_tpu import serialize_torch_obj as jax_serialize
from sparktorch_tpu.models import ClassificationNet as JaxClassificationNet
from sparktorch_tpu.models import Net as JaxNet
from sparktorch_tpu.net.transport import BinaryTransport as JaxBinaryTransport
from sparktorch_tpu.obs import Telemetry as JaxTelemetry
from sparktorch_tpu.serve import infer as jax_infer
from sparktorch_tpu.serve import param_server as jax_ps
from sparktorch_tpu.serve.router import InferenceTier as JaxInferenceTier
from sparktorch_tpu_torch import serialize_torch_obj
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.ft import ChaosConfig, inject
from sparktorch_tpu_torch.ft.policy import (
    BarrierPolicy,
    FtPolicy,
    RestartPolicy,
)
from sparktorch_tpu_torch.models import ClassificationNet, Net
from sparktorch_tpu_torch.net.transport import BinaryTransport
from sparktorch_tpu_torch.obs import HeartbeatEmitter, Telemetry
from sparktorch_tpu_torch.serve.infer import (
    DeadlineExceeded,
    InferenceReplica,
    Overloaded,
    WeightPuller,
    run_replica_server,
)
from sparktorch_tpu_torch.serve.param_server import (
    ParameterServer,
    ParamServerHttp,
)
from sparktorch_tpu_torch.serve.router import InferenceTier, Router

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def trained():
    jax_module = JaxNet()
    x = np.random.default_rng(0).normal(0, 1, (16, 10)).astype(np.float32)
    variables = jax.device_get(jax_module.init(jax.random.key(0), x))
    module = Net()
    state = state_dict_from_flax(variables, module)
    return module, state, x, jax_module, variables


def _replica(trained, tele, **kwargs):
    module, state, x = trained[:3]
    kwargs.setdefault("buckets", (1, 8))
    kwargs.setdefault("warm_input", x[:1])
    return InferenceReplica(module, state, telemetry=tele, device="cpu",
                            **kwargs)


def _ref(trained, x):
    """The JAX module on the same weights: the port serves its rows."""
    jax_module, variables = trained[3:]
    return np.asarray(jax_module.apply(variables, x))


# ---------------------------------------------------------------------------
# Admission / coalescing / padding
# ---------------------------------------------------------------------------


def test_admission_coalesces_deterministically(trained):
    """Requests queued while no batch is in flight coalesce into ONE
    bucket-sized batch, FIFO, and each future gets exactly its own
    rows back."""
    x = trained[2]
    tele = Telemetry(run_id="t_coalesce")
    rep = _replica(trained, tele, replica_id="0", auto_start=False)
    futs = [rep.submit(x[i:i + 1]) for i in range(5)]
    assert rep.queued_rows == 5
    rep.start()
    outs = [f.result(10.0) for f in futs]
    # One batch, smallest bucket that fits (8), fill 5/8.
    assert tele.counter_value("serve.batches_total",
                              {"replica": "0"}) == 1
    assert tele.gauge_value("serve.last_bucket", {"replica": "0"}) == 8
    fill = tele.histogram("serve.batch_fill", {"replica": "0"})
    assert fill["count"] == 1 and abs(fill["p50"] - 5 / 8) < 1e-9
    ref = _ref(trained, x[:5])
    for i, out in enumerate(outs):
        assert out.shape == (1, 1)
        np.testing.assert_allclose(out, ref[i:i + 1], **TOL)
    rep.stop()


def test_bucket_padding_never_leaks(trained):
    """Mixed-size requests padded to a bucket return exactly their own
    rows, equal to the unpadded forward — padded zero rows never appear
    in any output."""
    x = trained[2]
    tele = Telemetry(run_id="t_pad")
    rep = _replica(trained, tele, replica_id="0", auto_start=False)
    sizes = [1, 3, 2]
    offs = np.cumsum([0] + sizes)
    futs = [rep.submit(x[offs[i]:offs[i] + n])
            for i, n in enumerate(sizes)]
    rep.start()
    ref = _ref(trained, x[:offs[-1]])
    for i, (fut, n) in enumerate(zip(futs, sizes)):
        out = fut.result(10.0)
        assert out.shape[0] == n
        np.testing.assert_allclose(out, ref[offs[i]:offs[i] + n], **TOL)
    # A full-bucket request (no padding at all) agrees too.
    np.testing.assert_allclose(rep.infer(x[:8]), _ref(trained, x[:8]), **TOL)
    rep.stop()


class AnyShape(nn.Module):
    """Sums each row, whatever its width, times (scale + 1)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return x.sum(dim=-1, keepdim=True) * (self.scale + 1.0)


def test_mixed_shape_requests_never_coalesce():
    """Requests with different row shapes/dtypes queued together form
    SEPARATE batches: both complete, FIFO order preserved, and the loop
    survives to serve more traffic."""
    tele = Telemetry(run_id="t_mixed_shape")
    rep = InferenceReplica(AnyShape(), telemetry=tele, replica_id="0",
                           buckets=(1, 8), auto_start=False, device="cpu")
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (2, 10)).astype(np.float32)
    b = rng.normal(0, 1, (2, 12)).astype(np.float32)
    fa, fb = rep.submit(a), rep.submit(b)
    rep.start()
    np.testing.assert_allclose(fa.result(10.0),
                               a.sum(-1, keepdims=True) * 2.0, **TOL)
    np.testing.assert_allclose(fb.result(10.0),
                               b.sum(-1, keepdims=True) * 2.0, **TOL)
    # Two batches — never one — and the loop still serves.
    assert tele.counter_value("serve.batches_total",
                              {"replica": "0"}) == 2
    np.testing.assert_allclose(rep.infer(a[:1]),
                               a[:1].sum(-1, keepdims=True) * 2.0, **TOL)
    rep.stop()


def test_oversized_request_rejected(trained):
    x = trained[2]
    tele = Telemetry(run_id="t_oversize")
    rep = _replica(trained, tele, replica_id="0")
    with pytest.raises(ValueError, match="largest bucket"):
        rep.submit(np.concatenate([x, x]))  # 32 rows > bucket 8
    rep.stop()


def test_deadline_expiry(trained):
    """A request whose deadline lapses while queued fails with
    DeadlineExceeded (counted) and never occupies a batch slot; later
    requests are unaffected."""
    x = trained[2]
    tele = Telemetry(run_id="t_deadline")
    rep = _replica(trained, tele, replica_id="0", auto_start=False)
    stale = rep.submit(x[:1], deadline_s=0.05)
    time.sleep(0.15)
    fresh = rep.submit(x[1:2], deadline_s=30.0)
    rep.start()
    with pytest.raises(DeadlineExceeded):
        stale.result(10.0)
    np.testing.assert_allclose(fresh.result(10.0), _ref(trained, x[1:2]),
                               **TOL)
    assert tele.counter_value("serve.deadline_expired_total",
                              {"replica": "0"}) == 1
    rep.stop()


def test_backpressure_429_accounting(trained):
    """Admission past max_queue_rows raises Overloaded and counts one
    rejection; the admitted requests still complete."""
    x = trained[2]
    tele = Telemetry(run_id="t_429")
    rep = _replica(trained, tele, replica_id="0", auto_start=False,
                   max_queue_rows=4)
    futs = [rep.submit(x[i:i + 1]) for i in range(4)]
    with pytest.raises(Overloaded):
        rep.submit(x[4:5])
    assert Overloaded.status == 429
    assert tele.counter_value(
        "serve.rejected_total",
        {"replica": "0", "reason": "backpressure"}) == 1
    rep.start()
    for fut in futs:
        fut.result(10.0)
    rep.stop()


# ---------------------------------------------------------------------------
# Live weight updates
# ---------------------------------------------------------------------------


def _clf_payload(lr=0.1):
    torch.manual_seed(0)
    return serialize_torch_obj(
        ClassificationNet(n_classes=2), criterion="cross_entropy",
        optimizer="sgd", optimizer_params={"lr": lr}, input_shape=(10,),
    )


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _forward(module, state, x):
    module.load_state_dict(state)
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def test_live_weight_swap_exactness_single_server():
    """The puller's version-tagged pulls land a pushed update on the
    replica, and the SERVED outputs equal the server's weights'."""
    tele = Telemetry(run_id="t_weights")
    server = ParameterServer(_clf_payload(), device="cpu")
    http = ParamServerHttp(server, port=0).start()
    x = np.random.default_rng(1).normal(0, 1, (8, 10)).astype(np.float32)
    _v0, params0 = server.slot.read()
    rep = InferenceReplica(ClassificationNet(n_classes=2), params0,
                           replica_id="0", telemetry=tele, buckets=(8,),
                           warm_input=x, device="cpu")
    puller = WeightPuller(rep, BinaryTransport(http.url, quant=None),
                          poll_s=0.02, telemetry=tele).start()
    try:
        server.push_gradients({k: torch.ones_like(v)
                               for k, v in params0.items()}, wait=True)
        assert _wait(lambda: rep.params_version >= 1), \
            "pushed weights never landed"
        _v, server_params = server.slot.read()
        want = _forward(ClassificationNet(n_classes=2), server_params, x)
        np.testing.assert_allclose(rep.infer(x), want, **TOL)
        assert not np.allclose(want, _forward(ClassificationNet(n_classes=2),
                                              params0, x))
        assert tele.counter_value("serve.weight_updates_total",
                                  {"replica": "0"}) >= 1
        assert tele.gauge_value("serve.params_version",
                                {"replica": "0"}) == rep.params_version
        assert tele.histogram("serve.weight_install_s",
                              {"replica": "0"})["count"] >= 1
    finally:
        puller.stop()
        rep.stop()
        http.stop()
        server.stop()


# ---------------------------------------------------------------------------
# Router: load-aware routing, eviction, re-admission
# ---------------------------------------------------------------------------


def test_router_least_outstanding_weighted_by_latency(trained):
    """Routing picks (outstanding+1) x p50: with equal outstanding, a
    replica whose latency is 10x worse loses the pick; with a big
    enough backlog, even the fast one is passed over."""
    tele = Telemetry(run_id="t_route")
    r0 = _replica(trained, tele, replica_id="0")
    r1 = _replica(trained, tele, replica_id="1")
    router = Router(telemetry=tele)
    router.register(r0)
    router.register(r1)
    tele.observe("serve.request_latency_s", 0.5, labels={"replica": "0"})
    tele.observe("serve.request_latency_s", 0.05, labels={"replica": "1"})
    assert router._choose(set()) == "1"
    # Pile outstanding onto 1 until 0 wins despite worse latency.
    with router._lock:
        router._replicas["1"].outstanding = 20
    assert router._choose(set()) == "0"
    r0.stop()
    r1.stop()
    router.stop()


def test_a_restart_right_after_a_kill_brings_the_replica_back(trained):
    """``start`` straight after ``kill``, before the dying loop thread
    has returned, must still leave a live replica that serves."""
    x = trained[2]
    r = _replica(trained, Telemetry(run_id="t_restart")).start()
    try:
        for _ in range(5):
            r.kill()
            r.start()
            assert r.alive()
            assert r.infer(x[:1]).shape == (1, 1)
    finally:
        r.stop()


def test_router_evicts_and_readmits(trained):
    """A dead replica is evicted on the failed hop (the request is
    re-routed, not dropped); once it comes back, the health probe
    re-admits it and traffic reaches it again."""
    x = trained[2]
    tele = Telemetry(run_id="t_evict")
    policy = FtPolicy(restart=RestartPolicy(backoff_base_s=0.01,
                                            backoff_max_s=0.05))
    r0 = _replica(trained, tele, replica_id="0")
    r1 = _replica(trained, tele, replica_id="1")
    router = Router(ft_policy=policy, telemetry=tele,
                    probe_interval_s=0.05)
    router.register(r0)
    router.register(r1)
    tele.observe("serve.request_latency_s", 0.5, labels={"replica": "0"})
    tele.observe("serve.request_latency_s", 0.01, labels={"replica": "1"})
    assert router._choose(set()) == "1"
    r1.kill()
    outs = [router.submit(x[:1], deadline_s=10.0) for _ in range(6)]
    assert all(o.shape == (1, 1) for o in outs)
    assert tele.counter_value("router.evictions_total",
                              {"replica": "1", "reason": "error"}) >= 1
    # Recovery: restart the replica loop; the probe re-admits.
    r1.start()
    deadline = time.monotonic() + 5.0
    while router.stats["1"]["evicted"] and time.monotonic() < deadline:
        router.check_health()
        time.sleep(0.02)
    assert not router.stats["1"]["evicted"]
    assert tele.counter_value("router.readmissions_total",
                              {"replica": "1"}) >= 1
    # With replica 0 gone, the next request MUST land on replica 1.
    r0.kill()
    out = router.submit(x[:1], deadline_s=10.0)
    np.testing.assert_allclose(out, _ref(trained, x[:1]), **TOL)
    assert tele.counter_value("router.routed_total",
                              {"replica": "1"}) >= 1
    r0.stop()
    r1.stop()
    router.stop()


def test_router_heartbeat_deadline_evicts_wedged_replica(tmp_path):
    """A handle that still answers alive() but whose heartbeat AGED OUT
    (wedged loop, vanished exporter) is evicted."""
    tele = Telemetry(run_id="t_hb_evict")

    class _WedgedHandle:
        replica_id = "3"
        telemetry = tele

        def alive(self):
            return True

    hb_dir = str(tmp_path)
    HeartbeatEmitter(hb_dir, rank=3).beat()  # one beat, then silence
    policy = FtPolicy(barrier=BarrierPolicy(deadline_s=0.2))
    router = Router(ft_policy=policy, heartbeat_dir=hb_dir,
                    telemetry=tele)
    router.register(_WedgedHandle())
    router.check_health()
    assert not router.stats["3"]["evicted"]  # beat still fresh
    time.sleep(0.35)
    router.check_health()
    assert router.stats["3"]["evicted"]
    assert tele.counter_value("router.evictions_total",
                              {"replica": "3", "reason": "health"}) == 1
    assert tele.gauge_value("router.live_replicas") == 0
    router.stop()


def test_chaos_slow_replica_site(trained):
    """ChaosConfig.slow_replica_s delays that replica's admissions
    (the straggler fault the load-aware router sheds around)."""
    x = trained[2]
    tele = Telemetry(run_id="t_slow")
    rep = _replica(trained, tele, replica_id="0")
    with inject(ChaosConfig(slow_replica_s={0: 0.15}),
                telemetry=tele) as inj:
        t0 = time.perf_counter()
        rep.infer(x[:1])
        elapsed = time.perf_counter() - t0
    assert elapsed >= 0.15
    assert any(e["site"] == "serve.replica" and e.get("delay_s")
               for e in inj.events)
    assert tele.counter_value("chaos_injections_total",
                              {"site": "serve.replica"}) == 1
    rep.stop()


def test_tier_chaos_kill_zero_drops(trained):
    """The headline recovery contract: a seeded replica kill mid-load
    drops ZERO requests (the router re-routes them), the monitor
    restarts the replica, and the router re-admits it."""
    module, state, x = trained[:3]
    tele = Telemetry(run_id="t_tier_kill")
    policy = FtPolicy(restart=RestartPolicy(backoff_base_s=0.02,
                                            backoff_max_s=0.1,
                                            max_restarts=3))
    tier = InferenceTier(module, state, n_replicas=2,
                         telemetry=tele, ft_policy=policy,
                         warm_input=x[:1], buckets=(1, 8),
                         probe_interval_s=0.05, device="cpu")
    n = 30
    try:
        # Deterministic victim: replica 0 carries a fat observed
        # latency, so the weighted pick sends the opening requests to
        # replica 1 — whose 4th admission is the seeded kill.
        tele.observe("serve.request_latency_s", 0.5,
                     labels={"replica": "0"})
        with inject(ChaosConfig(kill_replica_at={1: 4}),
                    telemetry=tele) as inj:
            outs = []
            for _ in range(n):
                outs.append(tier.submit(x[:1], deadline_s=15.0))
                time.sleep(0.01)
        kills = [e for e in inj.events if e["site"] == "serve.replica"]
        assert len(kills) == 1
        assert len(outs) == n  # zero dropped
        ref = _ref(trained, x[:1])
        for out in outs:
            np.testing.assert_allclose(out, ref, **TOL)
        assert tele.counter_value("router.evictions_total",
                                  {"replica": "1",
                                   "reason": "error"}) >= 1
        assert _wait(lambda: tele.counter_value(
            "router.readmissions_total", {"replica": "1"}) >= 1)
        assert tele.counter_value("serve.replica_restarts_total",
                                  {"replica": "1"}) >= 1
        assert tele.counter_value("serve.replica_deaths_total",
                                  {"replica": "1"}) == 1
    finally:
        tier.stop()


# ---------------------------------------------------------------------------
# Both packages side by side
# ---------------------------------------------------------------------------


def test_coalescing_matches_the_jax_replica(trained):
    """The deterministic coalescing case through both packages: the same
    ragged requests queued before the loop starts give the same batches
    (equal ``serve.*`` counters, ``batch_fill`` and ``last_bucket``) and
    rows within 1e-5 of the JAX replica's."""
    module, state, x, jax_module, variables = trained
    sizes = [1, 3, 2, 1, 4, 2, 1]  # 14 rows: a bucket of 8, then 8 more
    offs = np.cumsum([0] + sizes)
    runs = {}
    for name in ("jax", "port"):
        if name == "jax":
            tele = JaxTelemetry(run_id="c")
            rep = jax_infer.InferenceReplica(
                jax_module, variables["params"], telemetry=tele,
                replica_id="0", buckets=(1, 8), warm_input=x[:1],
                auto_start=False)
        else:
            tele = Telemetry(run_id="c")
            rep = _replica(trained, tele, replica_id="0", auto_start=False)
        futs = [rep.submit(x[offs[i]:offs[i] + n])
                for i, n in enumerate(sizes)]
        rep.start()
        rows = np.concatenate([f.result(10.0) for f in futs])
        rep.stop()
        snap = tele.snapshot()
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith("serve.")}
        fill = snap["histograms"]["serve.batch_fill{replica=0}"]
        runs[name] = (rows, counters, fill["p50"], fill["count"],
                      snap["gauges"]["serve.last_bucket{replica=0}"])
    got, want = runs["port"], runs["jax"]
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert got[1:] == want[1:]
    assert got[1]["serve.batches_total{replica=0}"] == 2
    assert got[1]["serve.rows_total{replica=0}"] == 14


def test_tier_serves_the_jax_tiers_rows(trained):
    module, state, x, jax_module, variables = trained
    jax_tier = JaxInferenceTier(jax_module, variables["params"],
                                n_replicas=2, telemetry=JaxTelemetry(),
                                warm_input=x[:1], buckets=(1, 8))
    tier = InferenceTier(module, state, n_replicas=2, telemetry=Telemetry(),
                         warm_input=x[:1], buckets=(1, 8), device="cpu")
    try:
        for n in (1, 3, 8):
            np.testing.assert_allclose(tier.submit(x[:n]),
                                       jax_tier.submit(x[:n]), **TOL)
        assert set(tier.router.stats) == {"0", "1"}
    finally:
        tier.stop()
        jax_tier.stop()


class _Converted:
    """A transport whose pulled trees are carried to the other package's
    layout (the pull contract is the same on both sides)."""

    def __init__(self, transport, convert):
        self.transport = transport
        self.convert = convert

    def pull(self, have):
        snap = self.transport.pull(have)
        return None if snap is None else (snap[0], self.convert(snap[1]))

    def close(self):
        self.transport.close()


def _flax_from_state_dict(state):
    """A small Dense net's ``state_dict`` as Flax params."""
    out = {}
    for key, value in state.items():
        layer, leaf = key.split(".")
        value = np.asarray(value)
        out.setdefault(layer, {})["kernel" if leaf == "weight" else "bias"] = (
            value.T if leaf == "weight" else value)
    return out


def test_port_puller_against_a_jax_server():
    x = np.random.default_rng(2).normal(0, 1, (8, 10)).astype(np.float32)
    jax_module = JaxClassificationNet(n_classes=2)
    server = jax_ps.ParameterServer(jax_serialize(
        jax_module, criterion="cross_entropy", optimizer="sgd",
        optimizer_params={"lr": 0.1}, input_shape=(10,)))
    http = jax_ps.ParamServerHttp(server, port=0).start()
    module = ClassificationNet(n_classes=2)
    rep = InferenceReplica(module, telemetry=Telemetry(), buckets=(8,),
                           warm_input=x, device="cpu")
    puller = WeightPuller(rep, _Converted(
        BinaryTransport(http.url, quant=None),
        lambda tree: state_dict_from_flax(tree, module)), poll_s=0.02).start()
    try:
        assert _wait(lambda: puller.version >= 0)
        params0 = jax.device_get(server.get_parameters()[1])
        server.push_gradients(jax.tree.map(np.ones_like, params0), wait=True)
        assert _wait(lambda: rep.params_version >= 1)
        want = np.asarray(jax_module.apply(
            {"params": jax.device_get(server.get_parameters()[1])}, x))
        np.testing.assert_allclose(rep.infer(x), want, **TOL)
    finally:
        puller.stop()
        rep.stop()
        http.stop()
        server.stop()


def test_jax_puller_against_the_port_server():
    x = np.random.default_rng(3).normal(0, 1, (8, 10)).astype(np.float32)
    server = ParameterServer(_clf_payload(), device="cpu")
    http = ParamServerHttp(server, port=0).start()
    jax_module = JaxClassificationNet(n_classes=2)
    params0 = _flax_from_state_dict(server.slot.read()[1])
    rep = jax_infer.InferenceReplica(jax_module, params0,
                                     telemetry=JaxTelemetry(), buckets=(8,),
                                     warm_input=x)
    puller = jax_infer.WeightPuller(rep, _Converted(
        JaxBinaryTransport(http.url, quant=None), _flax_from_state_dict),
        poll_s=0.02).start()
    try:
        assert _wait(lambda: puller.version >= 0)
        _v, p0 = server.slot.read()
        server.push_gradients({k: torch.ones_like(v) for k, v in p0.items()},
                              wait=True)
        assert _wait(lambda: rep.params_version >= 1)
        want = _forward(ClassificationNet(n_classes=2), server.slot.read()[1],
                        x)
        np.testing.assert_allclose(rep.infer(x), want, **TOL)
    finally:
        puller.stop()
        rep.stop()
        http.stop()
        server.stop()


def test_run_replica_server_pulls_until_cancelled(tmp_path):
    server = ParameterServer(_clf_payload(), device="cpu")
    http = ParamServerHttp(server, port=0).start()
    cancel = threading.Event()
    result = {}
    tele = Telemetry()
    th = threading.Thread(target=lambda: result.update(run_replica_server(
        _clf_payload(), replica_id="2", server_url=http.url,
        heartbeat_interval_s=0.05, telemetry=tele, cancel=cancel,
        heartbeat_dir=str(tmp_path), device="cpu")), daemon=True)
    th.start()
    try:
        assert _wait(lambda: tele.counter_value(
            "serve.weight_updates_total", {"replica": "2"}) >= 1)
        _v, p0 = server.slot.read()
        server.push_gradients({k: torch.ones_like(v) for k, v in p0.items()},
                              wait=True)
        assert _wait(lambda: tele.gauge_value(
            "serve.params_version", {"replica": "2"}) == 1)
    finally:
        cancel.set()
        th.join(timeout=10)
        http.stop()
        server.stop()
    assert not th.is_alive()
    assert result == {"replica_id": "2", "batches": 0, "params_version": 1}
    from sparktorch_tpu_torch.obs import gang_report

    assert gang_report(str(tmp_path))["ranks"][2]["alive"] is False


@pytest.mark.parametrize("gate", ["1", "0"])
def test_router_start_arms_the_stack_profiler_as_jax(gate, monkeypatch):
    # The JAX Router.start arms the process's stack sampler
    # (profile.ensure on the router's bus); the port's does the same.
    from sparktorch_tpu.obs import profile as jax_profile
    from sparktorch_tpu.serve.router import Router as JaxRouter
    from sparktorch_tpu_torch.obs import profile

    monkeypatch.setenv("SPARKTORCH_TPU_PROFILE", gate)
    armed = {}
    for name, prof, router_cls, tele in (
            ("port", profile, Router, Telemetry()),
            ("jax", jax_profile, JaxRouter, JaxTelemetry())):
        prev = prof.install(None)
        router = router_cls(telemetry=tele)
        try:
            router.start()
            active = prof.active()
            armed[name] = (active is not None,
                           active is not None and active.telemetry is tele)
        finally:
            router.stop()
            started = prof.install(prev)
            if started is not None and started is not prev:
                started.stop()
    assert armed["port"] == armed["jax"] == ((True, True) if gate == "1"
                                             else (False, False))


def test_unported_paths_raise_and_name_their_item(trained):
    x = trained[2]
    tele = Telemetry()
    rep = _replica(trained, tele, replica_id="0")
    try:
        # A trace context once raised here: now the batch loop records
        # the request's queue_wait and execute under it, as the JAX
        # replica does.
        from sparktorch_tpu_torch.obs import rpctrace

        tracer = rpctrace.tracer_for(tele)
        tracer.sample_rate = 1.0
        with tracer.root_span("replica") as hop:
            rep.submit(x[:1], trace_ctx=hop.ctx).result(10)
        assert _wait(lambda: len(tracer.spans) == 3)
        spans = {s["name"]: s for s in tracer.spans}
        assert set(spans) == {"replica", "queue_wait", "execute"}
        for name in ("queue_wait", "execute"):
            assert spans[name]["parent_id"] == spans["replica"]["span_id"]
            assert spans[name]["kind"] == "server"
            assert spans[name]["ann"]["replica"] == "0"
        assert spans["execute"]["ann"]["bucket"] == 1
        assert spans["execute"]["ann"]["batch_rows"] == 1
        # Delta pulls are ported: a transport with pull_delta is taken,
        # and a 304 from it installs nothing.
        puller = WeightPuller(rep, types.SimpleNamespace(
            pull_delta=lambda have, quant=None: {"fresh": False,
                                                 "epoch": 7}))
        assert puller.poll_once() is False and puller.version == -1
    finally:
        rep.stop()
    # The fleet collector is ported: a router takes one (its weights
    # come from the collector's merged scrape).
    collector = types.SimpleNamespace(merged_snapshot=lambda: {})
    assert Router(collector=collector).collector is collector
    # The ctl worker context is ported: beside the JAX entry, a ctx whose
    # cancel is already set returns the same document at once, and the
    # stack profiler is armed on the context's bus.
    from sparktorch_tpu_torch.obs import profile

    ctx = types.SimpleNamespace(telemetry=Telemetry(), heartbeat=None,
                                cancel=threading.Event())
    ctx.cancel.set()
    jax_ctx = types.SimpleNamespace(telemetry=JaxTelemetry(), heartbeat=None,
                                    cancel=ctx.cancel)
    prev = profile.install(None)
    try:
        got = run_replica_server(_clf_payload(), replica_id="3", ctx=ctx,
                                 device="cpu")
        armed = profile.active()
    finally:
        started = profile.install(prev)
        if started is not None and started is not prev:
            started.stop()
    from sparktorch_tpu.obs import profile as jax_profile

    jax_prev = jax_profile.install(None)
    try:
        want = jax_infer.run_replica_server(jax_serialize(
            JaxClassificationNet(n_classes=2), criterion="cross_entropy",
            optimizer="sgd", optimizer_params={"lr": 0.1},
            input_shape=(10,)), replica_id="3", ctx=jax_ctx)
    finally:
        started = jax_profile.install(jax_prev)
        if started is not None and started is not jax_prev:
            started.stop()
    assert got == want == {"replica_id": "3", "batches": 0,
                           "params_version": 0}
    assert (armed is not None) == profile.enabled()
    if armed is not None:
        assert armed.telemetry is ctx.telemetry
    from sparktorch_tpu_torch.parallel.mesh import Mesh, MeshConfig

    for config in (MeshConfig(dp=2), MeshConfig(fsdp=2)):
        with pytest.raises(NotImplementedError, match="item 9"):
            _replica(trained, tele, mesh=Mesh(config.resolve(2)))


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(trained):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    module, state = trained[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceReplica(module, state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceTier(module, state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_replica_server(_clf_payload(), cancel=threading.Event())
