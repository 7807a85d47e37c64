"""The port's per-request RPC tracer (``obs/rpctrace.py``) against the JAX package's.

Frames: a traced frame and an untraced one are byte for byte the JAX
package's, and each package's ``frame_trace`` reads the other's. Span
documents: the same span dicts stitch to the same trees, critical paths
and Chrome events in both packages; a seeded tracer samples alike.
Live paths, every request sampled: a single server, a sharded fleet
(each package's client against the other's servers)
and a router in front of a replica give trees of the JAX shapes, and a
seeded slow shard is the critical path in both collectors.

Servers bind port 0 and every fleet, server and transport closes in a
``finally``.
"""

import time

import jax
import numpy as np
import pytest

from sparktorch_tpu import serialize_torch_obj as jax_serialize
from sparktorch_tpu.models import Net as JaxNet
from sparktorch_tpu.net import wire as jax_wire
from sparktorch_tpu.obs import rpctrace as jax_rpctrace
from sparktorch_tpu_torch import serialize_torch_obj
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import Net
from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.obs import rpctrace


def _span(trace, sid, parent, name, ts, dur, shard=None, kind="client",
          status="ok", **ann):
    if shard is not None:
        ann["shard"] = shard
    return {"trace_id": trace, "span_id": sid, "parent_id": parent,
            "name": name, "kind": kind, "ts": ts, "dur_s": dur,
            "status": status, "error": None, "forced": False, "ann": ann}


SPANS = [
    # A sharded pull whose shard 7 bounds it.
    _span("t1", "r", None, "pull", 100.0, 0.2),
    _span("t1", "a", "r", "shard_pull", 100.01, 0.02, shard="0"),
    _span("t1", "b", "r", "shard_pull", 100.01, 0.18, shard="7"),
    _span("t1", "c", "b", "serve", 100.02, 0.16, shard="7", kind="server",
          route="/delta.bin"),
    _span("t1", "d", "c", "render", 100.03, 0.01, kind="server"),
    # A push with an orphan, a duplicate and a second root.
    _span("t2", "r", None, "push", 10.0, 0.1),
    _span("t2", "x", "missing", "apply", 10.05, 0.01, kind="server"),
    _span("t2", "r", None, "push", 10.0, 0.1),
    _span("t2", "q", None, "push", 10.2, 0.05, status="error"),
    _span("t2", "e", "r", "encode", 10.001, 0.004, kind="internal"),
    _span("t2", "s", "r", "socket", 10.005, 0.09, kind="internal"),
    # Orphans only: the earliest is promoted.
    _span("t3", "y", "gone", "serve", 5.0, 0.02, kind="server"),
    _span("t3", "z", "gone", "decode", 5.01, 0.001, kind="server"),
    # An infer request: router -> replica -> queue_wait, execute.
    _span("t4", "i", None, "infer", 50.0, 0.05),
    _span("t4", "h", "i", "replica", 50.001, 0.048, replica="1"),
    _span("t4", "w", "h", "queue_wait", 50.002, 0.01, kind="server",
          replica="1"),
    _span("t4", "v", "h", "execute", 50.012, 0.035, kind="server",
          replica="1", bucket=8, batch_rows=3),
    # No ids: skipped.
    {"trace_id": None, "span_id": None, "name": "lost"},
]


# ---------------------------------------------------------------------------
# Frames and contexts
# ---------------------------------------------------------------------------


def test_traced_frames_are_the_jax_frames_and_read_across():
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.int32(9)}}
    ctx = rpctrace.SpanContext.from_parts("0123456789abcdef" * 2,
                                          "fedcba9876543210", True)
    jax_ctx = jax_rpctrace.SpanContext.from_parts(ctx.trace_id, ctx.span_id,
                                                  True)
    for trace, jax_trace in ((None, None), (ctx, jax_ctx)):
        got = wire.frame_bytes(wire.encode(tree, version=5, run_tag=321,
                                           trace=trace))
        want = jax_wire.frame_bytes(jax_wire.encode(tree, version=5,
                                                    run_tag=321,
                                                    trace=jax_trace))
        assert got == want
        for data in (got, want):
            for read in (wire.frame_trace, jax_wire.frame_trace):
                back = read(data)
                if trace is None:
                    assert back is None
                else:
                    assert (back.trace_id, back.span_id, back.sampled) == (
                        ctx.trace_id, ctx.span_id, True)
            # The trace extension shifts the body: both decode it.
            assert wire.decode(data)[0] == jax_wire.decode(data)[0] == 5
    # An unsampled context leaves the frame untraced; a delta frame
    # carries the extension too.
    off = rpctrace.SpanContext.from_parts(ctx.trace_id, ctx.span_id, False)
    assert wire.frame_bytes(wire.encode(tree, trace=off)) == \
        wire.frame_bytes(wire.encode(tree))
    versions = {("w",): 3, ("b", "c"): 4}
    assert wire.frame_bytes(wire.encode(
        tree, version=2, leaf_versions=versions, trace=ctx)) == \
        jax_wire.frame_bytes(jax_wire.encode(tree, version=2,
                                             leaf_versions=versions,
                                             trace=jax_ctx))
    # Truncated inside the extension, a malformed context: both refuse.
    traced = wire.frame_bytes(wire.encode(tree, trace=ctx))
    for mod in (wire, jax_wire):
        with pytest.raises(mod.WireError, match="trace extension"):
            mod.frame_trace(traced[:wire.HEADER_SIZE + 5])
    with pytest.raises(wire.WireError, match="malformed"):
        wire.encode(tree, trace=rpctrace.SpanContext("zz", "yy", True))


@pytest.mark.parametrize("value", [
    None, "", "garbage", "a-b-c", "zz" * 16 + "-" + "f" * 16 + "-01",
    "0" * 32 + "-" + "1" * 16, "0" * 32 + "-" + "1" * 16 + "-01",
    "a" * 32 + "-" + "b" * 16 + "-00", " " + "c" * 32 + "-" + "d" * 16
    + "-03 "])
def test_header_parse_matches_jax(value):
    got = rpctrace.SpanContext.from_header(value)
    want = jax_rpctrace.SpanContext.from_header(value)
    if want is None:
        assert got is None
    else:
        assert (got.trace_id, got.span_id, got.sampled) == (
            want.trace_id, want.span_id, want.sampled)
        assert got.to_header() == want.to_header()


def test_module_surface_matches_jax():
    for name in ("SAMPLE_ENV", "SLO_ENV", "BUFFER_ENV",
                 "DEFAULT_SAMPLE_RATE", "DEFAULT_SLO_S", "DEFAULT_BUFFER",
                 "TRACE_HEADER", "SECTION", "TRACES_SECTION"):
        assert getattr(rpctrace, name) == getattr(jax_rpctrace, name), name
    public = {n for n in dir(jax_rpctrace) if not n.startswith("_")
              and callable(getattr(jax_rpctrace, n))} - {
        "Telemetry", "get_telemetry", "Any", "Dict", "Iterable", "List",
        "Mapping", "Optional", "deque"}
    assert public <= set(dir(rpctrace))
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu_torch import obs

    exported = {n for n in jax_obs.__all__ if getattr(
        getattr(jax_obs, n), "__module__", None)
        == "sparktorch_tpu.obs.rpctrace"}
    assert len(exported) == 7 and exported <= set(obs.__all__)


# ---------------------------------------------------------------------------
# Span documents: stitching, critical paths, Chrome export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_traces", [None, 2])
def test_stitched_trees_match_jax(max_traces):
    got = rpctrace.stitch_spans(SPANS, max_traces=max_traces)
    want = jax_rpctrace.stitch_spans(SPANS, max_traces=max_traces)
    assert got == want
    by_root = {t["root"]["name"]: t for t in got}
    assert by_root["pull"]["critical"]["shard"] == "7"
    assert by_root.get("serve", {}).get("root", {}).get(
        "orphan_root", True) is True
    for t in got:
        assert rpctrace.critical_path(t["root"]) == \
            jax_rpctrace.critical_path(t["root"])
        assert rpctrace.critical_summary(t["root"]) == \
            jax_rpctrace.critical_summary(t["root"])
    if max_traces is None:
        assert [t["trace_id"] for t in got] == ["t1", "t4", "t2", "t3"]
        assert by_root["infer"]["critical"]["name"] == "execute"
        push = by_root["push"]
        assert push["n_spans"] == 5
        assert [o["name"] for o in push["orphans"]] == ["apply"]
        assert [r["status"] for r in push["extra_roots"]] == ["error"]


def test_chrome_export_and_snapshot_reader_match_jax(tmp_path):
    assert rpctrace.to_chrome_trace(SPANS, service="ps") == \
        jax_rpctrace.to_chrome_trace(SPANS, service="ps")
    path = rpctrace.write_chrome_trace(str(tmp_path / "rpc.json"), SPANS)
    import json

    with open(path) as f:
        assert json.load(f) == jax_rpctrace.to_chrome_trace(SPANS)
    snap = {"sections": {"rpc_spans": {"spans": SPANS[:3]}}}
    assert rpctrace.spans_from_snapshot(snap) == \
        jax_rpctrace.spans_from_snapshot(snap)
    for bad in ({}, {"sections": {"rpc_spans": "x"}},
                {"sections": {"rpc_spans": {"spans": 3}}}):
        assert rpctrace.spans_from_snapshot(bad) == \
            jax_rpctrace.spans_from_snapshot(bad) == []


def _drive(mod, tele, tracer):
    """The same calls on each package's tracer: seeded head sampling, a
    child tree, an after-the-fact record, an error, a forced slow root,
    the ring's bound."""
    decisions = []
    for _ in range(200):
        with tracer.root_span("pull", host="h", port=1) as sp:
            decisions.append(sp.ctx.sampled)
            with tracer.child_span("serve", sp.ctx, kind="server",
                                   shard="0") as c:
                c.annotate(route="/delta.bin")
                tracer.record("queue_wait", c.ctx, 1.0, 0.001,
                              kind="server")
    with pytest.raises(ValueError):
        with tracer.root_span("push") as sp:
            raise ValueError("boom")
    tracer.sample_rate = 0.0
    tracer.slo_s = 0.01
    with tracer.root_span("slow"):
        time.sleep(0.02)
    with tracer.root_span("fast"):
        pass
    return decisions


def test_tracer_samples_records_and_counts_as_jax():
    from sparktorch_tpu.obs import Telemetry as JaxTelemetry
    from sparktorch_tpu_torch.obs import Telemetry

    out = {}
    for name, mod, tele in (("port", rpctrace, Telemetry(run_id="t")),
                            ("jax", jax_rpctrace, JaxTelemetry(run_id="t"))):
        tracer = mod.RpcTracer(tele, sample_rate=0.3, slo_s=10.0,
                               buffer_size=64, seed=7)
        decisions = _drive(mod, tele, tracer)
        spans = tracer.spans
        counters = {k: v for k, v in tele.snapshot()["counters"].items()
                    if k.startswith("rpctrace.")}
        section = tele.get_section(mod.SECTION)
        out[name] = (decisions, [(s["name"], s["kind"], s["status"],
                                  s["forced"], s["ann"]) for s in spans],
                     counters, section["n"], section["dropped"],
                     tracer.dropped, [s["error"] for s in spans
                                      if s["error"]])
        tracer.resize(8)
        assert len(tracer.spans) == 8
        tracer.clear()
        assert tracer.spans == [] and tele.get_section(mod.SECTION) is None
        off = mod.RpcTracer(tele, sample_rate=-1.0)
        with off.root_span("pull") as sp:
            assert sp.ctx is None and not off.enabled
    assert out["port"] == out["jax"]
    assert 30 < sum(out["port"][0]) < 90
    assert out["port"][4] > 0  # the 64-span ring dropped spans
    assert out["port"][1][-1][:4] == ("slow", "client", "ok", True)


def test_env_sets_the_tracer_and_one_tracer_a_bus(monkeypatch):
    from sparktorch_tpu_torch.obs import Telemetry

    monkeypatch.setenv(rpctrace.SAMPLE_ENV, "0.5")
    monkeypatch.setenv(rpctrace.SLO_ENV, "2.5")
    monkeypatch.setenv(rpctrace.BUFFER_ENV, "3")
    tele = Telemetry()
    tracer = rpctrace.tracer_for(tele)
    assert (tracer.sample_rate, tracer.slo_s, tracer._ring.maxlen) == (
        0.5, 2.5, 3)
    assert rpctrace.tracer_for(tele) is tracer
    assert rpctrace.tracer_for(Telemetry()) is not tracer


# ---------------------------------------------------------------------------
# Live paths
# ---------------------------------------------------------------------------


def _shape(node):
    """A span tree's shape: names, kinds, annotation keys (less the
    socket's host and port) and the set of child shapes."""
    ann = tuple(sorted(k for k in (node.get("ann") or {})
                       if k not in ("host", "port")))
    return (node["name"], node["kind"], node["status"], ann,
            tuple(sorted({_shape(c) for c in node.get("children") or []})))


def _settled(tracers, n, timeout=5.0):
    """Every tracer's spans, once their total stops below ``n``: a
    handler thread closes its serve span just after the reply."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = [s for t in tracers for s in t.spans]
        if len(spans) >= n:
            time.sleep(0.05)
            return [s for t in tracers for s in t.spans]
        time.sleep(0.01)
    return [s for t in tracers for s in t.spans]


def _port_fleet_payload():
    import torch

    torch.manual_seed(0)
    return serialize_torch_obj(Net(), criterion="mse", optimizer="sgd",
                               optimizer_params={"lr": 0.1},
                               input_shape=(10,))


def _jax_payload():
    return jax_serialize(JaxNet(), criterion="mse", optimizer="sgd",
                         optimizer_params={"lr": 0.1}, input_shape=(10,))


def _ones(tree):
    """Ones shaped like a (nested) tree of arrays."""
    if isinstance(tree, dict):
        return {k: _ones(v) for k, v in tree.items()}
    return np.ones(np.shape(tree), np.float32)


def _single_server_trees(server_pkg, client_pkg):
    """One traced push and one fresh pull of ``client_pkg``'s
    BinaryTransport against ``server_pkg``'s single server."""
    pkgs = {"port": _port_pkg(), "jax": _jax_pkg()}
    s, c = pkgs[server_pkg], pkgs[client_pkg]
    s_tele, c_tele = s.Telemetry(run_id="srv"), c.Telemetry(run_id="cli")
    s_tracer, c_tracer = s.tracer_for(s_tele), c.tracer_for(c_tele)
    s_tracer.sample_rate = c_tracer.sample_rate = 1.0
    server = s.ParameterServer(s.payload(), telemetry=s_tele, **s.kw)
    http = s.ParamServerHttp(server, port=0).start()
    t = c.BinaryTransport(http.url, quant=None, telemetry=c_tele)
    try:
        version, params = t.pull(-1)
        t.push(c.ones(params))
        server.drain()
        assert t.pull(version) is not None
        spans = _settled([s_tracer, c_tracer], 3 + 7 + 3)
    finally:
        t.close()
        http.stop()
        server.stop()
    return spans


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _port_pkg():
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.net.transport import BinaryTransport
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )

    return _Pkg(Telemetry=Telemetry, tracer_for=rpctrace.tracer_for,
                rpctrace=rpctrace, ParameterServer=ParameterServer,
                ParamServerHttp=ParamServerHttp, ParamServerFleet=(
                    ParamServerFleet), BinaryTransport=BinaryTransport,
                ShardedTransport=ShardedTransport,
                FleetCollector=FleetCollector, payload=_port_fleet_payload,
                ones=_ones, kw={"device": "cpu"})


def _jax_pkg():
    from sparktorch_tpu.net.sharded import ShardedTransport
    from sparktorch_tpu.net.transport import BinaryTransport
    from sparktorch_tpu.obs import FleetCollector, Telemetry
    from sparktorch_tpu.serve.fleet import ParamServerFleet
    from sparktorch_tpu.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )

    return _Pkg(Telemetry=Telemetry, tracer_for=jax_rpctrace.tracer_for,
                rpctrace=jax_rpctrace, ParameterServer=ParameterServer,
                ParamServerHttp=ParamServerHttp, ParamServerFleet=(
                    ParamServerFleet), BinaryTransport=BinaryTransport,
                ShardedTransport=ShardedTransport,
                FleetCollector=FleetCollector, payload=_jax_payload,
                ones=_ones, kw={})


def test_single_server_trees_have_the_jax_shapes_across_packages():
    shapes = {}
    for pair in (("port", "port"), ("port", "jax"), ("jax", "port")):
        spans = _single_server_trees(*pair)
        for stitch in (rpctrace.stitch_spans, jax_rpctrace.stitch_spans):
            trees = stitch(spans)
            assert len(trees) == 3, [t["root"]["name"] for t in trees]
            shapes.setdefault(pair, set()).add(
                tuple(sorted(_shape(t["root"]) for t in trees)))
    want = shapes["port", "port"]
    assert len(want) == 1
    assert shapes["port", "jax"] == shapes["jax", "port"] == want
    names = {n[0]: n for n in next(iter(want))}
    push = names["push"]
    assert [c[0] for c in push[4]] == ["encode", "serve", "socket"]
    serve = next(c for c in push[4] if c[0] == "serve")
    assert [c[0] for c in serve[4]] == ["apply", "decode", "queue_wait"]
    pull = names["pull"]
    assert [c[0] for c in pull[4]] == ["serve"]
    assert [c[0] for c in pull[4][0][4]] == ["render"]


def _sharded_trees(fleet_pkg, client_pkg, slow=None):
    """A fresh traced pull, a push, and a pull (under ``slow``, a
    shard's seeded delay, when given) of ``client_pkg``'s
    ShardedTransport over ``fleet_pkg``'s 2-shard fleet: the spans of
    both buses, and, with ``slow``, the trees of a collector over the
    fleet (client and fleet then share the fleet's bus)."""
    pkgs = {"port": _port_pkg(), "jax": _jax_pkg()}
    f, c = pkgs[fleet_pkg], pkgs[client_pkg]
    f_tele = f.Telemetry(run_id="fleet")
    c_tele = f_tele if slow is not None else c.Telemetry(run_id="cli")
    tracers = {id(t): c.tracer_for(t) if t is c_tele else f.tracer_for(t)
               for t in (f_tele, c_tele)}
    for tracer in tracers.values():
        tracer.sample_rate = 1.0
    fleet = f.ParamServerFleet(f.payload(), n_shards=2, telemetry=f_tele,
                               **f.kw).start()
    t = c.ShardedTransport(fleet, telemetry=c_tele)
    collector, traces = None, None
    try:
        version, params = t.pull(-1)
        t.push(c.ones(params))
        fleet.drain()
        if slow is None:
            t.pull(version)
        else:
            from sparktorch_tpu.ft import ChaosConfig as JaxChaosConfig
            from sparktorch_tpu.ft import inject as jax_inject
            from sparktorch_tpu_torch.ft import ChaosConfig, inject

            cfg, inj = ((ChaosConfig, inject) if fleet_pkg == "port"
                        else (JaxChaosConfig, jax_inject))
            with inj(cfg(slow_shard_s={slow: 0.08}, seed=0)):
                t.pull(version)
        spans = _settled(list(tracers.values()), 0)
        if slow is not None:
            collector = f.FleetCollector.for_fleet(fleet, poll_interval_s=0)
            collector.poll()
            traces = collector.rpc_traces()
    finally:
        t.close()
        if collector is not None:
            collector.stop()
        fleet.stop()
    return spans, traces


@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port")],
                         ids=["jax-client-port-fleet",
                              "port-client-jax-fleet"])
def test_sharded_trees_have_the_port_shapes_across_packages(pair):
    shapes = {}
    for key in (pair, ("port", "port")):
        spans, _ = _sharded_trees(*key)
        trees = rpctrace.stitch_spans(spans)
        assert jax_rpctrace.stitch_spans(spans) == trees
        assert sorted(t["root"]["name"] for t in trees) == [
            "pull", "pull", "push"]
        assert all(not t["orphans"] for t in trees)
        shapes[key] = sorted(_shape(t["root"]) for t in trees)
        for t in trees:
            if t["root"]["name"] == "pull":
                hops = t["root"]["children"]
                assert sorted(h["ann"]["shard"] for h in hops) == ["0", "1"]
                for hop in hops:
                    assert [c["name"] for c in hop["children"]] == ["serve"]
                    serve = hop["children"][0]
                    assert serve["ann"] == {"route": "/delta.bin",
                                            "shard": hop["ann"]["shard"]}
                    assert [c["name"] for c in serve["children"]] == [
                        "render"]
    assert shapes[pair] == shapes["port", "port"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_slow_shard_is_the_critical_path_in_each_collector(pkg):
    _, traces = _sharded_trees(pkg, pkg, slow="1")
    slow = [t for t in traces if t["root"]["name"] == "pull"
            and t["wall_s"] >= 0.06]
    assert len(slow) == 1, [(t["root"]["name"], t["wall_s"]) for t in traces]
    assert str(slow[0]["critical"]["shard"]) == "1"
    assert slow[0]["critical"]["name"] == "shard_pull"


def test_unsampled_sharded_ops_record_nothing():
    pkg = _port_pkg()
    tele = pkg.Telemetry(run_id="off")
    tracer = rpctrace.tracer_for(tele)
    tracer.sample_rate = 0.0
    fleet = pkg.ParamServerFleet(pkg.payload(), n_shards=2, telemetry=tele,
                                 device="cpu").start()
    t = pkg.ShardedTransport(fleet, telemetry=tele)
    try:
        version, params = t.pull(-1)
        t.push(_ones(params))
        fleet.drain()
        t.pull(version)
        time.sleep(0.05)
        assert tracer.spans == []
    finally:
        t.close()
        fleet.stop()


def test_degraded_hop_stays_in_the_tree():
    pkg = _port_pkg()
    tele = pkg.Telemetry(run_id="degrade")
    tracer = rpctrace.tracer_for(tele)
    tracer.sample_rate = 1.0
    fleet = pkg.ParamServerFleet(pkg.payload(), n_shards=2, telemetry=tele,
                                 restart_shards=False, device="cpu").start()
    t = pkg.ShardedTransport(fleet, telemetry=tele, grace_s=30.0)
    try:
        have = t.pull(-1)[0]
        victim = sorted(fleet.urls())[0]
        fleet.kill_shard(victim)
        t.pull(have)
        time.sleep(0.05)
        tree = rpctrace.stitch_spans(tracer.spans)[0]
        hops = {c["ann"]["shard"]: c for c in tree["root"]["children"]}
        assert hops[victim]["status"] == "error"
        assert hops[victim]["ann"]["degraded"] is True
        other = next(s for s in hops if s != victim)
        assert hops[other]["status"] == "ok"
    finally:
        t.close()
        fleet.stop()


def test_router_request_tree_has_the_jax_shape():
    from sparktorch_tpu.obs import Telemetry as JaxTelemetry
    from sparktorch_tpu.serve.infer import InferenceReplica as JaxReplica
    from sparktorch_tpu.serve.router import Router as JaxRouter
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.infer import InferenceReplica
    from sparktorch_tpu_torch.serve.router import Router

    jax_module = JaxNet()
    x = np.random.default_rng(0).normal(0, 1, (16, 10)).astype(np.float32)
    variables = jax.device_get(jax_module.init(jax.random.key(0), x))
    module = Net()
    state = state_dict_from_flax(variables, module)
    out = {}
    for name, tele, make, router_cls, mod in (
            ("jax", JaxTelemetry(run_id="r"),
             lambda t: JaxReplica(jax_module, variables["params"],
                                  telemetry=t, replica_id="0",
                                  buckets=(1, 8), warm_input=x[:1]),
             JaxRouter, jax_rpctrace),
            ("port", Telemetry(run_id="r"),
             lambda t: InferenceReplica(module, state, telemetry=t,
                                        replica_id="0", buckets=(1, 8),
                                        warm_input=x[:1], device="cpu"),
             Router, rpctrace)):
        tracer = mod.tracer_for(tele)
        tracer.sample_rate = 1.0
        rep = make(tele)
        router = router_cls(telemetry=tele)
        router.register(rep)
        try:
            rows = router.submit(x[:3])
            spans = _settled([tracer], 4)
        finally:
            rep.stop()
            router.stop()
        trees = mod.stitch_spans(spans)
        assert len(trees) == 1
        root = trees[0]["root"]
        hop = root["children"][0]
        assert hop["ann"] == {"replica": "0"}
        execute = next(c for c in hop["children"] if c["name"] == "execute")
        out[name] = (_shape(root), execute["ann"], rows)
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][1] == {"replica": "0", "bucket": 8, "batch_rows": 3}
    np.testing.assert_allclose(out["port"][2], out["jax"][2], rtol=1e-5,
                               atol=1e-6)
