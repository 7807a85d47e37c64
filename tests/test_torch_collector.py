"""The port's fleet collector (``obs/collector.py``) against the JAX package's.

Rank exporters of each package carry the same data (counters, a
synthetic rank trace analysed by that package, heartbeats); each
package's collector scrapes each package's exporters, and the
collectors' ``/gang`` and ``/metrics`` must agree apart from time
fields. ``Router(collector=)`` weights replicas by the collector's merged
scrape as the JAX router does, and ``ElasticController(collector=)``
carries an elastic run through a SIGKILL, a shrink and a grow, every
transition in the collector's ``/gang`` (the bench's ``elastic_ctl``
gates at a cut depth).
"""

import tempfile

import pytest

import sparktorch_tpu.obs as jax_obs
import sparktorch_tpu_torch.obs as obs
from sparktorch_tpu.native import gang as jax_gang
from sparktorch_tpu_torch.native import gang

_TIME_KEYS = {"ts", "last_ts", "last_scrape_age_s", "last_seen_age_s",
              "age_s", "last_seen", "time", "wall"}


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in _TIME_KEYS and "age" not in k}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _jax_trace(rank, steps=2):
    events, t, scale = [], 1000.0, 1.0 + rank / 4.0
    for s in range(steps):
        wall = 1000.0 * scale
        events += [
            {"ph": "X", "pid": 1, "tid": 1, "name": "train_step", "ts": t,
             "dur": wall, "args": {"step_num": str(s)}},
            {"ph": "X", "pid": 1, "tid": 2, "name": f"fusion.{s}",
             "ts": t + 50, "dur": 600 * scale},
            {"ph": "X", "pid": 1, "tid": 3, "name": f"all-reduce.{s}",
             "ts": t + 400, "dur": 400 * scale}]
        t += wall
    return {"traceEvents": events}


@pytest.fixture(scope="module")
def exporters():
    """Three rank exporters of each package, the same data on each."""
    from sparktorch_tpu_torch.bench import _synthetic_rank_trace

    sets, dirs = {}, []
    for which, (o, g) in {"port": (obs, gang),
                          "jax": (jax_obs, jax_gang)}.items():
        d = tempfile.TemporaryDirectory()
        dirs.append(d)
        exps = []
        for r in range(3):
            tele = o.Telemetry(run_id="gang")
            tele.counter("bench.ticks", r + 1)
            tele.observe("serve.request_latency_s", 0.01 * (r + 1),
                         labels={"replica": str(r)})
            trace = (_synthetic_rank_trace(r) if which == "port"
                     else _jax_trace(r))
            o.analyze_trace(trace).publish(tele)
            o.HeartbeatEmitter(d.name, rank=r, telemetry=tele,
                               run_id="gang").notify_step(10 * (r + 1))
            exps.append(g.GangMetricsExporter(heartbeat_dir=d.name,
                                              telemetry=tele).start())
        sets[which] = exps
    yield sets
    for exps in sets.values():
        for e in exps:
            e.stop()
    for d in dirs:
        d.cleanup()


def _collect(o, exps):
    c = o.FleetCollector({r: e.url for r, e in enumerate(exps)},
                         run_id="collector", poll_interval_s=0)
    c.start(poll_loop=False)
    try:
        c.poll()
        gang_doc = o.scrape_json(c.url + "/gang")
        metrics = o.parse_prometheus(o.scrape_text(c.url + "/metrics"))
        health = c.health_view()
    finally:
        c.stop()
    return gang_doc, metrics, health


@pytest.mark.parametrize("exporter_pkg", ["port", "jax"])
def test_collectors_agree_over_each_packages_exporters(exporters,
                                                       exporter_pkg):
    exps = exporters[exporter_pkg]
    got_gang, got_metrics, got_health = _collect(obs, exps)
    want_gang, want_metrics, want_health = _collect(jax_obs, exps)
    assert _strip(got_gang) == _strip(want_gang)
    keep = [k for k in want_metrics if "age" not in k]
    assert {k: got_metrics.get(k) for k in keep} == \
        {k: want_metrics[k] for k in keep}
    assert set(got_metrics) == set(want_metrics)
    assert got_health is None and want_health is None
    xp = got_gang["xprof"]
    assert xp["n_ranks"] == 3 and xp["step_skew_s"] > 0
    assert got_gang["heartbeats"]["step_skew"] == 20
    assert got_metrics['sparktorch_bench_ticks{host="127.0.0.1",rank="1"}'] \
        == 2.0


def _rpc_spans():
    """A sharded pull's spans, as a rank's ring carries them: shard 1's
    hop bounds the request."""
    def span(sid, parent, name, ts, dur, shard=None, kind="client"):
        return {"trace_id": "a" * 32, "span_id": sid, "parent_id": parent,
                "name": name, "kind": kind, "ts": ts, "dur_s": dur,
                "status": "ok", "error": None, "forced": False,
                "ann": {} if shard is None else {"shard": shard}}

    return [span("r", None, "pull", 100.0, 0.2),
            span("a", "r", "shard_pull", 100.01, 0.02, "0"),
            span("b", "r", "shard_pull", 100.01, 0.18, "1"),
            span("c", "b", "serve", 100.02, 0.16, "1", "server")]


def test_rpc_spans_are_skipped_and_rpc_traces_raise(exporters):
    # Once skipped (the tracer was not ported): now each package's
    # collector stitches a rank's rpc_spans ring, over each package's
    # exporter, to the same trees and the same /gang view.
    got = {}
    for name, o, g in (("port", obs, gang), ("jax", jax_obs, jax_gang)):
        for exp_name, eo, eg in (("port", obs, gang),
                                 ("jax", jax_obs, jax_gang)):
            tele = eo.Telemetry(run_id="rpc")
            tele.set_section("rpc_spans", {"n": 4, "dropped": 0,
                                           "spans": _rpc_spans()})
            exp = eg.GangMetricsExporter(telemetry=tele).start()
            c = o.FleetCollector({0: exp.url}, poll_interval_s=0)
            try:
                c.poll()
                traces = c.rpc_traces()
                got[name, exp_name] = (traces, _strip(c.gang_view()["rpc"]),
                                       c.telemetry.get_section("rpc_traces"))
            finally:
                exp.stop()
                c.stop()
    want = got["jax", "jax"]
    assert all(v == want for v in got.values())
    traces = want[0]
    assert len(traces) == 1 and traces[0]["n_spans"] == 4
    assert traces[0]["critical"]["name"] == "serve"
    assert traces[0]["critical"]["shard"] == "1"
    assert want[1]["n_traces"] == 1


class _Handle:
    def __init__(self, rid):
        self.replica_id = rid


def test_router_weights_replicas_by_the_collector(exporters):
    from sparktorch_tpu.serve.router import Router as JaxRouter
    from sparktorch_tpu_torch.serve.router import Router

    chosen = {}
    for name, o, router_cls, exps in (
            ("port", obs, Router, exporters["port"]),
            ("jax", jax_obs, JaxRouter, exporters["jax"])):
        c = o.FleetCollector({r: e.url for r, e in enumerate(exps)},
                             poll_interval_s=0)
        c.poll()
        router = router_cls(collector=c)
        for rid in ("0", "1", "2"):
            router.register(_Handle(rid))
        p50 = [router._latency_p50(r, router._replicas[r])
               for r in ("0", "1", "2")]
        router._replicas["0"].outstanding = 3
        chosen[name] = (p50, router._choose(set()))
        c.stop()
    assert chosen["port"] == chosen["jax"]
    assert chosen["port"][1] == "1"


def test_elastic_controller_over_the_collector():
    from sparktorch_tpu_torch import bench

    rec = bench.bench_elastic_ctl(n_parts=9, part_sleep_s=0.1)
    assert rec["resizes"] == {"shrink": 1, "grow": 1}
    assert rec["removed"] == [1] and rec["chaos_kills"] == 1
    assert rec["generation"] == 2 and rec["world_size"] == 3
    assert set(rec) == bench.RECORD_KEYS["elastic_ctl"][0]
