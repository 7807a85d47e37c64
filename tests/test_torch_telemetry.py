"""The port's telemetry bus, sinks and heartbeats against the JAX package's.

The same calls go to a JAX ``Telemetry`` and a port one: the snapshots
must be equal (timestamps and the span durations, which are each bus's
own clock, left out), p50/p95/p99 roll-ups included, exactly. The JSONL
sinks must write the same lines, and each package's ``gang_report`` must
read the other's heartbeat files.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from sparktorch_tpu import obs as jax_obs
from sparktorch_tpu.ft import ChaosConfig as JaxChaosConfig
from sparktorch_tpu.ft import inject as jax_inject
from sparktorch_tpu_torch import obs
from sparktorch_tpu_torch.ft import ChaosConfig, inject
from sparktorch_tpu_torch.obs import telemetry as port_telemetry


def _drive(tele, seed=0):
    """One scripted run of every recording call, from a seeded stream."""
    rng = np.random.default_rng(seed)
    tele.counter("serve.requests_total", labels={"replica": "0"})
    tele.counter("serve.rows_total", 3.0, labels={"replica": "0"})
    tele.counter("serve.rejected_total",
                 labels={"replica": "1", "reason": "backpressure"})
    tele.counter("router.requests_total", 2.5)
    tele.gauge("serve.params_version", 7, labels={"replica": "0"})
    tele.gauge("router.live_replicas", 2)
    tele.info("trace_url", "http://x/y", labels={"rank": 0})
    tele.set_section("budget", {"a": [1, 2], "b": {"c": 0.5}})
    tele.set_section("gone", {"x": 1})
    tele.set_section("gone", None)
    for v in rng.exponential(0.01, 700):
        tele.observe("serve.request_latency_s", float(v),
                     labels={"replica": "0"})
    for v in rng.uniform(0, 1, 33):
        tele.observe("serve.batch_fill", float(v), labels={"replica": "1"})
    tele.observe("single", 4.25)
    with tele.span("bench", labels={"leg": "a"}):
        with tele.span("measure"):
            pass
    with tele.span("bench", labels={"leg": "a"}):
        pass
    return tele


def _comparable(snap):
    snap = dict(snap)
    snap.pop("ts")
    snap.pop("run_id")
    # Durations are each bus's own clock: keep the keys and counts.
    snap["spans"] = {k: v["count"] for k, v in snap["spans"].items()}
    return snap


@pytest.mark.parametrize("ring_size", [4096, 64])
def test_same_calls_give_equal_snapshots(ring_size):
    want = _drive(jax_obs.Telemetry(run_id="j", ring_size=ring_size))
    got = _drive(obs.Telemetry(run_id="p", ring_size=ring_size))
    a, b = _comparable(got.snapshot()), _comparable(want.snapshot())
    assert a == b
    assert set(a) == {"counters", "gauges", "info", "histograms", "spans",
                      "sections"}
    assert a["spans"] == {"bench{leg=a}": 2, "bench/measure": 1}
    # The roll-up arithmetic, read back one series at a time, exactly.
    for key, labels in (("serve.request_latency_s", {"replica": "0"}),
                        ("serve.batch_fill", {"replica": "1"}),
                        ("single", None), ("missing", None)):
        assert got.histogram(key, labels) == want.histogram(key, labels)
    assert got.counter_value("serve.rows_total", {"replica": "0"}) == 3.0
    assert got.gauge_value("router.live_replicas") == 2.0
    assert got.info_value("trace_url", {"rank": 0}) == "http://x/y"
    assert got.get_section("budget") == want.get_section("budget")


def test_format_key_and_rollup_from_state_match():
    keys = [("a", ()), ("serve.x", (("replica", "0"),)),
            ("r", (("host", "h"), ("rank", "1")))]
    for key in keys:
        assert port_telemetry.format_key(key) == jax_obs.format_key(key)
    for state in [(0, 0.0, 0.0, 0.0, ()), (1, 2.0, 2.0, 2.0, (2.0,)),
                  (5, 15.0, 1.0, 5.0, (1.0, 2.0, 3.0, 4.0, 5.0))]:
        from sparktorch_tpu.obs.telemetry import rollup_from_state

        assert port_telemetry.rollup_from_state(state) == \
            rollup_from_state(state)


def test_counter_refuses_a_negative_increment_and_reset_clears():
    tele = _drive(obs.Telemetry())
    with pytest.raises(ValueError, match="negative"):
        tele.counter("x", -1.0)
    tele.reset()
    snap = tele.snapshot()
    assert snap["counters"] == snap["gauges"] == snap["histograms"] == {}
    assert "sections" not in snap


def test_jsonl_sink_lines_match(tmp_path):
    lines = {}
    for name, pkg in (("jax", jax_obs), ("port", obs)):
        tele = pkg.Telemetry(run_id="run")
        path = str(tmp_path / name / "events.jsonl")  # parent made on demand
        sink = tele.add_jsonl_sink(path)
        tele.event("weights", version=3, replica="1")
        tele.event("note", text="a,b")
        with tele.span("outer", labels={"k": "v"}):
            pass
        sink.close()
        tele.event("after_close")  # detached: not written
        dump = str(tmp_path / name / "dump.jsonl")
        _drive(tele)
        tele.dump(dump)
        tele.dump(dump)  # appends
        recs = pkg.read_jsonl(path)
        for rec in recs:
            rec.pop("ts")
            rec.pop("dur_s", None)
        dumped = [_comparable({k: v for k, v in r.items() if k != "kind"})
                  for r in pkg.read_jsonl(dump)]
        lines[name] = (recs, dumped)
    assert lines["port"] == lines["jax"]
    assert [r["kind"] for r in lines["port"][0]] == ["weights", "note", "span"]
    assert len(lines["port"][1]) == 2


def test_read_jsonl_skips_torn_lines(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    obs.write_jsonl(path, [{"a": 1}, {"b": 2}])
    with open(path, "a") as f:
        f.write('{"c": ')
    assert obs.read_jsonl(path) == jax_obs.read_jsonl(path) == [
        {"a": 1}, {"b": 2}]


def test_pickled_bus_keeps_its_numbers_and_starts_a_new_scope():
    tele = _drive(obs.Telemetry(run_id="p"))
    tele.add_sink(lambda e: None)
    clone = pickle.loads(pickle.dumps(tele))
    assert _comparable(clone.snapshot()) == _comparable(tele.snapshot())
    assert clone._sinks == []
    clone.counter("after")  # its own lock works


def test_global_bus_and_span_sync():
    before = obs.get_telemetry()
    try:
        mine = obs.Telemetry(run_id="mine")
        obs.set_telemetry(mine)
        assert obs.get_telemetry() is mine
        obs.set_telemetry(None)
        assert obs.get_telemetry().run_id == "global"
    finally:
        obs.set_telemetry(before)
    tele = obs.Telemetry()
    with tele.span("s") as span:
        span.sync(torch.ones(2), np.ones(2), "host value")  # CPU: no-op
    assert span.synced and span.duration_s >= 0.0
    assert obs.wall_ts() > 1.6e9


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_gang_report_reads_the_others_heartbeats(tmp_path, writer):
    w = jax_obs if writer == "jax" else obs
    tele = w.Telemetry()
    d = str(tmp_path)
    a = w.HeartbeatEmitter(d, rank=0, host="h0", telemetry=tele,
                           run_id="gang-1")
    b = w.HeartbeatEmitter(d, rank=3, host="h1")
    a.notify_step(5)
    b.notify_step(12)
    b.close()  # alive=False on a clean stop
    with open(f"{d}/gang_hb_rank9.json", "w") as f:
        f.write("{torn")  # skipped, never fatal
    now = 2e9
    want = jax_obs.gang_report(d, now=now)
    got = obs.gang_report(d, now=now)
    assert got == want
    assert got["alive"] == [0] and got["step_skew"] == 7
    assert got["ranks"][0]["run_id"] == "gang-1"
    assert obs.read_heartbeats(d) == jax_obs.read_heartbeats(d)
    assert tele.counter_value("gang.heartbeats",
                              {"rank": 0, "host": "h0"}) == 1
    assert tele.gauge_value("gang.step", {"rank": 0, "host": "h0"}) == 5


def test_heartbeat_freeze_under_chaos_matches_jax(tmp_path):
    results = {}
    for name, pkg, cfg, injector in (
            ("jax", jax_obs, JaxChaosConfig, jax_inject),
            ("port", obs, ChaosConfig, inject)):
        d = str(tmp_path / name)
        hb = pkg.HeartbeatEmitter(d, rank=1, host="h")
        with injector(cfg(freeze_heartbeat_at={1: 3})) as inj:
            hb.notify_step(2)
            frozen = hb.beat()
            hb.notify_step(3)
            frozen = hb.beat()
        beats = pkg.read_heartbeats(d)
        results[name] = (frozen, [(r["step"], r["beats"]) for r in beats],
                         inj.events)
    assert results["port"] == results["jax"]
    assert results["port"][0] == {"rank": 1, "frozen": True}
    assert results["port"][1] == [(2, 2)]  # the beats of step 3 never landed


def test_obs_exports_the_core_only():
    # The core, the ported modules the supervisor and ctl/ import, the
    # health lane, replay, trace analyzer, fleet collector and the
    # request tracer: everything the JAX package's obs exports.
    assert set(obs.__all__) == {
        "Span", "Telemetry", "format_key", "get_telemetry", "set_telemetry",
        "wall_ts", "JsonlSink", "read_jsonl", "write_jsonl",
        "HEARTBEAT_DIR_ENV", "HeartbeatEmitter", "gang_report",
        "read_heartbeats", "get_logger", "PROMETHEUS_CONTENT_TYPE",
        "parse_prometheus", "render_prometheus", "MetricsHistory",
        "AlertManager", "AlertRule", "FlightRecorder", "attach_recorder",
        "collect_postmortem", "read_postmortem", "GoodputLedger",
        "LedgerSpan", "mfu_honest", "ScrapeError", "mint_run_id", "run_tag",
        "scrape_json", "scrape_text", "snapshot_histogram", "HealthConfig",
        "TrainHealthLedger", "health_alert_rules", "tree_checksum",
        "load_bundle", "replay_bundle", "GangAnalysis", "TraceAnalysis",
        "TraceParseError", "analyze_and_publish", "analyze_trace",
        "merge_analyses", "FleetCollector", "RpcTracer", "SpanContext",
        "critical_path", "critical_summary", "stitch_spans", "tracer_for",
        "write_chrome_trace"}
    assert set(obs.__all__) == set(jax_obs.__all__)
    assert obs.HEARTBEAT_DIR_ENV == jax_obs.HEARTBEAT_DIR_ENV
    assert json.loads(json.dumps(obs.Telemetry().snapshot()))["counters"] == {}
