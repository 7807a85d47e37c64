"""The port's history, alerts and skew modules against the JAX package's.

The same scripted and seeded series go through both packages'
``MetricsHistory`` (rates, windowed percentiles, deltas, spill and
rebuild), ``AlertManager`` (threshold, sustained and burn-rate rules:
the same firings at the same sweeps) and ``obs.skew`` (the stamp ring,
the run-level merge and its laggard verdict, the alert rules).
"""

import json

import numpy as np
import pytest

from sparktorch_tpu.obs import alerts as jax_alerts
from sparktorch_tpu.obs import goodput as jax_goodput
from sparktorch_tpu.obs import history as jax_history
from sparktorch_tpu.obs import skew as jax_skew
from sparktorch_tpu.obs import telemetry as jax_telemetry
from sparktorch_tpu_torch.obs import alerts, goodput, history, skew, telemetry

PKGS = {
    "port": (history, alerts, skew, goodput, telemetry),
    "jax": (jax_history, jax_alerts, jax_skew, jax_goodput, jax_telemetry),
}


def _digest(p99, count=1, p50=None):
    return {"count": count, "sum": 0.0, "mean": 0.0, "min": 0.0,
            "max": p99, "p50": p50 if p50 is not None else p99,
            "p95": p99, "p99": p99}


def _sweep(ts, counters=None, gauges=None, hists=None):
    return {"ts": ts, "counters": counters or {}, "gauges": gauges or {},
            "histograms": hists or {}}


# ---------------------------------------------------------------------------
# MetricsHistory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["port", "jax"])
def test_history_golden_queries(which, tmp_path):
    h_mod = PKGS[which][0]
    h = h_mod.MetricsHistory(retention=16)
    for ts, v in [(100, 0), (101, 4), (102, 10), (103, 10), (104, 18)]:
        h.append(_sweep(float(ts), counters={"req_total{rank=0}": float(v)}))
    assert h.rate("req_total") == pytest.approx(18 / 4)
    assert h.rate("req_total", window_s=2.0) == pytest.approx(8 / 2)
    assert h.delta_since("req_total", 101.0) == pytest.approx(14.0)
    # A reset (10, 14, 2, 5) counts 4 + 2 + 3.
    r = h_mod.MetricsHistory()
    for ts, v in [(0, 10), (1, 14), (2, 2), (3, 5)]:
        r.append(_sweep(float(ts), counters={"c": float(v)}))
    assert r.rate("c") == pytest.approx(3.0)
    # Percentile of per-sweep p99s, windowed from the newest point.
    for i, p in enumerate([0.010, 0.020, 0.030, 0.040, 0.050]):
        h.append(_sweep(float(i), hists={"lat_s{shard=2}": _digest(p)}))
    assert h.percentile_over("lat_s", 0, {"shard": "2"},
                             window_s=2.0) == pytest.approx(0.030)
    assert h.percentile_over("lat_s", 50, {"shard": "2"}) == \
        pytest.approx(0.030)
    assert h.percentile_over("lat_s", 99, {"shard": "2"},
                             field="p999") is None
    # Retention and label-subset matching.
    b = h_mod.MetricsHistory(retention=4)
    for i in range(10):
        b.append(_sweep(float(i), counters={"c{host=a,rank=3}": float(i)}))
    assert [p[0] for p in b.series("c")] == [6.0, 7.0, 8.0, 9.0]
    assert b.latest("c", {"rank": "3"}) == 9.0
    assert b.latest("c", {"rank": "4"}) is None
    # Spill and rebuild.
    spill = str(tmp_path / f"{which}.jsonl")
    s = h_mod.MetricsHistory(retention=8, spill_jsonl=spill)
    for i in range(5):
        s.append(_sweep(float(i), counters={"c": float(i * 2)},
                        hists={"lat_s": _digest(0.01 * (i + 1))}))
    rebuilt = h_mod.MetricsHistory.from_jsonl(spill)
    assert rebuilt.rate("c") == s.rate("c") == pytest.approx(2.0)
    assert rebuilt.percentile_over("lat_s", 100) == pytest.approx(0.05)
    assert s.query("series", "c")["points"][:2] == [[0.0, 0.0], [1.0, 2.0]]
    with pytest.raises(ValueError):
        s.query("nope", "c")


def _random_sweeps(seed, n=40):
    rng = np.random.default_rng(seed)
    total = bad = 0.0
    sweeps = []
    for i in range(n):
        total += float(rng.integers(20, 60))
        bad += float(rng.integers(0, 3))
        if i == n // 2:
            total, bad = 5.0, 0.0  # a process restart resets counters
        p99 = float(rng.uniform(0.01, 0.2))
        sweeps.append(_sweep(
            1000.0 + i * float(rng.uniform(0.5, 1.5)),
            counters={"req_total{rank=0}": total, "bad_total": bad},
            gauges={"lag{shard=1}": float(rng.normal(3.0, 2.0))},
            hists={"lat_s{shard=2,host=h}": _digest(
                p99, count=int(rng.integers(1, 9)),
                p50=p99 * float(rng.uniform(0.2, 0.9)))}))
    return sweeps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_history_queries_equal_on_seeded_series(seed):
    got, want = history.MetricsHistory(retention=24), \
        jax_history.MetricsHistory(retention=24)
    for sw in _random_sweeps(seed):
        got.append(sw)
        want.append(sw)
    queries = [("rate", dict(name="req_total")),
               ("rate", dict(name="bad_total", window_s=6.0)),
               ("latest", dict(name="lag", labels={"shard": "1"})),
               ("delta", dict(name="req_total", since_ts=1010.0)),
               ("series", dict(name="lag"))]
    for q in (0, 50, 90, 99, 100):
        queries.append(("pctile", dict(name="lat_s", q=q,
                                       labels={"shard": "2"})))
        queries.append(("pctile", dict(name="lat_s", q=q, field="p50",
                                       window_s=8.0)))
    for op, kw in queries:
        assert got.query(op, **kw) == want.query(op, **kw), (op, kw)
    assert got.series_names() == want.series_names()


# ---------------------------------------------------------------------------
# Alerts
# ---------------------------------------------------------------------------


def _rules(a_mod):
    return [
        a_mod.AlertRule(name="hot_lag", metric="lag", threshold=4.0,
                        labels={"shard": "1"}),
        a_mod.AlertRule(name="slow_p99", metric="lat_s", kind="sustained",
                        threshold=0.12, for_sweeps=2, field="p99"),
        a_mod.AlertRule(name="burn", metric="bad_total", kind="burn_rate",
                        total_metric="req_total", slo=0.02,
                        burn_factor=1.5, window_s=5.0),
    ]


def _alert_run(which, seed):
    h_mod, a_mod, _, _, t_mod = PKGS[which]
    h = h_mod.MetricsHistory(retention=32)
    tele = t_mod.Telemetry(run_id="alerts")
    am = a_mod.AlertManager(h, _rules(a_mod), telemetry=tele)
    seen = []
    am.subscribe(lambda e: seen.append((e["alert"], e["event"],
                                        e["episode"])))
    out = []
    for sw in _random_sweeps(seed):
        h.append(sw)
        out.append([(e["alert"], e["event"], e["episode"],
                     e.get("value")) for e in am.evaluate(ts=sw["ts"])])
    counters = {k: v for k, v in tele.snapshot()["counters"].items()
                if k.startswith("alerts.")}
    return out, seen, counters, am.doc()["rules"], am.active()


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_alert_firings_equal_on_seeded_series(seed):
    got, want = _alert_run("port", seed), _alert_run("jax", seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[4] == want[4]
    for name in got[3]:
        for key in ("state", "episodes", "value", "kind"):
            assert got[3][name].get(key) == want[3][name].get(key), \
                (name, key)
    assert any(ev for ev in got[0])  # the schedule does fire


@pytest.mark.parametrize("which", ["port", "jax"])
def test_alert_forms_and_refusals(which):
    h_mod, a_mod, _, _, t_mod = PKGS[which]
    h = h_mod.MetricsHistory()
    tele = t_mod.Telemetry(run_id="t")
    am = a_mod.AlertManager(h, [a_mod.AlertRule(name="g", metric="v",
                                                threshold=5.0)],
                            telemetry=tele)
    transitions = []
    am.subscribe(lambda e: transitions.append((e["event"], e["episode"])))
    for i, v in enumerate([3.0, 7.0, 8.0, 2.0, 9.0]):
        h.append(_sweep(float(i), gauges={"v": v}))
        am.evaluate(ts=float(i))
    assert transitions == [("fired", 1), ("resolved", 1), ("fired", 2)]
    assert tele.counter_value("alerts.fired_total",
                              labels={"rule": "g"}) == 2
    with pytest.raises(ValueError):
        a_mod.AlertRule(name="x", metric="m", kind="burn_rate", slo=0.0,
                        total_metric="t")
    with pytest.raises(ValueError):
        a_mod.AlertRule(name="x", metric="m", kind="nope")


# ---------------------------------------------------------------------------
# Skew
# ---------------------------------------------------------------------------


def _section(stamps, dropped=0):
    return {"n_stamps": len(stamps), "capacity": 512, "dropped": dropped,
            "stamps": [list(s) for s in stamps]}


def _seeded_sections(seed, ranks=4, steps=12):
    """Per-rank stamp rings with a persistent laggard (rank 2), jitter,
    a torn entry and a rank that missed some steps."""
    rng = np.random.default_rng(seed)
    docs = {}
    for r in range(ranks):
        stamps = []
        for i in range(steps):
            if r == 3 and i % 5 == 0:
                continue
            enter = 100.0 + i + float(rng.uniform(0, 0.02)) \
                + (0.3 if r == 2 else 0.0)
            stamps.append((i, 1, enter, 100.0 + i + 0.35
                           + float(rng.uniform(0, 0.01))))
        docs[str(r)] = _section(stamps)
    docs["1"]["stamps"].append(["torn"])
    return docs


@pytest.mark.parametrize("seed", [0, 5])
def test_skew_merge_equal_on_seeded_rings(seed):
    docs = _seeded_sections(seed)
    gdocs = {str(r): {"buckets": {"exposed_comm": 1.0 + r},
                      "fractions": {"data_wait": 0.3 if r == 2 else 0.01},
                      "compiles": 0} for r in range(4)}
    for kw in ({}, {"goodput_docs": gdocs}):
        got = skew.merge_sections(json.loads(json.dumps(docs)), **kw)
        want = jax_skew.merge_sections(json.loads(json.dumps(docs)), **kw)
        assert got == want
    assert got["laggard"]["rank"] == "2" and got["laggard"]["persistent"]
    assert got["laggard"]["cause"] == "data_wait"
    tele, jtele = telemetry.Telemetry(run_id="s"), \
        jax_telemetry.Telemetry(run_id="s")
    skew.publish_run_gauges(tele, got)
    jax_skew.publish_run_gauges(jtele, want)
    assert tele.snapshot()["gauges"] == jtele.snapshot()["gauges"]


def test_skew_ring_and_ledger_stamps_equal():
    rings = [skew.StepSkewRing(capacity=4), jax_skew.StepSkewRing(capacity=4)]
    for ring in rings:
        for i in range(6):
            ring.record(i, 1, float(i), float(i) + 0.5)
    assert rings[0].snapshot() == rings[1].snapshot()
    assert rings[0].snapshot()["dropped"] == 2
    # The ledger stamps its ring from each step span and publishes the
    # section only after the first stamp.
    for g_mod, t_mod in ((goodput, telemetry), (jax_goodput, jax_telemetry)):
        tele = t_mod.Telemetry(run_id="stamp")
        led = g_mod.GoodputLedger(telemetry=tele, rank=3)
        with led.span("compute"):
            pass
        led.publish()
        assert tele.get_section("skew") is None
        with led.step_span(step=7):
            pass
        with led.step_span():
            pass
        led.publish()
        sec = tele.get_section("skew")
        assert [s[0] for s in sec["stamps"]] == [7, 1]
        assert sec["rank"] == 3


def test_skew_alert_rules_equal_and_reach_the_controller():
    from sparktorch_tpu_torch.ctl.elastic import ElasticController

    got = [r.__dict__ for r in skew.skew_alert_rules()]
    want = [r.__dict__ for r in jax_skew.skew_alert_rules()]
    assert got == want
    tele = telemetry.Telemetry(run_id="skew-alerts")
    hist = history.MetricsHistory(retention=8)
    mgr = alerts.AlertManager(hist, rules=skew.skew_alert_rules(),
                              telemetry=tele)
    ctl = ElasticController([], lambda w: True, telemetry=tele, alerts=mgr)
    try:
        fired = []
        for k in range(5):
            tele.gauge("skew.straggler_fraction", 0.9)
            hist.append(tele.snapshot(), ts=1000.0 + k)
            fired += [e for e in mgr.evaluate(ts=1000.0 + k)
                      if e["event"] == "fired"]
        assert [e["alert"] for e in fired] == ["skew_straggler_sustained"]
        assert [s["rule"] for s in ctl.scale_signals] == [
            "skew_straggler_sustained"]
    finally:
        ctl.detach_alerts()
