"""The port's goodput ledger, flight recorder, stack profiler and collector helpers against the JAX package's.

The goodput ledgers of both packages run the same span schedule on an
injected clock (both modules' ``time`` and ``wall_ts`` replaced by one
scripted clock), so their bucket documents, gauges and run-level merges
must be equal, not close. The flight recorder and postmortem bundles,
the stack profiler's tries and merges, and the collector's scrape
helpers are held to the JAX modules on the same inputs too.
"""

import json
import os
import threading
import time

import pytest

from sparktorch_tpu.obs import blackbox as jax_blackbox
from sparktorch_tpu.obs import collector as jax_collector
from sparktorch_tpu.obs import goodput as jax_gp
from sparktorch_tpu.obs import profile as jax_profile
from sparktorch_tpu.obs import telemetry as jax_telemetry
from sparktorch_tpu_torch.obs import blackbox, collector
from sparktorch_tpu_torch.obs import goodput as gp
from sparktorch_tpu_torch.obs import profile, telemetry

PKGS = {"port": (gp, telemetry, blackbox, profile),
        "jax": (jax_gp, jax_telemetry, jax_blackbox, jax_profile)}


class _Clock:
    """A scripted clock standing in for ``time`` and ``wall_ts``."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def wall(self):
        return 1.7e9 + self.t

    def tick(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for g_mod, _, _, _ in PKGS.values():
        monkeypatch.setattr(g_mod, "time", c)
        monkeypatch.setattr(g_mod, "wall_ts", c.wall)
    return c


def _schedule(which, clock, **ledger_kw):
    g_mod, t_mod, _, _ = PKGS[which]
    clock.t = 1000.0
    tele = t_mod.Telemetry(run_id="gp")
    events = []
    tele.add_sink(events.append)
    led = g_mod.GoodputLedger(telemetry=tele, rank=3,
                              publish_interval_s=10.0, **ledger_kw)
    with led.span("compile"):
        clock.tick(0.25)
    for i in range(4):
        with led.step_span(step=i) as s:
            clock.tick(0.1)
            if i == 2:
                with led.span("checkpoint", {"site": "save"}):
                    clock.tick(0.05)
            s.count = 2
        with led.span("data_wait"):
            clock.tick(0.01 * (i + 1))
    led.add("restart_downtime", 0.3)
    clock.tick(0.4)
    led.note_compile(0.02, site="warm")
    led.set_comm_model(0.25, "estimate")
    mid = led.snapshot()
    led.apply_analysis({"exposed_comm_fraction": 0.5})
    led.set_comm_model(0.1, "estimate")  # never downgrades a measured split
    clock.tick(0.2)
    final = led.close()
    gauges = {k: v for k, v in tele.snapshot()["gauges"].items()
              if k.startswith(("goodput.", "skew."))}
    kinds = [e["kind"] for e in events if e["kind"].startswith("goodput")]
    return mid, final, gauges, kinds, tele.get_section("skew")


def test_ledger_documents_equal_on_an_injected_clock(clock):
    got = _schedule("port", clock, flops_per_step=1e12, peak_tflops=197.0)
    want = _schedule("jax", clock, flops_per_step=1e12, peak_tflops=197.0)
    for g, w in zip(got, want):
        assert g == w
    mid, final = got[0], got[1]
    assert mid["comm_source"] == "estimate"
    assert final["comm_source"] == "measured"
    assert final["n_steps"] == 8 and final["compiles"] == 2
    assert final["overattributed_s"] == 0.0
    assert abs(sum(final["buckets"].values()) - final["wall_s"]) < 1e-9
    assert final["buckets"]["checkpoint"] == pytest.approx(0.05)
    assert "goodput.ledger" in got[3]


def test_default_peak_is_the_cards(clock):
    """The port's MFU divides by the H100's dense bf16 peak, the JAX
    package's by its TPU's; with the same peak the formula agrees."""
    got = _schedule("port", clock, flops_per_step=1e12)[1]
    assert gp.H100_BF16_PEAK_TFLOPS == 989.0
    assert got["mfu"] == pytest.approx(
        round(gp.mfu_honest(got["achieved_tflops_per_chip"]), 6), abs=1e-6)
    for achieved in (0.0, 12.5, 197.0):
        assert gp.mfu_honest(achieved, 197.0) == jax_gp.mfu_honest(achieved)
    assert gp.achieved_tflops_per_chip(4e12, 2.0, 2) == \
        jax_gp.achieved_tflops_per_chip(4e12, 2.0, 2) == 1.0


def test_jit_cache_size_keeps_the_jax_signature():
    import torch

    def plain(x):
        return x

    for probe in (gp.jit_cache_size, jax_gp.jit_cache_size):
        assert probe(plain) is None
        assert probe(torch.nn.Linear(2, 2)) is None

    class Cached:
        def _cache_size(self):
            return 3

    assert gp.jit_cache_size(Cached()) == jax_gp.jit_cache_size(Cached()) == 3


def _same(got, want):
    """Equal documents, less the ``ts`` each merge stamps when called."""
    got, want = dict(got), dict(want)
    got.pop("ts"), want.pop("ts")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                        sort_keys=True)


def test_merge_sections_equal():
    a = {"rank": 0, "wall_s": 10.0, "n_steps": 10, "compiles": 1,
         "comm_source": "measured", "overattributed_s": 0.0,
         "flops_per_step": 1e12, "n_chips": 4, "peak_tflops": 100.0,
         "counts": {"compile": 1},
         "buckets": {"compute": 6.0, "exposed_comm": 1.0, "compile": 2.0,
                     "checkpoint": 0.0, "data_wait": 0.0,
                     "restart_downtime": 0.0, "resize_downtime": 0.0,
                     "idle": 1.0}}
    b = {"rank": 1, "wall_s": 10.0, "n_steps": 10, "compiles": 0,
         "comm_source": "estimate", "overattributed_s": 0.0, "counts": {},
         "buckets": {"compute": 2.0, "exposed_comm": 3.0, "compile": 0.0,
                     "checkpoint": 0.0, "data_wait": 0.0,
                     "restart_downtime": 4.0, "resize_downtime": 0.0,
                     "idle": 1.0}}
    for skew in (None, {"straggler_wait_s": 3.5, "wire_s": 0.5,
                        "laggard": {"rank": "1"}}):
        got = gp.merge_sections({0: a, 1: b, 2: {"rank": 2}}, skew=skew)
        want = jax_gp.merge_sections({0: a, 1: b, 2: {"rank": 2}},
                                     skew=skew)
        _same(got, want)
    assert got["biggest_thief"]["bucket"] == "straggler_wait"
    snaps = {0: {"sections": {"goodput": a}}, 1: None, 2: {"sections": {}}}
    assert gp.sections_from_snapshots(snaps) == \
        jax_gp.sections_from_snapshots(snaps)


def test_ambient_helpers_and_lanes():
    assert gp.active() is None
    with gp.span("compute") as sp:
        time.sleep(0.002)
    assert sp.duration_s >= 0.002  # an unbound span still times
    gp.add("compute", 1.0)  # no ledger: a no-op
    led = gp.GoodputLedger()
    prev = gp.install(led)
    try:
        gp.add("checkpoint", 0.001)
        assert gp.active() is led
        assert led.snapshot()["buckets"]["checkpoint"] > 0
    finally:
        gp.install(prev)
    with pytest.raises(ValueError):
        led.span("idle")  # derived, never attributed
    led.lanes = 3

    def lane():
        with led.step_span():
            time.sleep(0.02)

    threads = [threading.Thread(target=lane) for _ in range(3)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    doc = led.close()
    assert doc["lanes"] == 3 and doc["overattributed_s"] == 0.0


def test_restart_and_resize_downtime_reconcile(tmp_path):
    """The elastic controller's restart windows land in the ledger's
    ``restart_downtime`` as the same seconds as ``ft_recovery_latency_s``,
    and its shrink in ``resize_downtime``."""
    from sparktorch_tpu_torch.ctl import ElasticController
    from sparktorch_tpu_torch.ft import FtPolicy, RestartPolicy
    from sparktorch_tpu_torch.ft.supervisor import ThreadWorker

    out = str(tmp_path)
    work = [f"part{i}" for i in range(6)]

    def completed(p):
        return os.path.exists(os.path.join(out, p + ".done"))

    def start_fn(rank, attempt, generation, assignment):
        def run():
            for p in assignment:
                if rank == 1:
                    raise RuntimeError("boom")
                with open(os.path.join(out, p + ".done"), "w") as f:
                    f.write(str(rank))
                time.sleep(0.01)
        return ThreadWorker(f"rank{rank}", run)

    tele = telemetry.Telemetry(run_id="gp_elastic")
    ctl = ElasticController(work, completed, policy=FtPolicy(
        restart=RestartPolicy(max_restarts=2, backoff_base_s=0.02,
                              backoff_max_s=0.05, jitter=0.0)),
        telemetry=tele, min_world=1)
    for r in range(3):
        ctl.add_rank(r, start_fn)
    led = gp.GoodputLedger(telemetry=tele, rank="driver")
    with led.activate():
        summary = ctl.run(poll_interval_s=0.01, deadline_s=60)
    doc = tele.get_section(gp.SECTION)
    assert summary["resizes"]["shrink"] == 1
    recovery = sum(v["sum"] for k, v in tele.snapshot()["histograms"].items()
                   if k.startswith("ft_recovery_latency_s") and v["count"])
    assert recovery > 0
    assert doc["buckets"]["restart_downtime"] == pytest.approx(recovery,
                                                               rel=0.01)
    assert doc["buckets"]["resize_downtime"] > 0
    assert doc["counts"]["resize_downtime"] == 1
    assert doc["overattributed_s"] == 0.0


# ---------------------------------------------------------------------------
# Flight recorder and postmortems
# ---------------------------------------------------------------------------


def _recorded(which):
    _, t_mod, b_mod, _ = PKGS[which]
    tele = t_mod.Telemetry(run_id="bb")
    rec = b_mod.attach_recorder(tele, capacity=4)
    assert b_mod.attach_recorder(tele) is rec  # idempotent
    for i in range(6):
        tele.event("ctl.restart", rank=i)
    tele.event("serve.noise", x=1)  # filtered out
    with tele.span("work/chunk"):
        pass
    tele.counter("ft_restarts_total", labels={"worker": "w"})
    rec.publish()
    return tele, rec


def test_flight_recorder_ring_equal():
    (tele, rec), (jtele, jrec) = _recorded("port"), _recorded("jax")
    timed = ("ts", "dur_s")
    strip = [{k: v for k, v in e.items() if k not in timed}
             for e in rec.events()]
    jstrip = [{k: v for k, v in e.items() if k not in timed}
              for e in jrec.events()]
    assert strip == jstrip and strip[-1]["kind"] == "span"
    sec, jsec = tele.get_section("blackbox"), jtele.get_section("blackbox")
    assert sec.keys() == jsec.keys()
    assert [e["kind"] for e in blackbox.events_from_snapshot(
        tele.snapshot())] == [e["kind"] for e in
                              jax_blackbox.events_from_snapshot(
                                  jtele.snapshot())]


def test_postmortem_bundles_have_the_jax_keys(tmp_path):
    docs = {}
    for which, (g_mod, t_mod, b_mod, p_mod) in PKGS.items():
        tele = t_mod.Telemetry(run_id="pm")
        b_mod.attach_recorder(tele)
        led = g_mod.GoodputLedger(telemetry=tele, rank=0)
        with led.step_span(step=0):
            pass
        led.publish()
        prof = p_mod.StackProfiler(telemetry=tele, rank=0)
        prof.sample_once()
        prof.publish()
        tele.event("ctl.shrink", rank=1)
        tele.set_section("elastic", {"generation": 1})
        path = b_mod.collect_postmortem(str(tmp_path / which), "rank 1 died",
                                        telemetry=tele, window_s=60.0,
                                        rank=1)
        docs[which] = b_mod.read_postmortem(path)
    got, want = docs["port"], docs["jax"]
    assert got.keys() == want.keys()
    for key in ("goodput", "profile", "skew"):
        assert (got[key] is None) == (want[key] is None), key
        if got[key] is not None:
            assert got[key].keys() == want[key].keys(), key
    assert got["health"] is None and want["health"] is None
    assert [e["kind"] for e in got["events"]] == \
        [e["kind"] for e in want["events"]]
    assert got["reason"] == "rank 1 died" and got["rank"] == 1


# ---------------------------------------------------------------------------
# Stack profiler
# ---------------------------------------------------------------------------


def test_profile_tries_merge_and_diff_equal():
    trie = {"samples": 10, "self": 0, "children": {
        "f (a.py:1)": {"samples": 7, "self": 3, "children": {
            "g (a.py:9)": {"samples": 4, "self": 4, "children": {}}}},
        "h (b.py:2)": {"samples": 3, "self": 3, "children": {}}}}
    doc = {"rank": 0, "ticks": 5, "samples_total": 10,
           "buckets": {"compute": trie}}
    other = json.loads(json.dumps(doc))
    other["buckets"]["compute"]["children"]["h (b.py:2)"]["self"] = 9
    other["buckets"]["compute"]["children"]["h (b.py:2)"]["samples"] = 9
    _same(profile.merge_sections({0: doc, 1: other}),
          jax_profile.merge_sections({0: doc, 1: other}))
    assert profile.flatten_self(trie) == jax_profile.flatten_self(trie)
    assert profile.top_frames(doc, "compute", 2) == \
        jax_profile.top_frames(doc, "compute", 2)
    assert profile.diff_docs(other, doc) == jax_profile.diff_docs(other, doc)


def _hot_spin(release):
    while not release.is_set():
        sum(i * i for i in range(200))


def test_profiler_names_the_hot_function_in_its_bucket():
    release = threading.Event()

    def worker():
        with gp.span("data_wait"):
            _hot_spin(release)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    prof = profile.StackProfiler()
    try:
        for _ in range(40):
            prof.sample_once()
            time.sleep(0.001)
    finally:
        release.set()
        t.join(timeout=5.0)
    doc = prof.snapshot()
    assert doc["ticks"] == 40
    top_frame, _ = profile.top_frames(doc, "data_wait", n=1)[0]
    assert top_frame.startswith(("_hot_spin", "<genexpr>")), top_frame


@pytest.mark.parametrize("value,expect", [(None, True), ("0", False),
                                          ("1", True)])
def test_profile_env_gate_matches_jax(monkeypatch, value, expect):
    if value is None:
        monkeypatch.delenv(profile.ENV_GATE, raising=False)
    else:
        monkeypatch.setenv(profile.ENV_GATE, value)
    assert profile.ENV_GATE == jax_profile.ENV_GATE
    assert profile.enabled() == jax_profile.enabled() == expect
    tele = telemetry.Telemetry(run_id="ens")
    prev = profile.install(None)
    try:
        prof = profile.ensure(tele)
        assert (prof is not None) == expect
        if prof is not None:
            assert profile.ensure(tele) is prof  # one sampler a process
            assert profile.active() is prof
    finally:
        active = profile.install(prev)
        if active is not None and active is not prev:
            active.stop()


# ---------------------------------------------------------------------------
# The collector's helpers
# ---------------------------------------------------------------------------


def test_collector_helpers_match_jax():
    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.net import transport

    for run_id in (None, "", "gang-1", "x" * 40):
        assert collector.run_tag(run_id) == jax_collector.run_tag(run_id)
    assert transport.run_tag is collector.run_tag
    rid = collector.mint_run_id("bench")
    assert rid.startswith("bench-") and " " not in rid
    snap = {"histograms": {
        "lat_s{replica=2,rank=0}": {"count": 3, "p99": 0.1},
        "lat_s{replica=2,rank=1}": {"count": 9, "p99": 0.2},
        "lat_s{replica=3}": {"count": 50, "p99": 0.9}}}
    for labels in ({"replica": 2}, {"replica": "3"}, {"replica": 7}, None):
        assert collector.snapshot_histogram(snap, "lat_s", labels) == \
            jax_collector.snapshot_histogram(snap, "lat_s", labels)
    tele = telemetry.Telemetry(run_id="scrape")
    tele.counter("c")
    with GangMetricsExporter(telemetry=tele) as exporter:
        for mod in (collector, jax_collector):
            assert mod.scrape_json(exporter.url + "/telemetry")[
                "counters"]["c"] == 1
            assert "sparktorch_c" in mod.scrape_text(exporter.url
                                                     + "/metrics")
            with pytest.raises(mod.ScrapeError, match="404"):
                mod.scrape_text(exporter.url + "/nope")
            with pytest.raises(mod.ScrapeError, match="404"):
                mod.post_json(exporter.url + "/ctl", {"verb": "x"})
        url = exporter.url
    with pytest.raises(collector.ScrapeError):
        collector.scrape_json(url + "/telemetry", timeout=0.5)
