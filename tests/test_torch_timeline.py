"""The port's terminal renderer (``obs/timeline.py``) against the JAX package's.

Each package builds a small world with its own obs modules: two ranks'
buses carrying goodput ledgers with step stamps, a health ledger fed a
NaN step, stack profiles, a published trace analysis and an
``rpc_spans`` ring, behind rank exporters, a fleet collector with a
JSONL sink, the collector's ``/gang``, ``/goodput``, ``/health``,
``/skew`` and ``/profile`` documents saved to files, a postmortem and a
telemetry dump. Every renderer and every CLI mode of both packages
then reads the same files and documents, and the output must be equal
string for string. The JAX golden trace captures render alike too: the
JAX CLI on a capture, the port's on its ``torch.profiler``-shaped
translation (``tests/test_torch_xprof.py``'s).
"""

import contextlib
import gzip
import importlib.util
import io
import json
import os
import threading
import time

import pytest

import sparktorch_tpu.obs as jax_obs
import sparktorch_tpu_torch.obs as obs
from sparktorch_tpu.native import gang as jax_gang
from sparktorch_tpu.obs import goodput as jax_goodput
from sparktorch_tpu.obs import health as jax_health
from sparktorch_tpu.obs import profile as jax_profile
from sparktorch_tpu.obs import timeline as jax_timeline
from sparktorch_tpu_torch.native import gang
from sparktorch_tpu_torch.obs import goodput, health, profile, timeline

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "xprof")


def _xprof_helpers():
    spec = importlib.util.spec_from_file_location(
        "_torch_xprof_helpers", os.path.join(HERE, "test_torch_xprof.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(name):
    with gzip.open(os.path.join(FIXTURES, name + ".trace.json.gz"),
                   "rt") as f:
        return json.load(f)


def _spans():
    def span(sid, parent, name, ts, dur, kind="client", **ann):
        return {"trace_id": "c" * 32, "span_id": sid, "parent_id": parent,
                "name": name, "kind": kind, "ts": ts, "dur_s": dur,
                "status": "ok", "error": None, "forced": False, "ann": ann}

    return [span("r", None, "pull", 100.0, 0.2, shards=2),
            span("a", "r", "shard_pull", 100.01, 0.02, shard="0"),
            span("b", "r", "shard_pull", 100.01, 0.18, shard="1"),
            span("c", "b", "serve", 100.02, 0.16, "server", shard="1",
                 route="/delta.bin"),
            span("d", "c", "render", 100.03, 0.1, "server"),
            span("x", "gone", "apply", 100.05, 0.01, "server")]


PKGS = {
    "port": dict(obs=obs, gang=gang, goodput=goodput, health=health,
                 profile=profile),
    "jax": dict(obs=jax_obs, gang=jax_gang, goodput=jax_goodput,
                health=jax_health, profile=jax_profile),
}


def _hot(stop):
    x = 0
    while not stop.is_set():
        x += 1
    return x


def _build_world(which, root):
    """The files and documents of ``which`` package's world under
    ``root``."""
    m = PKGS[which]
    o, g, h, p = m["obs"], m["goodput"], m["health"], m["profile"]
    os.makedirs(root, exist_ok=True)
    buses, exporters = [], []
    xh = _xprof_helpers()
    traces = ("synthetic_overlap", "cpu_allreduce")
    for rank in range(2):
        tele = o.Telemetry(run_id="world")
        led = g.GoodputLedger(tele, rank=rank, publish_interval_s=0.0)
        prof = p.StackProfiler(telemetry=tele, rank=rank, hz=100.0)
        stop = threading.Event()
        with led.activate():
            for step in range(4):
                with led.step_span(step=step):
                    with led.span("compute"):
                        time.sleep(0.002 * (rank + 1) + 0.001 * step)
                    with led.span("exposed_comm", {"site": "wire"}):
                        time.sleep(0.001)
            hot = threading.Thread(target=lambda: _in_span(led, stop))
            hot.start()
            time.sleep(0.01)
            for _ in range(12):
                prof.sample_once()
            stop.set()
            hot.join()
        prof.publish()
        led.close()
        data = _load(traces[rank])
        if which == "port":
            data = xh.to_torch_shape(data)[0]
        o.analyze_trace(data).publish(tele)
        if rank == 0:
            tele.set_section("rpc_spans", {"n": 6, "dropped": 0,
                                           "spans": _spans()})
            hl = h.TrainHealthLedger(
                rank="0", telemetry=tele,
                config=h.HealthConfig(publish_interval_s=0.0, warmup_steps=2),
                leaf_keys=["a.weight", "a.bias"])
            for i in range(12):
                loss = float("nan") if i == 8 else 2.0 - 0.05 * i
                hl.note_step(host={"loss": loss, "grad_norm": 1.0 + 0.1 * i},
                             device={"finite": 0.0 if i == 8 else 1.0,
                                     "update_ratio": 1e-3,
                                     "leaf_norms": [0.5 + i, 0.25]})
            hl.flush()
        buses.append(tele)
        exporters.append(m["gang"].GangMetricsExporter(
            telemetry=tele).start())
    files = {"sink": os.path.join(root, "sink.jsonl"),
             "dump": os.path.join(root, "dump.jsonl"),
             "empty": os.path.join(root, "empty.jsonl")}
    o.Telemetry(run_id="none").dump(files["empty"])
    buses[0].dump(files["dump"])
    collector = o.FleetCollector({r: e.url for r, e in enumerate(exporters)},
                                 poll_interval_s=0, jsonl_path=files["sink"],
                                 run_id="world")
    collector.start(poll_loop=False)
    try:
        collector.poll()
        collector.poll()
        for route in ("gang", "goodput", "health", "skew", "profile"):
            files[route] = os.path.join(root, route + ".json")
            with open(files[route], "w") as f:
                json.dump(o.scrape_json(f"{collector.url}/{route}"), f)
        files["postmortem"] = o.collect_postmortem(
            root, "drill", telemetry=buses[0], collector=collector, rank=0)
    finally:
        collector.stop()
        for e in exporters:
            e.stop()
    files["tune"] = os.path.join(root, "tune.json")
    with open(files["tune"], "w") as f:
        json.dump(_TUNE, f)
    return files


def _in_span(led, stop):
    with led.span("compute"):
        _hot(stop)


_TUNE = {
    "kind": "tune", "n_devices": 8, "global_batch": 256, "run_id": "t1",
    "best_label": "dp4xtp2", "early_stopped": True, "noise_floor_s": 0.0004,
    "wall_s": 12.5,
    "candidates": [
        {"label": "dp8", "status": "measured", "score": 0.012,
         "measured": {"step_wall_s": 0.011, "exposed_comm_fraction": 0.2,
                      "overlap_fraction": 0.5}},
        {"label": "dp4xtp2", "status": "measured", "score": 0.009,
         "measured": {"step_wall_s": 0.008, "exposed_comm_fraction": 0.1,
                      "overlap_fraction": 0.7}},
        {"label": "tp8", "status": "pruned", "reason": "comm-bound",
         "predicted": {"total_cost": 4.5e8}},
        {"label": "fsdp8", "status": "failed", "reason": "oom",
         "predicted": {"total_bytes": 1.25e9}},
    ],
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {which: _build_world(which, str(tmp_path_factory.mktemp(which)))
            for which in PKGS}


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue()


MODES = [
    ["{dump}"], ["{dump}", "--json"], ["{sink}"],
    ["--gang", "{sink}"], ["--gang", "{gang}"], ["--gang", "{sink}", "--json"],
    ["--rpc", "{dump}"], ["--rpc", "{sink}"], ["--rpc", "{sink}", "--json"],
    ["--rpc", "{dump}", "--top", "1"], ["--rpc", "{empty}"],
    ["--goodput", "{sink}"], ["--goodput", "{goodput}"],
    ["--goodput", "{dump}"], ["--goodput", "{goodput}", "--json"],
    ["--health", "{sink}"], ["--health", "{health}"], ["--health", "{dump}"],
    ["--health", "{health}", "--top", "2"],
    ["--skew", "{sink}"], ["--skew", "{skew}"], ["--skew", "{dump}"],
    ["--skew", "{skew}", "--json"],
    ["--profile", "{sink}"], ["--profile", "{profile}"],
    ["--profile", "{profile}", "--top", "3"],
    ["--profile", "{profile}", "--diff", "{other_profile}"],
    ["--profile", "{dump}", "--diff", "{other_profile}"],
    ["--postmortem", "{postmortem}"], ["--postmortem", "{postmortem}",
                                       "--top", "5"],
    ["--postmortem", "{postmortem}", "--json"],
    ["--tune", "{tune}"], ["--tune", "{tune}", "--json"], ["--tune", "{gang}"],
    ["--rpc", "--gang", "{dump}"], ["--diff", "{profile}", "{dump}"],
    ["{dump}", "{sink}"], ["--follow", "{dump}", "{sink}"],
    ["--follow", "{goodput}"], ["--skew", "{empty}"], ["--health", "{empty}"],
    ["--goodput", "{empty}"], ["--profile", "{empty}"],
    ["--postmortem", "{missing}"], ["--tune", "{missing}"],
]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_every_cli_mode_prints_the_jax_output(worlds, which):
    files = dict(worlds[which])
    files["other_profile"] = worlds["jax" if which == "port" else
                                    "port"]["profile"]
    files["missing"] = files["dump"] + ".missing"
    codes = {}
    for mode in MODES:
        argv = [a.format(**files) for a in mode]
        got = _run(timeline, argv)
        want = _run(jax_timeline, argv)
        assert got == want, argv
        codes[" ".join(mode)] = got[0]
    assert codes["--rpc {sink}"] == codes["--health {sink}"] == 0
    assert codes["--rpc --gang {dump}"] == 2
    assert codes["--rpc {empty}"] == 1
    out = _run(timeline, ["--rpc", files["sink"]])[1]
    assert "bound by: render, shard 1" in out
    out = _run(timeline, ["--health", files["health"]])[1]
    assert "model health" in out and "nonfinite" in out
    assert "model health at death" in _run(
        timeline, ["--postmortem", files["postmortem"]])[1]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_renderers_and_follow_match_jax_on_the_same_documents(worlds, which):
    files = worlds[which]

    def doc(name):
        with open(files[name]) as f:
            return json.load(f)

    pairs = [
        ("render_gang_report", doc("gang")["xprof"]),
        ("render_goodput_report", doc("goodput")),
        ("render_health_report", doc("health")),
        ("render_skew_report", doc("skew")),
        ("render_profile_report", doc("profile")),
        ("render_postmortem_report", doc("postmortem")),
        ("render_tune_report", doc("tune")),
    ]
    for name, d in pairs:
        got = getattr(timeline, name)(d)
        assert got == getattr(jax_timeline, name)(d), name
        assert got.strip()
    traces = jax_obs.stitch_spans(_spans())
    assert timeline.render_rpc_report(traces, top=2) == \
        jax_timeline.render_rpc_report(traces, top=2)
    diff = jax_profile.diff_docs(doc("profile"), doc("profile"))
    assert timeline.render_profile_diff(diff) == \
        jax_timeline.render_profile_diff(diff)
    snap = json.loads(open(files["dump"]).read().splitlines()[-1])
    assert timeline.render_snapshot_report(snap) == \
        jax_timeline.render_snapshot_report(snap)

    lines = {}
    for name, mod in (("port", timeline), ("jax", jax_timeline)):
        stop = threading.Event()
        stop.set()
        lines[name] = list(mod.follow(files["sink"], poll_s=0.0, stop=stop))
        reader = mod.FollowReader(files["sink"])
        lines[name].append(len(reader.poll()))
        with open(files["sink"]) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        lines[name] += [mod.render_follow_line(r) for r in recs]
    assert lines["port"] == lines["jax"]
    kinds = {ln.split()[1] for ln in lines["port"]
             if isinstance(ln, str)}
    assert {"goodput.run", "profile.run", "health.run", "skew.run",
            "gang_snapshot"} <= kinds


@pytest.mark.parametrize("fixture", ["synthetic_overlap", "cpu_allreduce",
                                     "cpu_moe_a2a"])
def test_trace_reports_match_the_jax_reports(fixture, tmp_path):
    """The JAX CLI on a golden capture and the port's on its
    ``torch.profiler`` translation print the same report, word for word,
    save the capture's path and the NCCL kernel prefix of the
    collectives' names; the renderers print the same string on one
    analysis document."""
    xh = _xprof_helpers()
    data = _load(fixture)
    src = os.path.join(FIXTURES, fixture + ".trace.json.gz")
    translated, _ = xh.to_torch_shape(data)
    dst = str(tmp_path / (fixture + ".json"))
    with open(dst, "w") as f:
        json.dump(translated, f)
    got, want = _run(timeline, [dst]), _run(jax_timeline, [src])
    assert got[0] == want[0] == 0
    assert _words(got[1].replace(xh.NCCL, "").replace(dst, src)) == \
        _words(want[1])
    analysis = jax_obs.analyze_trace(data)

    class _Doc:
        def to_dict(self):
            return analysis.to_dict()

    for top in (3, 10):
        assert timeline.render_report(_Doc(), top=top) == \
            jax_timeline.render_report(analysis, top=top)
    other = _load("synthetic_overlap")
    gang = jax_obs.merge_analyses([analysis, jax_obs.analyze_trace(other)])
    assert timeline.render_gang_report(gang.to_dict()) == \
        jax_timeline.render_gang_report(gang)
    dst2 = str(tmp_path / "other.json")
    with open(dst2, "w") as f:
        json.dump(xh.to_torch_shape(other)[0], f)
    got = _run(timeline, ["--gang", dst, dst2])
    want = _run(jax_timeline, ["--gang", src, os.path.join(
        FIXTURES, "synthetic_overlap.trace.json.gz")])
    assert got[0] == want[0] == 0
    assert _words(got[1].replace(xh.NCCL, "")) == _words(want[1])


def _words(text):
    """``text`` line by line, each line's words: a collective's name
    loses its kernel prefix, and the columns it padded shift."""
    return [ln.split() for ln in text.splitlines()]
