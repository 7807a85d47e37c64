"""The port's Prometheus text, library log, tracing hooks and step recorder against the JAX package's.

The same snapshot must render to the same exposition text in both
packages and survive the round trip (the cases of ``tests/test_obs.py``,
label escaping included); ``profile_run`` and ``step_annotation`` must
write a trace on the CPU whose ``train_step`` ranges number as many as
the annotations, under the JAX package's ``tracing.*`` names; the
recorder must roll up the same summary keys and mirror the same counters
into the bus.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sparktorch_tpu import obs as jax_obs
from sparktorch_tpu.obs import prom as jax_prom
from sparktorch_tpu.utils import metrics as jax_metrics
from sparktorch_tpu_torch import obs
from sparktorch_tpu_torch.obs import prom
from sparktorch_tpu_torch.utils import metrics, tracing

REPO = Path(__file__).resolve().parent.parent


def _basic(tele):
    tele.counter("train.steps", 5)
    tele.counter("http_requests", labels={"route": "/metrics"})
    tele.gauge("queue_depth", 3)
    for v in (0.1, 0.2, 0.3):
        tele.observe("step_s", v)


def _escaping(tele):
    tele.counter("c", labels={"path": 'a"b\\c'})


def _edge(tele):
    nasty = 'quote:" back:\\ nl:\nend'
    tele.counter("edge_total", 3, labels={"msg": nasty})
    tele.info("edge_info", nasty)


def _spans(tele):
    with tele.span("bench", labels={"leg": "a"}):
        with tele.span("measure"):
            pass
    tele.observe("serve.batch_fill", 0.5, labels={"replica": "1"})


def _empty(tele):
    pass


# The scripted snapshots of tests/test_obs.py's Prometheus cases.
@pytest.mark.parametrize("drive", [_basic, _escaping, _edge, _spans, _empty],
                         ids=["basic", "escaping", "edge", "spans", "empty"])
def test_render_is_the_jax_text_and_round_trips(drive):
    tele = obs.Telemetry()
    drive(tele)
    snap = tele.snapshot()
    text = prom.render_prometheus(snap)
    assert text == jax_prom.render_prometheus(snap)
    assert prom.parse_prometheus(text) == jax_prom.parse_prometheus(text)
    # The port's bus and the JAX one, driven alike, render alike (spans
    # aside: their durations are each bus's own clock).
    jax_tele = jax_obs.Telemetry()
    drive(jax_tele)
    jax_snap = jax_tele.snapshot()
    if drive is not _spans:
        assert text == jax_prom.render_prometheus(jax_snap)
    parsed = prom.parse_prometheus(text)
    for flat, value in snap["counters"].items():
        name, labels = prom._parse_flat_key(flat)
        key = "sparktorch_" + prom.sanitize_name(name) + prom._labels_text(
            labels)
        assert parsed[key] == value
    if drive is _basic:
        assert "# TYPE sparktorch_step_s summary" in text
        assert parsed["sparktorch_step_s_count"] == 3.0
        assert parsed['sparktorch_step_s{quantile="0.5"}'] == pytest.approx(
            0.2)
    if drive is _escaping:
        assert r'path="a\"b\\c"' in text
    if drive is _edge:
        assert parsed['sparktorch_edge_total{msg="quote:\\" back:\\\\ '
                      'nl:\\nend"}'] == 3.0
    if drive is _empty:
        assert text == "\n"


@pytest.mark.parametrize("name", ["train.steps", "serve/batch-fill", "0abc",
                                  "a:b_c"])
def test_sanitize_name_and_the_empty_histogram(name):
    assert prom.sanitize_name(name) == jax_prom.sanitize_name(name)
    snap = {"histograms": {name: obs.Telemetry().histogram("never")}}
    text = prom.render_prometheus(snap)
    assert text == jax_prom.render_prometheus(snap)
    assert "quantile" not in text
    assert prom.CONTENT_TYPE == jax_prom.CONTENT_TYPE


def test_logger_root_and_level_variable():
    code = ("import logging\n"
            "from sparktorch_tpu_torch.obs import get_logger\n"
            "log = get_logger('sparktorch_tpu_torch.train')\n"
            "get_logger()\n"
            "root = logging.getLogger('sparktorch_tpu_torch')\n"
            "assert log.parent is root and not root.propagate\n"
            "assert len(root.handlers) == 1\n"
            "assert root.level == logging.WARNING, root.level\n"
            "log.info('hidden')\n"
            "log.warning('shown')\n")
    env = dict(os.environ, SPARKTORCH_TPU_LOG_LEVEL="warning",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "shown"
    assert "hidden" not in proc.stderr


def test_trainers_log_through_the_library_logger(caplog):
    import torch

    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import Net
    from sparktorch_tpu_torch.train.sync import train_distributed

    torch.manual_seed(0)
    obj = serialize_torch_obj(Net(), criterion="mse", optimizer="sgd",
                              optimizer_params={"lr": 0.1},
                              input_shape=(10,))
    x = np.random.default_rng(0).normal(0, 1, (16, 10)).astype(np.float32)
    root = logging.getLogger("sparktorch_tpu_torch")
    root.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="sparktorch_tpu_torch"):
            train_distributed(obj, x, labels=x[:, 0], iters=2, verbose=1,
                              device="cpu")
    finally:
        root.removeHandler(caplog.handler)
    lines = [r for r in caplog.records
             if r.name == "sparktorch_tpu_torch.train"]
    assert [r.getMessage().split(" loss ")[0] for r in lines] == [
        "[sparktorch_tpu_torch] round 0 iter 0",
        "[sparktorch_tpu_torch] round 0 iter 1"]


def _names(snap):
    return {section: sorted(snap[section]) for section in
            ("counters", "gauges", "histograms", "spans", "info")}


def test_profile_run_and_step_annotation_on_the_cpu(tmp_path):
    """Three annotated steps inside a profiled block in each package:
    the ``tracing.*`` names, the counts and the event kinds agree, and
    the port's Chrome trace holds one ``train_step`` range per
    annotation."""
    import jax.numpy as jnp
    import torch

    from sparktorch_tpu.utils import tracing as jax_tracing

    out = {}
    for name, pkg, mod in (("jax", jax_obs, jax_tracing),
                           ("port", obs, tracing)):
        tele = pkg.Telemetry(run_id=name)
        events = []
        tele.add_sink(events.append)
        log_dir = str(tmp_path / name)
        with mod.profile_run(log_dir, telemetry=tele, analyze=False) as h:
            for step in range(3):
                with mod.step_annotation(step, telemetry=tele):
                    if name == "jax":
                        (jnp.ones((8, 8)) @ jnp.ones((8, 8))).block_until_ready()
                    else:
                        torch.ones(8, 8) @ torch.ones(8, 8)
        snap = tele.snapshot()
        out[name] = (_names(snap), snap["counters"],
                     [e["kind"] for e in events], h["analysis"])
        assert snap["info"]["tracing.trace_url"] == mod.trace_viewer_url(
            log_dir)
        assert events[-1]["log_dir"] == log_dir
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"tracing.annotated_steps": 3.0,
                              "tracing.profile_runs": 1.0}

    (path,) = (tmp_path / "port").glob("*" + tracing.TRACE_SUFFIX)
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "train_step"
              and e.get("ph") == "X"]
    assert len(ranges) == 3


def test_tracing_is_a_no_op_without_a_directory_and_raises_through():
    tele = obs.Telemetry()
    with tracing.profile_run(None, telemetry=tele) as handle:
        with tracing.step_annotation(0, telemetry=tele, device="cpu"):
            pass
    assert handle == {"analysis": None, "trace_path": None}
    assert tele.snapshot()["counters"] == {"tracing.annotated_steps": 1.0}
    # A failure inside an annotation is never swallowed.
    with pytest.raises(ZeroDivisionError):
        with tracing.step_annotation(1, telemetry=tele, device="cpu"):
            1 / 0
    assert tele.counter_value("tracing.annotated_steps") == 2.0


def _records(rng, n):
    return [{"loss": float(v), "examples": 32.0,
             "step_time_s": float(t)} for v, t in
            zip(rng.uniform(0.1, 1.0, n), rng.uniform(0.01, 0.02, n))]


def test_recorder_mirrors_the_jax_recorder(tmp_path):
    out = {}
    for name, pkg, mod in (("jax", jax_obs, jax_metrics),
                           ("port", obs, metrics)):
        tele = pkg.Telemetry()
        rec = mod.MetricsRecorder(n_chips=2, telemetry=tele,
                                  prefix="train_streaming")
        for r in _records(np.random.default_rng(0), 6):
            rec.record(r)
        summary = rec.summary()
        path = str(tmp_path / name / "m.jsonl")
        rec.to_jsonl(path)
        rec.to_jsonl(path, append=True)
        lines = pkg.read_jsonl(path)
        snap = tele.snapshot()
        out[name] = (sorted(summary), summary["steps"],
                     summary["total_examples"], summary["first_loss"],
                     summary["final_loss"], summary["step_time_p50_s"],
                     snap["counters"], snap["gauges"],
                     {k: v["count"] for k, v in snap["histograms"].items()},
                     len(lines), lines[:6])
        assert summary["examples_per_sec_per_chip"] == pytest.approx(
            summary["examples_per_sec"] / 2, rel=1e-3)
    assert out["port"] == out["jax"]
    assert out["port"][6] == {"train_streaming.examples": 192.0,
                              "train_streaming.steps": 6.0}
