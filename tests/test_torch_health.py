"""The port's model-health lane (``obs/health.py``) and the step's health vector against the JAX package's.

The two ledgers fed the same step values must agree on everything but
the clock: snapshots, anomalies, flag gauges, alert firings and events.
The step's ``HealthVec`` is held to the JAX step's on the same weights
and batch (MLPs under SGD and Adam, a 2-layer causal LM): the finite bit
equal, the update ratio within 1e-5 relative, each parameter's grad norm
within 1e-5, matched by name through ``convert``. A poisoned
``train_distributed`` in both packages flags the same step with the
same kinds and detection lag.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.obs import alerts as jax_alerts
from sparktorch_tpu.obs import health as jax_health
from sparktorch_tpu.obs import history as jax_history
from sparktorch_tpu.obs import telemetry as jax_telemetry
from sparktorch_tpu_torch.obs import alerts, health, history, telemetry

PKGS = {"port": (health, telemetry, history, alerts),
        "jax": (jax_health, jax_telemetry, jax_history, jax_alerts)}

_CLOCK_KEYS = {"ts", "started_ts"}
# The port's anomaly also says when the ledger really ingested it
# (``ingest_lag``): checked on its own, beside the shared fields.
_PORT_ONLY_KEYS = {"ingest_lag"}


def _strip(doc):
    """``doc`` without its wall-clock and port-only fields, at any
    depth."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in _CLOCK_KEYS | _PORT_ONLY_KEYS}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    if isinstance(doc, float) and math.isnan(doc):
        return "nan"
    return doc


def _schedule():
    """Per-step (host, device) values: a warm-up, a loss spike, a grad
    explosion, a NaN step, then a flat run long enough to plateau."""
    rng = np.random.default_rng(0)
    steps = []
    for i in range(80):
        loss = 2.0 - 0.01 * i + 0.001 * rng.standard_normal()
        gnorm = 1.0 + 0.01 * rng.standard_normal()
        if i == 10:
            loss = 40.0
        if i == 14:
            gnorm = 500.0
        if i == 20:
            loss = float("nan")
        if i >= 26:
            loss = 1.5
        leaf = np.abs(rng.standard_normal(4)).astype(np.float32)
        dev = {"finite": np.float32(0.0 if i == 20 else 1.0),
               "update_ratio": np.float32(1e-3 * (1 + i % 3)),
               "leaf_norms": leaf}
        steps.append(({"loss": loss, "grad_norm": gnorm}, dev))
    return steps


def _run_ledger(which, chunk, publish_interval_s=0.0):
    h, t, hist_mod, al = PKGS[which]
    tele = t.Telemetry(run_id="health")
    events = []
    tele.add_sink(events.append)
    hist = hist_mod.MetricsHistory()
    manager = al.AlertManager(hist, h.health_alert_rules(), telemetry=tele)
    led = h.TrainHealthLedger(
        rank="w0", telemetry=tele,
        config=h.HealthConfig(publish_interval_s=publish_interval_s),
        leaf_keys=["a.weight", "a.bias", "b.weight", "b.bias"])
    steps = _schedule()
    firings = []
    for start in range(0, len(steps), chunk):
        part = steps[start:start + chunk]
        host = {k: np.asarray([p[0][k] for p in part], np.float64)
                for k in ("loss", "grad_norm")}
        dev = {k: np.stack([p[1][k] for p in part])
               for k in ("finite", "update_ratio", "leaf_norms")}
        if chunk == 1:
            host = {k: float(v[0]) for k, v in host.items()}
            dev = {k: v[0] for k, v in dev.items()}
        led.note_step(count=len(part), device=dev, host=host)
        hist.append(tele.snapshot())
        firings += [(e["alert"], e["event"]) for e in manager.evaluate()]
        if start == 30:
            led.reset()
    led.flush()
    if which == "port" and publish_interval_s == 0.0:
        # A publish each note settles the ledger each note: every
        # anomaly is ingested at the note its entry fell due at.
        for a in led.snapshot()["anomalies"]:
            assert a["ingest_lag"] == a["detect_lag"], a
    snap = tele.snapshot()
    gauges = {k: v for k, v in snap["gauges"].items()
              if k.startswith("health.")}
    kinds = [(e.get("kind"), e.get("akind"), e.get("step"), e.get("lag"))
             for e in events if str(e.get("kind", "")).startswith("health")]
    return (_strip(led.snapshot()), _strip(gauges), firings, kinds,
            _strip(tele.get_section("health")))


@pytest.mark.parametrize("chunk", [1, 4])
def test_ledgers_agree_on_the_same_steps(chunk):
    port = _run_ledger("port", chunk)
    want = _run_ledger("jax", chunk)
    assert port == want
    doc = port[0]
    assert {a["akind"] for a in doc["anomalies"]} == {
        "loss_spike", "grad_explosion", "nonfinite", "plateau"}
    assert ("health_nonfinite", "fired") in port[2]


@pytest.mark.parametrize("chunk", [1, 4])
def test_batched_settles_read_as_inline(chunk):
    """With publishes throttled, the inbox settles every READ_BATCH
    notes and reads what fell due in one copy; the ledger still equals
    the JAX one, which drains each note: the same anomalies at the same
    detect lags, gauges, alert firings and section."""
    port = _run_ledger("port", chunk, publish_interval_s=1e9)
    assert port == _run_ledger("jax", chunk, publish_interval_s=1e9)


@pytest.mark.parametrize("chunk", [1, 4])
def test_ingest_lag_counts_the_inbox(chunk):
    """An anomaly's ``ingest_lag`` (record and event) says when the
    ledger really ingested it: at or after its JAX ``detect_lag``, at
    most READ_BATCH - 1 notes later, and later for some."""
    tele = telemetry.Telemetry(run_id="lag")
    events = []
    tele.add_sink(events.append)
    led = health.TrainHealthLedger(
        rank="w0", telemetry=tele,
        config=health.HealthConfig(publish_interval_s=1e9))
    steps = _schedule()
    for start in range(0, len(steps), chunk):
        part = steps[start:start + chunk]
        host = {k: np.asarray([p[0][k] for p in part], np.float64)
                for k in ("loss", "grad_norm")}
        led.note_step(count=len(part), host=host)
    led.flush()
    lags = [(a["detect_lag"], a["ingest_lag"])
            for a in led.snapshot()["anomalies"]]
    most = (health.READ_BATCH - 1) * chunk
    assert lags and all(d <= i <= d + most for d, i in lags), lags
    assert any(i > d for d, i in lags), lags
    assert [e["ingest_lag"] for e in events
            if e.get("kind") == "health.anomaly"] == [i for _, i in lags]


def test_an_ingest_error_raises_into_the_trainer(monkeypatch):
    """An ingest that raises reaches the trainer through the note whose
    settle ran it (within READ_BATCH notes of falling due), and the
    ledger goes on afterwards."""
    ingest = health.TrainHealthLedger._ingest_row

    def planted(self, step, *args):
        if step == 3:
            raise ValueError("planted ingest error")
        return ingest(self, step, *args)

    monkeypatch.setattr(health.TrainHealthLedger, "_ingest_row", planted)
    led = health.TrainHealthLedger(
        rank="err", telemetry=telemetry.Telemetry(run_id="err"),
        config=health.HealthConfig(publish_interval_s=1e9))
    raised = []
    for i in range(4 * health.READ_BATCH):
        try:
            led.note_step(device={"loss": np.float32(1.0 + i)})
        except ValueError as exc:
            raised.append((i, str(exc)))
    due = 3 + led.config.fetch_lag
    assert len(raised) == 1 and raised[0][1] == "planted ingest error"
    assert due <= raised[0][0] < due + health.READ_BATCH, raised
    led.flush()
    assert led.snapshot()["last_step"] == 4 * health.READ_BATCH - 1


def test_host_tensors_are_read_as_values():
    """A tensor left on the host is read by value, whatever its dtype: a
    bfloat16 row of leaf norms gives the leaves their norms (it was read
    as its int16 bit patterns: 16487.0 for 3.609375)."""
    led = health.TrainHealthLedger(
        rank="h", telemetry=telemetry.Telemetry(run_id="host"),
        leaf_keys=["a", "b", "c"])
    for _ in range(4):
        led.note_step(device={
            "loss": torch.tensor(1.0),
            "leaf_norms": torch.tensor([1.0, 3.609375, 0.5]).bfloat16()})
    led.flush()
    assert led.snapshot()["top_grad_leaves"] == [
        ["b", 3.609375], ["a", 1.0], ["c", 0.5]]


def test_merge_and_sections_agree():
    docs = {}
    for which in ("port", "jax"):
        docs[which] = _run_ledger(which, 1)[4]
    for which, (h, _, _, _) in PKGS.items():
        merged = h.merge_sections({"a": docs[which], "b": {
            "rank": "solo", "anomalies": [], "counts": {},
            "steps_ingested": 3, "last_step": 2}})
        docs[which] = _strip(merged)
    assert docs["port"] == docs["jax"]
    assert docs["port"]["n_ranks"] == 2
    snaps = {0: {"sections": {"health": {"rank": "0"}}}, 1: None}
    assert health.sections_from_snapshots(snaps) == \
        jax_health.sections_from_snapshots(snaps)


def test_ambient_ledger_and_env_gate(monkeypatch):
    prev = health.install(None)
    try:
        tele = telemetry.Telemetry()
        led = health.ensure(tele, rank=3)
        assert health.active() is led and led.rank == 3
        assert health.ensure(tele) is led
        assert health.ensure(telemetry.Telemetry()) is not led
        monkeypatch.setenv(health.ENV_GATE, "0")
        assert not health.enabled() and health.ensure(tele) is None
    finally:
        health.install(prev)
    assert [r.name for r in health.health_alert_rules()] == \
        [r.name for r in jax_health.health_alert_rules()]


# -- the step's health vector against the JAX step's ------------------------


def _jax_step(flax_model, loss, opt, opt_kw, x, y):
    from sparktorch_tpu.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu.train.step import create_train_state, make_train_step
    from sparktorch_tpu.train.sync import prepare_sharded_batch
    from sparktorch_tpu.utils.data import DataBatch
    from sparktorch_tpu.utils.serde import ModelSpec

    spec = ModelSpec(module=flax_model, loss=loss, optimizer=opt,
                     optimizer_params=opt_kw, input_shape=x.shape[1:])
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    tx = spec.make_optimizer()
    state = create_train_state(spec, jax.random.key(0),
                               sample_x=jnp.asarray(x[:1]), tx=tx)
    params = jax.device_get(state.params)
    step = make_train_step(spec.make_module().apply, spec.loss_fn(), tx, mesh)
    batch = prepare_sharded_batch(DataBatch(
        jnp.asarray(x), jnp.asarray(y),
        jnp.ones((len(x),), jnp.float32)), mesh)
    _, m = step(state, batch)
    keys = jax_health.health_leaf_keys(params)
    norms = np.asarray(m.health.leaf_norms)
    leaves = jax.tree_util.tree_leaves(params)
    filled = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(a.shape, v, np.float32) for a, v in zip(leaves, norms)])
    return params, filled, keys, m


def _port_step(module, variables, filled, loss, opt, opt_kw, x, y):
    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.train.step import health_buffer, train_step
    from sparktorch_tpu_torch.train.sync import _build_trainer
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    module.load_state_dict(state_dict_from_flax(variables, module))
    spec = ModelSpec(module=module, loss=loss, optimizer=opt,
                     optimizer_params=opt_kw)
    mod, optimizer, loss_fn = _build_trainer(spec, spec, torch.device("cpu"))
    batch = DataBatch(torch.from_numpy(x), torch.from_numpy(y),
                      torch.ones(len(x)))
    m = train_step(mod, loss_fn, optimizer, batch,
                   health_buf=health_buffer(mod))
    want = state_dict_from_flax({"params": filled}, mod)
    return mod, m, want


def _check_health(jm, pm, mod, want):
    assert float(pm.health.finite) == float(jm.health.finite) == 1.0
    np.testing.assert_allclose(float(pm.health.update_ratio),
                               float(jm.health.update_ratio), rtol=1e-5)
    keys = health.health_leaf_keys(mod)
    got = dict(zip(keys, pm.health.leaf_norms.numpy()))
    assert len(got) == len(want) == pm.health.leaf_norms.numel()
    for name, value in want.items():
        flat = value.reshape(-1)
        assert float(flat.max()) == float(flat.min()), name  # one leaf
        np.testing.assert_allclose(got[name], float(flat[0]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("opt,opt_kw", [("sgd", {"lr": 0.1}),
                                        ("adam", {"lr": 1e-2})])
def test_health_vector_matches_jax_mlp(opt, opt_kw):
    from sparktorch_tpu.models import simple as jax_simple
    from sparktorch_tpu_torch.models import simple as torch_simple

    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 784)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    params, filled, _, jm = _jax_step(jax_simple.MnistMLP(hidden=(32,)),
                                      "cross_entropy", opt, opt_kw, x, y)
    mod, pm, want = _port_step(torch_simple.MnistMLP(hidden=(32,)),
                               {"params": params}, filled, "cross_entropy",
                               opt, opt_kw, x, y.astype(np.int64))
    _check_health(jm, pm, mod, want)


def test_health_vector_matches_jax_transformer():
    from sparktorch_tpu.models import transformer as jax_tf
    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        TransformerConfig,
    )

    cfg = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_len=16, dtype="float32")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (4, 17))
    x, y = ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.int32)
    params, filled, _, jm = _jax_step(
        jax_tf.CausalLM(jax_tf.TransformerConfig(**cfg)), "cross_entropy",
        "adamw", {"lr": 1e-3}, x, y)
    mod, pm, want = _port_step(CausalLM(TransformerConfig(**cfg)),
                               {"params": params}, filled, "cross_entropy",
                               "adamw", {"lr": 1e-3}, x, y.astype(np.int64))
    _check_health(jm, pm, mod, want)


def test_poisoned_fit_flags_the_same_step_in_both_packages():
    import sparktorch_tpu as jax_pkg
    import sparktorch_tpu_torch as port
    from sparktorch_tpu.ft import ChaosConfig as JaxChaos
    from sparktorch_tpu.ft import inject as jax_inject
    from sparktorch_tpu.models import simple as jax_simple
    from sparktorch_tpu.train.sync import train_distributed as jax_train
    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.models import simple as torch_simple
    from sparktorch_tpu_torch.train.sync import train_distributed

    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 10)).astype(np.float32)
    y = x.sum(1).astype(np.float32)
    flax_model = jax_simple.Net()
    variables = jax.device_get(flax_model.init(jax.random.key(0),
                                               jnp.asarray(x[:1])))
    module = torch_simple.Net()
    module.load_state_dict(state_dict_from_flax(variables, module))
    kw = dict(criterion="mse", optimizer="adam",
              optimizer_params={"lr": 1e-2}, input_shape=(10,))
    docs = {}
    for which in ("port", "jax"):
        h, t, _, _ = PKGS[which]
        tele = t.Telemetry(run_id=which)
        prev = h.install(None)
        try:
            if which == "port":
                with inject(ChaosConfig(poison_batch_at={0: 5})):
                    train_distributed(port.serialize_torch_obj(module, **kw),
                                      x, labels=y, iters=10,
                                      steps_per_call=1, telemetry=tele,
                                      device="cpu")
            else:
                with jax_inject(JaxChaos(poison_batch_at={0: 5})):
                    jax_train(jax_pkg.serialize_torch_obj(flax_model, **kw),
                              x, labels=y, iters=10, steps_per_call=1,
                              telemetry=tele)
        finally:
            h.install(prev)
        doc = tele.get_section("health")["ranks"]["0"]
        docs[which] = [(a["akind"], a["step"], a["detect_lag"])
                       for a in doc["anomalies"]]
        assert doc["steps_ingested"] == 10
    assert docs["port"] == docs["jax"]
    assert docs["port"][0] == ("nonfinite", 5, 2)


def test_postmortem_health_from_a_trainer_bus(tmp_path):
    # A trainer's bus holds only its ledger's per-rank ``health``
    # section: both packages' postmortems merge it to the run document.
    from sparktorch_tpu.obs import blackbox as jax_blackbox
    from sparktorch_tpu_torch.obs import blackbox

    got = {}
    for which, bb in (("port", blackbox), ("jax", jax_blackbox)):
        h, t = PKGS[which][:2]
        tele = t.Telemetry(run_id="pm")
        led = h.TrainHealthLedger(
            rank="0", telemetry=tele,
            config=h.HealthConfig(publish_interval_s=0.0),
            leaf_keys=["a.weight", "a.bias", "b.weight", "b.bias"])
        for host, dev in _schedule()[:24]:
            led.note_step(device=dev, host=host)
        led.flush()
        assert tele.get_section(h.SECTION) is not None
        assert tele.get_section(h.RUN_SECTION) is None
        path = bb.collect_postmortem(str(tmp_path / which), "drill",
                                     telemetry=tele)
        got[which] = _strip(bb.read_postmortem(path)["health"])
    assert got["port"] == got["jax"]
    assert got["port"]["kind"] == "health_run"
    assert got["port"]["worst"]["akind"] == "nonfinite"
