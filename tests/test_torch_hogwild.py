"""Hogwild training in both packages, and the port against the JAX wire.

With one worker, full batches and ``push(wait=True)`` the sequence of
server applies is deterministic, so the two packages agree step for
step from the same initial parameters (the JAX server's, for its seed,
carried across by ``convert``). Minibatch offsets come from different
generators in the two packages, so minibatched runs are checked for
their semantics only.
"""

import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes

import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import resnet as jax_resnet
from sparktorch_tpu.models import simple as jax_simple
from sparktorch_tpu.net.transport import BinaryTransport as JaxBinaryTransport
from sparktorch_tpu.serve import param_server as jax_ps
from sparktorch_tpu.train.hogwild import train_async as jax_train_async
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import resnet, simple
from sparktorch_tpu_torch.net.transport import BinaryTransport
from sparktorch_tpu_torch.serve import param_server as ps
from sparktorch_tpu_torch.train.hogwild import train_async

TINY_RESNET = dict(stage_sizes=(1, 1), num_classes=3, width=4)
MODELS = {
    "mlp": (lambda: jax_simple.MnistMLP(hidden=(16,), n_classes=3),
            lambda: simple.MnistMLP(hidden=(16,), n_classes=3,
                                    in_features=48), (48,)),
    # A tiny ResNet: a plain block, then a strided one with its projection.
    "resnet": (lambda: jax_resnet.ResNet(**TINY_RESNET,
                                         block_cls=jax_resnet.ResNetBlock,
                                         compute_dtype=jnp.float32),
               lambda: resnet.ResNet(**TINY_RESNET,
                                     block_cls=resnet.ResNetBlock,
                                     compute_dtype="float32"), (4, 4, 3)),
}


def _pair(kind, optimizer="sgd", params=None, seed=0):
    make_jax, make_port, shape = MODELS[kind]
    jax_model = make_jax()
    variables = jax.device_get(jax_model.init(jax.random.key(seed),
                                              jnp.zeros((1, *shape))))
    module = make_port()
    module.load_state_dict(state_dict_from_flax(variables, module))
    kw = dict(criterion="cross_entropy", optimizer=optimizer,
              optimizer_params=params or {"lr": 0.1}, input_shape=shape)
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(module, **kw), module)


def _data(shape, n=24, classes=3, seed=1):
    """Normal rows with 3 added to the feature that names their class,
    so a few steps learn."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = rng.standard_normal((n, int(np.prod(shape)))).astype(np.float32)
    x[np.arange(n), y] += 3.0
    return x.reshape(n, *shape), y


def _flax_state(result):
    return {"params": jax.device_get(result.params),
            **jax.device_get(result.model_state)}


@pytest.mark.parametrize("optimizer,params,tol", [
    ("sgd", {"lr": 0.1}, 2e-5),
    ("adam", {"lr": 1e-2}, 1e-4),
])
@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_single_worker_matches_jax(kind, optimizer, params, tol):
    jax_obj, obj, module = _pair(kind, optimizer, params)
    x, y = _data(MODELS[kind][2])
    want = jax_train_async(jax_obj, x, labels=y, iters=5, partitions=1)
    got = train_async(obj, x, labels=y, iters=5, partitions=1, device="cpu")
    assert [r["iter"] for r in got.metrics] == list(range(5))
    assert [r["version"] for r in got.metrics] == list(range(5))
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    assert got.summary["server_applied"] == 5
    expected = state_dict_from_flax(_flax_state(want), module)
    assert list(got.params) == list(module.state_dict())
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=tol, rtol=tol, err_msg=key)


def test_single_worker_moe_lm_matches_jax():
    # An MoE LM through the parameter server: each worker loss holds the
    # layers' load-balance loss, and the batch's weights reach the
    # routing, as the JAX worker's grad step has them.
    from sparktorch_tpu.models import transformer as jax_tf
    from sparktorch_tpu_torch.models import transformer as torch_tf

    cfg = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_len=32, n_experts=4, moe_every=2, dtype="float32",
               moe_group_size=24, moe_top_k=2, moe_aux_weight=0.1)
    jax_model = jax_tf.CausalLM(jax_tf.TransformerConfig(**cfg))
    variables = jax.device_get(jax_model.init(jax.random.key(0),
                                              jnp.zeros((1, 16))))
    module = torch_tf.CausalLM(torch_tf.TransformerConfig(**cfg))
    module.load_state_dict(state_dict_from_flax(variables, module))
    kw = dict(criterion="cross_entropy", optimizer="sgd",
              optimizer_params={"lr": 0.5}, input_shape=(16,))
    ids = np.random.default_rng(2).integers(0, 128, (6, 17))
    x, y = ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.int32)
    want = jax_train_async(jax_pkg.serialize_torch_obj(jax_model, **kw), x,
                           labels=y, iters=4, partitions=1)
    got = train_async(port.serialize_torch_obj(module, **kw), x, labels=y,
                      iters=4, partitions=1, device="cpu")
    # The JAX server keeps the aux loss its init sowed in the model
    # state it hands the workers (serve/param_server.py:90-93), so each
    # JAX worker loss carries that constant too; it has no gradient.
    stale = float(sum(np.sum(v) for v in
                      jax.tree.leaves(variables["losses"])))
    assert stale > 0
    np.testing.assert_allclose([r["loss"] + stale for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(_flax_state(want), module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=key)


def _mean(records, first, last):
    losses = [r["loss"] for r in sorted(records, key=lambda r: r["t"])]
    return np.mean(losses[:first]), np.mean(losses[-last:])


def test_four_workers_with_minibatches_train():
    _, obj, _ = _pair("mlp")
    x, y = _data((48,), n=256)
    result = train_async(obj, x, labels=y, iters=12, partitions=4,
                         mini_batch=16, device="cpu")
    assert len(result.metrics) == 48
    assert sorted({r["worker"] for r in result.metrics}) == [0, 1, 2, 3]
    assert result.summary["server_applied"] == 48
    assert result.summary["hogwild_budget"]["pushes"] == 48
    first, last = _mean(result.metrics, 8, 8)
    assert np.isfinite([r["loss"] for r in result.metrics]).all()
    assert last < first


def test_label_sorted_input_trains():
    # Round 0 shuffles before the split: no worker sees a single class.
    _, obj, _ = _pair("mlp")
    x, y = _data((48,), n=240)
    order = np.argsort(y, kind="stable")
    x, y = x[order], y[order]
    result = train_async(obj, x, labels=y, iters=30, partitions=3,
                         device="cpu")
    model = port.create_spark_torch_model(
        result.spec.make_module(), result.params).setDevice("cpu")
    preds = model.transform({"features": list(x)})["predicted"]
    assert set(np.unique(preds)) == {0.0, 1.0, 2.0}
    assert (preds == y).mean() > 0.9


@pytest.mark.parametrize("wire,quant", [("binary", None), ("binary", "int8"),
                                        ("dill", None)])
def test_http_transport_trains(wire, quant):
    _, obj, _ = _pair("resnet", params={"lr": 0.05})
    x, y = _data((4, 4, 3), n=64)
    result = train_async(obj, x, labels=y, iters=6, partitions=2,
                         mini_batch=16, transport="http", wire=wire,
                         quant=quant, device="cpu")
    budget = result.summary["hogwild_budget"]
    assert result.summary["server_applied"] == budget["pushes"] == 12
    assert budget["push_bytes"] > 0 and budget["pull_bytes"] > 0
    assert np.isfinite([r["loss"] for r in result.metrics]).all()


def test_http_single_worker_matches_local():
    _, obj, _ = _pair("mlp")
    x, y = _data((48,))
    local = train_async(obj, x, labels=y, iters=4, partitions=1,
                        device="cpu")
    remote = train_async(obj, x, labels=y, iters=4, partitions=1,
                         transport="http", compress=False, device="cpu")
    assert ([r["loss"] for r in remote.metrics]
            == [r["loss"] for r in local.metrics])
    for key, value in local.params.items():
        torch.testing.assert_close(remote.params[key], value, atol=0, rtol=0)


@pytest.mark.parametrize("optimizer,params,tol", [
    ("sgd", {"lr": 0.1}, 2e-5),
    ("adam", {"lr": 1e-2}, 1e-4),
])
def test_single_worker_on_a_fleet_matches_jax(optimizer, params, tol):
    # shards=2 over HTTP, float32 pushes and pulls: the port's fleet and
    # the JAX package's from the same init give the same losses and
    # parameters (each shard steps its leaves per leaf).
    jax_obj, obj, module = _pair("mlp", optimizer, params)
    x, y = _data((48,))
    kw = dict(iters=4, partitions=1, transport="http", shards=2,
              compress=False)
    want = jax_train_async(jax_obj, x, labels=y, **kw)
    got = train_async(obj, x, labels=y, device="cpu", **kw)
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    assert got.summary["fleet"] == want.summary["fleet"] == {
        "shards": 2, "ring_version": 1, "shard_restarts": 0}
    expected = state_dict_from_flax(_flax_state(want), module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=tol, rtol=tol, err_msg=key)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fleet_single_worker_equals_the_single_server(optimizer):
    # One worker, float32 both ways: per-leaf element-wise steps on
    # three shards give the single server's parameters bit for bit.
    _, obj, _ = _pair("mlp", optimizer, {"lr": 0.05})
    x, y = _data((48,))
    kw = dict(iters=4, partitions=1, transport="http", compress=False,
              device="cpu")
    single = train_async(obj, x, labels=y, **kw)
    sharded = train_async(obj, x, labels=y, shards=3, **kw)
    assert ([r["loss"] for r in sharded.metrics]
            == [r["loss"] for r in single.metrics])
    for key, value in single.params.items():
        torch.testing.assert_close(sharded.params[key], value, atol=0,
                                   rtol=0)


def test_push_every_windows_with_a_remainder():
    _, obj, _ = _pair("mlp")
    x, y = _data((48,), n=64)
    result = train_async(obj, x, labels=y, iters=10, partitions=2,
                         mini_batch=8, push_every=4, device="cpu")
    # Windows of 4, 4 and 2 iterations: three pushes per worker.
    assert result.summary["server_applied"] == 6
    for worker in (0, 1):
        rec = [r for r in result.metrics if r["worker"] == worker]
        assert [r["iter"] for r in rec] == list(range(10))
        assert len({r["t"] for r in rec}) == 3


def test_push_every_matches_jax_on_full_batches():
    jax_obj, obj, module = _pair("mlp")
    x, y = _data((48,))
    want = jax_train_async(jax_obj, x, labels=y, iters=6, partitions=1,
                           push_every=4)
    got = train_async(obj, x, labels=y, iters=6, partitions=1,
                      push_every=4, device="cpu")
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(_flax_state(want), module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=key)


def test_early_stop_fires_where_jax_stops():
    # lr 0: the validation loss never improves, so the stop fires after
    # `patience` windows without improvement.
    jax_obj, obj, _ = _pair("mlp", params={"lr": 0.0})
    x, y = _data((48,), n=40)
    kw = dict(labels=y, iters=20, partitions=1, validation_pct=0.25,
              early_stop_patience=2)
    want = jax_train_async(jax_obj, x, **kw)
    got = train_async(obj, x, device="cpu", **kw)
    assert len(want.metrics) < 20
    assert len(got.metrics) == len(want.metrics)


def test_port_transport_against_jax_server():
    jax_obj, _, _ = _pair("mlp", params={"lr": 0.5})
    server = jax_ps.ParameterServer(jax_obj)
    front = jax_ps.ParamServerHttp(server, port=0).start()
    client = BinaryTransport(front.url, quant=None)
    try:
        assert client.alive()
        version, tree = client.pull(-1)
        assert version == 0 and client.pull(0) is None
        want = jax.device_get(server.get_parameters()[1])
        grads = jax.tree.map(lambda a: np.full_like(a, 0.25), want)
        client.push(grads)
        version, after = client.pull(0)
        assert version == 1
        for layer, leaves in want.items():
            for name, value in leaves.items():
                np.testing.assert_allclose(after[layer][name],
                                           value - 0.5 * 0.25, atol=1e-6)
                np.testing.assert_array_equal(tree[layer][name], value)
        assert client.post_loss(1.0) is False
        assert client.stats["pushes"] == 1 and client.stats["pulls"] == 3
    finally:
        client.close()
        front.stop()
        server.stop()


def test_jax_transport_against_port_server():
    _, obj, module = _pair("mlp", params={"lr": 0.5})
    server = ps.ParameterServer(obj, device="cpu")
    front = ps.ParamServerHttp(server, port=0).start()
    client = JaxBinaryTransport(front.url, quant="bf16")
    try:
        assert client.alive()
        version, tree = client.pull(-1)
        assert version == 0 and client.pull(0) is None
        assert set(tree) == {n for n, _ in module.named_parameters()}
        grads = {k: np.full(v.shape, 0.3, np.float32)
                 for k, v in tree.items()}
        client.push(grads)
        version, after = client.pull(0)
        step = np.float32(np.float32(0.3).astype(ml_dtypes.bfloat16))
        for key, value in tree.items():
            np.testing.assert_allclose(after[key], value - 0.5 * step,
                                       atol=1e-6)
        assert version == 1 and server.applied_updates == 1
        assert client.post_loss(1.0) is False
    finally:
        client.close()
        front.stop()
        server.stop()


def test_estimator_hogwild_mode():
    x, y = _data((4, 4, 3), n=32)
    frame = {"features": list(x.reshape(32, -1)), "label": y.astype(
        np.float32)}
    kw = dict(inputCol="features", labelCol="label", iters=4,
              mode="hogwild", partitions=1)
    # Flat rows: both models reshape them by input_hw.
    jax_model = jax_resnet.ResNet(**TINY_RESNET, input_hw=(4, 4, 3),
                                  block_cls=jax_resnet.ResNetBlock,
                                  compute_dtype=jnp.float32)
    module = resnet.ResNet(**TINY_RESNET, input_hw=(4, 4, 3),
                           block_cls=resnet.ResNetBlock,
                           compute_dtype="float32")
    variables = jax.device_get(jax_model.init(jax.random.key(0),
                                              jnp.zeros((1, 48))))
    module.load_state_dict(state_dict_from_flax(variables, module))
    pkw = dict(criterion="cross_entropy", optimizer="sgd",
               optimizer_params={"lr": 0.05}, input_shape=(48,))
    jax_est = jax_pkg.SparkTorch(
        torchObj=jax_pkg.serialize_torch_obj(jax_model, **pkw), **kw)
    est = port.SparkTorch(torchObj=port.serialize_torch_obj(module, **pkw),
                          device="cpu", **kw)
    want = jax_est.fit(frame).transform(frame, {"useVectorOut": True})
    fitted = est.fit(frame)
    got = fitted.setDevice("cpu").transform(frame, {"useVectorOut": True})
    np.testing.assert_allclose([r["loss"] for r in est._last_metrics],
                               [r["loss"] for r in jax_est._last_metrics],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.stack(got["predictions"]),
                               np.stack(want["predictions"]),
                               atol=1e-4, rtol=1e-4)
    state = fitted.getModel().params
    assert state.keys() == module.state_dict().keys()
    assert any(k.endswith("running_var") for k in state)
    summary = est._last_summary
    assert summary["server_applied"] == summary["hogwild_budget"]["pushes"]


@pytest.mark.parametrize("setting,match", [
    (dict(supervise=True), "supervisor"),
    (dict(ft_policy=object()), "supervisor"),
])
def test_unported_settings_name_the_roadmap(setting, match):
    # Supervision is ported: either setting runs the round's workers
    # under the ft supervisor beside the JAX package's, with the same
    # records and parameters and an empty restart table.
    jax_obj, obj, module = _pair("mlp")
    x, y = _data((48,))
    jax_setting = setting
    if "ft_policy" in setting:
        setting = dict(ft_policy=port.ft.FtPolicy(seed=1))
        jax_setting = dict(ft_policy=jax_pkg.ft.FtPolicy(seed=1))
    want = jax_train_async(jax_obj, x, labels=y, iters=3, partitions=1,
                           **jax_setting)
    got = train_async(obj, x, labels=y, iters=3, partitions=1, device="cpu",
                      **setting)
    for result in (got, want):
        ft_summary = result.summary["ft"]
        assert ft_summary["restarts_total"] == 0
        assert [(r["workers"], r["restarts"], r["failed"])
                for r in ft_summary["rounds"]] == [(1, {}, [])]
    assert match == "supervisor"
    np.testing.assert_allclose([r["loss"] for r in got.metrics],
                               [r["loss"] for r in want.metrics],
                               atol=1e-5, rtol=1e-5)
    expected = state_dict_from_flax(_flax_state(want), module)
    for key, value in got.params.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=key)


# ---------------------------------------------------------------------------
# Telemetry and chaos (the JAX names, the same counts)
# ---------------------------------------------------------------------------

# Names the port's runs do not publish: the JAX trainer arms the stack
# profiler (``profile.*``, which the port's hogwild driver leaves off).
# The workers' health ledgers' ``health.*`` names and the wire's request
# tracer's ``rpctrace.*`` names are compared, with every request
# sampled in both packages (the default 1% would make the name sets a
# matter of chance).
UNPORTED = ("profile.", "xprof.")
# The frame tables name the leaves (Flax paths against state_dict
# names), so the bytes on the wire differ between the packages.
WIRE_BYTES = "param_server.wire_bytes_total"


def _named(snap):
    return {section: {k: (v["count"] if isinstance(v, dict) else v)
                      for k, v in snap[section].items()
                      if not k.startswith(UNPORTED)}
            for section in ("counters", "gauges", "histograms", "spans",
                            "info")}


def settled_snapshot(tele, timeout=5.0):
    """``tele``'s snapshot once its request tracer has stopped counting
    spans: a server handler closes its serve span just after the reply
    the worker is already holding."""
    def spans():
        return sum(v for k, v in tele.snapshot()["counters"].items()
                   if k.startswith("rpctrace.spans_total"))

    last, deadline = spans(), time.monotonic() + timeout
    while time.monotonic() < deadline:
        time.sleep(0.05)
        now = spans()
        if now == last:
            break
        last = now
    return tele.snapshot()


def _http_run(pkg_train, obj, tele, **kw):
    x, y = _data((48,), n=48)
    return pkg_train(obj, x, labels=y, iters=8, partitions=2, push_every=2,
                     seed=0, transport="http", wire="binary",
                     telemetry=tele, **kw)


def test_http_run_telemetry_matches_jax(monkeypatch):
    monkeypatch.setenv("SPARKTORCH_TPU_RPC_SAMPLE", "1.0")
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu_torch import obs

    jax_obj, obj, _ = _pair("mlp")
    jax_tele, tele = jax_obs.Telemetry(run_id="h"), obs.Telemetry(run_id="h")
    want = _http_run(jax_train_async, jax_obj, jax_tele)
    got = _http_run(train_async, obj, tele, device="cpu")
    a, b = (_named(settled_snapshot(tele)),
            _named(settled_snapshot(jax_tele)))
    for section in ("counters", "gauges", "histograms", "spans", "info"):
        assert a[section].keys() == b[section].keys(), section
    assert ({k: v for k, v in a["counters"].items()
             if not k.startswith(WIRE_BYTES)}
            == {k: v for k, v in b["counters"].items()
                if not k.startswith(WIRE_BYTES)})
    assert a["histograms"] == b["histograms"]
    counters = a["counters"]
    pushes = sum(v for k, v in counters.items()
                 if k.startswith("hogwild.pushes"))
    assert counters["param_server.applies"] == pushes == 8.0
    assert got.summary["server_applied"] == got.summary["hogwild_budget"][
        "pushes"] == pushes
    assert counters["hogwild.iters{worker=0}"] == counters[
        "hogwild.iters{worker=1}"] == 8.0
    assert counters["hogwild.rounds"] == 1.0
    assert counters["tracing.annotated_steps"] == 8.0  # one a window
    assert len(want.metrics) == len(got.metrics) == 16


def test_metrics_scrape_of_a_run_equals_its_dump(tmp_path):
    """After an HTTP run, the run's bus served on ``/metrics`` parses to
    the values of its JSONL dump (``tests/test_obs.py``'s check)."""
    import urllib.request

    from sparktorch_tpu_torch import obs

    _, obj, _ = _pair("mlp")
    tele = obs.Telemetry(run_id="scrape")
    _http_run(train_async, obj, tele, device="cpu")
    server = ps.ParameterServer(obj, telemetry=tele, device="cpu")
    http = ps.ParamServerHttp(server, port=0).start()
    try:
        with urllib.request.urlopen(http.url + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"] == obs.PROMETHEUS_CONTENT_TYPE
            scraped = obs.parse_prometheus(r.read().decode())
    finally:
        http.stop()
        server.stop()
    snap = tele.dump(str(tmp_path / "run.jsonl"))
    assert obs.read_jsonl(str(tmp_path / "run.jsonl"))[0]["counters"] == \
        snap["counters"]
    want = obs.parse_prometheus(obs.render_prometheus(snap))
    assert scraped == want
    assert scraped["sparktorch_param_server_applies"] == sum(
        v for k, v in scraped.items()
        if k.startswith("sparktorch_hogwild_pushes")) == 8.0


@pytest.mark.parametrize("config,site", [
    (dict(kill_worker_at={0: 2}), "worker.step"),
    (dict(poison_batch_at={0: 2}), "data.batch"),
    (dict(slow_rank_s={0: (1, 0.001)}), "train.rank"),
], ids=["worker.step", "data.batch", "train.rank"])
def test_worker_chaos_sites_match_jax(config, site):
    from sparktorch_tpu import ft as jax_ft
    from sparktorch_tpu_torch import ft

    jax_obj, obj, _ = _pair("mlp")
    x, y = _data((48,))
    out = {}
    for name, pkg, run in (
            ("jax", jax_ft, lambda: jax_train_async(
                jax_obj, x, labels=y, iters=4, partitions=1)),
            ("port", ft, lambda: train_async(obj, x, labels=y, iters=4,
                                             partitions=1, device="cpu"))):
        with pkg.inject(pkg.ChaosConfig(**config)) as inj:
            if site == "worker.step":
                with pytest.raises(RuntimeError, match="hogwild worker") as e:
                    run()
                assert isinstance(e.value.__cause__, pkg.ChaosKill)
                losses = None
            else:
                losses = [r["loss"] for r in run().metrics]
        out[name] = (inj.events, losses)
    assert out["port"][0] == out["jax"][0]
    assert {e["site"] for e in out["port"][0]} == {site}
    if site == "data.batch":
        for losses in (out["port"][1], out["jax"][1]):
            assert np.isfinite(losses[:2]).all()
            assert np.isnan(losses[2:]).all()
    if site == "train.rank":
        np.testing.assert_allclose(out["port"][1], out["jax"][1],
                                   atol=1e-5, rtol=1e-5)


def _order_last_pull_before_poisoned_push(monkeypatch, chaos_mod,
                                          hogwild_mod, last_step):
    """Worker 0's last pull happens before worker 1's push of
    ``last_step`` (the poisoned one), whatever the thread timing: the
    ``worker.step`` chaos site names each worker thread's step, worker
    0's pull of that step sets an event, and worker 1's push of it
    waits for the event. Else worker 0 may pull the NaN parameters and
    flag its own step."""
    fire = chaos_mod.fire
    where = threading.local()
    pulled = threading.Event()

    def fire_and_note(site, **ctx):
        if site == "worker.step":
            where.worker, where.step = ctx.get("worker"), ctx.get("step")
        return fire(site, **ctx)

    transport = hogwild_mod.LocalTransport
    pull, push = transport.pull, transport.push

    def pull_and_mark(self, have_version):
        snap = pull(self, have_version)
        if (getattr(where, "worker", None), getattr(where, "step", None)) \
                == (0, last_step):
            pulled.set()
        return snap

    def push_after_mark(self, grads):
        if (getattr(where, "worker", None), getattr(where, "step", None)) \
                == (1, last_step):
            assert pulled.wait(timeout=60.0), "worker 0 never pulled"
        return push(self, grads)

    monkeypatch.setattr(chaos_mod, "fire", fire_and_note)
    monkeypatch.setattr(transport, "pull", pull_and_mark)
    monkeypatch.setattr(transport, "push", push_after_mark)


def test_worker_health_ledgers_and_goodput_match_jax(monkeypatch):
    """One health ledger a worker (rank ``w<id>``) on the shared bus: a
    batch poisoned on worker 1 surfaces as w1's anomaly in both
    packages, w0 clean; under each package's goodput ledger the pulls
    are exposed comm, the loads data waits, the windows steps (one
    stamp each) and the drains compute. Worker 0's last pull is
    ordered before worker 1's poisoned push in both runs."""
    from sparktorch_tpu import ft as jax_ft
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu.ft import chaos as jax_chaos
    from sparktorch_tpu.obs import goodput as jax_goodput
    from sparktorch_tpu.obs import health as jax_health
    from sparktorch_tpu.train import hogwild as jax_hogwild
    from sparktorch_tpu_torch import ft, obs
    from sparktorch_tpu_torch.ft import chaos
    from sparktorch_tpu_torch.obs import goodput, health
    from sparktorch_tpu_torch.train import hogwild

    for chaos_mod, hogwild_mod in ((jax_chaos, jax_hogwild),
                                   (chaos, hogwild)):
        _order_last_pull_before_poisoned_push(monkeypatch, chaos_mod,
                                              hogwild_mod, last_step=5)
    jax_obj, obj, _ = _pair("mlp")
    x, y = _data((48,), n=48)
    out = {}
    for name, o, g, h, pkg, run in (
            ("jax", jax_obs, jax_goodput, jax_health, jax_ft,
             lambda t: jax_train_async(jax_obj, x, labels=y, iters=6,
                                       partitions=2, seed=0, telemetry=t)),
            ("port", obs, goodput, health, ft,
             lambda t: train_async(obj, x, labels=y, iters=6, partitions=2,
                                   seed=0, telemetry=t, device="cpu"))):
        tele = o.Telemetry(run_id=name)
        led = g.GoodputLedger(tele, rank=0)
        with led.activate(), pkg.inject(pkg.ChaosConfig(
                poison_batch_at={1: 5}), telemetry=tele):
            run(tele)
        merged = h.merge_sections({"driver": tele.get_section("health")})
        doc = led.snapshot()
        out[name] = (
            sorted((a["rank"], a["akind"], a["step"])
                   for a in merged["anomalies"]),
            {r: d["steps_ingested"] for r, d in merged["per_rank"].items()},
            {b for b, v in doc["buckets"].items() if v > 0} - {"idle"},
            doc["n_steps"], doc["lanes"], len(led.skew.snapshot()["stamps"]))
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == [("w1", "nonfinite", 5)]
    assert out["port"][2] >= {"compute", "exposed_comm", "data_wait"}
    assert out["port"][2] <= out["jax"][2] | {"compute"}
    assert out["port"][3:] == (12, 2, 12)
