"""The sharded parameter-server fleet in both packages: the versioned
slot, a shard's delta bodies, the fleet's parameters after the same
pushes, the gateway, the serving puller's delta paths and
``train_async(shards=N)``.

Both fleets start from the parameters the JAX package initialises for
its seed (carried into the port's module by ``convert``). Servers bind
port 0 and every fleet and transport closes in a ``finally``.
"""

import types

import jax
import numpy as np
import optax
import pytest
import torch

from sparktorch_tpu import serialize_torch_obj as jax_serialize
from sparktorch_tpu.ft import ChaosConfig as JaxChaosConfig
from sparktorch_tpu.ft import inject as jax_inject
from sparktorch_tpu.models import ClassificationNet as JaxClassificationNet
from sparktorch_tpu.models import Net as JaxNet
from sparktorch_tpu.net import wire as jax_wire
from sparktorch_tpu.net.transport import BinaryTransport as JaxBinaryTransport
from sparktorch_tpu.obs import Telemetry as JaxTelemetry
from sparktorch_tpu.serve import fleet as jax_fleet
from sparktorch_tpu.serve import infer as jax_infer
from sparktorch_tpu.serve import param_server as jax_ps
from sparktorch_tpu.train.hogwild import train_async as jax_train_async
from sparktorch_tpu.utils.locks import TreeVersionedSlot as JaxSlot
from sparktorch_tpu.utils.serde import deserialize_model
from sparktorch_tpu_torch import serialize_torch_obj
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.ft import ChaosConfig, inject
from sparktorch_tpu_torch.models import ClassificationNet, Net
from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.net.transport import BinaryTransport
from sparktorch_tpu_torch.obs import Telemetry
from sparktorch_tpu_torch.serve import fleet
from sparktorch_tpu_torch.serve.infer import WeightPuller
from sparktorch_tpu_torch.serve.param_server import (
    ParameterServer,
    ParamServerHttp,
)
from sparktorch_tpu_torch.train.hogwild import train_async
from sparktorch_tpu_torch.utils.locks import TreeVersionedSlot


def _pair(optimizer, params):
    """The JAX payload, the port's payload on the JAX init, the Flax
    variables, the port module and ``{flax path: port name}``."""
    kw = dict(criterion="mse", optimizer=optimizer, optimizer_params=params,
              input_shape=(10,))
    jax_obj = jax_serialize(JaxNet(), **kw)
    variables = jax.device_get(deserialize_model(jax_obj).init_params(
        jax.random.key(0)))
    module = Net()
    module.load_state_dict(state_dict_from_flax(variables, module))
    flat = jax_wire.flatten_tree(variables["params"])
    # Each leaf tagged by its index: the port name it lands on.
    tagged = state_dict_from_flax({"params": jax_wire.unflatten_tree(
        [(p, np.full(np.shape(a), i + 1, np.float32))
         for i, (p, a) in enumerate(flat)])}, module)
    names = {flat[int(v.flatten()[0]) - 1][0]: k for k, v in tagged.items()}
    return jax_obj, serialize_torch_obj(module, **kw), variables, module, \
        names


def _grads(variables, rng, paths=None):
    flat = jax_wire.flatten_tree(variables["params"])
    return jax_wire.unflatten_tree(
        [(p, rng.standard_normal(np.shape(a)).astype(np.float32))
         for p, a in flat if paths is None or p in paths])


def _port_grads(g, names, module):
    """The port's ``{(name,): grad}`` for a (partial) Flax grad tree."""
    flat = dict(jax_wire.flatten_tree(g))
    out = {}
    for path, value in flat.items():
        name = names[path]
        like = module.state_dict()[name]
        t = torch.from_numpy(np.asarray(value))
        out[(name,)] = (t.T if t.dim() == 2 else t).reshape(like.shape)
    return out


def test_tree_versioned_slot_matches_jax():
    ops = [("swap_leaves", {("a",): 5.0}), ("swap", None),
           ("remove_leaves", [("b", "c")]), ("swap_leaves", {("d",): 1.0})]
    a = TreeVersionedSlot({("a",): 0.0, ("b", "c"): 1.0}, epoch=3)
    b = JaxSlot({("a",): 0.0, ("b", "c"): 1.0}, epoch=3)
    for op, arg in ops:
        if op == "swap":
            arg = {"a": 2.0, "b": {"c": 3.0}}
        out = getattr(a, op)(arg), getattr(b, op)(arg)
        assert out[0] == out[1], op
        for have in (-1, 0, 1, 2):
            assert a.read_delta(have) == b.read_delta(have), (op, have)
        assert a.read() == b.read() and a.read_leaves() == b.read_leaves()
    assert a.epoch == b.epoch == 3
    assert TreeVersionedSlot().epoch != TreeVersionedSlot().epoch


def _mini_leaves():
    rng = np.random.default_rng(0)
    return {("w",): rng.standard_normal(256).astype(np.float32),
            ("b",): rng.standard_normal(8).astype(np.float32)}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_shard_delta_bodies_equal_the_jax_shards(quant):
    # Three versions (a sparse push, then a dense one) with int8 error
    # feedback: the bodies equal the JAX shard's byte for byte. SGD at
    # a power-of-two rate keeps both updates exact, so the leaves agree
    # to the bit.
    leaves = _mini_leaves()
    mine = fleet.ParamShardServer(
        "0", leaves,
        make_optimizer=lambda ps, shapes: torch.optim.SGD(ps, lr=0.125),
        device="cpu")
    want = jax_fleet.ParamShardServer(
        "0", leaves,
        make_tx=lambda: optax.sgd(0.125), device=jax.devices("cpu")[0])
    rng = np.random.default_rng(1)
    pushes = [{("w",): rng.standard_normal(256).astype(np.float32)},
              {("w",): rng.standard_normal(256).astype(np.float32),
               ("b",): rng.standard_normal(8).astype(np.float32)}]
    try:
        bodies = []
        for step in range(3):
            for have in (-1, step - 1):
                got = mine.render_delta(have, quant=quant, run_tag=5)
                ref = want.render_delta(have, quant=quant, run_tag=5)
                assert got == ref, (step, have)
                bodies.append(got[1])
            if step < 2:
                mine.push_gradients(pushes[step])
                want.push_gradients(pushes[step])
        assert mine.render_delta(2, quant=quant) == (2, None)
        _, flat, vers = wire.decode_delta(bodies[-1])
        assert vers == {("w",): 2, ("b",): 2} and set(flat) == set(vers)
        # Version 1 touched w only: its delta ships w alone.
        _, flat1, _ = wire.decode_delta(bodies[3])
        assert set(flat1) == {("w",)}
        if quant == "int8":
            for p in (("w",), ("b",)):
                np.testing.assert_array_equal(mine._pull_residuals[p],
                                              want._pull_residuals[p])
    finally:
        mine.stop()
        want.stop()


def _fleet_pair(optimizer, params, n_shards=3):
    jax_obj, obj, variables, module, names = _pair(optimizer, params)
    return (jax_fleet.ParamServerFleet(jax_obj, n_shards=n_shards,
                                       devices=jax.devices("cpu")),
            fleet.ParamServerFleet(obj, n_shards=n_shards, device="cpu"),
            variables, module, names)


@pytest.mark.parametrize("optimizer,params,tol,migrate", [
    ("sgd", {"lr": 0.1}, 1e-5, False),
    ("adam", {"lr": 1e-2}, 1e-4, False),
    ("adam", {"lr": 1e-2}, 1e-4, True),
])
def test_fleet_parameters_match_the_jax_fleet(optimizer, params, tol,
                                              migrate):
    # Dense and sparse pushes of the same gradients (per-leaf optimizer
    # state: a sparse push steps only its leaves, and Adam's bias
    # correction uses each leaf's own count). With ``migrate``, a shard
    # is added and another drained between pushes: the moments move
    # with their leaves, or the parameters would part.
    want_fleet, got_fleet, variables, module, names = _fleet_pair(
        optimizer, params)
    rng = np.random.default_rng(1)
    paths = [p for p, _ in jax_wire.flatten_tree(variables["params"])]
    sparse = [paths[:1], paths[1:3], None, paths[2:], None]
    try:
        for step, subset in enumerate(sparse):
            g = _grads(variables, rng, subset)
            want_fleet.scatter_push(
                dict(jax_wire.flatten_tree(g)), wait=True)
            got_fleet.scatter_push(_port_grads(g, names, module), wait=True)
            if migrate and step == 1:
                assert want_fleet.add_shard() == got_fleet.add_shard()
            if migrate and step == 3:
                want_fleet.drain_shard("1")
                got_fleet.drain_shard("1")
        want, _ = want_fleet.final_state()
        got, _ = got_fleet.final_state()
        if migrate:
            # Every leaf's moments sit beside it on its current shard.
            for shard in got_fleet._shards.values():
                for path in shard.slot.paths:
                    p = shard._master[path]
                    assert set(shard._opt.state[p]) >= {"exp_avg",
                                                        "exp_avg_sq"}
            assert got_fleet.ring_version == 3
    finally:
        want_fleet.stop()
        got_fleet.stop()
    ref = state_dict_from_flax({"params": jax.device_get(want)}, module)
    assert set(got) == set(ref)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   atol=tol, rtol=tol, err_msg=name)


def _gateway_script(fl, push, pull, n_owners):
    """One scripted conversation with a fleet's gateway; the observables
    each package must agree on, with the version steps checked here."""
    seen = []
    r = pull(-1)
    seen.append((r["fresh"], len(r["leaves"])))
    have = r["version"]
    seen.append((pull(have)["fresh"], 0))
    push("sparse")
    r = pull(have)
    assert r["version"] == have + 1
    seen.append((r["fresh"], len(r["leaves"])))
    have = r["version"]
    push("dense")
    r = pull(have, quant="int8")
    assert r["version"] == have + n_owners()
    seen.append((r["fresh"], len(r["leaves"])))
    have = r["version"]
    fl.drain_shard(fl.ring.shard_ids[0])
    r = pull(have)
    assert r["version"] >= have  # monotonic through the drain
    have = r["version"] if r["fresh"] else have
    fl.add_shard()
    r = pull(have)
    assert r["version"] >= have  # and through the add
    have = r["version"] if r["fresh"] else have
    seen.append((pull(have)["fresh"], 0))
    return seen


def test_gateway_versions_and_304s_behave_as_jax():
    want_fleet, got_fleet, variables, module, names = _fleet_pair(
        "sgd", {"lr": 0.1})
    want_fleet.start()
    got_fleet.start()
    jt = JaxBinaryTransport(want_fleet.gateway_url, quant=None)
    pt = BinaryTransport(got_fleet.gateway_url, quant=None)
    rng = np.random.default_rng(2)
    paths = [p for p, _ in jax_wire.flatten_tree(variables["params"])]
    try:
        grads = {"sparse": _grads(variables, rng, paths[:1]),
                 "dense": _grads(variables, rng)}

        def owners(fl):
            return lambda: sum(bool(s.slot.paths)
                               for s in fl._shards.values())

        want = _gateway_script(
            want_fleet,
            lambda k: want_fleet.scatter_push(
                dict(jax_wire.flatten_tree(grads[k]))),
            lambda have, quant=None: jt.pull_delta(have, quant=quant),
            owners(want_fleet))
        got = _gateway_script(
            got_fleet,
            lambda k: got_fleet.scatter_push(
                _port_grads(grads[k], names, module)),
            lambda have, quant=None: pt.pull_delta(have, quant=quant),
            owners(got_fleet))
        assert got == want == [(True, 4), (False, 0), (True, 1), (True, 4),
                               (False, 0)]
        # The legacy full-pull route: the composite version, a 304 when
        # current, the whole tree.
        version, tree = pt.pull(-1)
        assert version == got_fleet._gateway.server.slot.version
        assert pt.pull(version) is None and sorted(tree) == sorted(
            module.state_dict())
    finally:
        jt.close()
        pt.close()
        want_fleet.stop()
        got_fleet.stop()


class _Replica:
    """The replica surface a puller uses: the bus, the labels, installs."""

    def __init__(self, telemetry):
        self.telemetry = telemetry
        self._labels = {"replica": "0"}
        self.replica_id = "0"
        self.installs = []

    def install_params(self, tree, version=None):
        self.installs.append((version, sorted(
            "/".join(p) for p, _ in jax_wire.flatten_tree(tree))))


class _Scripted:
    """A delta transport whose replies are a script (the epoch changes
    at the third reply)."""

    def __init__(self):
        self.replies = [
            {"fresh": True, "version": 3, "epoch": 1,
             "leaves": {("a",): np.ones(2)}},
            {"fresh": False, "epoch": 1},
            {"fresh": False, "epoch": 2},
            {"fresh": True, "version": 1, "epoch": 2,
             "leaves": {("a",): np.zeros(2), ("b",): np.ones(1)}},
        ]
        self.haves = []

    def pull_delta(self, have, quant=None):
        self.haves.append(have())
        return self.replies.pop(0)


def _serve_counters(tele):
    return {k: v for k, v in tele.snapshot()["counters"].items()
            if k.startswith("serve.")}


def test_weight_puller_delta_fallback_and_resync_count_as_jax():
    jax_obj, obj, variables, module, names = _pair("sgd", {"lr": 0.1})
    results = {}
    # Delta pulls from each package's fleet gateway.
    for pkg in ("jax", "port"):
        tele = JaxTelemetry() if pkg == "jax" else Telemetry()
        rep = _Replica(tele)
        if pkg == "jax":
            fl = jax_fleet.ParamServerFleet(jax_obj, n_shards=2).start()
            puller = jax_infer.WeightPuller(
                rep, JaxBinaryTransport(fl.gateway_url, quant=None))
            push = lambda: fl.scatter_push(  # noqa: E731
                dict(jax_wire.flatten_tree(_grads(
                    variables, np.random.default_rng(0)))))
        else:
            fl = fleet.ParamServerFleet(obj, n_shards=2,
                                        device="cpu").start()
            puller = WeightPuller(
                rep, BinaryTransport(fl.gateway_url, quant=None),
                quant="int8")
            push = lambda: fl.scatter_push(_port_grads(  # noqa: E731
                _grads(variables, np.random.default_rng(0)), names,
                module))
        try:
            polls = [puller.poll_once(), puller.poll_once()]
            push()
            polls.append(puller.poll_once())
        finally:
            puller.stop()
            fl.stop()
        results[pkg] = (polls, puller._use_delta, len(rep.installs),
                        len(rep.installs[-1][1]), _serve_counters(tele))
    assert results["port"] == results["jax"]
    assert results["port"][0] == [True, False, True]

    # A server without /delta.bin: one 404, then full pulls for good.
    for pkg in ("jax", "port"):
        tele = JaxTelemetry() if pkg == "jax" else Telemetry()
        rep = _Replica(tele)
        if pkg == "jax":
            server = jax_ps.ParameterServer(jax_obj)
            http = jax_ps.ParamServerHttp(server, port=0).start()
            puller = jax_infer.WeightPuller(
                rep, JaxBinaryTransport(http.url, quant=None))
        else:
            server = ParameterServer(obj, device="cpu")
            http = ParamServerHttp(server, port=0).start()
            puller = WeightPuller(rep, BinaryTransport(http.url, quant=None))
        try:
            polls = [puller.poll_once(), puller.poll_once()]
        finally:
            puller.stop()
            http.stop()
            server.stop()
        results[pkg] = (polls, puller._use_delta, puller.version,
                        _serve_counters(tele))
    assert results["port"] == results["jax"] == (
        [True, False], False, 0, {"serve.weight_updates_total{replica=0}":
                                  1.0})

    # An epoch change clears the cache and pulls everything again.
    for pkg in ("jax", "port"):
        tele = JaxTelemetry() if pkg == "jax" else Telemetry()
        rep, t = _Replica(tele), _Scripted()
        puller = (jax_infer.WeightPuller if pkg == "jax" else WeightPuller)(
            rep, t)
        polls = [puller.poll_once(), puller.poll_once(), puller.poll_once()]
        results[pkg] = (polls, t.haves, rep.installs, puller.version,
                        _serve_counters(tele))
    assert results["port"] == results["jax"]
    assert results["port"][4]["serve.weight_epoch_resyncs_total{replica=0}"] \
        == 1


def _clf_data():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 1, (60, 10)),
                        rng.normal(2, 1, (60, 10))]).astype(np.float32)
    y = np.concatenate([np.zeros(60), np.ones(60)]).astype(np.float32)
    return x, y


def _clf(pkg):
    kw = dict(criterion="cross_entropy", optimizer="adam",
              optimizer_params={"lr": 5e-3}, input_shape=(10,))
    if pkg == "jax":
        return jax_serialize(JaxClassificationNet(n_classes=2), **kw)
    torch.manual_seed(0)
    return serialize_torch_obj(ClassificationNet(n_classes=2), **kw)


@pytest.mark.parametrize("wire_fmt,pull_quant", [("binary", "int8"),
                                                 ("binary", None),
                                                 ("dill", None)])
def test_train_async_on_a_fleet_keeps_exact_records(wire_fmt, pull_quant):
    x, y = _clf_data()
    tele = Telemetry(run_id="fleet_train")
    result = train_async(_clf("port"), x, labels=y, iters=8, partitions=2,
                         seed=0, transport="http", shards=2, wire=wire_fmt,
                         pull_quant=pull_quant, telemetry=tele, device="cpu")
    assert len(result.metrics) == 16
    assert sorted({r["worker"] for r in result.metrics}) == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in result.metrics)
    assert result.summary["fleet"] == {"shards": 2, "ring_version": 1,
                                       "shard_restarts": 0}
    assert result.summary["server_applied"] > 0
    assert sorted(result.params) == sorted(ClassificationNet().state_dict())


def test_shard_kill_restarts_and_fires_the_jax_events():
    # One worker: its requests to shard 1 come in a fixed order, so the
    # kill lands on the same request in both packages.
    x, y = _clf_data()
    events, fleets = {}, {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            tele = JaxTelemetry(run_id="fleet_kill")
            with jax_inject(JaxChaosConfig(kill_shard_at={1: 4}),
                            telemetry=tele) as inj:
                result = jax_train_async(_clf(pkg), x, labels=y, iters=6,
                                         partitions=1, seed=0,
                                         transport="http", shards=3,
                                         telemetry=tele)
        else:
            tele = Telemetry(run_id="fleet_kill")
            with inject(ChaosConfig(kill_shard_at={1: 4}),
                        telemetry=tele) as inj:
                result = train_async(_clf(pkg), x, labels=y, iters=6,
                                     partitions=1, seed=0,
                                     transport="http", shards=3,
                                     telemetry=tele, device="cpu")
        assert len(result.metrics) == 6
        events[pkg] = [{k: e[k] for k in ("site", "shard")}
                       for e in inj.events]
        fleets[pkg] = result.summary["fleet"]
        assert tele.histogram("fleet.shard_recovery_latency_s")["count"] >= 1
        assert tele.snapshot()["counters"].get(
            "fleet.shard_restarts_total{shard=1}", 0) >= 1
    assert events["port"] == events["jax"] == [{"site": "fleet.shard",
                                                "shard": "1"}]
    assert fleets["port"]["shard_restarts"] >= 1
    assert fleets["jax"]["shard_restarts"] >= 1


def test_a_hung_up_client_leaves_no_traceback(capsys):
    """A kill closes connections under live requests: the handler's
    write then fails with a connection error, which the frontend drops;
    any other handler error still prints its traceback."""
    from http.server import BaseHTTPRequestHandler

    from sparktorch_tpu_torch.serve.param_server import _KeepAliveHTTPServer

    httpd = _KeepAliveHTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    try:
        for exc in (BrokenPipeError(32, "Broken pipe"),
                    ConnectionResetError(104, "reset"), ValueError("bug")):
            try:
                raise exc
            except Exception:
                httpd.handle_error(None, ("127.0.0.1", 1))
    finally:
        httpd.server_close()
    err = capsys.readouterr().err
    assert "BrokenPipeError" not in err and "ConnectionResetError" not in err
    assert "ValueError: bug" in err


def test_unported_fleet_paths_raise_and_name_their_item():
    _, obj, *_ = _pair("sgd", {"lr": 0.1})
    fl = fleet.ParamServerFleet(obj, n_shards=2, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="item 10"):
            fl.scatter_push({}, trace_ctx=object())
        with pytest.raises(NotImplementedError, match="item 10"):
            fl._shards["0"].push_gradients({}, trace_ctx=object())
    finally:
        fl.stop()
    with pytest.raises(ValueError, match="transport='http'"):
        train_async(obj, np.zeros((4, 10), np.float32),
                    labels=np.zeros(4, np.float32), shards=2,
                    device="cpu")
    with pytest.raises(ValueError, match="pull_quant"):
        from sparktorch_tpu_torch.net.sharded import ShardedTransport

        ShardedTransport(types.SimpleNamespace(describe=dict),
                         pull_quant="bf16")
