"""The sharded fleet's client half in both packages: the hash ring, delta
pulls over the wire, and ``ShardedTransport`` against either package's
fleet.

The ring must give the JAX package's owner for every path; each
package's ``BinaryTransport.pull_delta`` and ``ShardedTransport`` read
the other's shards. Servers bind port 0 and every fleet and transport
closes in a ``finally``.
"""

import time

import numpy as np
import pytest
import torch

from sparktorch_tpu.net import sharded as jax_sharded
from sparktorch_tpu.net.transport import BinaryTransport as JaxBinaryTransport
from sparktorch_tpu_torch import serialize_torch_obj
from sparktorch_tpu_torch.models import Net
from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.net.sharded import (
    HashRing,
    HttpFleetView,
    ShardedTransport,
    StaticFleetView,
)
from sparktorch_tpu_torch.net.transport import BinaryTransport, TransportError
from sparktorch_tpu_torch.obs import Telemetry
from sparktorch_tpu_torch.serve.fleet import ParamServerFleet


def _paths(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        depth = int(rng.integers(1, 4))
        out.append(tuple(f"k{int(rng.integers(0, 10_000))}.{j}"
                         for j in range(depth)) + (f"leaf{i}",))
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
def test_ring_owners_equal_the_jax_ring(n_shards):
    # 1,000 seeded paths; owners and assignments equal, exactly, and
    # again after an add and after a remove.
    paths = _paths()
    ring, want = HashRing(range(n_shards)), jax_sharded.HashRing(
        range(n_shards))
    for step in ("start", "add", "remove"):
        assert [ring.owner(p) for p in paths] == [want.owner(p)
                                                   for p in paths], step
        assert ring.assignment(paths) == want.assignment(paths), step
        assert ring.shard_ids == want.shard_ids
        if step == "start":
            ring.add(n_shards)
            want.add(n_shards)
        elif step == "add":
            ring.remove(0)
            want.remove(0)


def test_ring_moves_only_the_changed_arcs():
    paths = _paths(400, seed=1)
    ring = HashRing(range(4))
    owners = {p: ring.owner(p) for p in paths}
    ring.add(4)
    moved = {p for p in paths if ring.owner(p) != owners[p]}
    assert 0 < len(moved) < len(paths) // 2
    assert all(ring.owner(p) == "4" for p in moved)
    with pytest.raises(ValueError):
        ring.add(4)
    with pytest.raises(ValueError):
        HashRing().owner(("x",))


def _payload(optimizer="adam", lr=5e-3):
    torch.manual_seed(0)
    return serialize_torch_obj(Net(), criterion="mse", optimizer=optimizer,
                               optimizer_params={"lr": lr},
                               input_shape=(10,))


def _ones(tree):
    return {k: np.ones(np.asarray(v).shape, np.float32)
            for k, v in tree.items()}


def _assembled(fleet):
    return {k: v.numpy() for k, v in fleet.assemble().items()}


def test_sharded_transport_scatters_and_pulls_deltas():
    tele = Telemetry(run_id="fleet_sg")
    fleet = ParamServerFleet(_payload(), n_shards=3, telemetry=tele,
                             device="cpu").start()
    t = ShardedTransport(fleet, telemetry=tele, run_id=tele.run_id)
    try:
        version, params = t.pull(-1)
        want = _assembled(fleet)
        assert sorted(params) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(params[k], want[k])
        assert t.pull(version) is None  # every shard said 304
        # From scratch, a caller gets the cached tree on all-304s.
        assert t.pull(-1)[0] == version
        t.push(_ones(params))
        fleet.drain()
        owners = [s for s in fleet._shards.values() if s.slot.paths]
        assert fleet.applied_updates == len(owners)
        version2, params2 = t.pull(version)
        assert version2 > version
        full_bytes = t.stats["pull_bytes"]
        # A sparse push: the next delta ships only that leaf.
        hot = sorted(want)[0]
        fleet.scatter_push({(hot,): np.ones(want[hot].shape, np.float32)})
        fleet.drain()
        before = t.stats["pull_bytes"]
        _, params3 = t.pull(version2)
        assert 0 < t.stats["pull_bytes"] - before < full_bytes / 2
        now = _assembled(fleet)
        for k in now:
            np.testing.assert_array_equal(params3[k], now[k])
        counters = tele.snapshot()["counters"]
        for shard in owners:
            key = ("param_server.wire_bytes_total"
                   f"{{dir=tx,route=/delta.bin,shard={shard.shard_id}}}")
            assert counters.get(key, 0) > 0, (key, sorted(counters))
    finally:
        t.close()
        fleet.stop()


def test_push_residuals_follow_the_leaf_across_a_drain():
    # int8 pushes with error feedback: sum(applied) + residual equals
    # the sum of the raw gradients for every leaf, the leaves a drain
    # moved to another shard included (the store is keyed by path).
    lr = 0.1
    rng = np.random.default_rng(7)
    fleet = ParamServerFleet(_payload("sgd", lr), n_shards=2,
                             device="cpu").start()
    t = ShardedTransport(fleet, quant="int8")
    try:
        _, init = t.pull(-1)
        init = {k: np.array(v) for k, v in init.items()}

        def grads():
            return {k: (np.pi * rng.normal(1.0, 0.3, v.shape)).astype(
                np.float32) for k, v in init.items()}

        owned0 = [p[0] for p in t._ring.assignment(
            [(k,) for k in init])["0"]]
        assert owned0, "shard 0 owns no leaf: the drain moves nothing"
        g1 = grads()
        t.push(g1)
        fleet.drain()
        fleet.drain_shard("0")
        t.pull(-1)  # learns the new ring
        assert "0" not in t._clients
        g2 = grads()
        t.push(g2)
        fleet.drain()
        final = _assembled(fleet)
        for k in init:
            applied = (init[k].astype(np.float64) - final[k]) / lr
            raw = g1[k].astype(np.float64) + g2[k]
            resid = np.asarray(t._push_residuals.get((k,), 0.0), np.float64)
            # float32 parameter rounding over two steps.
            np.testing.assert_allclose(applied + resid, raw, atol=5e-5,
                                       err_msg=k)
        assert any(np.abs(t._push_residuals[(k,)]).max() > 1e-6
                   for k in owned0)
    finally:
        t.close()
        fleet.stop()


def test_grace_window_degrades_then_fails():
    fleet = ParamServerFleet(_payload(), n_shards=2, device="cpu",
                             restart_shards=False).start()
    tele = Telemetry()
    t = ShardedTransport(fleet, grace_s=0.3, telemetry=tele)
    try:
        version, params = t.pull(-1)
        fleet.kill_shard("1")
        # Inside the window: the shard's leaves freeze, its partial is
        # dropped and counted, the worker goes on.
        t.pull(version)
        t.push(_ones(params))
        st = t.stats
        assert st["shard_failures"] >= 2 and st["pushes_skipped"] >= 1
        time.sleep(0.4)
        with pytest.raises(TransportError, match="grace"):
            t.pull(version)
        assert tele.counter_value("sharded_shard_failures_total",
                                  {"shard": "1", "op": "pull"}) >= 1
    finally:
        t.close()
        fleet.stop()


def test_unsynced_shard_fails_the_pull_loudly():
    fleet = ParamServerFleet(_payload(), n_shards=2, device="cpu",
                             restart_shards=False).start()
    t = ShardedTransport(fleet, grace_s=0.5)
    try:
        fleet.kill_shard("0")
        with pytest.raises(TransportError, match="first sync"):
            t.pull(-1)
    finally:
        t.close()
        fleet.stop()


def test_epoch_change_resyncs_the_shard():
    # A shard whose slot is rebuilt (a new epoch) is pulled again from
    # -1, counted on sharded_epoch_resyncs_total.
    fleet = ParamServerFleet(_payload(), n_shards=2, device="cpu").start()
    tele = Telemetry()
    t = ShardedTransport(fleet, telemetry=tele)
    try:
        version, _ = t.pull(-1)
        shard = fleet._shards["1"]
        shard.slot.epoch += 1
        shard.slot.swap_leaves({})  # the version moves too
        assert t.pull(version) is not None
        assert tele.counter_value("sharded_epoch_resyncs_total",
                                  {"shard": "1"}) == 1
        assert t._clients["1"].epoch == shard.slot.epoch
    finally:
        t.close()
        fleet.stop()


def test_fleet_json_discovery_and_static_view():
    fleet = ParamServerFleet(_payload(), n_shards=3, device="cpu").start()
    view = HttpFleetView(fleet.gateway_url)
    try:
        doc = view.describe()
        assert doc["shards"] == fleet.urls() and doc["ring_version"] == 1
        t = ShardedTransport(view)
        s = ShardedTransport(StaticFleetView(fleet.urls()))
        try:
            got, want = t.pull(-1)[1], s.pull(-1)[1]
            for k, v in _assembled(fleet).items():
                np.testing.assert_array_equal(got[k], v)
                np.testing.assert_array_equal(want[k], v)
        finally:
            t.close()
            s.close()
    finally:
        view.close()
        fleet.stop()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_jax_delta_client_reads_a_port_shard(quant):
    fleet = ParamServerFleet(_payload(), n_shards=2, device="cpu").start()
    jt = JaxBinaryTransport(fleet.urls()["0"], quant=None)
    pt = BinaryTransport(fleet.urls()["0"], quant=None)
    try:
        got, mine = jt.pull_delta(-1, quant=quant), pt.pull_delta(
            -1, quant=quant)
        assert got["epoch"] == mine["epoch"] == fleet._shards["0"].slot.epoch
        assert got["ring_version"] == mine["ring_version"] == 1
        assert got["version"] == mine["version"] == 0
        assert got["leaf_versions"] == mine["leaf_versions"]
        assert got["nbytes"] == mine["nbytes"]
        want = dict(fleet._shards["0"].slot.read_leaves()[1])
        assert set(got["leaves"]) == set(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got["leaves"][path],
                                          mine["leaves"][path])
            # int8: within half a quantization step of the leaf.
            tol = (0 if quant is None
                   else np.abs(leaf.numpy()).max() / 127 / 2 + 1e-7)
            np.testing.assert_allclose(got["leaves"][path], leaf.numpy(),
                                       atol=tol, rtol=0)
        assert not jt.pull_delta(0)["fresh"]
        # The JAX ShardedTransport drives the port's whole fleet.
        js = jax_sharded.ShardedTransport(fleet, pull_quant=quant)
        try:
            _, tree = js.pull(-1)
            assert sorted(tree) == sorted(_assembled(fleet))
            js.push(_ones(tree))
            fleet.drain()
            assert fleet.applied_updates >= 1
        finally:
            js.close()
    finally:
        jt.close()
        pt.close()
        fleet.stop()


def test_port_delta_client_reads_a_jax_shard():
    from sparktorch_tpu import serialize_torch_obj as jax_serialize
    from sparktorch_tpu.models import Net as JaxNet
    from sparktorch_tpu.serve.fleet import ParamServerFleet as JaxFleet

    fleet = JaxFleet(jax_serialize(JaxNet(), criterion="mse",
                                   optimizer="sgd",
                                   optimizer_params={"lr": 0.1},
                                   input_shape=(10,)), n_shards=2).start()
    pt = BinaryTransport(fleet.urls()["1"], quant=None)
    t = ShardedTransport(fleet, pull_quant="int8")
    try:
        res = pt.pull_delta(-1)
        _v, leaves, vers = fleet._shards["1"].slot.read_leaves()
        assert res["fresh"] and res["leaf_versions"] == vers
        assert res["epoch"] == fleet._shards["1"].slot.epoch
        for path, leaf in leaves.items():
            np.testing.assert_array_equal(res["leaves"][path],
                                          np.asarray(leaf))
        assert not pt.pull_delta(res["version"])["fresh"]
        version, tree = t.pull(-1)
        flat = dict(wire.flatten_tree(tree))
        assert set(flat) == {p for p, _ in jax_sharded.wire.flatten_tree(
            fleet.assemble())}
        t.push(tree)
        fleet.drain()
        assert t.pull(version) is not None
    finally:
        pt.close()
        t.close()
        fleet.stop()
