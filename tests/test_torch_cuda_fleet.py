"""The sharded parameter-server fleet on the card: shards holding their leaves on CUDA, a one-worker run against the single server, int8 delta pulls into a serving replica, and a shard kill.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy and the port, so it runs on a machine without
jax:

    python -m pytest --noconftest tests/test_torch_cuda_fleet.py -q
"""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _payload(optimizer="adam"):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import ClassificationNet

    torch.manual_seed(0)
    return serialize_torch_obj(ClassificationNet(n_classes=2),
                               criterion="cross_entropy",
                               optimizer=optimizer,
                               optimizer_params={"lr": 5e-3},
                               input_shape=(10,))


def _data():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 1, (60, 10)),
                        rng.normal(2, 1, (60, 10))]).astype(np.float32)
    y = np.concatenate([np.zeros(60), np.ones(60)]).astype(np.int64)
    return x, y


@pytest.mark.cuda
def test_shards_keep_their_leaves_on_the_card(card):
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet

    fleet = ParamServerFleet(_payload(), n_shards=3).start()
    t = ShardedTransport(fleet, pull_quant="int8")
    try:
        for shard in fleet._shards.values():
            assert shard.device.type == "cuda"
            for leaf in shard.slot.read_leaves()[1].values():
                assert leaf.device.type == "cuda"
        version, tree = t.pull(-1)
        t.push({k: np.ones(np.shape(v), np.float32) for k, v in tree.items()})
        fleet.drain()
        version2, tree2 = t.pull(version)
        assert version2 > version
        want = {k: v.cpu().numpy() for k, v in fleet.assemble().items()}
        for k, v in want.items():
            # int8 pulls: within one quantization step of the leaf.
            step = np.abs(v).max() / 127 + 1e-7
            np.testing.assert_allclose(tree2[k], v, atol=step, rtol=0)
    finally:
        t.close()
        fleet.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_one_worker_on_a_fleet_equals_the_single_server(card, optimizer):
    from sparktorch_tpu_torch.train.hogwild import train_async

    x, y = _data()
    kw = dict(iters=6, partitions=1, transport="http", compress=False,
              seed=0)
    single = train_async(_payload(optimizer), x, labels=y, **kw)
    sharded = train_async(_payload(optimizer), x, labels=y, shards=4, **kw)
    assert len(sharded.metrics) == 6
    for key, value in single.params.items():
        scale = max(1.0, float(value.abs().max()))
        torch.testing.assert_close(sharded.params[key], value,
                                   atol=1e-6 * scale, rtol=0)


@pytest.mark.cuda
def test_replica_pulls_int8_deltas_from_the_fleet(card):
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.models import ClassificationNet
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.serve.infer import InferenceReplica, WeightPuller

    x = _data()[0]
    fleet = ParamServerFleet(_payload("sgd"), n_shards=4).start()
    tele = Telemetry()
    torch.manual_seed(1)
    module = ClassificationNet(n_classes=2)
    replica = InferenceReplica(module, telemetry=tele, buckets=(1, 8),
                               warm_input=x[:1], device=card)
    puller = WeightPuller(replica, ShardedTransport(fleet,
                                                    pull_quant="int8"))
    try:
        assert puller.poll_once()
        fleet.scatter_push({k: torch.ones_like(v)
                            for k, v in fleet.assemble().items()})
        assert puller.poll_once() and not puller.poll_once()
        installed = {k: torch.as_tensor(np.asarray(v))
                     for k, v in dict(
                         (p[0], a) for p, a in
                         puller.transport._leaves.items()).items()}
        module.load_state_dict(installed)
        want = BatchPredictor(module, device=card, chunk=8).predict(x[:8])
        got = replica.infer(x[:8])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert replica.params_version == puller.version
    finally:
        puller.stop()
        replica.stop()
        fleet.stop()


@pytest.mark.cuda
def test_shard_kill_on_the_card_keeps_every_record(card):
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.hogwild import train_async

    x, y = _data()
    tele = Telemetry(run_id="card_fleet_kill")
    with inject(ChaosConfig(kill_shard_at={1: 4}), telemetry=tele) as inj:
        result = train_async(_payload(), x, labels=y, iters=10,
                             partitions=2, seed=0, transport="http",
                             shards=4, pull_quant="int8", telemetry=tele)
    assert [e["site"] for e in inj.events] == ["fleet.shard"]
    assert len(result.metrics) == 20
    assert result.summary["fleet"]["shard_restarts"] >= 1
    assert all(np.isfinite(r["loss"]) for r in result.metrics)


@pytest.mark.cuda
def test_weight_copies_off_a_busy_stream_are_exact(card):
    """A render's host copy and an install's load run on a side stream:
    each must still see what the default stream wrote before it, and an
    install must not be overwritten by the module copy it loads into."""
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.net.transport import tree_to_host

    x = torch.zeros(1 << 20, device=card)
    torch.cuda._sleep(50_000_000)  # keeps the default stream busy
    x.add_(1.0)
    host = tree_to_host({"x": x, "h": {"b": x.to(torch.bfloat16)}})
    assert np.all(host["x"] == 1.0)
    assert host["h"]["b"].dtype == torch.bfloat16
    assert torch.all(host["h"]["b"] == 1.0)

    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                 torch.nn.Linear(64, 8))
    other = {k: torch.randn_like(v) for k, v in module.state_dict().items()}
    pred = BatchPredictor(module, device=card)
    before = {k: v.clone() for k, v in pred.module.state_dict().items()}
    old = pred.module
    torch.cuda._sleep(50_000_000)
    pred.update_params(other)
    for k, v in pred.module.state_dict().items():
        assert torch.equal(v.cpu(), other[k]), k
    for k, v in old.state_dict().items():
        assert torch.equal(v, before[k]), k
