"""Per-request RPC tracing on the card: traced requests through a serving tier of BERT-base with the flash kernel, and traced int8 delta pulls from a fleet whose shards hold their leaves on CUDA, one shard slowed.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy and the port, so it runs on a machine without
jax:

    python -m pytest --noconftest tests/test_torch_cuda_rpc.py -q
"""

import time

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shape(node):
    return (node["name"], node["kind"],
            tuple(sorted(_shape(c) for c in node["children"])))


@pytest.mark.cuda
def test_traced_requests_through_a_bert_tier(card):
    """Each traced request is one infer -> replica -> {queue_wait,
    execute} tree; the flash kernel runs 12 times a batch the trace
    shows; the rows equal an untraced run's bit for bit."""
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.obs import Telemetry, rpctrace
    from sparktorch_tpu_torch.ops.flash_attention import flash_attention
    from sparktorch_tpu_torch.serve.router import InferenceTier

    torch.manual_seed(0)
    with torch.device("cuda"):
        module = bert_base(attn_impl="flash")
    ids = np.random.default_rng(0).integers(
        0, module.config.vocab_size, (8, 128)).astype(np.int64)
    tele = Telemetry(run_id="cuda_rpc")
    tracer = rpctrace.tracer_for(tele)
    tracer.sample_rate = 1.0
    tier = InferenceTier(module, n_replicas=2, telemetry=tele,
                         buckets=(1, 8), warm_input=ids[:1], device="cuda")
    try:
        flash_attention.launches = 0
        traced = [tier.submit(ids[i:i + 1]) for i in range(len(ids))]
        launches = flash_attention.launches
        deadline = time.monotonic() + 10.0
        while len(tracer.spans) < 4 * len(ids) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        spans = tracer.spans
        tracer.sample_rate = -1.0
        untraced = [tier.submit(ids[i:i + 1]) for i in range(len(ids))]
    finally:
        tier.stop()
    trees = rpctrace.stitch_spans(spans)
    assert len(trees) == len(ids)
    assert {_shape(t["root"]) for t in trees} == {
        ("infer", "client", (("replica", "client", (
            ("execute", "server", ()), ("queue_wait", "server", ()))),))}
    for t in trees:
        hop = t["root"]["children"][0]
        assert t["wall_s"] >= max(c["dur_s"] for c in hop["children"])
    batches = {(s["ann"]["replica"], s["ts"]) for s in spans
               if s["name"] == "execute"}
    assert launches == module.config.n_layers * len(batches)
    for a, b in zip(traced, untraced):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_slowed_shard_bounds_a_traced_delta_pull(card):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.models import ClassificationNet
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry, rpctrace
    from sparktorch_tpu_torch.obs import timeline
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet

    torch.manual_seed(0)
    payload = serialize_torch_obj(ClassificationNet(n_classes=2),
                                  criterion="cross_entropy", optimizer="sgd",
                                  optimizer_params={"lr": 1e-2},
                                  input_shape=(10,))
    tele = Telemetry(run_id="cuda_rpc_fleet")
    rpctrace.tracer_for(tele).sample_rate = 1.0
    fleet = ParamServerFleet(payload, n_shards=4, telemetry=tele).start()
    t = ShardedTransport(fleet, pull_quant="int8", telemetry=tele)
    collector = None
    try:
        version = t.pull(-1)[0]
        ones = {(n,): torch.ones_like(v) for n, v in fleet.assemble().items()}
        fleet.scatter_push(ones, wait=True)
        with inject(ChaosConfig(seed=0, slow_shard_s={"1": 0.3})):
            t.pull(version)
        time.sleep(0.1)
        collector = FleetCollector.for_fleet(fleet, poll_interval_s=0)
        collector.poll()
        traces = [tr for tr in collector.rpc_traces()
                  if tr["root"]["name"] == "pull"]
        rendered = timeline.render_rpc_report(traces)
    finally:
        t.close()
        if collector is not None:
            collector.stop()
        fleet.stop()
    assert len(traces) == 2
    hop = ("shard_pull", "client", (
        ("serve", "server", (("render", "server", ()),)),))
    assert {_shape(tr["root"]) for tr in traces} == {
        ("pull", "client", (hop,) * 4)}
    assert str(traces[0]["critical"]["shard"]) == "1"
    assert "bound by: shard_pull, shard 1" in rendered
