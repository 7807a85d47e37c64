"""The weight path's copies on the CPU: host copies of device trees
(``net.transport.tree_to_host``), the side-stream block they and weight
installs use (``utils.streams.copy_stream``), and full pulls received
into a caller's buffer (``BinaryTransport.pull(into=)``, which a
``WeightPuller`` keeps from pull to pull). Trees, dtypes and values come
back as they were, and an installed weight never aliases the buffer.
Their card behaviour is in ``tests/test_torch_cuda_fleet.py``."""

import time

import numpy as np
import pytest
import torch

from sparktorch_tpu_torch import serialize_torch_obj
from sparktorch_tpu_torch.ft import ChaosConfig, inject
from sparktorch_tpu_torch.models import ClassificationNet
from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.net.transport import BinaryTransport, tree_to_host
from sparktorch_tpu_torch.obs import Telemetry
from sparktorch_tpu_torch.serve.infer import InferenceReplica, WeightPuller
from sparktorch_tpu_torch.serve.param_server import (ParameterServer,
                                                      ParamServerHttp)
from sparktorch_tpu_torch.utils.streams import copy_stream


def test_tree_to_host_keeps_the_tree_and_dtypes():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    tree = {"a": torch.from_numpy(w), "b": {"c": torch.arange(5),
                                            "d": torch.ones(2, dtype=torch.bfloat16)},
            ("p", "q"): torch.tensor(2.5), "e": np.float32(1.5)}
    host = tree_to_host(tree)
    assert set(host) == set(tree) and set(host["b"]) == {"c", "d"}
    np.testing.assert_array_equal(host["a"], w)  # exact: a copy, no cast
    assert host["b"]["c"].dtype == np.int64
    assert isinstance(host["b"]["d"], torch.Tensor)
    assert host["b"]["d"].dtype == torch.bfloat16
    assert host[("p", "q")].shape == () and host[("p", "q")] == 2.5
    assert isinstance(host["e"], np.ndarray)


def test_copy_stream_runs_the_block_as_it_is_off_cuda():
    dst = torch.zeros(4)
    with copy_stream("cpu"):
        dst.copy_(torch.arange(4.0))
    np.testing.assert_array_equal(dst.numpy(), [0.0, 1.0, 2.0, 3.0])


@pytest.fixture()
def served():
    torch.manual_seed(0)
    payload = serialize_torch_obj(
        ClassificationNet(n_classes=2), criterion="cross_entropy",
        optimizer="sgd", optimizer_params={"lr": 0.1}, input_shape=(10,))
    server = ParameterServer(payload, device="cpu")
    http = ParamServerHttp(server, port=0).start()
    try:
        yield server, http
    finally:
        http.stop()
        server.stop()


def test_pull_into_a_buffer_equals_a_plain_pull(served):
    server, http = served
    plain, into = (BinaryTransport(http.url, quant=None) for _ in range(2))
    buf = np.zeros(1 << 20, np.uint8)
    try:
        v, want = plain.pull(-1)
        v2, got = into.pull(-1, into=lambda n: buf)
        assert v2 == v and set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])  # exact
            assert np.shares_memory(got[k], buf)
        assert into.stats["pull_bytes"] == plain.stats["pull_bytes"]
        assert into.pull(v, into=lambda n: buf) is None  # a 304
    finally:
        plain.close()
        into.close()


def test_a_torn_pull_into_a_buffer_raises(served):
    _, http = served
    transport = BinaryTransport(http.url, quant=None)
    buf = np.zeros(1 << 20, np.uint8)
    try:
        with inject(ChaosConfig(truncate_pull_frames=1)):
            with pytest.raises(wire.WireError):
                transport.pull(-1, into=lambda n: buf)
        assert transport.pull(-1, into=lambda n: buf) is not None
    finally:
        transport.close()


def test_installed_weights_do_not_alias_the_pull_buffer(served):
    """Each full pull lands in the puller's one buffer; the install
    copies out of it, so overwriting it changes no served weight."""
    server, http = served
    tele = Telemetry(run_id="t_pull_buffer")
    x = np.random.default_rng(1).normal(0, 1, (8, 10)).astype(np.float32)
    _, params0 = server.slot.read()
    rep = InferenceReplica(ClassificationNet(n_classes=2), params0,
                           replica_id="0", telemetry=tele, buckets=(8,),
                           warm_input=x, device="cpu")
    puller = WeightPuller(rep, BinaryTransport(http.url, quant=None),
                          poll_s=0.02, telemetry=tele).start()
    try:
        for step in range(1, 3):
            server.push_gradients({k: torch.ones_like(v)
                                   for k, v in params0.items()}, wait=True)
            deadline = time.monotonic() + 10.0
            while rep.params_version < step and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rep.params_version == step
        puller.stop()
        _, want = server.slot.read()
        served_before = rep.infer(x)
        puller._buf.numpy()[:] = 0xFF  # what the next pull would do
        for k, v in rep.predictor.module.state_dict().items():
            if k in want:
                assert torch.equal(v, want[k]), k
        np.testing.assert_array_equal(rep.infer(x), served_before)
    finally:
        puller.stop()
        rep.stop()
