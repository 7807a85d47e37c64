"""The health lane, its replay, the trace analyzer and the shards' int8 pulls on the card.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy and the port, so it runs on a machine without
jax:

    python -m pytest --noconftest tests/test_torch_cuda_health.py -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(10, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 1))


def _xy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 10)).astype(np.float32)
    return x, x.sum(1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_health_vector_on_the_card_matches_the_cpu(card, optimizer):
    # The same weights, batch and step on the card and on the CPU:
    # finite bits equal, update ratio and per-parameter grad norms
    # within 1e-4 relative.
    from sparktorch_tpu_torch.train.step import health_buffer, train_step
    from sparktorch_tpu_torch.train.sync import _build_trainer
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    x, y = _xy()
    out = {}
    for dev in (torch.device("cpu"), card):
        spec = ModelSpec(module=_mlp(), loss="mse", optimizer=optimizer,
                         optimizer_params={"lr": 1e-2})
        module, opt, loss_fn = _build_trainer(spec, spec, dev)
        batch = DataBatch(torch.from_numpy(x).to(dev),
                          torch.from_numpy(y).to(dev),
                          torch.ones(len(x), device=dev))
        m = train_step(module, loss_fn, opt, batch,
                       health_buf=health_buffer(module))
        out[dev.type] = (float(m.health.finite),
                         float(m.health.update_ratio),
                         m.health.leaf_norms.cpu().numpy())
    assert out["cuda"][0] == out["cpu"][0] == 1.0
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)


@pytest.mark.cuda
def test_replay_is_bitwise_on_the_card(card, tmp_path):
    # A finite loss spike (a limit below every loss) on the card, two
    # steps past its anchor, replayed in a fresh process on the card.
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.obs import Telemetry, health
    from sparktorch_tpu_torch.train.sync import train_distributed

    from sparktorch_tpu_torch.models import Net

    x, y = _xy()
    torch.manual_seed(0)
    obj = serialize_torch_obj(Net(), criterion="mse", optimizer="adam",
                              optimizer_params={"lr": 1e-2},
                              input_shape=(10,))
    tele = Telemetry()
    cfg = health.HealthConfig(
        replay_dir=str(tmp_path), replay_max_bundles=1, warmup_steps=1,
        spike_factor=0.0, spike_min_delta=-1e9,
        replay_builder="sparktorch_tpu_torch.obs.replay:net_builder",
        replay_builder_kwargs={"device": "cuda"})
    prev = health.install(health.TrainHealthLedger(config=cfg,
                                                   telemetry=tele))
    try:
        train_distributed(obj, x, labels=y, iters=4, steps_per_call=1,
                          telemetry=tele, device="cuda")
    finally:
        health.install(prev)
    (meta,) = tele.get_section("health")["ranks"]["0"]["replay"]["bundles"]
    assert json.load(open(meta))["akind"] == "loss_spike"
    proc = subprocess.run(
        [sys.executable, "-m", "sparktorch_tpu_torch.obs.replay", meta],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bitwise reproduction over 2 step(s)" in proc.stdout


@pytest.mark.cuda
def test_profile_run_analyses_a_cuda_fit(card, tmp_path):
    # The steps are the device projections of the train_step ranges,
    # one per annotated step; one card, no collective.
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.sync import train_distributed

    x, y = _xy()
    obj = serialize_torch_obj(_mlp(), criterion="mse", optimizer="adam")
    tele = Telemetry()
    train_distributed(obj, x, labels=y, iters=4, steps_per_call=1,
                      telemetry=tele, profile_dir=str(tmp_path),
                      device="cuda")
    doc = tele.get_section("xprof")
    assert doc["n_steps"] == doc["n_markers"] == 4 == \
        tele.counter_value("tracing.annotated_steps")
    assert doc["comm_s"] == 0 and doc["compute_s"] > 0
    assert all(s["compute_s"] <= s["wall_s"] for s in doc["steps"])


@pytest.mark.cuda
def test_int8_quantization_on_the_card_is_the_hosts_byte_for_byte(card):
    # Two rounds of error feedback: the card's int8 bodies, scales and
    # residuals against quantize_leaf_int8 on the host copies.
    from sparktorch_tpu_torch.net import wire

    rng = np.random.default_rng(0)
    shapes = [(1000,), (64, 33), (7,), (3, 5, 2)]
    host_res = [None] * len(shapes)
    card_res = [None] * len(shapes)
    for _ in range(2):
        values = [(rng.standard_normal(s) * rng.uniform(1e-3, 1e3))
                  .astype(np.float32) for s in shapes]
        got = wire.quantize_leaves_int8_on_card(
            [torch.from_numpy(v).to(card) for v in values], card_res)
        for i, (v, (qleaf, residual)) in enumerate(zip(values, got)):
            want, host_res[i] = wire.quantize_leaf_int8(v, host_res[i])
            assert qleaf.data.dtype == np.int8
            assert qleaf.data.tobytes() == want.data.tobytes()
            assert qleaf.scale == want.scale
            assert residual.is_cuda
            assert residual.cpu().numpy().tobytes() == host_res[i].tobytes()
            card_res[i] = residual


@pytest.mark.cuda
def test_card_values_read_in_batches_equal_host_values(card):
    """A ledger fed 0-d card tensors (read back READ_BATCH notes at a
    time, in one copy) ends with the same doc as one fed the same
    values on the host, the NaN step and its lags included."""
    from sparktorch_tpu_torch.obs import health
    from sparktorch_tpu_torch.obs.telemetry import Telemetry

    def strip(doc):
        if isinstance(doc, dict):
            return {k: strip(v) for k, v in doc.items()
                    if k not in ("ts", "started_ts")}
        if isinstance(doc, list):
            return [strip(v) for v in doc]
        if isinstance(doc, float) and doc != doc:
            return "nan"
        return doc

    losses = [2.0 - 0.01 * i for i in range(40)]
    losses[12] = float("nan")
    losses[20] = 50.0
    docs = []
    for on_card in (False, True):
        led = health.TrainHealthLedger(
            rank="r", telemetry=Telemetry(run_id="batches"),
            config=health.HealthConfig(publish_interval_s=1e9))
        for loss in losses:
            v = torch.tensor(loss, device=card if on_card else "cpu")
            leaf = torch.arange(3.0, device=v.device) + v
            led.note_step(device={"loss": v, "grad_norm": v * 0 + 1.0,
                                  "finite": torch.isfinite(v).float(),
                                  "leaf_norms": leaf.bfloat16()})
        led.flush()
        docs.append(strip(led.snapshot()))
    assert docs[0] == docs[1]
    assert [a["akind"] for a in docs[1]["anomalies"]][:2] == [
        "nonfinite", "loss_spike"]
