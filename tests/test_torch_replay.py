"""Bitwise replay of the port's health bundles (``obs/replay.py``).

A port fit writes a bundle (the JAX package's format: ``.json`` meta and
``.npz`` leaves, plus the state's names and the process's deterministic
settings) and ``python -m sparktorch_tpu_torch.obs.replay`` re-runs the
step in a fresh process: every recorded metric's float32 bits must come
back, for a NaN step and for a finite loss spike (two steps from their
anchor). As in the JAX package, a drifted checksum raises and a missing
or altered metric fails the replay.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparktorch_tpu_torch.obs import Telemetry, health, replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fit(tmp_path, poison_at=None, **cfg):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.models import Net
    from sparktorch_tpu_torch.train.sync import train_distributed

    torch.manual_seed(0)
    # The JAX bench's health drill: Net, MSE, Adam 1e-2 (net_builder).
    obj = serialize_torch_obj(Net(), criterion="mse", optimizer="adam",
                              optimizer_params={"lr": 1e-2},
                              input_shape=(10,))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 10)).astype(np.float32)
    y = x.sum(1).astype(np.float32)
    tele = Telemetry()
    config = health.HealthConfig(
        replay_dir=str(tmp_path),
        replay_builder="sparktorch_tpu_torch.obs.replay:net_builder",
        replay_builder_kwargs={"device": "cpu"}, **cfg)
    prev = health.install(health.TrainHealthLedger(config=config,
                                                   telemetry=tele))
    try:
        with inject(ChaosConfig(poison_batch_at={0: poison_at}
                                if poison_at is not None else {})):
            train_distributed(obj, x, labels=y, iters=8, steps_per_call=1,
                              telemetry=tele, device="cpu")
    finally:
        health.install(prev)
    return tele.get_section("health")["ranks"]["0"]["replay"]["bundles"]


def _cli(meta):
    return subprocess.run(
        [sys.executable, "-m", "sparktorch_tpu_torch.obs.replay", meta],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT + os.pathsep
             + os.environ.get("PYTHONPATH", "")})


def test_nan_bundle_replays_bitwise_in_a_fresh_process(tmp_path):
    bundles = _fit(tmp_path, poison_at=5, replay_max_bundles=1)
    assert [os.path.basename(b) for b in bundles] == \
        ["replay_step000005_r0.json"]
    meta = json.load(open(bundles[0]))
    assert meta["kind"] == "health_replay" and meta["anchor_step"] == 5
    assert meta["state_keys"][0].startswith("model.")
    assert any(k.startswith("optim.") for k in meta["state_keys"])
    assert meta["bad"]["finite"]["bits"] == 0
    proc = _cli(bundles[0])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bitwise reproduction over 1 step(s)" in proc.stdout


def test_finite_spike_replays_bitwise_over_two_steps(tmp_path):
    # A spike limit below every loss: the first judged step (1) is a
    # finite "loss_spike", two steps past the step-0 anchor's state.
    bundles = _fit(tmp_path, spike_factor=0.0, spike_min_delta=-1e9,
                   warmup_steps=1, replay_max_bundles=1)
    meta = json.load(open(bundles[0]))
    assert meta["akind"] == "loss_spike"
    assert (meta["step"], meta["anchor_step"]) == (1, 0)
    assert all(np.isfinite(v["value"]) for v in meta["bad"].values())
    proc = _cli(bundles[0])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "over 2 step(s)" in proc.stdout


def test_drifted_checksum_and_missing_metric_fail(tmp_path):
    (path,) = _fit(tmp_path, poison_at=3, replay_max_bundles=1)
    bundle = replay.load_bundle(path)
    assert replay.replay_bundle(bundle)["match"]

    drifted = replay.load_bundle(path)
    drifted["arrays"]["state_0"] = drifted["arrays"]["state_0"] + 1.0
    with pytest.raises(ValueError, match="param checksum mismatch"):
        replay.replay_bundle(drifted)

    missing = replay.load_bundle(path)
    missing["meta"]["bad"]["bogus"] = {"value": 1.0, "bits": 0x3F800000,
                                       "dtype": "float32"}
    result = replay.replay_bundle(missing)
    assert not result["match"]
    assert result["compared"]["bogus"]["replayed_bits"] is None

    flipped = json.load(open(path))
    flipped["bad"]["finite"]["bits"] = 1
    with open(path, "w") as f:
        json.dump(flipped, f)
    assert replay.main([path]) == 1
    with pytest.raises(ValueError, match="builder"):
        replay.resolve_builder("no_colon")
