"""The online serving tier on the card: a two-replica tier with a chaos kill, and the flash forward kernel at the tier's bucket shapes.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy, the port and ``chip_smoke``, so it runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_serve.py -q
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tier_survives_a_chaos_kill_with_zero_drops(card):
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.ft.policy import FtPolicy, RestartPolicy
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.models import ClassificationNet
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.router import InferenceTier

    torch.manual_seed(0)
    module = ClassificationNet(n_classes=2)  # f32, as the bench's
    x = np.random.default_rng(0).normal(0, 1, (64, 10)).astype(np.float32)
    want = BatchPredictor(module, device=card, chunk=32).predict(x)
    tele = Telemetry(run_id="card_kill")
    tier = InferenceTier(module, n_replicas=2, telemetry=tele,
                         ft_policy=FtPolicy(restart=RestartPolicy(
                             backoff_base_s=0.02, backoff_max_s=0.1)),
                         buckets=(1, 8, 32), warm_input=x[:1],
                         probe_interval_s=0.05, device=card)
    try:
        assert tier.replicas["0"].predictor.device.type == "cuda"
        tele.observe("serve.request_latency_s", 0.5, labels={"replica": "0"})
        with inject(ChaosConfig(kill_replica_at={1: 4}),
                    telemetry=tele) as inj:
            got = np.concatenate([tier.submit(x[i:i + 1], deadline_s=30.0)
                                  for i in range(len(x))])
        assert len([e for e in inj.events
                    if e["site"] == "serve.replica"]) == 1
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        deadline = time.monotonic() + 15.0
        while (tele.counter_value("router.readmissions_total",
                                  {"replica": "1"}) < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        for name in ("router.evictions_total", "serve.replica_restarts_total",
                     "router.readmissions_total"):
            labels = {"replica": "1"}
            if name == "router.evictions_total":
                labels["reason"] = "error"
            assert tele.counter_value(name, labels) >= 1, name
    finally:
        tier.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_flash_forward_at_the_bucket_shapes(card, batch):
    from sparktorch_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device=card).manual_seed(batch)
    qkv = torch.randn((batch, chip_smoke.SERVE_SEQ, 3, 12, 64),
                      generator=gen, device=card, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)  # strided views, as the model gives them
    before = flash_attention.launches
    with torch.inference_mode():
        got = flash_attention(q, k, v, False)
        want = flash_attention_reference(q, k, v, False)
    assert flash_attention.launches == before + 1
    chip_smoke.check_close(f"bucket b={batch}", got, want,
                           *chip_smoke.TOL["bfloat16"])
    chip_smoke.check_tiles(torch, f"bucket b={batch}", got, want,
                           chip_smoke.TILE_TOL["bfloat16"])
