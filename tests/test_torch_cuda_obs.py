"""The obs and chaos hooks on the card, at a small size: a traced LM fit whose ``train_step`` ranges bracket the kernels, a hogwild run's ``/metrics`` scrape, and a seeded kill.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy, the port and ``chip_smoke``, so it runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_obs.py -q
"""

import os
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

# A small causal LM through the five training kernels: bf16 flash
# attention (head dim 32) with remat, and the fused CE.
TINY = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128,
            max_len=256, remat=True, attn_impl="flash")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lm(seed=0):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    torch.manual_seed(seed)
    payload = serialize_torch_obj(CausalLM(TransformerConfig(**TINY)),
                                  criterion="cross_entropy",
                                  optimizer="adamw",
                                  optimizer_params={"lr": 1e-3})
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                               (2, TINY["max_len"] + 1))
    return payload, ids[:, :-1].astype(np.float32), ids[:, 1:]


def _per_step(steps):
    layers = TINY["n_layers"]
    return dict(flash_fwd=2 * layers * steps, flash_bwd_dq=layers * steps,
                flash_bwd_dkv=layers * steps, ce_fwd=steps, ce_bwd=steps)


@pytest.mark.cuda
def test_traced_fit_brackets_the_kernels(card, tmp_path):
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.sync import train_distributed

    payload, x, y = _lm()
    kw = dict(labels=y, iters=3, steps_per_call=1, device="cuda")
    train_distributed(payload, x, **dict(kw, iters=1))  # builds, warms
    tele = Telemetry(run_id="traced")
    chip_smoke.reset_counts()
    traced = train_distributed(payload, x, telemetry=tele,
                               profile_dir=str(tmp_path), **kw)
    assert chip_smoke.read_counts() == _per_step(3)
    (name,) = os.listdir(tmp_path)
    ranges, inside, outside = chip_smoke.step_kernel_launches(
        str(tmp_path / name))
    snap = tele.snapshot()
    assert ranges == snap["counters"]["tracing.annotated_steps"] == 3
    assert inside == _per_step(3)
    assert not any(outside.values())
    assert snap["counters"]["train.steps"] == 3
    assert snap["counters"]["train.examples"] == sum(
        r["examples"] for r in traced.metrics)
    assert snap["counters"]["tracing.profile_runs"] == 1
    plain = train_distributed(payload, x, **kw)
    a = np.asarray([r["loss"] for r in traced.metrics])
    b = np.asarray([r["loss"] for r in plain.metrics])
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.cuda
def test_hogwild_scrape_equals_the_dump(card):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.obs import (
        Telemetry,
        parse_prometheus,
        render_prometheus,
    )
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )
    from sparktorch_tpu_torch.train.hogwild import train_async

    torch.manual_seed(0)
    payload = serialize_torch_obj(MnistMLP(), criterion="cross_entropy",
                                  optimizer="adam",
                                  optimizer_params={"lr": 1e-3},
                                  input_shape=(784,))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (512, 784)).astype(np.float32)
    y = rng.integers(0, 10, 512).astype(np.int32)
    tele = Telemetry(run_id="hogwild")
    result = train_async(payload, x, labels=y, iters=16, mini_batch=64,
                         push_every=4, partitions=2, transport="http",
                         wire="binary", telemetry=tele, device="cuda")
    server = ParameterServer(payload, telemetry=tele, device="cuda")
    http = ParamServerHttp(server, port=0).start()
    try:
        with urllib.request.urlopen(http.url + "/metrics", timeout=30) as r:
            scraped = parse_prometheus(r.read().decode())
    finally:
        http.stop()
        server.stop()
    snap = tele.snapshot()
    assert scraped == parse_prometheus(render_prometheus(snap))
    pushes = sum(v for k, v in snap["counters"].items()
                 if k.startswith("hogwild.pushes"))
    assert snap["counters"]["param_server.applies"] == pushes == 8
    assert result.summary["hogwild_budget"]["pushes"] == pushes


@pytest.mark.cuda
def test_a_seeded_kill_fires_at_its_step(card):
    from sparktorch_tpu_torch.ft import ChaosConfig, ChaosKill, inject
    from sparktorch_tpu_torch.train.sync import train_distributed

    payload, x, y = _lm()
    records = []
    chip_smoke.reset_counts()
    with inject(ChaosConfig(kill_worker_at={0: 2})) as inj:
        with pytest.raises(ChaosKill):
            train_distributed(payload, x, labels=y, iters=4,
                              steps_per_call=1, device="cuda",
                              metrics_hook=records.append)
    assert inj.events == [{"site": "worker.step", "worker": 0, "step": 2}]
    assert [r["iter"] for r in records] == [0, 1]
    assert chip_smoke.read_counts() == _per_step(2)
