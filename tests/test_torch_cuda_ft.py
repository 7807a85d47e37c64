"""The ft supervisor and the control plane on the card: a supervised LM hogwild run through the flash and CE kernels under a worker kill, and a ``ctl.worker`` child on the card SIGKILLed and restarted.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy and the port, so it runs on a machine without
jax:

    python -m pytest --noconftest tests/test_torch_cuda_ft.py -q

A spawned child imports this module to unpickle its callable.
"""

import os
import time

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _policy():
    from sparktorch_tpu_torch.ft import FtPolicy, RestartPolicy

    return FtPolicy(restart=RestartPolicy(max_restarts=2,
                                          backoff_base_s=0.05), seed=0)


@pytest.mark.cuda
def test_supervised_lm_hogwild_recovers_from_a_kill_on_the_card(card):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        TransformerConfig,
    )
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.ops.flash_attention import flash_attention
    from sparktorch_tpu_torch.ops.fused_ce import fused_ce_forward
    from sparktorch_tpu_torch.train.hogwild import train_async

    torch.manual_seed(0)
    cfg = TransformerConfig(vocab_size=1024, d_model=128, n_heads=2,
                            n_layers=2, d_ff=256, max_len=256,
                            attn_impl="flash")
    payload = serialize_torch_obj(CausalLM(cfg), criterion="cross_entropy",
                                  optimizer="adamw",
                                  optimizer_params={"lr": 1e-3})
    ids = np.random.default_rng(0).integers(0, 1024, (2, 257))
    x, y = ids[:, :-1].astype(np.float32), ids[:, 1:]
    tele = Telemetry(run_id="cuda_ft")
    flash_attention.launches = fused_ce_forward.launches = 0
    with inject(ChaosConfig(kill_worker_at={0: 2}, seed=0),
                telemetry=tele) as inj:
        result = train_async(payload, x, labels=y, iters=5, seed=0,
                             supervise=True, ft_policy=_policy(),
                             telemetry=tele, device="cuda")
    assert inj.events == [{"site": "worker.step", "worker": 0, "step": 2}]
    assert result.summary["ft"]["restarts_total"] == 1
    assert len(result.metrics) == 5
    # The killed attempt computed 2 steps, the rerun 5.
    assert fused_ce_forward.launches == 7
    assert flash_attention.launches > 0
    assert result.summary["server_applied"] == 7
    assert [r["version"] for r in result.metrics] == list(range(2, 7))
    losses = [r["loss"] for r in result.metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    latency = tele.histogram("ft_recovery_latency_s", labels={"worker": "0"})
    assert latency["count"] == 1 and latency["max"] < 10.0


def _card_work(out_dir, n):
    """A dill-shipped callable: a product on the card per step, an
    idempotent output file per step, progress on the heartbeat."""

    def work(ctx):
        import torch

        a = torch.ones(512, 512, device="cuda")
        for step in range(n):
            if ctx.should_stop():
                return
            ctx.notify_step(step)
            path = os.path.join(out_dir, f"p{step}.done")
            if os.path.exists(path):
                continue
            value = float((a @ a).sum())
            with open(path + ".tmp", "w") as f:
                f.write(f"{ctx.name}:{value}:{torch.cuda.get_device_name(0)}")
            os.replace(path + ".tmp", path)
            time.sleep(0.2)

    return work


@pytest.mark.cuda
def test_ctl_worker_child_on_the_card_is_sigkilled_and_restarted(card,
                                                                 tmp_path):
    from sparktorch_tpu_torch.ctl import EXIT_OK, spawn_worker
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.ft.supervisor import Supervisor
    from sparktorch_tpu_torch.obs import Telemetry

    out, hb = str(tmp_path / "out"), str(tmp_path / "hb")
    os.makedirs(out)
    tele = Telemetry(run_id="cuda_ctl")
    handles = []

    def start(attempt):
        handles.append(spawn_worker(_card_work(out, 5), rank=0,
                                    heartbeat_dir=hb, name=f"c{attempt}",
                                    telemetry=tele))
        return handles[-1]

    sup = Supervisor(policy=_policy(), telemetry=tele)
    sup.add("card", start, rank=0)
    with inject(ChaosConfig(kill_process_at={0: 2}, seed=0),
                telemetry=tele) as inj:
        summary = sup.run(poll_interval_s=0.05, deadline_s=240)
    assert summary["restarts"] == {"card": 1}
    assert [e["site"] for e in inj.events] == ["ctl.process"]
    assert [h.process.returncode for h in handles] == [-9, EXIT_OK]
    assert sorted(os.listdir(out)) == [f"p{i}.done" for i in range(5)]
    done = [open(os.path.join(out, f"p{i}.done")).read().split(":")
            for i in range(5)]
    assert {d[0] for d in done} == {"c0", "c1"}
    assert all(float(d[1]) == 512.0 ** 3 for d in done)
    assert {d[2] for d in done} == {torch.cuda.get_device_name(0)}
    assert tele.counter_value("ft_restarts_total",
                              labels={"worker": "card"}) == 1
    for h in handles:
        h.cleanup()
