"""Mixture-of-experts models and the optax-only optimizers on the card: the checks of ``chip_smoke.py``'s moe phase.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy, the port and ``chip_smoke``, so it runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_moe.py -q
"""

import sys
from pathlib import Path

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
def test_routing_logits_and_a_step_match_the_cpu(card):
    # moe_card_parity raises unless the MoE layer routes every token as
    # on the CPU, the logits and one step's loss agree, and the expert
    # Function's gradients match autograd through the plain einsums.
    out = chip_smoke.moe_card_parity(torch)
    assert out["top1"]["routing_flips"] == out["top2"]["routing_flips"] == 0
    assert out["expert_grad_max_abs_err"] <= 1e-4


@pytest.mark.cuda
def test_optax_only_optimizers_match_the_cpu(card):
    diffs = chip_smoke.moe_optimizers(torch)
    assert set(diffs) == {"adafactor", "lamb", "lion", "rmsprop"}
    assert max(diffs.values()) <= 1e-5


@pytest.mark.cuda
def test_bench_moe_lm_record(card):
    from sparktorch_tpu_torch import bench

    chip_smoke.reset_counts()
    rec = bench.bench_moe_lm()
    jax_keys, omitted, added = bench.RECORD_KEYS["moe_lm"]
    assert set(rec) == (jax_keys - omitted) | added
    assert rec["tokens_per_sec_per_chip"] > 0
    assert rec["moe_vs_dense_step_ratio"] > 0
    assert chip_smoke.read_counts() == chip_smoke.bench_counts("moe_lm", rec)
