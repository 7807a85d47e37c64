"""Data-parallel training on the card: the two checks of ``chip_smoke.py``'s DP phase.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy, the port and ``chip_smoke``, so it runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_dp.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return chip_smoke.dp_world_of_one(torch)


@pytest.mark.cuda
def test_nccl_world_of_one_equals_the_fit_without_a_group(world_of_one):
    # dp_world_of_one raises unless the losses and every parameter equal
    # the fit without a process group bit for bit.
    (losses, params), info = world_of_one
    assert info["bitwise_equal"] and len(losses) == chip_smoke.DP_STEPS
    assert all(torch.isfinite(v).all() for v in params.values())


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_the_world_of_one(world_of_one):
    result = chip_smoke.dp_gloo_pair(torch, world_of_one[0])
    assert result["max_abs_diff"] <= result["limit"]
