"""The port's flash-attention gradients against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain forward and
backward under its ``torch.autograd.Function``; the JAX side takes
``jax.vjp`` through its ``custom_vjp``, whose backward runs the Pallas
kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in interpret mode
(blocks of 128). Both get the same numpy inputs and output cotangent.
The Hopper kernels are held to the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparktorch_tpu.ops.flash_attention import flash_attention as jax_flash
from sparktorch_tpu_torch.ops.flash_attention import (
    _delta,
    _probs_and_ds,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
)

# f32 on both sides; the two differ only in summation order.
ATOL = RTOL = 1e-4


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32)
            for _ in range(4)]


def _port_grads(q, k, v, g, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_attention(qt, kt, vt, causal).backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in (qt, kt, vt)]


def _jax_grads(q, k, v, g, causal, blocks=(128, 128)):
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, *blocks),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_pallas(causal, d, s):
    q, k, v, g = _inputs(2, s, 2, d, seed=s + d + causal)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = _port_grads(q, k, v, g, causal)
    # CPU: the plain version, no kernel launch.
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
    for name, a, b in zip(("dq", "dk", "dv"), got, _jax_grads(q, k, v, g,
                                                              causal)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_ragged_match_jax_dense_fallback(causal):
    # s=100 does not tile on the TPU, so the JAX wrapper differentiates
    # dense attention; the port's kernels mask the ragged end instead.
    q, k, v, g = _inputs(2, 100, 2, 64, seed=5)
    got = _port_grads(q, k, v, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          _jax_grads(q, k, v, g, causal, blocks=())):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_flash_return_lse_is_not_differentiable():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs(1, 64, 2, 32, seed=9))
    o, lse = flash_attention(q, k, v, True, return_lse=True)
    assert o.requires_grad and not lse.requires_grad


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("grad,queries,keys", [
    # The last 128-row Q tile of the forward loses one 16-key product.
    ("o", slice(3968, None), slice(1024, 1040)),
    ("dq", slice(3072, None), slice(1024, 1088)),
    ("dv", slice(3584, None), slice(3072, 3136)),
])
def test_smoke_tile_check_catches_a_dropped_far_tile(grad, queries, keys):
    # A causal kernel that drops keys from the late queries' sums stays
    # inside an elementwise tolerance (the forward's 2e-2 of
    # chip_smoke.py; the backward's earlier bar, scaled by the largest
    # reference value), since late rows' outputs and gradients are small;
    # the per-tile relative check of chip_smoke.py catches it.
    smoke = _smoke_module()
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4096, 1, 64, 11))
    o, lse = flash_attention(q, k, v, True, return_lse=True)
    p, ds = _probs_and_ds(q, k, v, do, lse, _delta(o, do), True)
    if grad == "o":
        want = torch.einsum("bhqk,bkhd->bqhd", p, v)
        p[:, :, queries, keys] = 0
        got = torch.einsum("bhqk,bkhd->bqhd", p, v)
        smoke.check_close(grad, got, want, *smoke.TOL["bfloat16"])
    else:
        if grad == "dq":
            want = torch.einsum("bhqk,bkhd->bqhd", ds, k)
            ds[:, :, queries, keys] = 0
            got = torch.einsum("bhqk,bkhd->bqhd", ds, k)
        else:
            want = torch.einsum("bhqk,bqhd->bkhd", p, do)
            p[:, :, queries, keys] = 0
            got = torch.einsum("bhqk,bqhd->bkhd", p, do)
        scale = float(want.abs().max())
        assert ((got - want).abs() <= 2e-2 * scale + 2e-2 * want.abs()).all()
    with pytest.raises(AssertionError, match="tile has relative L2 error"):
        smoke.check_tiles(torch, grad, got, want, smoke.TILE_TOL["bfloat16"])
    assert smoke.check_tiles(torch, grad, want, want, 0.0)[1] == 0.0
