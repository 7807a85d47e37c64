"""The Hopper flash-attention kernel against its plain version, on the card.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch and the port, so it runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from sparktorch_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,s", [
    (torch.bfloat16, 64, False, 128),
    (torch.bfloat16, 128, True, 300),
    (torch.bfloat16, 32, True, 256),
    (torch.float32, 64, True, 200),
])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, d, causal, s):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, s, 4, d), generator=gen, device=cuda_device,
                           dtype=dtype) for _ in range(3))
    before = flash_attention.launches
    with torch.inference_mode():
        got, lse = flash_attention(q, k, v, causal, return_lse=True)
        want, want_lse = flash_attention_reference(q, k, v, causal,
                                                   return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(lse, want_lse, atol=lse_tol, rtol=lse_tol)
