"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch and the port, so it runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from sparktorch_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from sparktorch_tpu_torch.ops.fused_ce import (
    fused_ce_backward,
    fused_ce_backward_reference,
    fused_ce_forward,
    fused_ce_reference,
    fused_cross_entropy,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, tol, tile=64):
    # Relative L2 error of every 64-row tile of each (batch, head), each
    # against its own reference, so the small outputs and gradients of
    # late causal rows are held as closely as the first. bf16 outputs
    # round at 2^-9 of their size; f32 sums run in another order.
    b, s, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -s % tile)
    diff = torch.nn.functional.pad(got.float() - want.float(), pad)
    ref = torch.nn.functional.pad(want.float(), pad)
    num, den = (x.view(b, -1, tile, h, d).square().sum((2, 4))
                for x in (diff, ref))
    worst = float((num / den.clamp_min(1e-30)).sqrt().max())
    assert worst <= tol, f"worst tile relative L2 error {worst:.3e} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,s", [
    (torch.bfloat16, 64, False, 128),
    (torch.bfloat16, 128, True, 300),
    (torch.bfloat16, 32, True, 256),
    (torch.float32, 64, True, 200),
    (torch.bfloat16, 64, True, 2048),
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
    _close(got, want, 1e-2 if dtype == torch.bfloat16 else 1e-4)
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(lse, want_lse, atol=lse_tol, rtol=lse_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,s", [
    (torch.bfloat16, 64, True, 256),
    (torch.bfloat16, 64, False, 128),
    (torch.bfloat16, 128, True, 300),
    (torch.bfloat16, 32, False, 200),
    (torch.float32, 64, True, 200),
    (torch.float32, 128, False, 130),
    (torch.float32, 32, True, 64),
])
def test_cuda_backward_kernels_match_plain_version(cuda_device, dtype, d,
                                                   causal, s):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn((2, s, 4, d), generator=gen,
                               device=cuda_device, dtype=dtype)
                   for _ in range(4))
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_backward(q, k, v, o, lse, do, causal)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        _close(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_autograd_through_fused_qkv_views(cuda_device, causal):
    # The model's q, k, v are strided views of one qkv product; gradients
    # flow back into it through the kernels with no copy of the inputs.
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((3, 256, 3, 4, 64), generator=gen, device=cuda_device,
                      dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn((3, 256, 4, 64), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    counts = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    flash_attention(*qkv.unbind(2), causal).backward(g)
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    q, k, v = (x.detach() for x in qkv.unbind(2))
    o, lse = flash_attention_reference(q, k, v, causal, return_lse=True)
    want = torch.stack(flash_attention_backward_reference(
        q, k, v, o, lse, g, causal), dim=2)
    _close(qkv.grad.flatten(2, 3), want.flatten(2, 3), 1e-2)


# The bf16 kernels tile 128 query rows (forward), 192 (dq at head_dim
# <= 64; 128 at 128) or 128 keys (dk/dv) a block, in stages of 64:
# sequence lengths on both sides of every tile edge, every head dim, q/k/v
# as views of one fused qkv product. The backward adds the edges of dq's
# 192-row tiles and of a third Q tile: dq walks its Q tiles longest first,
# so a partial last tile runs first.
_EDGES = [1, 63, 65, 127, 129, 255, 257]
_BWD_EDGES = _EDGES + [191, 193, 383, 385]


def _fused_qkv(gen, device, b, s, h, d):
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=device,
                      dtype=torch.bfloat16)
    return qkv.unbind(2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", _EDGES)
def test_cuda_forward_at_tile_edges(cuda_device, s, causal, d):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = _fused_qkv(gen, cuda_device, 2, s, 3, d)
    with torch.inference_mode():
        got, lse = flash_attention(q, k, v, causal, return_lse=True)
        want, want_lse = flash_attention_reference(q, k, v, causal,
                                                   return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    _close(got, want, 1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", _BWD_EDGES)
def test_cuda_backward_at_tile_edges(cuda_device, s, causal, d):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = _fused_qkv(gen, cuda_device, 2, s, 3, d)
    do = torch.randn(q.shape, generator=gen, device=cuda_device,
                     dtype=torch.bfloat16)
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    got = flash_attention_backward(q, k, v, o, lse, do, causal)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        if s == 1 and name != "dv":
            # One key: the softmax has no gradient, so dq and dk are zero
            # in exact arithmetic and both sides hold rounding noise of
            # dP - D (~1e-6 of dP) only.
            assert float(g.float().abs().max()) < 1e-3, name
            continue
        _close(g, w, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernels_with_many_heads(cuda_device, causal):
    # batch·heads = 1,280 blocks along the grid's x axis.
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = _fused_qkv(gen, cuda_device, 64, 130, 20, 64)
    do = torch.randn(q.shape, generator=gen, device=cuda_device,
                     dtype=torch.bfloat16)
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    want_o, want_lse = flash_attention_reference(q, k, v, causal,
                                                 return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    _close(o, want_o, 1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)
    got = flash_attention_backward(q, k, v, o, lse, do, causal)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    for g, w in zip(got, want):
        _close(g, w, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_k", [(100, 300), (300, 100)])
def test_cuda_kernels_with_unequal_lengths(cuda_device, s_q, s_k, causal):
    # The mask is top-left aligned (key > query is masked), as in the
    # plain version; keys past every query get no gradient.
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q = torch.randn((2, s_q, 4, 64), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((2, s_k, 4, 64), generator=gen, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device=cuda_device,
                     dtype=torch.bfloat16)
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    want_o, want_lse = flash_attention_reference(q, k, v, causal,
                                                 return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    _close(o, want_o, 1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)
    got = flash_attention_backward(q, k, v, o, lse, do, causal)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if causal and s_k > s_q and name != "dq":
            # Keys past the last query: exactly zero on both sides.
            assert torch.equal(g[:, s_q:], w[:, s_q:]), name
            g, w = g[:, :s_q], w[:, :s_q]
        _close(g, w, 1e-2)


@pytest.mark.cuda
def test_cuda_kernels_repeat_bit_for_bit(cuda_device):
    # Twenty runs at one shape give the same bits: each output element is
    # owned by one block and summed in a fixed order, so a run that
    # differs has read a stage before its load landed or after it was
    # refilled.
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = _fused_qkv(gen, cuda_device, 2, 1000, 8, 64)
    do = torch.randn(q.shape, generator=gen, device=cuda_device,
                     dtype=torch.bfloat16)
    first = None
    for _ in range(20):
        o, lse = flash_attention(q, k, v, True, return_lse=True)
        out = (o, lse, *flash_attention_backward(q, k, v, o, lse, do, True))
        if first is None:
            first = out
            want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                      True)
            for g, w in zip(out[2:], want):
                _close(g, w, 1e-2)
        for a, b in zip(out, first):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,v", [
    (torch.float32, 512, 4096),
    (torch.float32, 300, 1000),    # ragged vocab: rows start off 16 bytes
    (torch.bfloat16, 256, 30522),
])
def test_cuda_fused_ce_matches_plain_version(cuda_device, dtype, t, v):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    logits = (4 * torch.randn((t, v), generator=gen, device=cuda_device)
              ).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device=cuda_device)
    labels[0] = -1  # outside [0, v): picks nothing, as in the TPU kernel
    g = torch.rand((t,), generator=gen, device=cuda_device)
    counts = (fused_ce_forward.launches, fused_ce_backward.launches)
    loss, lse = fused_ce_forward(logits, labels)
    grad = fused_ce_backward(logits, labels, lse, g)
    torch.cuda.synchronize()
    assert (fused_ce_forward.launches, fused_ce_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    want_loss, want_lse = fused_ce_reference(logits, labels)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(loss, want_loss, atol=1e-5, rtol=1e-5)
    # On the same lse, every entry relative to itself: a bf16 entry may
    # round one ulp (2^-8) the other way; f32 differs by expf's ulps.
    want_grad = fused_ce_backward_reference(logits, labels, lse, g)
    assert grad.dtype == dtype
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(grad.float(), want_grad.float(), atol=0,
                               rtol=tol)


@pytest.mark.cuda
def test_cuda_fused_ce_autograd(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    logits = torch.randn((128, 2048), generator=gen, device=cuda_device,
                         requires_grad=True)
    labels = torch.randint(0, 2048, (128,), generator=gen, device=cuda_device)
    fused_cross_entropy(logits, labels).mean().backward()
    ref = logits.detach().clone().requires_grad_()
    torch.nn.functional.cross_entropy(ref, labels).backward()
    # Every entry relative to itself; the two logsumexps differ by f32
    # rounding, about 1e-6 of each probability.
    torch.testing.assert_close(logits.grad, ref.grad, atol=0, rtol=1e-5)
