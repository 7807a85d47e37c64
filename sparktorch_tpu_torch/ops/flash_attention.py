"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

The port of ``sparktorch_tpu/ops/flash_attention.py``'s forward kernels
(``_fwd_kernel`` and ``_fwd_kernel_lse``, both ``_fwd_body``). The CUDA
source is ``csrc/flash_fwd.cu``; its header note says what bounds it on
the card and how the design answers that.

- :func:`flash_attention` keeps the JAX wrapper's contract: q, k, v are
  (batch, seq, heads, head_dim), the output has q's shape and dtype,
  and ``return_lse=True`` adds the per-row logsumexp, (batch, heads,
  seq) in float32. A CPU tensor goes to the plain version; a CUDA
  tensor launches the kernel or raises. There is no dense fallback for
  ragged lengths: the kernel masks them.
- :func:`flash_attention_reference` is the same math in plain PyTorch —
  f32 logits, P rounded to the input dtype before P·V, l clamped at
  1e-20 — and is the kernel's yardstick on the card.

The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) are not
ported yet, so the wrapper refuses CUDA inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_Y = 65535


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False, *,
                              return_lse: bool = False):
    """Plain PyTorch version of the kernel's math: one dense softmax
    in float32, P cast to v's dtype before P·V, f32 accumulation."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    # A fully masked row keeps m = -inf; exp then yields 0, not NaN.
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (pv / l.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (batch, seq, heads, head_dim)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte vectors along head_dim (bf16) and takes
    any (batch, seq, head) strides that keep them aligned; anything else
    is copied contiguous first."""
    aligned = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in x.stride()[:3]))
    return x if aligned else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, *, return_lse: bool = False):
    """Fused attention forward over (batch, seq, heads, head_dim).

    Returns ``o``, or ``(o, lse)`` with lse (batch, heads, seq_q) in
    float32 when ``return_lse``. CUDA tensors run the Hopper kernel
    (bf16 on the tensor cores, f32 with scalar FMA; head_dim 32, 64 or
    128); CPU tensors run :func:`flash_attention_reference`.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal,
                                         return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward kernel yet; call it under "
            "torch.no_grad() or torch.inference_mode()")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(
            f"flash_attention: batch*heads {b * h} > {_MAX_GRID_Y}")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b * s_q:
        fn = _kernel()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr() if lse is not None else None,
                     b, h, s_q, s_k, d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3],
                     d ** -0.5, int(causal), int(q.dtype == torch.bfloat16),
                     stream)
        if err != 0:
            raise RuntimeError(
                f"flash_fwd kernel launch failed: cudaError {err}")
        flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


@functools.cache
def _kernel():
    """The C entry point of ``csrc/flash_fwd.cu``, built at first use."""
    from sparktorch_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").sparktorch_flash_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 5 + [i32] * 5 + [i64] * 12
                   + [ctypes.c_float, i32, i32, ptr])
    fn.restype = i32
    return fn
