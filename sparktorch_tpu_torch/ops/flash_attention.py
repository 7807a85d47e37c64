"""Flash attention, forward and backward: hand-written Hopper kernels and their plain versions.

The port of ``sparktorch_tpu/ops/flash_attention.py``: the forward
kernels (``_fwd_kernel`` and ``_fwd_kernel_lse``, both ``_fwd_body``)
are ``csrc/flash_fwd.cu``, the backward kernels (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``) are ``csrc/flash_bwd.cu``. Each source's header
note says what bounds it on the card and how the design answers that.

- :func:`flash_attention` keeps the JAX wrapper's contract: q, k, v are
  (batch, seq, heads, head_dim), the output has q's shape and dtype,
  and ``return_lse=True`` adds the per-row logsumexp, (batch, heads,
  seq) in float32. When a gradient is needed it runs under a
  ``torch.autograd.Function`` whose forward keeps lse and whose
  backward is :func:`flash_attention_backward`. A CPU tensor goes to
  the plain versions; a CUDA tensor launches the kernels or raises.
  There is no dense fallback for ragged lengths: the kernels mask them.
- :func:`flash_attention_reference`, :func:`flash_bwd_dq_reference` and
  :func:`flash_bwd_dkv_reference` are the kernels' math in plain
  PyTorch — f32 logits, P (and dS) rounded to the input dtype before
  the products that take them, l clamped at 1e-20 — and their
  yardsticks on the card; :func:`flash_attention_backward_reference`
  is the whole backward made of them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_Y = 65535


def _causal_mask(s_q: int, s_k: int, device) -> torch.Tensor:
    """True where a key lies after its query (masked out)."""
    q_pos = torch.arange(s_q, device=device)
    k_pos = torch.arange(s_k, device=device)
    return q_pos[:, None] < k_pos[None, :]


def _logits(q, k, causal):
    """f32 Q·Kᵀ·d^-½ as (batch, heads, s_q, s_k), masked with -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], k.shape[1], q.device),
                          float("-inf"))
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False, *,
                              return_lse: bool = False):
    """Plain PyTorch version of the forward kernel's math: one dense
    softmax in float32, P cast to v's dtype before P·V, f32 accumulation."""
    s = _logits(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    # A fully masked row keeps m = -inf; exp then yields 0, not NaN.
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = (pv / l.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ O) in f32, (batch, heads, seq) — computed outside
    the kernels, as the JAX wrapper computes it outside Pallas."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, causal):
    """p recomputed from lse and ds = p·(dO·Vᵀ − D), both f32."""
    p = torch.exp(_logits(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=False):
    """Plain version of the dq kernel: dq = scale·ds·K, ds rounded to
    the input dtype first, f32 accumulation."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=False):
    """Plain version of the dk/dv kernel: dk = scale·dsᵀ·Q with ds
    rounded to the input dtype, dv = pᵀ·dO with p rounded to dO's
    dtype, f32 accumulation."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, o, lse, do, causal=False):
    """Plain version of the whole backward: (dq, dk, dv) in the inputs'
    dtypes."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))


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


def _check_cuda(q, k):
    """What the kernels take; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    b, _, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(
            f"flash_attention: batch*heads {b * h} > {_MAX_GRID_Y}")
    # The bf16 kernels put their 128-row tiles on the grid's y axis.
    s = max(q.shape[1], k.shape[1])
    if s > 128 * _MAX_GRID_Y:
        raise ValueError(f"flash_attention: sequence {s} > "
                         f"{128 * _MAX_GRID_Y}")


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels read their tiles with TMA through a (head_dim,
    head, seq, batch) tensor map, which needs a 16-byte-aligned base and
    (batch, seq, head) strides that are multiples of 16 bytes and do not
    grow inward (the strides of extent-1 dims never enter an address).
    Views of the fused qkv product pass as they are; anything else is
    copied into a fresh contiguous tensor (fresh, so its base is aligned
    even where ``x`` was contiguous already)."""
    strides = [st for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1]
    aligned = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
               and all(st > 0 and st % 8 == 0 for st in strides)
               and strides == sorted(strides, reverse=True))
    return x if aligned else x.clone(memory_format=torch.contiguous_format)


def _forward(q, k, v, causal, return_lse):
    """The forward on q's device: the plain version on the CPU, the
    kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal,
                                         return_lse=return_lse)
    _check_cuda(q, k)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b * s_q:
        fn = _fwd_entry()
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


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with lse kept; backward through the dq and dk/dv
    kernels (the port of the JAX wrapper's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, *, return_lse: bool = False):
    """Fused attention over (batch, seq, heads, head_dim), differentiable.

    Returns ``o``, or ``(o, lse)`` with lse (batch, heads, seq_q) in
    float32 when ``return_lse``. CUDA tensors run the Hopper kernels
    (bf16 on the tensor cores, f32 with scalar FMA; head_dim 32, 64 or
    128); CPU tensors run the plain versions. ``launches`` counts the
    forward kernel's launches.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, causal)
        return (o, lse) if return_lse else o
    return _forward(q, k, v, causal, return_lse)


flash_attention.launches = 0


def _bwd_operands(q, k, v, do, lse, delta):
    """Checks what the backward kernels take; returns the operands in
    the layout they read."""
    _check(q, k, v)
    _check_cuda(q, k)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    b, s_q, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, s_q) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{name} must be ({b}, {h}, {s_q}) float32 on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype}")
    q, k, v, do = (_kernel_operand(x) for x in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def _launch_bwd(name, q, k, v, do, lse, delta, causal, dq=None, dk=None,
                dv=None) -> bool:
    """Launch one backward entry point; False when there is no work."""
    b, s_q, h, d = q.shape
    if b * s_q == 0:
        return False
    outs = [x for x in (dq, dk, dv) if x is not None]
    # (batch, seq, head) strides of q, k, v, dO, dq, dk, dv; an output
    # this entry point does not write takes q's strides, unread.
    strides = (ctypes.c_longlong * 21)(*(
        st for x in (q, k, v, do, dq, dk, dv)
        for st in (q if x is None else x).stride()[:3]))
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, *outs)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entries()[name](*ptrs, b, h, s_q, k.shape[1], d, strides,
                               d ** -0.5, int(causal),
                               int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_{name} kernel launch failed: "
                           f"cudaError {err}")
    return True


def _dq(operands, causal) -> torch.Tensor:
    """The dq kernel on operands :func:`_bwd_operands` has laid out."""
    q = operands[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _launch_bwd("bwd_dq", *operands, causal, dq=dq):
        flash_bwd_dq.launches += 1
    return dq


def _dkv(operands, causal):
    """The dk/dv kernel on operands :func:`_bwd_operands` has laid out."""
    k, v = operands[1:3]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if _launch_bwd("bwd_dkv", *operands, causal, dk=dk, dv=dv):
        flash_bwd_dkv.launches += 1
    else:  # no queries: no gradient reaches K or V
        dk.zero_()
        dv.zero_()
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False) -> torch.Tensor:
    """dQ on the card (``csrc/flash_bwd.cu``, dq kernel). ``delta`` is
    rowsum(dO ∘ O), (batch, heads, seq) f32. Counts its launches."""
    return _dq(_bwd_operands(q, k, v, do, lse, delta), causal)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False):
    """(dK, dV) on the card (``csrc/flash_bwd.cu``, dk/dv kernel).
    Counts its launches."""
    return _dkv(_bwd_operands(q, k, v, do, lse, delta), causal)


flash_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, causal=False):
    """(dq, dk, dv) of flash attention given the forward's output and
    lse: the two backward kernels on CUDA, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    operands = _bwd_operands(q, k, v, do, lse, _delta(o, do))
    return (_dq(operands, causal), *_dkv(operands, causal))


@functools.cache
def _fwd_entry():
    """The C entry point of ``csrc/flash_fwd.cu``, built at first use."""
    from sparktorch_tpu_torch.ops import _build

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.load("flash_fwd").sparktorch_flash_fwd
    fn.argtypes = ([ptr] * 5 + [i32] * 5 + [i64] * 12
                   + [ctypes.c_float, i32, i32, ptr])
    fn.restype = i32
    return fn


@functools.cache
def _bwd_entries():
    """The C entry points of ``csrc/flash_bwd.cu``, built at first use."""
    from sparktorch_tpu_torch.ops import _build

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _build.load("flash_bwd")
    dq, dkv = lib.sparktorch_flash_bwd_dq, lib.sparktorch_flash_bwd_dkv
    dq.argtypes = [ptr] * 7 + [i32] * 5 + [ptr, ctypes.c_float, i32, i32, ptr]
    dkv.argtypes = [ptr] * 8 + [i32] * 5 + [ptr, ctypes.c_float, i32, i32, ptr]
    dq.restype = dkv.restype = i32
    return {"bwd_dq": dq, "bwd_dkv": dkv}
