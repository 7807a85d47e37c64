"""Fused softmax cross-entropy, forward and backward: Hopper kernels and their plain versions.

The port of ``sparktorch_tpu/ops/fused_ce.py``: ``_ce_kernel`` and
``_ce_bwd_kernel`` are the two kernels of ``csrc/fused_ce.cu`` (CUDA C++;
its header note says what bounds them and how the design answers that).

- :func:`fused_cross_entropy` keeps the JAX wrapper's contract: logits
  (tokens, vocab) in f32 or bf16, integer labels (tokens,), per-token
  loss (tokens,) in f32, differentiable through a
  ``torch.autograd.Function``. The forward saves the per-token
  logsumexp as the backward's residual. The JAX wrapper falls back to a
  dense path when tokens or vocab do not divide its blocks; the kernels
  mask the vocabulary tail instead, so every shape runs them.
- :func:`fused_cross_entropy_loss` is the loss registry's entry: 2-D or
  3-D logits → per-example loss.
- :func:`fused_ce_reference` and :func:`fused_ce_backward_reference`
  are the same math in plain PyTorch. A CPU tensor goes to them; a CUDA
  tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def fused_ce_reference(logits: torch.Tensor, labels: torch.Tensor):
    """(loss, lse), both (tokens,) f32: lse = logsumexp of the f32
    logits, loss = lse − logit[label]; a label outside [0, vocab) picks
    nothing, as in the kernels."""
    s = logits.float()
    lse = torch.logsumexp(s, dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < s.shape[-1])
    picked = s.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return lse - torch.where(valid, picked, 0.0), lse


def fused_ce_backward_reference(logits, labels, lse, g):
    """d logits = (exp(s − lse) − onehot(label))·g in the logits' dtype."""
    s = logits.float()
    cols = torch.arange(s.shape[-1], device=s.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return ((torch.exp(s - lse[:, None]) - onehot)
            * g.float()[:, None]).to(logits.dtype)


def _check(logits, labels):
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"fused_cross_entropy: logits {tuple(logits.shape)} "
                         f"and labels {tuple(labels.shape)}; want (t, v) "
                         "and (t,)")
    if logits.device != labels.device:
        raise ValueError("logits and labels must lie on one device")
    if logits.shape[1] == 0:
        raise ValueError("fused_cross_entropy needs at least one class")


def _cuda_operands(logits, labels, *rows):
    """Checks what the kernels take (``rows``: per-token f32 inputs);
    returns logits and labels in the layout they read."""
    _check(logits, labels)
    for x in rows:
        if x.shape != labels.shape or x.device != logits.device:
            raise ValueError(f"per-token input {tuple(x.shape)} on "
                             f"{x.device}; want ({logits.shape[0]},) on "
                             f"{logits.device}")
    if logits.device.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ce: unsupported dtype {logits.dtype}")
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    return logits, labels.to(torch.int64).contiguous()


def fused_ce_forward(logits: torch.Tensor, labels: torch.Tensor):
    """(loss, lse) on the card (``csrc/fused_ce.cu``, forward kernel).
    Counts its launches."""
    logits, labels = _cuda_operands(logits, labels)
    t, v = logits.shape
    loss = torch.empty(t, dtype=torch.float32, device=logits.device)
    lse = torch.empty(t, dtype=torch.float32, device=logits.device)
    if t:
        with torch.cuda.device(logits.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernels()["fwd"](
                logits.data_ptr(), logits.stride(0), labels.data_ptr(),
                loss.data_ptr(), lse.data_ptr(), t, v,
                int(logits.dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"ce_fwd kernel launch failed: cudaError {err}")
        fused_ce_forward.launches += 1
    return loss, lse


fused_ce_forward.launches = 0


def fused_ce_backward(logits, labels, lse, g) -> torch.Tensor:
    """d logits on the card (``csrc/fused_ce.cu``, backward kernel), in
    the logits' dtype. Counts its launches."""
    logits, labels = _cuda_operands(logits, labels, lse, g)
    t, v = logits.shape
    grad = torch.empty((t, v), dtype=logits.dtype, device=logits.device)
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    if t:
        with torch.cuda.device(logits.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernels()["bwd"](
                logits.data_ptr(), logits.stride(0), labels.data_ptr(),
                lse.data_ptr(), g.data_ptr(), grad.data_ptr(), grad.stride(0),
                t, v, int(logits.dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"ce_bwd kernel launch failed: cudaError {err}")
        fused_ce_backward.launches += 1
    return grad


fused_ce_backward.launches = 0


def _forward(logits, labels):
    """(loss, lse) on the logits' device: the plain version on the CPU,
    the kernel on CUDA."""
    if logits.device.type == "cpu":
        _check(logits, labels)
        return fused_ce_reference(logits, labels)
    return fused_ce_forward(logits, labels)


def _backward(logits, labels, lse, g):
    """d logits on the logits' device, as :func:`_forward` chooses."""
    if logits.device.type == "cpu":
        return fused_ce_backward_reference(logits, labels, lse, g)
    return fused_ce_backward(logits, labels, lse, g)


class _FusedCE(torch.autograd.Function):
    """The port of the JAX wrapper's ``custom_vjp``: forward kernel, lse
    kept as the residual, backward kernel."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = _forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return _backward(logits, labels, lse, g), None


def fused_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE loss. logits (tokens, vocab), labels (tokens,) int.
    Returns (tokens,) float32."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _FusedCE.apply(logits, labels)
    return _forward(logits, labels)[0]


def fused_cross_entropy_loss(preds: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """Registry-compatible loss: (batch, vocab) or (batch, seq, vocab)
    logits, returns the per-example loss (batch,)."""
    labels = targets.long()
    if preds.dim() == 2:
        return fused_cross_entropy(preds, labels)
    b = preds.shape[0]
    per_token = fused_cross_entropy(preds.reshape(-1, preds.shape[-1]),
                                    labels.reshape(-1))
    return per_token.reshape(b, -1).mean(dim=-1)


@functools.cache
def _kernels():
    """The C entry points of ``csrc/fused_ce.cu``, built at first use."""
    from sparktorch_tpu_torch.ops import _build

    lib = _build.load("fused_ce")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd, bwd = lib.sparktorch_ce_fwd, lib.sparktorch_ce_bwd
    fwd.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32, ptr]
    bwd.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr]
    fwd.restype = bwd.restype = i32
    return {"fwd": fwd, "bwd": bwd}
