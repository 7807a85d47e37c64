"""Peak rates of one NVIDIA H100 SXM and the least time each hand-written kernel's work can take.

One source for ``chip_smoke.py``'s per-kernel bounds and the bench's
roofline and MFU fields (:mod:`sparktorch_tpu_torch.bench`). The peaks
are the published dense (no sparsity) figures at 700 W; a card set to a
lower power limit runs below them under load.

Each ``*_flops`` function counts the work of one kernel launch: the
matrix products of the flash kernels at 2 FLOPs per multiply-add over
the (query, key) pairs the mask keeps, and ~4 f32 operations per logit
for the fused cross-entropy. Each ``*_bound`` returns the larger of the
operations over the peak for their type and the bytes over the memory
rate, in milliseconds, and which of the two sets it.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def _bound(ops: float, op_dtype: str, nbytes: float):
    t_ops = ops / PEAK_FLOPS[op_dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def attention_flops(b, s, h, d, causal) -> int:
    """One attention forward: QKᵀ and PV."""
    return 4 * b * h * d * _pairs(s, causal)


def flash_bwd_flops(kind, b, s, h, d, causal) -> int:
    """One backward kernel: 6·d per kept pair for dq (S, dP, dS·K), 8·d
    for dk/dv (S, dP, Pᵀ·dO, dSᵀ·Q)."""
    return (6 if kind == "dq" else 8) * d * b * h * _pairs(s, causal)


def ce_ops(t, v) -> int:
    """One CE kernel: max, subtract, exp, add per logit (the backward's
    subtract, exp, subtract, multiply)."""
    return 4 * t * v


def attention_bound(b, s, h, d, causal, dtype, with_lse, itemsize):
    """Least time (ms) for one attention forward on an H100, and which
    of bytes or operations sets it: q, k, v read and o (and lse)
    written once."""
    nbytes = 4 * b * s * h * d * itemsize + (4 * b * h * s if with_lse else 0)
    return _bound(attention_flops(b, s, h, d, causal), dtype, nbytes)


def flash_bwd_bound(kind, b, s, h, d, causal, dtype, itemsize):
    """Least time (ms) for one backward kernel: q, k, v, dO read once,
    dq (or dk and dv) written once, lse and D read once."""
    tensors = 5 if kind == "dq" else 6
    nbytes = tensors * b * s * h * d * itemsize + 8 * b * h * s
    return _bound(flash_bwd_flops(kind, b, s, h, d, causal), dtype, nbytes)


def ce_bound(kind, t, v, itemsize):
    """Least time (ms) for one CE kernel: the logits read once (and, in
    the backward, the gradient written once) plus the per-token labels,
    lse, g and loss, in f32 operations."""
    nbytes = t * v * itemsize * (1 if kind == "fwd" else 2) + 16 * t
    return _bound(ce_ops(t, v), "float32", nbytes)
