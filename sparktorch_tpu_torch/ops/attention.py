"""Dense softmax attention — the port of ``sparktorch_tpu/ops/attention.py``.

:func:`dense_attention` is the ``attn_impl="dense"`` path of the
transformer and the yardstick the flash kernel's model test is held
against. Layout is the JAX package's: (batch, seq, heads, head_dim).
``ring_attention`` (sequence parallel over an ``sp`` group) is not
ported yet.
"""

from __future__ import annotations

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Plain attention over (batch, seq, heads, head_dim) inputs.

    As in the JAX package, QKᵀ is taken in the input dtype and the
    logits are then softmaxed in float32; the weights are cast back to
    v's dtype before the PV product.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    # A fully masked row (all -inf) softmaxes to NaN; zero it instead.
    weights = torch.nan_to_num(weights, nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
