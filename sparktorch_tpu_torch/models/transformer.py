"""Transformer encoder / LM family — the port of ``sparktorch_tpu/models/transformer.py``.

Forward and backward (training goes through autograd; flash attention
and the fused cross-entropy have their own backward kernels). The
numerics follow the Flax modules so that weights carried over by
:mod:`sparktorch_tpu_torch.convert` give the same outputs:

- parameters are stored in float32 and cast to the compute dtype at
  use; Dense outputs are in the compute dtype;
- LayerNorm has epsilon 1e-6 and takes its statistics in float32
  (Flax computes the variance as E[x²] − mean², torch as
  E[(x − mean)²]; the two differ by f32 rounding);
- GELU is the tanh approximation;
- ``pos_embed`` is cast to the compute dtype and sliced to the length;
- float ids are cast to int;
- the classifier head and the CausalLM head compute in float32;
- ``remat=True`` recomputes each encoder layer in the backward
  (``torch.utils.checkpoint``, the counterpart of ``nn.remat``), so
  only the layer inputs are kept between forward and backward.

``attn_impl``: ``"dense"`` (:func:`~sparktorch_tpu_torch.ops.attention.
dense_attention`), ``"flash"`` (the Hopper kernel in
:mod:`sparktorch_tpu_torch.ops.flash_attention`) and ``"ring"``, which
computes dense attention as the JAX module does whenever no
sequence-parallel mesh is in scope. Mixture-of-experts layers are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sparktorch_tpu_torch.ops.attention import dense_attention
from sparktorch_tpu_torch.ops.flash_attention import flash_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's config (BERT-base)."""

    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_len: int = 512
    n_classes: int = 2
    dtype: str = "bfloat16"
    attn_impl: str = "dense"  # 'dense' | 'flash' | 'ring'
    causal: bool = False
    remat: bool = False
    n_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_top_k: int = 1
    moe_group_size: int = 4096
    moe_ep_dispatch: str = "auto"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class Dense(nn.Linear):
    """``flax.linen.Dense(dtype=...)``: f32 weights cast to ``dtype`` at use."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self):
        # lecun_normal kernel (truncated normal, std 1/sqrt(fan_in)), zero bias.
        std = 1.0 / math.sqrt(self.in_features) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=...)``: epsilon 1e-6, f32 statistics."""

    def __init__(self, d: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.compute_dtype = dtype
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Embed(nn.Embedding):
    """``flax.linen.Embed(dtype=...)``: f32 table, rows cast to ``dtype``."""

    def __init__(self, num: int, d: int, dtype: torch.dtype):
        super().__init__(num, d)
        self.compute_dtype = dtype

    def reset_parameters(self):
        # variance_scaling(1.0, 'fan_in', 'normal', out_axis=0): std 1/sqrt(d).
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(self.embedding_dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = config
        if cfg.attn_impl not in ("dense", "flash", "ring"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        self.config = cfg
        dt = cfg.compute_dtype
        self.qkv = Dense(cfg.d_model, 3 * cfg.n_heads * cfg.head_dim, dt)
        self.proj = Dense(cfg.n_heads * cfg.head_dim, cfg.d_model, dt)

    def forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        qkv = self.qkv(x).view(b, s, 3, cfg.n_heads, cfg.head_dim)
        # Strided (b, s, h, hd) views; their backward stacks dq, dk, dv.
        q, k, v = qkv.unbind(2)
        if cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, cfg.causal)
        else:
            out = dense_attention(q, k, v, causal=cfg.causal)
        return self.proj(out.reshape(b, s, cfg.n_heads * cfg.head_dim))


class EncoderLayer(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        dt = config.compute_dtype
        self.ln_attn = LayerNorm(config.d_model, dt)
        self.attn = MultiHeadAttention(config)
        self.ln_mlp = LayerNorm(config.d_model, dt)
        self.mlp_in = Dense(config.d_model, config.d_ff, dt)
        self.mlp_out = Dense(config.d_ff, config.d_model, dt)

    def forward(self, x):
        x = x + self.attn(self.ln_attn(x))
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class Transformer(nn.Module):
    """Token-id encoder backbone. Accepts int ids or float columns (the
    estimator's feature matrix is float32; ids are cast).

    With ``own_embed=False`` the caller owns the token embedding and
    passes it to ``forward`` (weight tying in :class:`CausalLM`)."""

    def __init__(self, config: TransformerConfig, own_embed: bool = True):
        super().__init__()
        if config.n_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet (ROADMAP, "
                "Queue 1: sequence, sharding and MoE)")
        self.config = config
        dt = config.compute_dtype
        self.tok_embed = (Embed(config.vocab_size, config.d_model, dt)
                          if own_embed else None)
        self.pos_embed = nn.Parameter(
            torch.randn(config.max_len, config.d_model) * 0.02)
        self.layers = nn.ModuleList(
            EncoderLayer(config) for _ in range(config.n_layers))
        self.ln_final = LayerNorm(config.d_model, dt)

    def forward(self, ids, embed: Optional[Embed] = None):
        cfg = self.config
        if ids.is_floating_point():
            ids = ids.to(torch.int32)
        s = ids.shape[1]
        embed = self.tok_embed if embed is None else embed
        x = embed(ids) + self.pos_embed[None, :s].to(cfg.compute_dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        return self.ln_final(x)


class SequenceClassifier(nn.Module):
    """BERT-style classifier (SST-2 workload, BASELINE config 4)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        dt = config.compute_dtype
        self.backbone = Transformer(config)
        self.pooler = Dense(config.d_model, config.d_model, dt)
        self.classifier = Dense(config.d_model, config.n_classes,
                                torch.float32)

    def forward(self, ids):
        x = self.backbone(ids)
        # Mean-pool in f32 (as jnp.mean does for bf16), back to the
        # compute dtype for the pooler.
        pooled = x.float().mean(dim=1).to(self.config.compute_dtype)
        return self.classifier(torch.tanh(self.pooler(pooled)))


class CausalLM(nn.Module):
    """Decoder-style LM head over the same backbone, always causal."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = dataclasses.replace(config, causal=True)
        self.config = cfg
        if cfg.tie_embeddings:
            self.tok_embed = Embed(cfg.vocab_size, cfg.d_model,
                                   cfg.compute_dtype)
            self.backbone = Transformer(cfg, own_embed=False)
        else:
            self.backbone = Transformer(cfg)
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32)

    def forward(self, ids):
        if self.config.tie_embeddings:
            x = self.backbone(ids, embed=self.tok_embed)
            # f32 logits like the untied head: h @ Eᵀ.
            return x.float() @ self.tok_embed.weight.float().T
        return self.lm_head(self.backbone(ids))


def bert_base(n_classes: int = 2, **overrides) -> SequenceClassifier:
    cfg = TransformerConfig(n_classes=n_classes, **overrides)
    return SequenceClassifier(cfg)


def tiny_transformer(**overrides) -> TransformerConfig:
    """Small config for tests and dry runs."""
    defaults = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                    d_ff=128, max_len=128)
    defaults.update(overrides)
    return TransformerConfig(**defaults)
