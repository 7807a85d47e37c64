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
sequence-parallel mesh is in scope.

Mixture of experts (``n_experts > 0``): every ``moe_every``-th layer's
FFN is a :class:`MoEFFN`, routed on one card (no expert-parallel mesh,
so ``moe_ep_dispatch`` is accepted and has nothing to choose). Where the
Flax layer sows its load-balance loss and its (dropped, routed) counts,
the port records them into the :func:`collect_moe` block the forward
runs in; ``forward`` returns logits only. ``forward(ids, example_w)``
masks weight-0 rows out of routing, as the JAX modules do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import List, Optional, Tuple

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

    def moe_pattern(self) -> List[bool]:
        """Per-layer use_moe flags: every ``moe_every``-th layer."""
        return [self.n_experts > 0 and (i + 1) % max(1, self.moe_every) == 0
                for i in range(self.n_layers)]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    """Flax's lecun_normal: a truncated normal of std 1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Dense(nn.Linear):
    """``flax.linen.Dense(dtype=...)``: f32 weights cast to ``dtype`` at use."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self):
        _lecun_normal_(self.weight, self.in_features)
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
    """``flax.linen.Embed(dtype=...)``: f32 table, rows cast to ``dtype``.
    An id outside ``[0, num)`` reads a NaN row, as ``jnp.take`` fills an
    out-of-range index in the JAX package (where ``F.embedding`` would
    raise, or on the card trip a device assert)."""

    def __init__(self, num: int, d: int, dtype: torch.dtype):
        super().__init__(num, d)
        self.compute_dtype = dtype

    def reset_parameters(self):
        # variance_scaling(1.0, 'fan_in', 'normal', out_axis=0): std 1/sqrt(d).
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(self.embedding_dim))

    def forward(self, ids):
        n = self.num_embeddings
        bad = (ids < 0) | (ids >= n)
        rows = F.embedding(ids.clamp(0, n - 1), self.weight)
        return rows.masked_fill(bad[..., None], float("nan")).to(
            self.compute_dtype)

    def attend(self, x):
        """f32 logits against the table, ``x @ Eᵀ`` (weight tying)."""
        return x.float() @ self.weight.float().T


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

    def flax_param_shapes(self):
        """The Flax shapes of the fused weights, whose rank differs here
        (``convert.py``): Adafactor factors them on these."""
        cfg = self.config
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        return {"qkv.weight": (d, 3, h, hd), "qkv.bias": (3, h, hd),
                "proj.weight": (h, hd, d)}

    def forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        # The heads this module holds: all of them, or this rank's
        # h/tp when the qkv weight is split by heads (parallel/tp.py).
        h = self.qkv.weight.shape[0] // (3 * cfg.head_dim)
        qkv = self.qkv(x).view(b, s, 3, h, cfg.head_dim)
        # Strided (b, s, h, hd) views; their backward stacks dq, dk, dv.
        q, k, v = qkv.unbind(2)
        if cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, cfg.causal)
        else:
            out = dense_attention(q, k, v, causal=cfg.causal)
        return self.proj(out.reshape(b, s, h * cfg.head_dim))


def moe_group_partition(cfg: TransformerConfig, n: int) -> Tuple[int, int]:
    """``(group size, group count)`` for routing ``n`` tokens: the
    largest ``g <= cfg.moe_group_size`` that divides ``n`` (the JAX
    package's base rule; with no mesh there is no per-device anchor)."""
    g = min(n, max(1, cfg.moe_group_size))
    while n % g:
        g -= 1
    return g, n // g


class MoEStats:
    """What the MoE layers of one forward recorded: each layer's
    load-balance loss (already times ``moe_aux_weight``) and its
    (dropped, routed) token-choice counts, as device scalars."""

    def __init__(self):
        self.aux: List[torch.Tensor] = []
        self.dropped: List[torch.Tensor] = []
        self.routed: List[torch.Tensor] = []

    def aux_total(self) -> Optional[torch.Tensor]:
        """The summed aux loss; None when no MoE layer ran."""
        return torch.stack(self.aux).sum() if self.aux else None

    def counts(self) -> Optional[torch.Tensor]:
        """(dropped, routed) summed over the layers, f32; None when no
        MoE layer ran."""
        if not self.routed:
            return None
        return torch.stack([torch.stack(self.dropped).sum(),
                            torch.stack(self.routed).sum()])


_RECORDING = threading.local()


@contextlib.contextmanager
def collect_moe():
    """Record the aux losses and drop counts of the MoE layers run in
    this block, on this thread (the counterpart of Flax's ``losses`` and
    ``moe_metrics`` collections). A forward outside any block records
    nothing. Trainers run the backward after the block has closed, so a
    ``remat`` layer recomputed there records nothing a second time."""
    stack = getattr(_RECORDING, "stack", None)
    if stack is None:
        stack = _RECORDING.stack = []
    stats = MoEStats()
    stack.append(stats)
    try:
        yield stats
    finally:
        stack.pop()


def _recording() -> Optional[MoEStats]:
    stack = getattr(_RECORDING, "stack", None)
    return stack[-1] if stack else None


def _top_k_routing(probs: torch.Tensor, k: int):
    """The top ``k`` probabilities and their expert indices, as ``k``
    rounds of argmax and masking with −1 (the first index wins a tie,
    as in the JAX package's ``_top_k_routing``)."""
    vals, idxs = [], []
    p = probs
    for _ in range(k):
        i = p.argmax(-1)
        vals.append(p.amax(-1))
        idxs.append(i)
        p = torch.where(F.one_hot(i, p.shape[-1]).bool(), -1.0, p)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _gelu(z):
    return F.gelu(z, approximate="tanh")


class _ExpertFFN(torch.autograd.Function):
    """The dense per-expert FFN on (G, e, cap, d) capacity blocks, with
    the JAX package's custom backward (``_expert_ffn``): each weight
    gradient contracts every group's partial over ``cap`` only and sums
    the groups in f32, and the residuals keep the pre-activation ``z``,
    not the post-GELU hidden."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, w_out, b_out):
        dt = x.dtype
        z = (torch.einsum("gecd,edf->gecf", x, w_in.to(dt))
             + b_in[None, :, None].to(dt))
        y = (torch.einsum("gecf,efd->gecd", _gelu(z), w_out.to(dt))
             + b_out[None, :, None].to(dt))
        ctx.save_for_backward(x, z, w_in, w_out)
        return y

    @staticmethod
    def backward(ctx, ct):
        x, z, w_in, w_out = ctx.saved_tensors
        dt = x.dtype
        f32 = torch.float32
        h = _gelu(z)  # recomputed from the saved pre-activation
        d_w_out = torch.einsum("gecf,gecd->gefd", h.to(f32),
                               ct.to(f32)).sum(0)
        d_b_out = ct.to(f32).sum(2).sum(0)
        d_h = torch.einsum("gecd,efd->gecf", ct, w_out.to(dt))
        d_z = torch.ops.aten.gelu_backward(d_h, z, approximate="tanh")
        d_b_in = d_z.to(f32).sum(2).sum(0)
        d_w_in = torch.einsum("gecd,gecf->gedf", x.to(f32),
                              d_z.to(f32)).sum(0)
        d_x = torch.einsum("gecf,edf->gecd", d_z, w_in.to(dt))
        return (d_x, d_w_in.to(w_in.dtype), d_b_in.to(w_in.dtype),
                d_w_out.to(w_out.dtype), d_b_out.to(w_out.dtype))


def expert_ffn(x, w_in, b_in, w_out, b_out):
    """:class:`_ExpertFFN` on capacity blocks ``x`` in the compute dtype."""
    return _ExpertFFN.apply(x, w_in, b_in, w_out, b_out)


class MoEFFN(nn.Module):
    """Top-k mixture-of-experts FFN (switch-style at k = 1, gates
    renormalised over the chosen k at k ≥ 2) — the JAX package's
    ``MoEFFN`` with no mesh.

    Tokens route within groups (:func:`moe_group_partition`) through an
    f32 router; each expert takes at most ceil(cf·g·k/e) tokens a group,
    first choices before second ones (a choice-major cumsum). Dispatch
    and combine are one-hot einsums over the (experts, capacity) layout,
    the experts one batched product (:class:`_ExpertFFN`). ``token_w``
    (b, s) masks weight-0 tokens out of routing: they claim no
    capacity, move no aux loss and get no expert output.

    Inside :func:`collect_moe` the layer records its switch load-balance
    loss ``moe_aux_weight · e · mean_G Σ_e frac·mean_prob`` over valid
    tokens (frac from the first choice) and its (dropped, routed)
    counts. The expert weights are lecun-normal with Flax's fan-in of a
    3-D kernel: d·e for ``moe_w_in`` (e, d, d_ff), d_ff·e for
    ``moe_w_out``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = config
        if cfg.moe_ep_dispatch not in ("auto", "a2a", "replicate"):
            raise ValueError(f"unknown moe_ep_dispatch {cfg.moe_ep_dispatch!r}")
        self.config = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = Dense(d, e, torch.float32)
        self.moe_w_in = nn.Parameter(torch.empty(e, d, f))
        self.moe_b_in = nn.Parameter(torch.zeros(e, f))
        self.moe_w_out = nn.Parameter(torch.empty(e, f, d))
        self.moe_b_out = nn.Parameter(torch.zeros(e, d))
        _lecun_normal_(self.moe_w_in, d * e)
        _lecun_normal_(self.moe_w_out, f * e)

    def route(self, tokens):
        """The f32 router over (G, g, d) token groups: ``(probs, top-k
        probabilities, top-k expert indices)``."""
        k = max(1, min(self.config.moe_top_k, self.config.n_experts))
        probs = torch.softmax(self.router(tokens.float()), dim=-1)
        return (probs, *_top_k_routing(probs, k))

    def forward(self, x, token_w=None):
        cfg = self.config
        dt = cfg.compute_dtype
        b, s, d = x.shape
        e = cfg.n_experts
        k = max(1, min(cfg.moe_top_k, e))
        g, n_groups = moe_group_partition(cfg, b * s)
        cap = max(1, math.ceil(cfg.capacity_factor * g * k / e))
        tokens = x.reshape(n_groups, g, d)
        mask = (token_w.reshape(n_groups, g) > 0
                if token_w is not None else None)

        probs, topk_p, topk_idx = self.route(tokens)     # (G, g, k)
        if k == 1:
            gates = topk_p                                # switch: raw prob
        else:
            gates = topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9)
        oh = F.one_hot(topk_idx, e)                       # (G, g, k, e)
        if mask is not None:
            oh = oh * mask[:, :, None, None]
            gates = gates * mask[:, :, None]
        # Capacity with choice-level priority: every first choice ranks
        # before any second one. Flatten (k, g) choice-major, cumsum the
        # arrival order, unflatten.
        oh_t = oh.transpose(1, 2).reshape(n_groups, k * g, e)
        pos = oh_t.cumsum(1) * oh_t                       # 1-based rank
        keep = (pos > 0) & (pos <= cap)
        slot = (pos - 1).clamp(0, cap - 1)
        # The capacity one-hot as a comparison: a bool tensor, never the
        # int64 one F.one_hot would write (G·k·g·e·cap elements).
        slots = torch.arange(cap, device=slot.device)
        disp = (keep[..., None] & (slot[..., None] == slots)).reshape(
            n_groups, k, g, e, cap).transpose(1, 2)        # (G, g, k, e, cap)
        # A token's k choices are k distinct experts: the sum over the
        # choices is a 0/1 dispatch tensor.
        dispatch = disp.any(2).to(dt)                     # (G, g, e, cap)
        expert_in = torch.einsum("gnec,gnd->gecd", dispatch, tokens.to(dt))
        expert_out = expert_ffn(expert_in, self.moe_w_in, self.moe_b_in,
                                self.moe_w_out, self.moe_b_out)
        combine = torch.einsum("gnk,gnkec->gnec", gates.to(dt), disp.to(dt))
        out = torch.einsum("gnec,gecd->gnd", combine, expert_out)

        # The aux loss and counts are computed on every forward, recorded
        # or not: a remat layer's recomputation must save the tensors
        # its first run saved.
        oh0 = oh[:, :, 0].float()                         # (G, g, e)
        if mask is not None:
            mf = mask.float()
            valid = mf.sum(1).clamp_min(1.0)[:, None]
            frac = oh0.sum(1) / valid
            mean_prob = (probs * mf[:, :, None]).sum(1) / valid
        else:
            frac = oh0.mean(1)
            mean_prob = probs.mean(1)
        aux = cfg.moe_aux_weight * e * (frac * mean_prob).sum(-1).mean()
        routed = oh.sum().float()
        stats = _recording()
        if stats is not None:
            stats.aux.append(aux)
            stats.dropped.append(routed - keep.sum().float())
            stats.routed.append(routed)
        return out.reshape(b, s, d)


class EncoderLayer(nn.Module):
    def __init__(self, config: TransformerConfig, use_moe: bool = False):
        super().__init__()
        dt = config.compute_dtype
        self.ln_attn = LayerNorm(config.d_model, dt)
        self.attn = MultiHeadAttention(config)
        self.ln_mlp = LayerNorm(config.d_model, dt)
        # An MoE layer holds no dense FFN: a parameter that never gets a
        # gradient would still be decayed by AdamW (the step gives it a
        # zero gradient).
        if use_moe:
            self.moe = MoEFFN(config)
        else:
            self.mlp_in = Dense(config.d_model, config.d_ff, dt)
            self.mlp_out = Dense(config.d_ff, config.d_model, dt)
        self.use_moe = use_moe

    def forward(self, x, token_w=None):
        x = x + self.attn(self.ln_attn(x))
        h = self.ln_mlp(x)
        if self.use_moe:
            return x + self.moe(h, token_w)
        return x + self.mlp_out(_gelu(self.mlp_in(h)))


class Transformer(nn.Module):
    """Token-id encoder backbone. Accepts int ids or float columns (the
    estimator's feature matrix is float32; ids are cast).

    With ``own_embed=False`` the caller owns the token embedding and
    passes it to ``forward`` (weight tying in :class:`CausalLM`)."""

    def __init__(self, config: TransformerConfig, own_embed: bool = True):
        super().__init__()
        self.config = config
        dt = config.compute_dtype
        self.tok_embed = (Embed(config.vocab_size, config.d_model, dt)
                          if own_embed else None)
        self.pos_embed = nn.Parameter(
            torch.randn(config.max_len, config.d_model) * 0.02)
        self.layers = nn.ModuleList(
            EncoderLayer(config, use_moe) for use_moe in config.moe_pattern())
        self.ln_final = LayerNorm(config.d_model, dt)

    def forward(self, ids, example_w=None, embed: Optional[Embed] = None):
        cfg = self.config
        if ids.is_floating_point():
            # A non-finite id (a poisoned batch) goes out of range, so
            # its row is NaN: the cast alone would give INT_MIN on the
            # CPU and 0 on the card (as XLA's convert gives 0).
            ids = torch.where(torch.isfinite(ids), ids, -1.0).to(torch.int32)
        b, s = ids.shape
        embed = self.tok_embed if embed is None else embed
        x = embed(ids) + self.pos_embed[None, :s].to(cfg.compute_dtype)
        # Per-token weights for MoE routing: weight-0 (padding) examples
        # broadcast over their tokens.
        token_w = (example_w[:, None].expand(b, s)
                   if example_w is not None and cfg.n_experts > 0 else None)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (checkpoint(layer, x, token_w, use_reentrant=False) if remat
                 else layer(x, token_w))
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

    def forward(self, ids, example_w=None):
        x = self.backbone(ids, example_w)
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

    def forward(self, ids, example_w=None):
        if self.config.tie_embeddings:
            x = self.backbone(ids, example_w, embed=self.tok_embed)
            # f32 logits like the untied head: h @ Eᵀ.
            return self.tok_embed.attend(x)
        return self.lm_head(self.backbone(ids, example_w))


def bert_base(n_classes: int = 2, **overrides) -> SequenceClassifier:
    cfg = TransformerConfig(n_classes=n_classes, **overrides)
    return SequenceClassifier(cfg)


def tiny_transformer(**overrides) -> TransformerConfig:
    """Small config for tests and dry runs."""
    defaults = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                    d_ff=128, max_len=128)
    defaults.update(overrides)
    return TransformerConfig(**defaults)
