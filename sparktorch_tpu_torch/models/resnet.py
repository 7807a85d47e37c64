"""ResNet family — the port of ``sparktorch_tpu/models/resnet.py``.

BASELINE configs 3 and 5: ResNet-18 on CIFAR-10 through the hogwild
parameter server, ResNet-50 batch inference. The input contract is the
JAX package's: NHWC images, or flat rows in H·W·C order with
``input_hw=(H, W, C)``. ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC
tensor is NCHW in channels-last layout with no copy, and every
convolution runs in that layout.

Parameters and BatchNorm statistics are float32, the body computes in
``compute_dtype`` (bfloat16 by default), the head in float32, and the
last BatchNorm of each block starts with a zero scale. Submodules carry
the Flax names (``conv_stem``, ``stage1_block0.Conv_0``, ``norm_proj``,
``head``...).

Convolutions and the stem's max pool pad as XLA's ``"SAME"`` does,
asymmetrically under stride 2 (:func:`~sparktorch_tpu_torch.models.simple.same_pads`).

:class:`BatchNorm` keeps Flax's rules where ``nn.BatchNorm2d`` has
others: the running statistics move by ``1 - momentum`` (Flax's 0.9 is
torch's 0.1), the running variance takes the *biased* batch variance,
and the statistics are reduced in float32 whatever the activations'
dtype. Train mode normalises by batch statistics and updates the
running ones (Flax's ``mutable=["batch_stats"]``); eval mode uses the
running ones.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Type

import torch
import torch.nn.functional as F
from torch import nn

from sparktorch_tpu_torch.models.simple import (
    Conv,
    Dense,
    DType,
    as_dtype,
    nhwc_to_nchw,
    pad_same,
)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channels of an NCHW tensor."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        # F.batch_norm (cuDNN on the card) reduces in float32 and moves
        # a running variance by the unbiased batch variance:
        # v ← d·v + (1 − d)·s²·n/(n − 1). Flax moves it by the biased s²,
        # so the op moves a copy (autograd keeps what the op was given)
        # and the buffer takes that step scaled back by (n − 1)/n.
        n = x.numel() // x.shape[1]
        decay = self.momentum
        moved = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias,
                         True, 1.0 - decay, self.epsilon)
        with torch.no_grad():
            kept = decay * self.running_var
            self.running_var.copy_(kept + (moved - kept) * ((n - 1) / n))
        return y


class ResNetBlock(nn.Module):
    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides, False)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        if in_features != filters or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_features, filters, (1, 1), strides, False)
            self.norm_proj = BatchNorm(filters)
        else:
            self.conv_proj = self.norm_proj = None
        self.out_features = filters

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x if self.conv_proj is None else self.norm_proj(
            self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1)):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, False)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        if in_features != out or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_features, out, (1, 1), strides, False)
            self.norm_proj = BatchNorm(out)
        else:
            self.conv_proj = self.norm_proj = None
        self.out_features = out

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x if self.conv_proj is None else self.norm_proj(
            self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module],
                 num_classes: int = 10, width: int = 64,
                 compute_dtype: DType = torch.bfloat16,
                 input_hw: Optional[Tuple[int, int, int]] = None,
                 small_images: bool = True):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.input_hw = None if input_hw is None else tuple(input_hw)
        self.small_images = small_images
        in_channels = self.input_hw[2] if self.input_hw else 3
        if small_images:
            self.conv_stem = Conv(in_channels, width, (3, 3), use_bias=False)
        else:
            self.conv_stem = Conv(in_channels, width, (7, 7), (2, 2), False)
        self.norm_stem = BatchNorm(width)
        features = width
        self.block_names = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = block_cls(features, width * 2 ** i, strides)
                name = f"stage{i}_block{j}"
                self.add_module(name, block)
                self.block_names.append(name)
                features = block.out_features
        self.head = Dense(features, num_classes, torch.float32)

    def forward(self, x):
        if x.dim() == 2:
            if self.input_hw is None:
                raise ValueError("flat input needs input_hw=(H, W, C)")
            x = x.reshape(x.shape[0], *self.input_hw)
        x = nhwc_to_nchw(x).to(self.compute_dtype)
        x = F.relu(self.norm_stem(self.conv_stem(x)))
        if not self.small_images:
            x, padding = pad_same(x, (3, 3), (2, 2), value=float("-inf"))
            x = F.max_pool2d(x, 3, 2, padding)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.compute_dtype)
        return self.head(x)


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock,
                  num_classes=num_classes, **kw)


def resnet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock,
                  num_classes=num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    kw.setdefault("small_images", False)
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock,
                  num_classes=num_classes, **kw)
