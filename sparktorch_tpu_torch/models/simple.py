"""Small networks — the port of ``sparktorch_tpu/models/simple.py``.

The same nets under the same names and constructor defaults: ``MLP``,
``Net``, ``AutoEncoder``, ``ClassificationNet``,
``NetworkWithParameters``, ``MnistMLP`` and ``MnistCNN``. Submodules
carry the Flax modules' names (``Dense_0``, ``Conv_1``, ``dense_2``...),
so :func:`sparktorch_tpu_torch.convert.state_dict_from_flax`
maps one package's parameters onto the other's by name.

Torch sizes a layer when it is built, Flax at the first call, so the
port takes the input width where Flax infers it: the nets' declared
``in_features``/``input_size``, ``MnistMLP(in_features=784)``, and
``MLP(in_features=None)``, whose first layer is then a ``LazyLinear``
that :class:`~sparktorch_tpu_torch.utils.serde.ModelSpec` sizes from
its ``input_shape``.

``MnistCNN`` takes flat 784-feature rows, (n, 28, 28) or NHWC
(n, 28, 28, 1) images, runs its convolutions channels-last, and
flattens in H·W·C order before its first Dense, as the Flax net does.
Parameters are float32; ``compute_dtype`` (bfloat16 by default) is the
dtype of every layer but the float32 head.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

DType = Union[str, torch.dtype]


def as_dtype(dtype: DType) -> torch.dtype:
    """``torch.bfloat16`` for ``"bfloat16"`` (or the dtype itself)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's default kernel init: a normal of variance 1/fan_in,
    truncated at two standard deviations (and rescaled for it)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: float32 parameters, input, kernel
    and bias cast to ``dtype`` for the product; Flax's init."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: DType = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = as_dtype(dtype)
        with torch.no_grad():
            lecun_normal_(self.weight, in_features)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the total that keeps
    ceil(size / stride) outputs, the odd pixel at the end. Under stride 2
    on an even size it is asymmetric ((0, 1) for a 3×3 on 32, (2, 3)
    for a 7×7 on 224), which torch's symmetric ``padding=k//2`` is not."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Tuple[int, int],
             strides: Tuple[int, int], value: float = 0.0):
    """``x`` (N, C, H, W) padded as ``"SAME"`` asks, and the symmetric
    padding left for the op itself: ``(x, (ph, pw))``. Only asymmetric
    pads are materialised (``F.pad``; the layout is kept)."""
    (t, b), (l, r) = (same_pads(n, k, s) for n, k, s in
                      zip(x.shape[2:], kernel, strides))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class Conv(nn.Module):
    """Flax ``nn.Conv(features, kernel, strides, padding="SAME")`` on
    NCHW tensors: an OIHW float32 kernel, cast to the input's dtype and
    to channels-last for the product (cuDNN's bf16 convolutions want
    that layout)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 use_bias: bool = True):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_features, *kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        with torch.no_grad():
            lecun_normal_(self.weight, in_features * kernel[0] * kernel[1])

    def forward(self, x):
        x, padding = pad_same(x, self.kernel, self.strides)
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.strides, padding)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW: a view, which is NCHW in channels-last
    layout when ``x`` is contiguous."""
    return x.permute(0, 3, 1, 2)


class MLP(nn.Module):
    """Generic MLP: hidden widths + activation + optional head act."""

    def __init__(self, features: Sequence[int],
                 activation: Callable = F.relu,
                 final_activation: Optional[Callable] = None,
                 in_features: Optional[int] = None):
        super().__init__()
        self.features = tuple(features)
        self.activation = activation
        self.final_activation = final_activation
        widths = (in_features,) + self.features
        for i, width in enumerate(self.features):
            layer = (nn.LazyLinear(width) if widths[i] is None
                     else nn.Linear(widths[i], width))
            self.add_module(f"dense_{i}", layer)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(len(self.features)):
            x = getattr(self, f"dense_{i}")(x)
            if i < len(self.features) - 1:
                x = self.activation(x)
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x


class Net(nn.Module):
    """10 -> 20 -> 1 regressor (tests/simple_net.py:5-16)."""

    def __init__(self, in_features: int = 10, hidden: int = 20):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, 1)

    def forward(self, x):
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x)


class AutoEncoder(nn.Module):
    """10 -> 5 -> 10 autoencoder (tests/simple_net.py:19-36)."""

    def __init__(self, in_features: int = 10, latent: int = 5):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, latent)
        self.Dense_1 = nn.Linear(latent, in_features)

    def forward(self, x):
        z = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(z)


class ClassificationNet(nn.Module):
    """10 -> 20 -> n_classes with log-softmax head
    (tests/simple_net.py:39-51); pairs with the ``nll`` loss."""

    def __init__(self, in_features: int = 10, hidden: int = 20,
                 n_classes: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, n_classes)

    def forward(self, x):
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return F.log_softmax(self.Dense_1(x), dim=-1)


class NetworkWithParameters(nn.Module):
    """Ctor-parameterized net (tests/simple_net.py:54-65) — the lazy
    path ships its kwargs with the class."""

    def __init__(self, input_size: int = 10, hidden_size: int = 20,
                 output_size: int = 1):
        super().__init__()
        self.Dense_0 = nn.Linear(input_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, output_size)

    def forward(self, x):
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x)


class MnistMLP(nn.Module):
    """784 -> 256 -> 128 -> 10 (examples/simple_dnn.py workload)."""

    def __init__(self, hidden: Sequence[int] = (256, 128),
                 n_classes: int = 10, in_features: int = 784):
        super().__init__()
        widths = (in_features, *hidden, n_classes)
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


class MnistCNN(nn.Module):
    """MNIST conv net (examples/cnn_network.py:6-24 capability), for
    28×28×1 images."""

    def __init__(self, n_classes: int = 10, width: int = 32,
                 compute_dtype: DType = torch.bfloat16):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.Conv_0 = Conv(1, width, (3, 3))
        self.Conv_1 = Conv(width, width * 2, (3, 3))
        self.Dense_0 = Dense(7 * 7 * width * 2, 128, self.compute_dtype)
        self.Dense_1 = Dense(128, n_classes, torch.float32)

    def forward(self, x):
        if x.dim() == 2:  # flat (batch, 784) rows
            x = x.reshape(x.shape[0], 28, 28, 1)
        elif x.dim() == 3:
            x = x[..., None]
        x = nhwc_to_nchw(x).to(self.compute_dtype)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # H·W·C order
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)
