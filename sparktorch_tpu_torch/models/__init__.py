"""Model zoo (ported so far: the small nets, the ResNet family and the
transformer family), under the JAX package's names."""

from sparktorch_tpu_torch.models.simple import (
    MLP,
    Net,
    AutoEncoder,
    ClassificationNet,
    NetworkWithParameters,
    MnistMLP,
    MnistCNN,
)
from sparktorch_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet34,
    resnet50,
)
from sparktorch_tpu_torch.models.transformer import (
    CausalLM,
    SequenceClassifier,
    Transformer,
    TransformerConfig,
    bert_base,
    tiny_transformer,
)

__all__ = [
    "MLP",
    "Net",
    "AutoEncoder",
    "ClassificationNet",
    "NetworkWithParameters",
    "MnistMLP",
    "MnistCNN",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "TransformerConfig",
    "Transformer",
    "SequenceClassifier",
    "CausalLM",
    "bert_base",
    "tiny_transformer",
]
