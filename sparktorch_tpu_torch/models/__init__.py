"""Model zoo (ported so far: the transformer family)."""

from sparktorch_tpu_torch.models.transformer import (
    CausalLM,
    SequenceClassifier,
    Transformer,
    TransformerConfig,
    bert_base,
    tiny_transformer,
)

__all__ = [
    "CausalLM",
    "SequenceClassifier",
    "Transformer",
    "TransformerConfig",
    "bert_base",
    "tiny_transformer",
]
