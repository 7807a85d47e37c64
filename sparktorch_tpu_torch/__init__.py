"""sparktorch_tpu_torch — the PyTorch/CUDA port of ``sparktorch_tpu``.

The JAX package stays in the repository as the reference; this package
sits beside it, mirrors its layout and names, and runs on an NVIDIA
Hopper card. Each Pallas kernel of the JAX package becomes a kernel
written by hand for Hopper (``ops/csrc``).

Ported so far: batch inference (``SparkTorchModel.transform`` and
``BatchPredictor``) of the transformer family, with flash attention as
a CUDA kernel, plus model packaging and pipeline persistence. It
imports neither jax nor anything of ``sparktorch_tpu``.
"""

from sparktorch_tpu_torch.utils.serde import (
    ModelSpec,
    serialize_model,
    serialize_model_lazy,
    deserialize_model,
    serialize_torch_obj,
    serialize_torch_obj_lazy,
)
from sparktorch_tpu_torch.ml.estimator import SparkTorchModel
from sparktorch_tpu_torch.ml.pipeline import Pipeline, PipelineModel, PysparkPipelineWrapper
from sparktorch_tpu_torch.inference import (
    BatchPredictor,
    create_spark_torch_model,
    attach_model_to_pipeline,
    attach_pytorch_model_to_pipeline,
    convert_to_serialized,
)

__version__ = "0.1.0"

__all__ = [
    "ModelSpec",
    "serialize_model",
    "serialize_model_lazy",
    "deserialize_model",
    "serialize_torch_obj",
    "serialize_torch_obj_lazy",
    "SparkTorchModel",
    "Pipeline",
    "PipelineModel",
    "PysparkPipelineWrapper",
    "BatchPredictor",
    "create_spark_torch_model",
    "attach_model_to_pipeline",
    "attach_pytorch_model_to_pipeline",
    "convert_to_serialized",
]
