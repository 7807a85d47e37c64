"""sparktorch_tpu_torch — the PyTorch/CUDA port of ``sparktorch_tpu``.

The JAX package stays in the repository as the reference; this package
sits beside it, mirrors its layout and names, and runs on an NVIDIA
Hopper card. Each Pallas kernel of the JAX package becomes a kernel
written by hand for Hopper (``ops/csrc``).

Ported so far: synchronous training on one GPU (``SparkTorch.fit``),
with step checkpoints and resume (``utils/checkpoint.py``) and a
streaming trainer for data larger than the card
(``train.sync.train_distributed_streaming``), hogwild training through
the parameter server (``mode="hogwild"``: ``train/hogwild.py``,
``serve/param_server.py``, the binary wire in ``net/``), and batch
inference (``SparkTorchModel.transform``, ``BatchPredictor`` with
on-device pre- and postprocessing, ``predict_device`` and live weight
updates, and Parquet streaming: ``inference.write_rows_parquet``,
``inference.stream_parquet_predict``) of the small nets, the MNIST nets,
the ResNets and the transformer family, with flash attention (forward
and backward) and the fused cross-entropy as CUDA kernels, plus model
packaging and pipeline persistence, and the online serving tier
(``serve.infer``, ``serve.router``: continuous-batching replicas behind
a router, restarts, live weight pulls) with the core of the telemetry
bus (``obs``) and the ft policies and chaos harness (``ft``). It
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
from sparktorch_tpu_torch.ml.estimator import SparkTorch, SparkTorchModel
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
    "SparkTorch",
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
