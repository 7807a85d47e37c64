"""Batch inference over already-trained models — the port of ``sparktorch_tpu/inference.py``.

A "trained model" here is a torch module holding its weights (or a
module plus a ``state_dict`` to load). :class:`BatchPredictor` runs it
in fixed-size chunks under ``torch.inference_mode()`` on an explicit
device: CUDA unless the caller passes ``device="cpu"``.

Not ported yet: ``predict_device``, ``predict_stream``, Parquet
streaming (``write_rows_parquet``, ``stream_parquet_predict``), the
serving telemetry and ``update_params``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from sparktorch_tpu_torch.ml.estimator import SparkTorchModel, _encode_bundle
from sparktorch_tpu_torch.ml.pipeline import PipelineModel
from sparktorch_tpu_torch.utils.serde import ModelSpec, meta_copy


def _resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for (or
    left to the default) and there is no card. The port never falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


class BatchPredictor:
    """Chunked batch inference on one device.

    Every forward sees one input shape: rows go in ``chunk``-row
    pieces, and when there is more than one chunk the last is
    zero-padded to ``chunk`` rows (the padding is cut from the output).
    On CUDA the host→device copy of chunk i+1 is enqueued from pinned
    memory before chunk i's result is read back, so the copy overlaps
    the readback; device memory holds about two chunks.
    """

    def __init__(self, module: torch.nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, chunk: int = 1024):
        """``params`` (optional) is a ``state_dict`` to load into
        ``module`` first (buffers included: torch has no separate
        model state)."""
        self.device = _resolve_device(device)
        if params is not None:
            module.load_state_dict(params)
        self.module = module.to(self.device).eval()
        self.chunk = max(1, int(chunk))

    def _chunks(self, x: np.ndarray, n: int):
        """Yield (padded_part, real_rows) chunks of one shape."""
        for start in range(0, n, self.chunk):
            part = x[start : start + self.chunk]
            real = part.shape[0]
            if real < self.chunk and n > self.chunk:
                pad = np.zeros((self.chunk - real, *part.shape[1:]),
                               part.dtype)
                part = np.concatenate([part, pad])
            yield part, real

    def _put(self, part: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(part))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(x)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Chunked forward over the rows of ``x`` (numpy)."""
        x = np.asarray(x)
        n = x.shape[0]
        if n == 0:
            # Probe one row for the output shape.
            probe = np.zeros((1, *x.shape[1:]), x.dtype)
            return self._fwd(self._put(probe)).cpu().numpy()[:0]
        parts = self._chunks(x, n)
        host = []
        nxt = next(parts)
        dev = self._put(nxt[0])
        prev = None  # (device_out, real) one chunk behind
        while nxt is not None:
            _, real = nxt
            out = self._fwd(dev)
            nxt = next(parts, None)
            if nxt is not None:
                dev = self._put(nxt[0])  # queued before the readback below
            if prev is not None:
                host.append(prev[0].cpu().numpy()[: prev[1]])
            prev = (out, real)
        host.append(prev[0].cpu().numpy()[: prev[1]])
        return np.concatenate(host) if len(host) > 1 else host[0]


def convert_to_serialized(
        model: torch.nn.Module,
        variables: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Serialize a trained module to the model string format used by
    :class:`SparkTorchModel`: a weight-free copy of the module plus a
    ``state_dict`` (``variables`` if given, else the module's own)."""
    if variables is None:
        variables = model.state_dict()
    params = {k: v.detach().cpu() for k, v in dict(variables).items()}
    return _encode_bundle(ModelSpec(module=meta_copy(model)), params)


def create_spark_torch_model(
    model: torch.nn.Module,
    variables: Optional[Mapping[str, torch.Tensor]] = None,
    inputCol: str = "features",
    predictionCol: str = "predicted",
    useVectorOut: bool = False,
) -> SparkTorchModel:
    """Wrap a trained module as a transformer without running ``fit``."""
    return SparkTorchModel(
        inputCol=inputCol,
        predictionCol=predictionCol,
        modStr=convert_to_serialized(model, variables),
        useVectorOut=useVectorOut,
    )


def attach_model_to_pipeline(
    pipeline_model: PipelineModel,
    spark_model: SparkTorchModel,
) -> PipelineModel:
    """Append an inference stage to a fitted pipeline."""
    return PipelineModel(list(pipeline_model.stages) + [spark_model])


# Reference-compatible name.
attach_pytorch_model_to_pipeline = attach_model_to_pipeline
