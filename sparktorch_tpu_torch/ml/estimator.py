"""``SparkTorchModel`` Transformer — the port of ``sparktorch_tpu/ml/estimator.py``.

``transform`` runs the batched forward over the whole column in fixed
1024-row chunks (the last one padded) through
:class:`sparktorch_tpu_torch.inference.BatchPredictor`, then emits the
argmax (multi-output), the scalar (single output) or, with
``useVectorOut``, the raw output vector per row.

The model runs on CUDA unless ``setDevice("cpu")`` says otherwise; with
no device set and no CUDA device present, ``transform`` raises. The
``SparkTorch`` estimator (training) is not ported yet.
"""

from __future__ import annotations

import base64
from typing import Any, NamedTuple, Optional

import dill
import numpy as np
import torch

from sparktorch_tpu_torch.ml.dataset import LocalDataFrame
from sparktorch_tpu_torch.ml.params import (
    Model,
    Param,
    Params,
    TypeConverters,
    keyword_only,
)
from sparktorch_tpu_torch.utils.serde import ModelSpec

_INFER_CHUNK = 1024  # fixed chunk: one input shape for every forward


class ModelBundle(NamedTuple):
    """What ``getModel`` returns: the module with its trained weights
    loaded, and the ``state_dict`` they came from (buffers included;
    torch has no separate model state)."""

    module: Any
    params: Any

    def apply(self, x):
        with torch.inference_mode():
            return self.module(x)


def _encode_bundle(spec: ModelSpec, params) -> str:
    payload = {"spec": spec, "params": params}
    return base64.b64encode(dill.dumps(payload)).decode()


def _decode_bundle(mod_str: str) -> dict:
    return dill.loads(base64.b64decode(mod_str))


class SparkTorchModel(Model):
    """Fitted model; ``transform`` adds a prediction column."""

    modStr = Param(Params._dummy(), "modStr", "serialized trained model",
                   TypeConverters.toString)
    useVectorOut = Param(Params._dummy(), "useVectorOut",
                         "emit the raw output vector instead of argmax/scalar",
                         TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, predictionCol=None, modStr=None,
                 useVectorOut=None):
        super().__init__()
        self._setDefault(predictionCol="predictions", useVectorOut=False)
        self._set(**self._input_kwargs)
        self._bundle_cache = None
        self._forward_cache = None
        self._device: Optional[str] = None

    def __getstate__(self):
        # Pipeline save dill-dumps the stage: ship the params, not the
        # decoded module or the device-resident predictor.
        state = dict(self.__dict__)
        state["_bundle_cache"] = None
        state["_forward_cache"] = None
        return state

    def copy(self, extra=None):
        # ``transform(df, params)`` works on a copy: let it reuse the
        # decoded module and the predictor instead of building new ones.
        new = super().copy(extra)
        new._bundle_cache = self._bundle_cache
        new._forward_cache = self._forward_cache
        return new

    def setDevice(self, device):
        """Where inference runs (``"cuda"``, ``"cuda:1"``, ``"cpu"``).
        The port's counterpart of the JAX package's ``setMesh``."""
        self._device = None if device is None else str(device)
        self._forward_cache = None
        return self

    def getDevice(self) -> Optional[str]:
        return self._device

    def getModStr(self) -> str:
        return self.getOrDefault(self.modStr)

    def getUseVectorOut(self) -> bool:
        return self.getOrDefault(self.useVectorOut)

    def getPytorchModel(self) -> ModelBundle:
        return self.getModel()

    def getModel(self) -> ModelBundle:
        if self._bundle_cache is None:
            payload = _decode_bundle(self.getModStr())
            spec: ModelSpec = payload["spec"]
            module = spec.make_module()
            module.load_state_dict(payload["params"], assign=True)
            self._bundle_cache = ModelBundle(
                module=module.eval(), params=payload["params"])
        return self._bundle_cache

    # -- inference ---------------------------------------------------------

    def _predictor(self):
        if self._forward_cache is None:
            from sparktorch_tpu_torch.inference import BatchPredictor

            self._forward_cache = BatchPredictor(
                self.getModel().module, device=self._device,
                chunk=_INFER_CHUNK,
            )
        return self._forward_cache

    def _predict_matrix(self, x: np.ndarray) -> np.ndarray:
        return self._predictor().predict(x)

    def _transform(self, dataset):
        df = LocalDataFrame.from_any(dataset)
        inp = self.getInputCol()
        out_col = self.getPredictionCol()
        x = df.column_matrix(inp)
        if x.shape[0] == 0:
            # Zero-row frame: emit an empty prediction column without
            # touching the model.
            dtype = object if self.getUseVectorOut() else np.float64
            return df.with_column(out_col, np.empty((0,), dtype=dtype))
        preds = self._predict_matrix(x)

        if self.getUseVectorOut():
            values = np.empty(len(df), dtype=object)
            for i in range(len(df)):
                values[i] = np.asarray(preds[i])
            return df.with_column(out_col, values)

        # Float path: argmax for multi-output, scalar otherwise.
        flat = preds.reshape(preds.shape[0], -1)
        if flat.shape[1] > 1:
            values = np.argmax(flat, axis=1).astype(np.float64)
        else:
            values = flat[:, 0].astype(np.float64)
        return df.with_column(out_col, values)
