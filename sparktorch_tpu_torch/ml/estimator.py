"""``SparkTorch`` Estimator and ``SparkTorchModel`` Transformer — the port of ``sparktorch_tpu/ml/estimator.py``.

``SparkTorch.fit`` trains the packaged model on one device (or
data-parallel over a ``mesh`` of the process group) with the
synchronous trainer (:func:`sparktorch_tpu_torch.train.sync.train_distributed`,
with step snapshots in ``checkpointDir`` every ``checkpointEvery`` steps
and ``resume`` from the newest) or, with ``mode="hogwild"``, through the
parameter server (:func:`sparktorch_tpu_torch.train.hogwild.train_async`,
which ignores ``checkpointDir`` as the reference's does), and returns
a ``SparkTorchModel`` holding the trained ``state_dict`` (BatchNorm
running statistics included). The Param surface is the JAX package's, name for name;
``device`` defaults to ``"cuda"`` and raises when there is no card.

``transform`` runs the batched forward over the whole column in fixed
1024-row chunks (the last one padded) through
:class:`sparktorch_tpu_torch.inference.BatchPredictor`, then emits the
argmax (multi-output), the scalar (single output) or, with
``useVectorOut``, the raw output vector per row.

The model runs on CUDA unless ``setDevice("cpu")`` says otherwise; with
no device set and no CUDA device present, ``transform`` raises.
``setMesh`` shards each chunk over the ranks of a data-parallel mesh
(every rank transforms the same frame and gets every row).
"""

from __future__ import annotations

import base64
from typing import Any, NamedTuple, Optional

import dill
import numpy as np
import torch

from sparktorch_tpu_torch.ml.dataset import LocalDataFrame
from sparktorch_tpu_torch.ml.params import (
    Estimator,
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
        self._mesh = None

    def __getstate__(self):
        # Pipeline save dill-dumps the stage: ship the params, not the
        # decoded module, the device-resident predictor or the mesh
        # (its process group belongs to this process).
        state = dict(self.__dict__)
        state["_bundle_cache"] = None
        state["_forward_cache"] = None
        state["_mesh"] = None
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

    def setMesh(self, mesh):
        """Mesh-parallel inference (``sparktorch_tpu/ml/estimator.py:90-96``):
        each chunk is split over the batch shards (dp × fsdp) of ``mesh`` (a
        :func:`~sparktorch_tpu_torch.parallel.mesh.build_mesh` mesh or a
        ``MeshConfig``), every rank runs its share on its device, and
        one all-gather gives every rank all the rows. Every rank must
        call ``transform`` with the same frame."""
        self._mesh = mesh
        self._forward_cache = None
        return self

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

            from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

            mesh = self._mesh
            if isinstance(mesh, MeshConfig):
                mesh = build_mesh(mesh)
            self._forward_cache = BatchPredictor(
                self.getModel().module, device=self._device,
                chunk=_INFER_CHUNK, mesh=mesh,
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, Queue 1: "
                               f"{item})")


class SparkTorch(Estimator):
    """The training Estimator (reference ``torch_distributed.py:130-349``)."""

    torchObj = Param(Params._dummy(), "torchObj",
                     "serialized model spec envelope", TypeConverters.toString)
    mode = Param(Params._dummy(), "mode",
                 "training mode: synchronous | hogwild",
                 TypeConverters.toString)
    device = Param(Params._dummy(), "device",
                   "device to train on: cuda (default) or cpu",
                   TypeConverters.toString)
    iters = Param(Params._dummy(), "iters",
                  "training iterations per shuffle round", TypeConverters.toInt)
    partitions = Param(Params._dummy(), "partitions", "data partition hint",
                       TypeConverters.toInt)
    verbose = Param(Params._dummy(), "verbose", "loss logging verbosity",
                    TypeConverters.toInt)
    acquireLock = Param(Params._dummy(), "acquireLock",
                        "serialize async server applies",
                        TypeConverters.toBoolean)
    partitionShuffles = Param(Params._dummy(), "partitionShuffles",
                              "global reshuffle rounds", TypeConverters.toInt)
    port = Param(Params._dummy(), "port", "param-server port (async mode)",
                 TypeConverters.toInt)
    useBarrier = Param(Params._dummy(), "useBarrier",
                       "gang scheduling (always true here)",
                       TypeConverters.toBoolean)
    useVectorOut = Param(Params._dummy(), "useVectorOut",
                         "fitted model emits raw output vectors",
                         TypeConverters.toBoolean)
    earlyStopPatience = Param(Params._dummy(), "earlyStopPatience",
                              "early-stop patience (-1 disables)",
                              TypeConverters.toInt)
    miniBatch = Param(Params._dummy(), "miniBatch",
                      "minibatch size per step (-1 = full batch)",
                      TypeConverters.toInt)
    validationPct = Param(Params._dummy(), "validationPct",
                          "validation split fraction", TypeConverters.toFloat)
    pushEvery = Param(Params._dummy(), "pushEvery",
                      "async mode: push mean of every k grads",
                      TypeConverters.toInt)
    checkpointDir = Param(Params._dummy(), "checkpointDir",
                          "step-indexed checkpoint directory (sync mode)",
                          TypeConverters.toString)
    checkpointEvery = Param(Params._dummy(), "checkpointEvery",
                            "save a snapshot every N steps (0 disables)",
                            TypeConverters.toInt)
    resume = Param(Params._dummy(), "resume",
                   "resume from the latest snapshot in checkpointDir",
                   TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, labelCol=None, predictionCol=None,
                 torchObj=None, iters=None, partitions=None, verbose=None,
                 mode=None, device=None, acquireLock=None,
                 partitionShuffles=None, port=None, useBarrier=None,
                 useVectorOut=None, earlyStopPatience=None, miniBatch=None,
                 validationPct=None, pushEvery=None, checkpointDir=None,
                 checkpointEvery=None, resume=None, mesh=None, seed=None,
                 n_micro=None):
        super().__init__()
        self._setDefault(
            predictionCol="predictions",
            mode="synchronous",
            device="cuda",
            iters=10,
            verbose=0,
            acquireLock=True,
            partitionShuffles=1,
            port=3000,
            useBarrier=True,
            useVectorOut=False,
            earlyStopPatience=-1,
            miniBatch=-1,
            validationPct=0.0,
            pushEvery=1,
            checkpointEvery=0,
            resume=False,
        )
        self._mesh, self._seed, self._n_micro = None, 0, 4
        self._set_args(self._input_kwargs)

    def _set_args(self, kwargs: dict):
        """mesh, seed and n_micro are plain attributes, not ML Params;
        the rest are Params."""
        kwargs = dict(kwargs)
        if "mesh" in kwargs:
            self._mesh = kwargs.pop("mesh")
        for key, attr in (("seed", "_seed"), ("n_micro", "_n_micro")):
            value = kwargs.pop(key, None)
            if value is not None:
                setattr(self, attr, int(value))
        return self._set(**kwargs)

    @keyword_only
    def setParams(self, **kwargs):
        return self._set_args(self._input_kwargs)

    def setMesh(self, mesh):
        """Train data-parallel over ``mesh`` (a
        :func:`~sparktorch_tpu_torch.parallel.mesh.build_mesh` mesh or a
        ``MeshConfig``, e.g. ``MeshConfig(fsdp=2)``): every rank of the
        process group fits with the same frame and trains its shard of
        it, the batch split over dp × fsdp with the parameters
        replicated (tp peers train the same shard), as the JAX
        package's ``train_distributed`` does."""
        self._mesh = mesh
        return self

    def _resolve_mesh(self):
        from sparktorch_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh

        if self._mesh is None or isinstance(self._mesh, Mesh):
            return self._mesh
        if isinstance(self._mesh, MeshConfig):
            return build_mesh(self._mesh)
        raise _not_ported(f"mesh {self._mesh!r} (the port takes the dp x "
                          "fsdp x tp mesh of parallel.mesh.build_mesh)",
                          "the rest of multi-GPU training, items 7 and 8")

    def getTorchObj(self):
        return self.getOrDefault(self.torchObj)

    def getMode(self):
        return self.getOrDefault(self.mode)

    def getDevice(self):
        return self.getOrDefault(self.device)

    def getIters(self):
        return self.getOrDefault(self.iters)

    def getPartitions(self):
        return (self.getOrDefault(self.partitions)
                if self.isDefined(self.partitions) else -1)

    def getVerbose(self):
        return self.getOrDefault(self.verbose)

    def getAcquireLock(self):
        return self.getOrDefault(self.acquireLock)

    def getPartitionShuffles(self):
        return self.getOrDefault(self.partitionShuffles)

    def getPort(self):
        return self.getOrDefault(self.port)

    def getUseBarrier(self):
        return self.getOrDefault(self.useBarrier)

    def getUseVectorOut(self):
        return self.getOrDefault(self.useVectorOut)

    def getEarlyStopPatience(self):
        return self.getOrDefault(self.earlyStopPatience)

    def getMiniBatch(self):
        return self.getOrDefault(self.miniBatch)

    def getValidationPct(self):
        return self.getOrDefault(self.validationPct)

    def getCheckpointDir(self):
        return (self.getOrDefault(self.checkpointDir)
                if self.isDefined(self.checkpointDir) else None)

    def getCheckpointEvery(self):
        return self.getOrDefault(self.checkpointEvery)

    def getResume(self):
        return self.getOrDefault(self.resume)

    def _extract_xy(self, df: LocalDataFrame):
        x = df.column_matrix(self.getInputCol())
        label_col = self.getLabelCol()
        y = None
        if label_col is not None and label_col in df.columns:
            col = df[label_col]
            y = (np.stack([np.asarray(v) for v in col]) if col.dtype == object
                 else np.asarray(col))
        return x, y

    def _fit(self, dataset) -> SparkTorchModel:
        mode = self.getMode()
        if mode not in ("synchronous", "sync", "barrier", "hogwild", "async"):
            raise ValueError(
                f"unknown mode {mode!r}; use 'synchronous' or 'hogwild'")
        if self._n_micro != 4:
            raise _not_ported("an n_micro setting",
                              "multi-GPU training and train/pipeline.py")
        mesh = self._resolve_mesh()

        df = LocalDataFrame.from_any(dataset)
        x, y = self._extract_xy(df)
        mini_batch = self.getMiniBatch()
        common = dict(
            labels=y,
            iters=self.getIters(),
            partition_shuffles=self.getPartitionShuffles(),
            verbose=self.getVerbose(),
            mini_batch=mini_batch if mini_batch and mini_batch > 0 else None,
            validation_pct=self.getValidationPct(),
            early_stop_patience=self.getEarlyStopPatience(),
            seed=self._seed,
            device=self.getDevice(),
        )
        if mode in ("hogwild", "async"):
            from sparktorch_tpu_torch.train.hogwild import train_async

            result = train_async(
                self.getTorchObj(), x,
                acquire_lock=self.getAcquireLock(),
                port=self.getPort(),
                partitions=self.getPartitions(),
                push_every=self.getOrDefault(self.pushEvery),
                **common)
        else:
            from sparktorch_tpu_torch.train.sync import train_distributed
            from sparktorch_tpu_torch.utils.checkpoint import latest_step

            # Resume only from a finalized snapshot: resume=True over an
            # empty or torn directory trains from scratch.
            ckpt_dir = self.getCheckpointDir()
            resume = bool(ckpt_dir and self.getResume()
                          and latest_step(ckpt_dir) is not None)
            result = train_distributed(
                self.getTorchObj(), x, checkpoint_dir=ckpt_dir,
                checkpoint_every=self.getCheckpointEvery(), resume=resume,
                mesh=mesh, **common)
        self._last_metrics = result.metrics
        self._last_summary = result.summary
        return SparkTorchModel(
            inputCol=self.getInputCol(),
            predictionCol=self.getPredictionCol(),
            modStr=_encode_bundle(result.spec, result.params),
            useVectorOut=self.getUseVectorOut(),
        )
