"""PySpark Estimator/Model adapter over the port's trainers — the port of ``sparktorch_tpu/spark/torch_distributed.py``.

A real ``pyspark.ml`` Estimator with the reference's Param surface
(``sparktorch/torch_distributed.py``). The ``device`` Param names where
training and inference run: ``"cuda"`` (the default, raising when there
is no card) or ``"cpu"``; nothing picks the CPU on its own. Three deploy
paths:

- ``deployMode='driver'`` (default): executors only *produce data*
  (their partitions stream to the driver), and the driver trains with
  :func:`~sparktorch_tpu_torch.train.sync.train_distributed` or, with
  ``mode='hogwild'``, :func:`~sparktorch_tpu_torch.train.hogwild.train_async`.
- ``deployMode='barrier'``, synchronous: the reference's topology, one
  Spark **barrier task per device** (``rdd.barrier()``). Task index =
  rank; the driver runs the native gang coordinator; each task calls
  :func:`~sparktorch_tpu_torch.parallel.launch.bringup_multihost`
  (gloo when ``device`` is the CPU, NCCL on cards) and trains its
  partition with
  :func:`~sparktorch_tpu_torch.train.sync.train_distributed_multihost`
  (weight-0 padding absorbs skewed and empty partitions). Rank 0 yields
  the bundle.
- ``deployMode='barrier'``, ``mode='hogwild'``: the driver hosts the
  parameter server over HTTP, and each executor task runs the hogwild
  worker loop against it (binary wire, bf16 pushes when ``compress``;
  or the reference's dill wire).

Inference (``SparkTorchModel._transform``) is a pandas UDF over a
broadcast model bundle, running the port's chunked
:class:`~sparktorch_tpu_torch.inference.BatchPredictor`, versus the
reference's batch-1 row UDF.

Not ported yet (ROADMAP, Queue 1): ``supervise`` (the ft supervisor,
item 9); it raises.
"""

from __future__ import annotations

import socket

import numpy as np

from sparktorch_tpu_torch.spark.localsession import require_pyspark

try:
    require_pyspark()
    from pyspark import keyword_only
    from pyspark.ml.base import Estimator, Model
    from pyspark.ml.param import Param, Params, TypeConverters
    from pyspark.ml.param.shared import HasInputCol, HasLabelCol, HasPredictionCol
    from pyspark.ml.util import MLReadable, MLWritable
    from pyspark.sql.functions import pandas_udf
    from pyspark.sql.types import ArrayType, DoubleType
except ImportError as _e:  # pragma: no cover
    raise ImportError(
        "sparktorch_tpu_torch.spark requires pyspark (or "
        "sparktorch_tpu_torch.spark.localsession.install()); use "
        "sparktorch_tpu_torch.ml for the JVM-free surface"
    ) from _e


from sparktorch_tpu_torch.ml.estimator import (
    _decode_bundle,
    _encode_bundle,
    _not_ported,
)
from sparktorch_tpu_torch.spark.pipeline_util import PythonStagePersistence
from sparktorch_tpu_torch.utils.serde import deserialize_model


def _labels_to_f32(values, label_col) -> np.ndarray:
    try:
        return np.asarray(values, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"labelCol {label_col!r} must be numeric; index string "
            "labels first (e.g. StringIndexer)"
        ) from e


def _rows_to_x(rows) -> np.ndarray:
    """Stack row features (DenseVector or array-like) into a float32
    matrix — the vectorized analog of the reference's per-row
    ``row[input_col].toArray()`` (torch_distributed.py:43-55)."""
    return np.stack([
        np.asarray(r[0], dtype=np.float32)
        if not hasattr(r[0], "toArray")
        else r[0].toArray().astype(np.float32)
        for r in rows
    ])


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class _SparkTorchParams(HasInputCol, HasLabelCol, HasPredictionCol):
    """The reference's 14 declared Params (torch_distributed.py:141-154)
    plus deployMode and the JAX package's additions."""

    torchObj = Param(Params._dummy(), "torchObj", "serialized model spec",
                     typeConverter=TypeConverters.toString)
    mode = Param(Params._dummy(), "mode", "synchronous | hogwild",
                 typeConverter=TypeConverters.toString)
    device = Param(Params._dummy(), "device",
                   "where executors and the inference UDF run: cuda "
                   "(default) or cpu",
                   typeConverter=TypeConverters.toString)
    iters = Param(Params._dummy(), "iters", "", typeConverter=TypeConverters.toInt)
    partitions = Param(Params._dummy(), "partitions", "",
                       typeConverter=TypeConverters.toInt)
    verbose = Param(Params._dummy(), "verbose", "", typeConverter=TypeConverters.toInt)
    acquireLock = Param(Params._dummy(), "acquireLock", "",
                        typeConverter=TypeConverters.toBoolean)
    partitionShuffles = Param(Params._dummy(), "partitionShuffles", "",
                              typeConverter=TypeConverters.toInt)
    port = Param(Params._dummy(), "port", "", typeConverter=TypeConverters.toInt)
    useBarrier = Param(Params._dummy(), "useBarrier", "",
                       typeConverter=TypeConverters.toBoolean)
    useVectorOut = Param(Params._dummy(), "useVectorOut", "",
                         typeConverter=TypeConverters.toBoolean)
    earlyStopPatience = Param(Params._dummy(), "earlyStopPatience", "",
                              typeConverter=TypeConverters.toInt)
    miniBatch = Param(Params._dummy(), "miniBatch", "",
                      typeConverter=TypeConverters.toInt)
    validationPct = Param(Params._dummy(), "validationPct", "",
                          typeConverter=TypeConverters.toFloat)
    deployMode = Param(Params._dummy(), "deployMode", "driver | barrier",
                       typeConverter=TypeConverters.toString)
    pushEvery = Param(Params._dummy(), "pushEvery",
                      "hogwild: push the mean gradient of every k steps "
                      "(k-fold fewer wire round-trips; the window is the "
                      "staleness unit)",
                      typeConverter=TypeConverters.toInt)
    compress = Param(Params._dummy(), "compress",
                     "hogwild: bf16-compress gradient pushes on the wire",
                     typeConverter=TypeConverters.toBoolean)
    wire = Param(Params._dummy(), "wire",
                 "hogwild HTTP wire format: 'binary' (framed tensor "
                 "protocol, keep-alive, 304 pulls) or 'dill' "
                 "(reference-parity pickle wire)",
                 typeConverter=TypeConverters.toString)
    supervise = Param(Params._dummy(), "supervise",
                      "fault tolerance: restart a failed barrier stage "
                      "(not ported yet: raises)",
                      typeConverter=TypeConverters.toBoolean)
    ftMaxRestarts = Param(Params._dummy(), "ftMaxRestarts",
                          "fault tolerance: restart budget for the "
                          "supervised barrier stage",
                          typeConverter=TypeConverters.toInt)
    checkpointDir = Param(Params._dummy(), "checkpointDir",
                          "step-indexed checkpoint directory (a shared "
                          "file system across hosts)",
                          typeConverter=TypeConverters.toString)
    checkpointEvery = Param(Params._dummy(), "checkpointEvery",
                            "save a snapshot every N steps (0 disables)",
                            typeConverter=TypeConverters.toInt)


class SparkTorch(Estimator, _SparkTorchParams, PythonStagePersistence,
                 MLReadable, MLWritable):
    """Persistence is mixed into the ESTIMATOR too (reference
    ``torch_distributed.py:130-138``): an *unfitted* Pipeline holding
    a SparkTorch stage saves/loads, and the stage saves directly via
    ``write()``/``load()``. ``PythonStagePersistence`` precedes
    ``MLReadable``/``MLWritable`` in the MRO so its concrete
    ``write``/``read``/``load`` win.

    After a fit, ``_last_metrics`` holds the step records (driver and
    barrier modes), and a hogwild executor fit leaves the per-worker
    summaries on ``_last_hogwild_summaries`` and the server's applied
    pushes on ``_last_hogwild_applied``."""

    @keyword_only
    def __init__(self, inputCol=None, labelCol=None, predictionCol=None,
                 torchObj=None, iters=None, partitions=None, verbose=None,
                 mode=None, device=None, acquireLock=None,
                 partitionShuffles=None, port=None, useBarrier=None,
                 useVectorOut=None, earlyStopPatience=None, miniBatch=None,
                 validationPct=None, deployMode=None, pushEvery=None,
                 compress=None, wire=None, supervise=None,
                 ftMaxRestarts=None, checkpointDir=None,
                 checkpointEvery=None):
        super().__init__()
        self._setDefault(
            predictionCol="predictions", mode="synchronous", device="cuda",
            iters=10, verbose=0, acquireLock=True, partitionShuffles=1,
            port=3000, useBarrier=True, useVectorOut=False,
            earlyStopPatience=-1, miniBatch=-1, validationPct=0.0,
            deployMode="driver", pushEvery=1, compress=True, wire="binary",
            supervise=False, ftMaxRestarts=2, checkpointEvery=0,
        )
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, **kwargs):
        return self._set(**self._input_kwargs)

    def _opt(self, param):
        return self.getOrDefault(param) if self.isDefined(param) else None

    # -- data movement -----------------------------------------------------

    def _collect_xy(self, dataset):
        """Executors -> driver column stream (deployMode='driver')."""
        inp = self.getOrDefault(self.inputCol)
        label = self._opt(self.labelCol)
        cols = [inp] + ([label] if label else [])
        rows = dataset.select(*cols).collect()
        x = _rows_to_x(rows)
        y = _labels_to_f32([r[1] for r in rows], label) if label else None
        return x, y

    # -- fit ---------------------------------------------------------------

    def _fit(self, dataset):
        if self.getOrDefault(self.supervise):
            raise _not_ported("SparkTorch(supervise=True)",
                              "the ft supervisor, item 9")
        if self.getOrDefault(self.deployMode) == "barrier":
            if self.getOrDefault(self.mode) in ("hogwild", "async"):
                result = self._fit_hogwild_executors(dataset)
            else:
                result = self._fit_barrier(dataset)
        else:
            result = self._fit_driver(dataset)
        return SparkTorchModel(
            inputCol=self.getOrDefault(self.inputCol),
            predictionCol=self.getOrDefault(self.predictionCol),
            modStr=result,
            useVectorOut=self.getOrDefault(self.useVectorOut),
            device=self.getOrDefault(self.device),
        )

    def _fit_driver(self, dataset) -> str:
        x, y = self._collect_xy(dataset)
        spec = deserialize_model(self.getOrDefault(self.torchObj))
        mini_batch = self.getOrDefault(self.miniBatch)
        common = dict(
            labels=y,
            iters=self.getOrDefault(self.iters),
            partition_shuffles=self.getOrDefault(self.partitionShuffles),
            verbose=self.getOrDefault(self.verbose),
            mini_batch=None if mini_batch <= 0 else mini_batch,
            validation_pct=self.getOrDefault(self.validationPct),
            early_stop_patience=self.getOrDefault(self.earlyStopPatience),
            device=self.getOrDefault(self.device),
        )
        if self.getOrDefault(self.mode) in ("hogwild", "async"):
            from sparktorch_tpu_torch.train.hogwild import train_async

            partitions = self._opt(self.partitions)
            result = train_async(
                spec, x,
                acquire_lock=self.getOrDefault(self.acquireLock),
                port=self.getOrDefault(self.port),
                partitions=-1 if partitions is None else partitions,
                push_every=self.getOrDefault(self.pushEvery),
                compress=self.getOrDefault(self.compress),
                **common)
        else:
            from sparktorch_tpu_torch.train.sync import train_distributed

            result = train_distributed(spec, x, **common)
        self._last_metrics = result.metrics
        return _encode_bundle(result.spec, result.params)

    def _fit_hogwild_executors(self, dataset) -> str:
        """The reference's hogwild topology, executor-side: the DRIVER
        hosts the parameter server (``ParamServerHttp``), executor
        tasks run the async worker loop over the HTTP wire —
        pull/grad/push per iteration with version-tagged pulls
        (reference ``hogwild.py:65-142`` + ``torch_distributed.py:
        310-334``).
        """
        inp = self.getOrDefault(self.inputCol)
        label = self._opt(self.labelCol)
        torch_obj = self.getOrDefault(self.torchObj)
        iters = self.getOrDefault(self.iters)
        mini_batch = self.getOrDefault(self.miniBatch)
        mini_batch = None if mini_batch <= 0 else mini_batch
        shuffles = max(1, self.getOrDefault(self.partitionShuffles))
        verbose = self.getOrDefault(self.verbose)
        patience = self.getOrDefault(self.earlyStopPatience)
        validation_pct = self.getOrDefault(self.validationPct)
        device = self.getOrDefault(self.device)
        # Explicitly-set port is honored (reference default 3000);
        # otherwise ephemeral, so concurrent fits never collide.
        port = self.getOrDefault(self.port) if self.isSet(self.port) else 0
        push_every = max(1, self.getOrDefault(self.pushEvery))
        compress = self.getOrDefault(self.compress)
        wire_fmt = self.getOrDefault(self.wire)
        if wire_fmt not in ("binary", "dill"):
            raise ValueError(
                f"unknown wire {wire_fmt!r}; use 'binary' or 'dill'"
            )
        spark = dataset.sparkSession
        driver_host = spark.conf.get("spark.driver.host", "127.0.0.1")
        n_parts = self._opt(self.partitions) or dataset.rdd.getNumPartitions()
        base = dataset.select(*([inp] + ([label] if label else [])))

        from sparktorch_tpu_torch.serve.param_server import (
            ParameterServer,
            ParamServerHttp,
        )

        spec = deserialize_model(torch_obj)
        if spec.input_shape is None:
            first = dataset.select(inp).take(1)
            if not first:
                raise ValueError("cannot infer input shape from empty data")
            v = first[0][0]
            spec.input_shape = tuple(
                np.asarray(v.toArray() if hasattr(v, "toArray") else v).shape
            )

        server = ParameterServer(
            spec, window_len=n_parts, early_stop_patience=patience,
            acquire_lock=self.getOrDefault(self.acquireLock), seed=0,
            device=device,
        )
        # Bind all interfaces (executors are remote); workers reach the
        # driver through spark.driver.host.
        http = ParamServerHttp(server, host="0.0.0.0", port=port).start()
        url = f"http://{driver_host}:{http.port}"
        early_stop = patience is not None and patience > 0

        def make_run_worker(round_seed: int):
            def run_worker(iterator):
                rows = list(iterator)
                if not rows:
                    return  # hogwild has no collectives: empty task exits
                import os as _os

                from sparktorch_tpu_torch.train.hogwild import (
                    run_hogwild_worker,
                )

                x = _rows_to_x(rows)
                y = (_labels_to_f32([r[1] for r in rows], label)
                     if label else x)
                if mini_batch:
                    # The sampler takes contiguous blocks: a label-sorted
                    # partition would feed single-class blocks, so
                    # shuffle the resident rows first.
                    perm = np.random.default_rng(round_seed).permutation(
                        x.shape[0])
                    x, y = x[perm], y[perm]
                # The server's twin (model_seed 0): its buffers are the
                # server's model state, its parameters come with each
                # pull. The validation split is per partition, like the
                # reference's executor-side handle_features.
                out = run_hogwild_worker(
                    torch_obj, url, x, y, iters=iters, mini_batch=mini_batch,
                    push_every=push_every, seed=round_seed,
                    worker_id=_os.getpid() % 100000, wire=wire_fmt,
                    compress=compress, device=device,
                    validation_pct=validation_pct, verbose=verbose,
                    early_stop=early_stop, model_seed=0)
                yield {"worker": _os.getpid(),
                       **{k: out[k] for k in ("losses", "versions", "examples",
                                              "pushes", "loop_s")}}

            return run_worker

        try:
            summaries = []
            for round_idx in range(shuffles):  # hogwild.py:161-177 parity
                # A fresh repartition per round; the per-round seed
                # re-randomizes every worker's minibatch stream, which is
                # the shuffle's effect where (as in localspark)
                # repartition is only a partition-count hint.
                rdd = base.rdd.repartition(n_parts)
                if self.getOrDefault(self.useBarrier):
                    rdd = rdd.barrier()  # torch_distributed.py:312-313
                summaries.extend(
                    rdd.mapPartitions(
                        make_run_worker(round_idx * 100003)
                    ).collect()
                )
                if server.should_stop:
                    break
            self._last_hogwild_summaries = summaries
            self._last_hogwild_applied = server.applied_updates
            from sparktorch_tpu_torch.serve.param_server import build_module
            from sparktorch_tpu_torch.train.hogwild import final_result

            return _encode_bundle(*final_result(server, spec,
                                                build_module(spec, 0)))
        finally:
            # Stop server even on failure (hogwild.py:184-186 parity).
            http.stop()
            server.stop()

    def _fit_barrier(self, dataset) -> str:
        """One barrier task per device; rank = barrier partition id.

        Each task joins the gang (the coordinator runs on the DRIVER,
        on an ephemeral port), joins the process group on a port the
        driver picked (both travel in the closure, so concurrent fits do
        not collide) and trains its partition with
        ``train_distributed_multihost`` (an all-gather of row counts,
        weight-0 padding of skewed and empty partitions). A task with no
        rows still enters every collective.
        """
        inp = self.getOrDefault(self.inputCol)
        label = self._opt(self.labelCol)
        torch_obj = self.getOrDefault(self.torchObj)
        mini_batch = self.getOrDefault(self.miniBatch)
        train_kwargs = dict(
            iters=self.getOrDefault(self.iters),
            partition_shuffles=self.getOrDefault(self.partitionShuffles),
            verbose=self.getOrDefault(self.verbose),
            mini_batch=None if mini_batch <= 0 else mini_batch,
            early_stop_patience=self.getOrDefault(self.earlyStopPatience),
            checkpoint_dir=self._opt(self.checkpointDir),
            checkpoint_every=self.getOrDefault(self.checkpointEvery),
            device=self.getOrDefault(self.device),
        )
        backend = ("gloo" if str(train_kwargs["device"]).startswith("cpu")
                   else None)
        spark = dataset.sparkSession
        gang_host = spark.conf.get("spark.driver.host", "127.0.0.1")
        n_hosts = self._opt(self.partitions) or dataset.rdd.getNumPartitions()
        rdd = dataset.select(*([inp] + ([label] if label else []))).rdd
        if rdd.getNumPartitions() != n_hosts:
            rdd = rdd.repartition(n_hosts)

        from sparktorch_tpu_torch.native.gang import GangCoordinator

        coord = GangCoordinator(world_size=n_hosts, port=0)
        gang_port = coord.port
        dist_port = _free_port(gang_host)

        def run_host(iterator):
            import torch.distributed as dist
            from pyspark import BarrierTaskContext

            from sparktorch_tpu_torch.parallel.launch import bringup_multihost
            from sparktorch_tpu_torch.train.sync import (
                train_distributed_multihost,
            )

            rank = BarrierTaskContext.get().partitionId()
            rows = list(iterator)
            x = _rows_to_x(rows) if rows else np.zeros((0, 1), np.float32)
            # Empty partitions still declare the label axis; their
            # shapes come from a rank with rows (train_distributed_multihost).
            y = None
            if label:
                y = (_labels_to_f32([r[1] for r in rows], label)
                     if rows else np.zeros((0,), np.float32))
            _, worker = bringup_multihost(
                rank=rank, world_size=n_hosts, coordinator_host=gang_host,
                gang_port=gang_port, dist_port=dist_port,
                start_coordinator=False, backend=backend,
            )
            try:
                result = train_distributed_multihost(torch_obj, x, local_y=y,
                                                     **train_kwargs)
                # Every rank holds the same replica; rank 0's is kept
                # (the reference keeps collect()[0], distributed.py:267-273).
                if rank == 0:
                    yield (_encode_bundle(result.spec, result.params),
                           result.metrics)
            finally:
                if worker is not None:
                    worker.close()
                if dist.is_initialized():
                    dist.destroy_process_group()

        try:
            out = rdd.barrier().mapPartitions(run_host).collect()
        finally:
            coord.stop()
        if not out:
            raise RuntimeError("barrier training returned no model")
        bundle, self._last_metrics = out[0]
        return bundle


class SparkTorchModel(Model, _SparkTorchParams, PythonStagePersistence,
                      MLReadable, MLWritable):
    """Fitted transformer. Persists inside standard Spark pipelines via
    the carrier mechanism (PythonStagePersistence — the writer hook the
    reference implements in ``pipeline_util.py:80-130``). ``device``
    names where the inference UDF runs."""

    modStr = Param(Params._dummy(), "modStr", "serialized trained model",
                   typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, inputCol=None, predictionCol=None, modStr=None,
                 useVectorOut=None, device=None):
        super().__init__()
        self._setDefault(predictionCol="predictions", useVectorOut=False,
                         device="cuda")
        self._set(**self._input_kwargs)

    def getPytorchModel(self):
        """Decoded {spec, params} bundle (torch_distributed.py:92-94
        parity)."""
        return _decode_bundle(self.getOrDefault(self.modStr))

    def _transform(self, dataset):
        inp = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.predictionCol)
        use_vec = self.getOrDefault(self.useVectorOut)
        device = self.getOrDefault(self.device)
        sc = dataset.sparkSession.sparkContext
        broadcast_mod = sc.broadcast(self.getOrDefault(self.modStr))

        # Arrow cannot serialize VectorUDT columns into a pandas_udf;
        # convert Spark ML vectors to plain arrays first.
        input_col = dataset[inp]
        try:
            from pyspark.ml.functions import vector_to_array
            from pyspark.ml.linalg import VectorUDT

            if isinstance(dataset.schema[inp].dataType, VectorUDT):
                input_col = vector_to_array(input_col)
        except ImportError:
            pass

        # One predictor per worker process and transform: the bundle is
        # decoded and moved to the device once, not once per UDF batch.
        cache = {}

        def predict_matrix(series) -> np.ndarray:
            if "model" not in cache:
                from sparktorch_tpu_torch.ml.estimator import (
                    SparkTorchModel as _Local,
                )

                cache["model"] = _Local(modStr=broadcast_mod.value
                                        ).setDevice(device)
            x = np.stack([np.asarray(v, dtype=np.float32) for v in series])
            return cache["model"]._predict_matrix(x)

        if use_vec:
            @pandas_udf(ArrayType(DoubleType()))
            def predict(series):
                import pandas as pd

                out = predict_matrix(series)
                return pd.Series([row.astype(float).tolist() for row in out])
        else:
            @pandas_udf(DoubleType())
            def predict(series):
                import pandas as pd

                out = predict_matrix(series)
                flat = out.reshape(out.shape[0], -1)
                vals = (np.argmax(flat, axis=1).astype(np.float64)
                        if flat.shape[1] > 1 else flat[:, 0].astype(np.float64))
                return pd.Series(vals)

        return dataset.withColumn(out_col, predict(input_col))
