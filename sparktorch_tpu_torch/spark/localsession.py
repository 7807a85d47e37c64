"""A pyspark-API-compatible local runtime, no JVM, real processes — the port of ``sparktorch_tpu/spark/localsession.py``.

The reference's test tier runs against a real local Spark session
(``local[2]`` with 2 partitions, the smallest world where barrier
execution is real). Where pyspark is not installed, this module stands
in for it: a miniature of the pyspark surface the adapter uses,
in which **mapPartitions tasks run in separate OS processes** (closures
shipped with dill, one process per partition, gang-launched for barrier
RDDs, each started as ``python -m sparktorch_tpu_torch.spark._executor``).
So the gang coordinator's TCP rendezvous, the ``torch.distributed``
bring-up and the hogwild HTTP wire run for real.

``install()`` registers these classes under the module names the
adapter imports (``pyspark``, ``pyspark.ml`` ...) ONLY when real
pyspark is absent. The modules carry their own marker,
``__localspark_torch__``: the JAX package's shim (marker
``__localspark__``) is never taken for real pyspark, and is replaced
whole, never patched, so a caller that saved its ``sys.modules`` entries
can put it back. Executors run wherever the caller's ``device`` says.

Implemented subset (what ``torch_distributed.py`` and
``pipeline_util.py`` touch): SparkSession/builder/conf, columnar
DataFrame (select/withColumn/collect/schema/rdd), RDD
(mapPartitions/repartition/barrier/collect/foreach),
BarrierTaskContext, broadcast, pandas_udf, DenseVector/VectorUDT/
vector_to_array, StopWordsRemover, Pipeline/PipelineModel with
directory persistence that honors the ``_to_carrier`` hook (the shim's
analog of pyspark's ``_to_java`` JavaMLWriter hook).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from sparktorch_tpu_torch.ml.params import (
    Param,
    Params,
    TypeConverters,
    keyword_only,
)

_EXECUTOR_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# Rows / vectors / SQL types
# ---------------------------------------------------------------------------


class Row(tuple):
    """Indexable by position, column name, or attribute — the access
    patterns the adapter uses (``r[0]``, ``r['predictions']``)."""

    def __new__(cls, values: Sequence, fields: Sequence[str]):
        self = super().__new__(cls, values)
        self._fields = tuple(fields)
        return self

    def __getitem__(self, key):
        if isinstance(key, str):
            return super().__getitem__(self._fields.index(key))
        return super().__getitem__(key)

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return tuple.__getitem__(self, fields.index(name))
        raise AttributeError(name)

    def asDict(self) -> dict:
        return {f: tuple.__getitem__(self, i) for i, f in enumerate(self._fields)}

    def __reduce__(self):
        return (Row, (tuple(self), self._fields))


class DenseVector:
    """pyspark.ml.linalg.DenseVector lookalike."""

    def __init__(self, values):
        self._values = np.asarray(values, dtype=np.float64)

    def toArray(self) -> np.ndarray:
        return self._values

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __repr__(self):
        return f"DenseVector({self._values.tolist()})"


class Vectors:
    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and np.ndim(values[0]) >= 1:
            return DenseVector(values[0])
        return DenseVector(values)


class VectorUDT:
    def __eq__(self, other):
        return isinstance(other, VectorUDT)

    def __hash__(self):
        return hash("VectorUDT")


class DoubleType:
    pass


class FloatType:
    pass


class ArrayType:
    def __init__(self, elementType=None, containsNull=True):
        self.elementType = elementType
        self.containsNull = containsNull


class StructField:
    def __init__(self, name: str, dataType, nullable: bool = True):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable


class StructType:
    def __init__(self, fields: List[StructField]):
        self.fields = fields

    def __getitem__(self, name: str) -> StructField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


def _infer_type(value):
    if isinstance(value, DenseVector):
        return VectorUDT()
    if isinstance(value, (list, np.ndarray)):
        return ArrayType(DoubleType())
    return DoubleType()


# ---------------------------------------------------------------------------
# Columns and pandas UDFs
# ---------------------------------------------------------------------------


class Column:
    """A lazy reference to a source column plus a value converter
    chain (``vector_to_array``) and optionally a pandas UDF."""

    def __init__(self, name: str, conv: Optional[Callable] = None,
                 udf: Optional["_PandasUdf"] = None):
        self.name = name
        self.conv = conv
        self.udf = udf


def vector_to_array(col: Column) -> Column:
    def conv(values):
        return [
            np.asarray(v.toArray() if hasattr(v, "toArray") else v,
                       dtype=np.float64)
            for v in values
        ]

    return Column(col.name, conv=conv, udf=col.udf)


class _PandasUdf:
    def __init__(self, fn: Callable, returnType):
        self.fn = fn
        self.returnType = returnType

    def __call__(self, col: Column) -> Column:
        return Column(col.name, conv=col.conv, udf=self)


def pandas_udf(returnType, functionType=None):
    def deco(fn):
        return _PandasUdf(fn, returnType)

    return deco


# ---------------------------------------------------------------------------
# DataFrame
# ---------------------------------------------------------------------------


class DataFrame:
    def __init__(self, cols: Dict[str, list], session: "SparkSession",
                 npartitions: int = 2):
        self._cols = {k: list(v) for k, v in cols.items()}
        ns = {len(v) for v in self._cols.values()}
        if len(ns) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in self._cols.items()} }")
        self._n = ns.pop() if ns else 0
        self.sparkSession = session
        self._npartitions = max(1, npartitions)

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    @property
    def schema(self) -> StructType:
        return StructType([
            StructField(name, _infer_type(vals[0]) if vals else DoubleType())
            for name, vals in self._cols.items()
        ])

    def __getitem__(self, name: str) -> Column:
        if name not in self._cols:
            raise KeyError(name)
        return Column(name)

    def count(self) -> int:
        return self._n

    def select(self, *names) -> "DataFrame":
        names = [n.name if isinstance(n, Column) else n for n in names]
        return DataFrame({n: self._cols[n] for n in names}, self.sparkSession,
                         self._npartitions)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self._cols, self.sparkSession, n)

    def collect(self) -> List[Row]:
        fields = list(self._cols)
        return [
            Row([self._cols[f][i] for f in fields], fields)
            for i in range(self._n)
        ]

    def take(self, n: int) -> List[Row]:
        return self.collect()[:n]

    @property
    def rdd(self) -> "RDD":
        fields = list(self._cols)
        rows = [
            Row([self._cols[f][i] for f in fields], fields)
            for i in range(self._n)
        ]
        return RDD(rows, self._npartitions, self.sparkSession)

    def withColumn(self, name: str, col: Column) -> "DataFrame":
        if not isinstance(col, Column) or col.udf is None:
            raise TypeError("withColumn expects a pandas_udf column")
        import pandas as pd

        values = self._cols[col.name]
        if col.conv is not None:
            values = col.conv(values)
        # Evaluate in >=2 batches when possible: faithful to Arrow's
        # chunked evaluation, and catches UDFs that assume one call.
        chunks = []
        n_chunks = 2 if self._n >= 2 else 1
        for part in np.array_split(np.arange(self._n), n_chunks):
            if len(part) == 0:
                continue
            series = pd.Series([values[i] for i in part])
            out = col.udf.fn(series)
            chunks.extend(list(out))
        new_cols = dict(self._cols)
        new_cols[name] = chunks
        return DataFrame(new_cols, self.sparkSession, self._npartitions)


# ---------------------------------------------------------------------------
# RDD with real-process executors
# ---------------------------------------------------------------------------


class BarrierTaskContext:
    """Executor-side context; set up by the executor bootstrap."""

    _current: Optional["BarrierTaskContext"] = None

    def __init__(self, partition_id: int, world: int):
        self._partition_id = partition_id
        self._world = world

    @classmethod
    def get(cls) -> "BarrierTaskContext":
        if cls._current is None:
            raise RuntimeError("not inside a barrier task")
        return cls._current

    def partitionId(self) -> int:
        return self._partition_id

    def getTaskInfos(self):
        return [{"address": "127.0.0.1"} for _ in range(self._world)]

    def barrier(self):  # tasks are gang-launched; nothing to wait on
        return None


def _split_partitions(rows: List, n: int) -> List[List]:
    # array_split's chunking without numpy coercion (Rows are tuples —
    # np.asarray would explode them into a 2-D object array).
    bounds = np.linspace(0, len(rows), n + 1).astype(int)
    return [rows[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _executor_env() -> Dict[str, str]:
    """Child env: the caller's, with the repository on ``PYTHONPATH``
    and, unless the caller set it, ``OMP_NUM_THREADS=1``: pyspark sets
    it to ``spark.task.cpus`` (default 1) for its Python workers, so N
    tasks on a host do not each start a thread per core."""
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


class RDD:
    def __init__(self, rows: List, npartitions: int, session: "SparkSession",
                 fns: Optional[List[Callable]] = None, is_barrier: bool = False):
        self._rows = rows
        self._npartitions = max(1, npartitions)
        self._session = session
        self._fns = fns or []
        self._is_barrier = is_barrier

    def getNumPartitions(self) -> int:
        return self._npartitions

    def repartition(self, n: int) -> "RDD":
        return RDD(self._rows, n, self._session, self._fns, self._is_barrier)

    def barrier(self) -> "RDD":
        return RDD(self._rows, self._npartitions, self._session, self._fns, True)

    def mapPartitions(self, fn: Callable) -> "RDD":
        return RDD(self._rows, self._npartitions, self._session,
                   self._fns + [fn], self._is_barrier)

    def foreach(self, fn: Callable) -> None:
        # An action: evaluate everything, discard results
        # (the reference's hogwild trigger, hogwild.py:161-173).
        self.mapPartitions(lambda it: [fn(x) for x in it]).collect()

    def collect(self) -> List:
        if not self._fns:
            return list(self._rows)
        return self._run_executors()

    def _run_executors(self) -> List:
        """One OS process per partition, launched concurrently (the
        gang — every barrier task starts before any is waited on),
        closures shipped via dill like Spark ships them to its Python
        workers."""
        import dill

        parts = _split_partitions(self._rows, self._npartitions)

        def chained(iterator, _fns=self._fns):
            out = iterator
            for f in _fns:
                out = f(out)
            return list(out)

        import shutil
        import time as _time

        tmpdir = tempfile.mkdtemp(prefix="localspark_")
        try:
            procs = []
            for idx, rows in enumerate(parts):
                payload_path = os.path.join(tmpdir, f"task{idx}.in")
                result_path = os.path.join(tmpdir, f"task{idx}.out")
                log_path = os.path.join(tmpdir, f"task{idx}.log")
                with open(payload_path, "wb") as f:
                    # JSON header first: the executor must extend
                    # sys.path BEFORE unpickling (dill resolves closure
                    # modules by import — Spark likewise requires user
                    # code importable on its workers).
                    f.write(json.dumps({"sys_path": sys.path}).encode() + b"\n")
                    dill.dump(
                        {
                            "fn": chained,
                            "rows": rows,
                            "partition_id": idx,
                            "world": self._npartitions,
                            "barrier": self._is_barrier,
                        },
                        f,
                        recurse=False,
                    )
                # Task output goes to a FILE, not a pipe: a chatty
                # executor must never block on a full pipe buffer while
                # the driver waits on a different task — in barrier
                # mode that would stall the whole gang.
                log_f = open(log_path, "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "sparktorch_tpu_torch.spark._executor",
                     payload_path, result_path],
                    env=_executor_env(),
                    stdout=log_f,
                    stderr=subprocess.STDOUT,
                )
                procs.append((idx, proc, result_path, log_path, log_f))

            results: List = []
            errors: List[str] = []
            deadline = _time.monotonic() + _EXECUTOR_TIMEOUT_S
            for idx, proc, result_path, log_path, log_f in procs:
                try:
                    proc.wait(timeout=max(1.0, deadline - _time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                log_f.close()
                if proc.returncode != 0:
                    with open(log_path) as f:
                        tail = f.read()[-4000:]
                    word = "timed out" if proc.returncode == -9 else (
                        f"failed (rc={proc.returncode})"
                    )
                    errors.append(f"task {idx} {word}\n{tail}")
                    continue
                with open(result_path, "rb") as f:
                    results.extend(dill.load(f))
            if errors:
                raise RuntimeError(
                    "localspark executor failure:\n" + "\n---\n".join(errors)
                )
            return results
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


class Broadcast:
    def __init__(self, value):
        self.value = value

    def unpersist(self):
        pass


class _JavaArray(list):
    """Fixed-length array as py4j's ``gateway.new_array`` returns —
    supports the slice assignment the carrier encoder uses
    (reference ``pipeline_util.py:125``)."""

    def __init__(self, n: int):
        super().__init__([None] * n)


class _JavaString:
    """Token standing in for ``gateway.jvm.java.lang.String``."""


class _JavaLang:
    String = _JavaString


class _Java:
    lang = _JavaLang


class _Jvm:
    java = _Java


class _Gateway:
    """The slice of the py4j gateway surface the carrier encoder
    touches (``sc._gateway.jvm.java.lang.String`` +
    ``sc._gateway.new_array``). With real pyspark these calls cross
    into the JVM; here they hit this protocol-faithful local stand-in,
    so the SAME ``_to_java`` code path executes in both runtimes."""

    jvm = _Jvm

    def new_array(self, java_class, n: int) -> _JavaArray:
        return _JavaArray(n)


class _JavaStopWordsRemover:
    """The object ``JavaParams._new_java_obj`` would materialize in the
    JVM (``org.apache.spark.ml.feature.StopWordsRemover``): carries a
    uid and a stopwords array."""

    def __init__(self, uid: str):
        self._uid = uid
        self._stopWords: list = []

    def setStopWords(self, arr):
        self._stopWords = [w for w in arr]
        return self

    def getStopWords(self):
        return list(self._stopWords)

    def uid(self):
        return self._uid


class JavaParams:
    """pyspark.ml.wrapper.JavaParams subset: the ``_new_java_obj``
    factory the carrier encoder calls (reference
    ``pipeline_util.py:126``)."""

    _CARRIER_JAVA_CLASS = "org.apache.spark.ml.feature.StopWordsRemover"

    @staticmethod
    def _new_java_obj(java_class: str, *args):
        if java_class != JavaParams._CARRIER_JAVA_CLASS:
            raise ValueError(
                f"localspark gateway only materializes the carrier class, "
                f"not {java_class!r}"
            )
        uid = args[0] if args else f"StopWordsRemover_{uuid.uuid4().hex[:12]}"
        return _JavaStopWordsRemover(uid)


class JavaMLWriter:
    """Stage-level writer driving the instance's ``_to_java`` hook —
    the same contract as pyspark's JavaMLWriter (which the reference
    returns from ``write()``, ``pipeline_util.py:88-90``): convert to
    the JVM-persistable carrier, save it under ``path``."""

    def __init__(self, instance):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "JavaMLWriter":
        self._overwrite = True
        return self

    def session(self, _session) -> "JavaMLWriter":
        return self

    def save(self, path: str) -> None:
        jobj = self._instance._to_java()
        if os.path.exists(path) and not self._overwrite:
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        meta = {
            "class": JavaParams._CARRIER_JAVA_CLASS,
            "uid": jobj.uid(),
            "stopWords": jobj.getStopWords(),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)  # lint-obs: ok (JVM-parity metadata)


class JavaMLReader:
    """Reads a saved carrier stage back as the carrier class instance
    (pyspark's ``JavaMLReader(StopWordsRemover).load`` contract — the
    reference's ``read()``, ``pipeline_util.py:92-95``)."""

    def __init__(self, clazz):
        self._clazz = clazz

    def load(self, path: str):
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("class") != JavaParams._CARRIER_JAVA_CLASS:
            raise ValueError(f"not a carrier stage dir: {path}")
        stage = self._clazz()
        stage.uid = meta["uid"]
        stage.setStopWords(meta["stopWords"])
        return stage


class MLReadable:
    """Marker mixin, parity with pyspark.ml.util.MLReadable."""


class MLWritable:
    """Marker mixin, parity with pyspark.ml.util.MLWritable."""


class Identifiable:
    """Marker mixin, parity with pyspark.ml.util.Identifiable."""


class SparkContext:
    # Real pyspark exposes the active context (and its py4j gateway)
    # here; the carrier encoder reads it (reference
    # pipeline_util.py:120). Set while a SparkSession is alive.
    _active_spark_context: Optional["SparkContext"] = None

    def __init__(self):
        self._gateway = _Gateway()

    def broadcast(self, value) -> Broadcast:
        return Broadcast(value)


class _RuntimeConf:
    def __init__(self):
        self._conf = {"spark.driver.host": "127.0.0.1"}

    def get(self, key: str, default=None):
        return self._conf.get(key, default)

    def set(self, key: str, value):
        self._conf[key] = value


class SparkSession:
    _active: Optional["SparkSession"] = None

    def __init__(self, master: str = "local[2]"):
        self.conf = _RuntimeConf()
        self.sparkContext = SparkContext()
        SparkContext._active_spark_context = self.sparkContext
        m = re.match(r"local\[(\d+|\*)\]", master or "local[2]")
        self.default_parallelism = (
            os.cpu_count() if m and m.group(1) == "*" else int(m.group(1)) if m else 2
        )

    class _Builder:
        def __init__(self):
            self._master = "local[2]"

        def master(self, m):
            self._master = m
            return self

        def appName(self, _):
            return self

        def config(self, *_, **__):
            return self

        def getOrCreate(self) -> "SparkSession":
            if SparkSession._active is None:
                SparkSession._active = SparkSession(self._master)
            return SparkSession._active

    builder = None  # replaced below (class-level property pattern)

    def createDataFrame(self, data, schema=None) -> DataFrame:
        if hasattr(data, "columns") and hasattr(data, "to_dict"):  # pandas
            cols = {c: list(data[c]) for c in data.columns}
        elif data and isinstance(data[0], dict):
            cols = {k: [row[k] for row in data] for k in data[0]}
        elif data and isinstance(data[0], (tuple, list, Row)):
            if schema is None:
                raise ValueError("schema (column names) required for tuple rows")
            names = schema if isinstance(schema, (list, tuple)) else [
                f.name for f in schema.fields
            ]
            cols = {n: [row[i] for row in data] for i, n in enumerate(names)}
        elif isinstance(data, dict):
            cols = {k: list(v) for k, v in data.items()}
        else:
            raise TypeError(f"cannot build DataFrame from {type(data)}")
        return DataFrame(cols, self, npartitions=self.default_parallelism)

    def stop(self):
        SparkSession._active = None
        SparkContext._active_spark_context = None


class _BuilderDescriptor:
    def __get__(self, obj, objtype=None):
        return SparkSession._Builder()


SparkSession.builder = _BuilderDescriptor()


# ---------------------------------------------------------------------------
# ML: base classes, StopWordsRemover, Pipeline persistence
# ---------------------------------------------------------------------------


class HasInputCol(Params):
    inputCol = Param(Params._dummy(), "inputCol", "input column name",
                     TypeConverters.toString)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)


class HasLabelCol(Params):
    labelCol = Param(Params._dummy(), "labelCol", "label column name",
                     TypeConverters.toString)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)


class HasPredictionCol(Params):
    predictionCol = Param(Params._dummy(), "predictionCol",
                          "prediction column name", TypeConverters.toString)

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)


class Estimator(Params):
    def __init__(self):
        super().__init__()
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"

    def fit(self, dataset, params: Optional[dict] = None):
        est = self.copy(params) if params else self
        return est._fit(dataset)


class Transformer(Params):
    def __init__(self):
        super().__init__()
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"

    def transform(self, dataset, params: Optional[dict] = None):
        t = self.copy(params) if params else self
        return t._transform(dataset)


class Model(Transformer):
    pass


class StopWordsRemover(Transformer):
    """The carrier class of the reference's persistence trick
    (reference ``pipeline_util.py:16-31``): a JVM-persistable stage
    whose stopwords list smuggles a dill payload."""

    inputCol = Param(Params._dummy(), "inputCol", "", TypeConverters.toString)
    outputCol = Param(Params._dummy(), "outputCol", "", TypeConverters.toString)
    stopWords = Param(Params._dummy(), "stopWords", "", TypeConverters.toList)

    def __init__(self, inputCol=None, outputCol=None):
        super().__init__()
        self.uid = f"StopWordsRemover_{uuid.uuid4().hex[:12]}"
        self._set(inputCol=inputCol, outputCol=outputCol)
        self._setDefault(stopWords=[])

    def setStopWords(self, words):
        return self._set(stopWords=list(words))

    def getStopWords(self):
        return self.getOrDefault(self.stopWords)

    def _transform(self, dataset):
        return dataset  # carrier-only usage here


_JSON_STAGES = {"StopWordsRemover": StopWordsRemover}


def _stage_to_entry(stage) -> dict:
    """Persist one stage. Pure-Python stages must provide
    ``_to_carrier()`` (the shim analog of pyspark's ``_to_java`` hook,
    reference ``pipeline_util.py:112-130``) to become a carrier."""
    if type(stage).__name__ not in _JSON_STAGES and hasattr(stage, "_to_carrier"):
        stage = stage._to_carrier()
    cls = type(stage).__name__
    if cls not in _JSON_STAGES:
        raise ValueError(
            f"stage {stage!r} is not JVM-persistable and has no _to_carrier "
            "hook (see sparktorch_tpu_torch.spark.pipeline_util)"
        )
    return {"className": cls, "uid": stage.uid,
            "paramMap": stage.extractParamMap()}


def _entry_to_stage(entry: dict):
    stage = _JSON_STAGES[entry["className"]].__new__(
        _JSON_STAGES[entry["className"]]
    )
    Params.__init__(stage)
    stage.uid = entry["uid"]
    stage._set(**entry["paramMap"])
    return stage


class _PipelineWriter:
    def __init__(self, target):
        self._target = target
        self._overwrite = False

    def overwrite(self):
        self._overwrite = True
        return self

    def save(self, path: str):
        if os.path.exists(path) and not self._overwrite:
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        meta = {
            "class": type(self._target).__name__,
            "stages": [_stage_to_entry(s) for s in self._target.stages],
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)  # lint-obs: ok (JVM-parity metadata)


class Pipeline(Estimator):
    def __init__(self, stages: Optional[list] = None):
        super().__init__()
        self.stages = list(stages or [])

    def getStages(self):
        return self.stages

    def setStages(self, stages):
        self.stages = list(stages)
        return self

    def _fit(self, dataset):
        # pyspark semantics: transform feeds only LATER estimators, so
        # stages at/after the last estimator are not transformed during
        # fit (no wasted inference pass on the training set).
        est_idx = [i for i, s in enumerate(self.stages) if hasattr(s, "fit")]
        last_est = est_idx[-1] if est_idx else -1
        fitted = []
        df = dataset
        for i, stage in enumerate(self.stages):
            model = stage.fit(df) if hasattr(stage, "fit") else stage
            fitted.append(model)
            if i < last_est and hasattr(model, "transform"):
                df = model.transform(df)
        return PipelineModel(fitted)

    def write(self) -> _PipelineWriter:
        return _PipelineWriter(self)

    def save(self, path: str):
        self.write().save(path)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        return _load_pipeline(path, cls)


class PipelineModel(Model):
    def __init__(self, stages: list):
        super().__init__()
        self.stages = list(stages)

    def _transform(self, dataset):
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df

    def write(self) -> _PipelineWriter:
        return _PipelineWriter(self)

    def save(self, path: str):
        self.write().save(path)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        return _load_pipeline(path, cls)


def _load_pipeline(path: str, cls):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    stages = [_entry_to_stage(e) for e in meta["stages"]]
    if cls is Pipeline:
        return Pipeline(stages)
    return PipelineModel(stages)


# ---------------------------------------------------------------------------
# install(): register as the pyspark the adapter imports
# ---------------------------------------------------------------------------


MARKER = "__localspark_torch__"
_FOREIGN_MARKER = "__localspark__"  # the JAX package's shim


def pyspark_entries() -> Dict[str, object]:
    """The ``pyspark`` modules now in ``sys.modules``, by name."""
    return {k: v for k, v in sys.modules.items()
            if k == "pyspark" or k.startswith("pyspark.")}


def require_pyspark() -> None:
    """Raise ImportError unless ``pyspark`` is real pyspark or this
    shim: the adapter must never bind the JAX package's shim classes."""
    import pyspark

    if (getattr(pyspark, _FOREIGN_MARKER, False)
            and not getattr(pyspark, MARKER, False)):
        raise ImportError(
            "pyspark is the JAX package's localspark shim; call "
            "sparktorch_tpu_torch.spark.localsession.install() first")


def install(force: bool = False) -> bool:
    """Register this runtime under the ``pyspark`` module names.

    Returns True if installed (or already installed), False if real
    pyspark is present (in which case nothing is touched: the adapter
    uses the real one). Another shim's modules are removed from
    ``sys.modules`` and new ones registered in their place.
    """
    if not force:
        current = sys.modules.get("pyspark")
        if current is None:
            try:
                import pyspark as current
            except ImportError:
                current = None
        if current is not None:
            if getattr(current, MARKER, False):
                return True  # our own earlier install
            if not getattr(current, _FOREIGN_MARKER, False):
                return False  # real pyspark

    import types

    for name in pyspark_entries():
        del sys.modules[name]

    def module(name: str, **attrs) -> types.ModuleType:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
        for k, v in attrs.items():
            setattr(mod, k, v)
        return mod

    pyspark = module(
        "pyspark",
        keyword_only=keyword_only,
        BarrierTaskContext=BarrierTaskContext,
        SparkContext=SparkContext,
        **{MARKER: True},
    )
    pyspark.sql = module(
        "pyspark.sql", SparkSession=SparkSession, DataFrame=DataFrame, Row=Row
    )
    pyspark.sql.functions = module("pyspark.sql.functions", pandas_udf=pandas_udf)
    pyspark.sql.types = module(
        "pyspark.sql.types",
        ArrayType=ArrayType, DoubleType=DoubleType, FloatType=FloatType,
        StructType=StructType, StructField=StructField,
    )
    ml = module(
        "pyspark.ml", Pipeline=Pipeline, PipelineModel=PipelineModel,
        Estimator=Estimator, Transformer=Transformer, Model=Model,
    )
    ml.base = module(
        "pyspark.ml.base", Estimator=Estimator, Transformer=Transformer,
        Model=Model,
    )
    ml.param = module(
        "pyspark.ml.param", Param=Param, Params=Params,
        TypeConverters=TypeConverters,
    )
    ml.param.shared = module(
        "pyspark.ml.param.shared",
        HasInputCol=HasInputCol, HasLabelCol=HasLabelCol,
        HasPredictionCol=HasPredictionCol,
    )
    ml.feature = module("pyspark.ml.feature", StopWordsRemover=StopWordsRemover)
    ml.linalg = module(
        "pyspark.ml.linalg", DenseVector=DenseVector, Vectors=Vectors,
        VectorUDT=VectorUDT,
    )
    ml.functions = module("pyspark.ml.functions", vector_to_array=vector_to_array)
    ml.util = module(
        "pyspark.ml.util",
        JavaMLWriter=JavaMLWriter, JavaMLReader=JavaMLReader,
        MLReadable=MLReadable, MLWritable=MLWritable,
        Identifiable=Identifiable,
    )
    ml.wrapper = module("pyspark.ml.wrapper", JavaParams=JavaParams)
    pyspark.context = module("pyspark.context", SparkContext=SparkContext)
    return True
