"""Decode/encode Spark-ML pipelines that carry Python stages — the port of ``sparktorch_tpu/spark/pipeline_util.py``.

Reference mechanism (``sparktorch/pipeline_util.py``): PySpark cannot
persist pure-Python Transformers, so the reference dill-dumps the
Python object, zlib-compresses it, renders the bytes as a
comma-joined decimal string and stores it as the stopwords list of a
``StopWordsRemover`` (the JVM "carrier class"), tagged with a magic
GUID (:16-31, :112-130); ``unwrap`` walks loaded stages and
re-hydrates carriers, recursing into nested pipelines (:49-77).

This adapter interoperates with that on-disk format: pipelines saved
by the reference (or by this adapter) load back into live Python
objects. The GUID below matches the reference's tag so *existing*
saved pipelines remain readable — it is a file-format constant, like
a magic number. The decimal rendering and its parse are vectorised
with numpy and run in blocks on threads (a fitted BERT-base stage is
~0.4 GB of compressed payload, ~1.5 GB of decimal text); the text of a
payload is the reference's rendering, byte for byte. The payload is
deflated in blocks on threads too: one zlib stream, which the
reference's reader inflates, and for a payload of one block (16 MiB)
or less the very bytes of ``zlib.compress``.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List

import dill
import numpy as np

from sparktorch_tpu_torch.spark.localsession import require_pyspark

try:
    require_pyspark()
    from pyspark.context import SparkContext
    from pyspark.ml import Pipeline as SparkPipeline
    from pyspark.ml import PipelineModel as SparkPipelineModel
    from pyspark.ml.feature import StopWordsRemover
    from pyspark.ml.util import JavaMLReader, JavaMLWriter
    from pyspark.ml.wrapper import JavaParams
except ImportError as _e:  # pragma: no cover - exercised only w/ pyspark
    raise ImportError(
        "sparktorch_tpu_torch.spark requires pyspark (or "
        "sparktorch_tpu_torch.spark.localsession.install()); use the "
        "native sparktorch_tpu_torch.ml.Pipeline persistence otherwise"
    ) from _e

# File-format constant: the magic id tagging carrier stages. Matches
# the reference's on-disk tag (pipeline_util.py:27) so pipelines saved
# by the reference remain readable.
CARRIER_GUID = "4c1740b00d3c4ff6806a1402321572cb"


# "0," .. "255," as fixed-width byte strings, NUL-padded to 4.
_TOKENS = np.array([f"{b},".encode() for b in range(256)], dtype="S4")
# Work on large payloads goes in blocks of this size on threads (numpy
# and zlib release the interpreter lock).
_BLOCK = 16 << 20


def _blocks(fn, starts) -> list:
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        return list(pool.map(fn, starts))


def _decimal_text(payload: bytes) -> str:
    """``"".join(f"{b}," for b in payload)``, vectorised."""
    data = np.frombuffer(payload, np.uint8)

    def render(start: int) -> bytes:
        chars = _TOKENS[data[start:start + _BLOCK]].view(np.uint8)
        return chars[chars != 0].tobytes()

    return b"".join(_blocks(render, range(0, len(data), _BLOCK))).decode(
        "ascii")


def _parse_block(part) -> np.ndarray:
    """The values of one block of whole ``digits,`` tokens."""
    chars = np.frombuffer(part, np.uint8)
    comma = chars == 44
    digits = chars - np.uint8(48)
    if not ((digits <= 9) | comma).all():
        raise ValueError("carrier payload is not comma-separated decimal "
                         "bytes")
    ends = np.flatnonzero(comma)
    lens = np.diff(ends, prepend=-1) - 1
    if lens.size and (lens.min() < 1 or lens.max() > 3):
        raise ValueError("carrier payload has an empty or long token")
    values = digits[ends - 1].astype(np.uint16)
    for k, scale in ((2, 10), (3, 100)):
        at = np.flatnonzero(lens >= k)
        values[at] += digits[ends[at] - k].astype(np.uint16) * scale
    return values


def _decimal_bytes(text: str) -> bytes:
    """The inverse of :func:`_decimal_text`: the bytes of comma-separated
    decimal tokens, the last comma optional. Raises ValueError on
    anything else (another character, an empty token, a value above
    255). Parsed in blocks on threads."""
    raw = text.encode("ascii")
    if raw and not raw.endswith(b","):
        raw += b","
    cuts = [0]
    while cuts[-1] < len(raw):
        nxt = raw.find(b",", cuts[-1] + _BLOCK)
        cuts.append(len(raw) if nxt < 0 else nxt + 1)
    view = memoryview(raw)
    parts = _blocks(lambda i: _parse_block(view[cuts[i]:cuts[i + 1]]),
                    range(len(cuts) - 1))
    values = np.concatenate(parts) if parts else np.zeros(0, np.uint16)
    if values.size and values.max() > 255:
        raise ValueError("carrier payload holds a value above 255")
    return values.astype(np.uint8).tobytes()


def _compress(data: bytes) -> bytes:
    """A zlib stream of ``data``: blocks deflated on threads, each ended
    by a full flush (the last by the final block), between the zlib
    header and the Adler-32 of the whole. For one block it is
    ``zlib.compress(data)``, byte for byte. A fitted BERT-base stage is
    ~0.55 GB of dill, which one core deflates several times slower than
    the blocks on eight (``spark_costs.py`` times both)."""
    view = memoryview(data)

    def block(start: int) -> bytes:
        deflate = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED,
                                   -15)
        end = start + _BLOCK
        return deflate.compress(view[start:end]) + deflate.flush(
            zlib.Z_FINISH if end >= len(data) else zlib.Z_FULL_FLUSH)

    body = b"".join(_blocks(block, range(0, len(data) or 1, _BLOCK)))
    return b"\x78\x9c" + body + struct.pack(">I", zlib.adler32(data))


def _payload_strings(obj: Any) -> List[str]:
    """dill -> zlib -> decimal-rendered bytes, GUID-tagged — the
    2-element stopwords list that IS the carrier file format."""
    payload = _compress(dill.dumps(obj))
    # Trailing comma matters: the reference's reader does
    # ``split(',')[0:-1]`` (pipeline_util.py:35), so a string without
    # it would lose its last byte there.
    return [_decimal_text(payload), CARRIER_GUID]


def encode_python_stage(obj: Any, uid: str) -> StopWordsRemover:
    """Pack a Python stage into a JVM-persistable carrier stage."""
    carrier = StopWordsRemover(inputCol=uid, outputCol=uid + "_out")
    carrier.setStopWords(_payload_strings(obj))
    return carrier


def decode_carrier_stage(stage) -> Any:
    """Carrier stage -> live Python object."""
    words: List[str] = stage.getStopWords()
    return dill.loads(zlib.decompress(_decimal_bytes(words[0])))


def is_carrier(stage) -> bool:
    if not isinstance(stage, StopWordsRemover):
        return False
    words = stage.getStopWords()
    return bool(words) and words[-1] == CARRIER_GUID


class PythonStagePersistence:
    """Mixin that lets a pure-Python pyspark stage (estimator, model,
    or transformer) be saved and loaded — directly via
    ``stage.write().save(path)`` / ``Cls.load(path)``, or inside a
    surrounding ``Pipeline``/``PipelineModel``.

    Parity: the reference's ``PysparkReaderWriter`` (reference
    ``pipeline_util.py:80-130``), mixed into BOTH the estimator and
    the model (reference ``torch_distributed.py:58,130-138``):

    - ``write()`` returns the runtime's ``JavaMLWriter`` over this
      instance, whose save path calls ``_to_java`` (reference :88-90);
    - ``read()``/``load()`` go through ``JavaMLReader`` on the carrier
      class and re-hydrate with ``_from_java`` (reference :92-101);
    - ``_to_java`` performs the gateway-side carrier construction
      itself — dill dump, zlib, decimal string array through
      ``sc._gateway.new_array``, ``JavaParams._new_java_obj`` of the
      carrier class (reference :112-130). Under real pyspark these
      calls cross the Py4J bridge into the JVM; under localspark they
      hit the protocol-faithful local gateway — the same code path
      either way.

    ``_to_carrier`` additionally serves the localspark pipeline
    writer, which persists carrier stages as JSON param maps.
    """

    def write(self) -> "JavaMLWriter":
        return JavaMLWriter(self)

    @classmethod
    def read(cls) -> "JavaMLReader":
        return JavaMLReader(StopWordsRemover)

    @classmethod
    def load(cls, path: str):
        obj = cls._from_java(cls.read().load(path))
        # The carrier format has no class discriminator; catch a
        # wrong-kind load (model path through SparkTorch.load, etc.)
        # here rather than as a far-away AttributeError.
        if cls is not PythonStagePersistence and not isinstance(obj, cls):
            raise TypeError(
                f"{path} holds a {type(obj).__name__}, not a {cls.__name__}"
            )
        return obj

    def _to_carrier(self) -> StopWordsRemover:
        return encode_python_stage(self, getattr(self, "uid", "pystage"))

    def _to_java(self):
        pylist = _payload_strings(self)
        sc = SparkContext._active_spark_context
        if sc is None:
            raise RuntimeError(
                "persistence requires an active SparkSession (the "
                "gateway lives on SparkContext._active_spark_context)"
            )
        java_class = sc._gateway.jvm.java.lang.String
        java_array = sc._gateway.new_array(java_class, len(pylist))
        java_array[0:2] = pylist[0:2]
        java_obj = JavaParams._new_java_obj(
            "org.apache.spark.ml.feature.StopWordsRemover",
            getattr(self, "uid", "pystage"),
        )
        java_obj.setStopWords(java_array)
        return java_obj

    @classmethod
    def _from_java(cls, java_stage):
        """Carrier (JVM object via Py4J, or any object exposing
        ``getStopWords``) -> live Python instance."""
        words = list(java_stage.getStopWords())
        if not words or words[-1] != CARRIER_GUID:
            raise ValueError("stage is not a sparktorch carrier")
        return decode_carrier_stage(java_stage)


def unwrap_spark_pipeline(pipeline):
    """Re-hydrate carrier stages in a loaded Spark pipeline.

    Parity: ``PysparkPipelineWrapper.unwrap`` (pipeline_util.py:49-77),
    including recursion into nested pipelines.
    """
    if isinstance(pipeline, (SparkPipeline, SparkPipelineModel)):
        stages = pipeline.getStages() if hasattr(pipeline, "getStages") else pipeline.stages
        new_stages = []
        for stage in stages:
            if is_carrier(stage):
                new_stages.append(decode_carrier_stage(stage))
            elif isinstance(stage, (SparkPipeline, SparkPipelineModel)):
                new_stages.append(unwrap_spark_pipeline(stage))
            else:
                new_stages.append(stage)
        if hasattr(pipeline, "setStages"):
            pipeline.setStages(new_stages)
        else:
            pipeline.stages = new_stages
    return pipeline


class PysparkPipelineWrapper:
    """Reference-named entry point (``pipeline_util.py:49-77``):
    ``PysparkPipelineWrapper.unwrap(PipelineModel.load(path))``."""

    @staticmethod
    def unwrap(pipeline):
        return unwrap_spark_pipeline(pipeline)
