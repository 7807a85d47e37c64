"""PySpark deployment tier — the port of ``sparktorch_tpu/spark``.

``torch_distributed`` / ``pipeline_util`` require a pyspark module at
import time. On a Spark cluster that is the real thing; everywhere
else :mod:`sparktorch_tpu_torch.spark.localsession` provides an
API-compatible local runtime (real multi-process executors, barrier
execution, pipeline persistence): call ``localsession.install()``
first and the adapter code runs unmodified. The core package
(:mod:`sparktorch_tpu_torch.ml`) never imports any of this.
"""

__all__ = ["localsession"]

from sparktorch_tpu_torch.spark import localsession  # noqa: E402
