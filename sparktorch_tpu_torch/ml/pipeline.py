"""Pipeline composition + persistence — the port of ``sparktorch_tpu/ml/pipeline.py``.

Reference: Spark's ``Pipeline``/``PipelineModel`` plus
``sparktorch/pipeline_util.py`` — which must smuggle pure-Python
transformers through the JVM by dill-dumping them, zlib-compressing,
rendering the bytes as a decimal string and hiding it in a
``StopWordsRemover``'s stopwords list tagged with a magic GUID
(``pipeline_util.py:16-31,112-130``), then re-hydrating on load
(``unwrap``, ``pipeline_util.py:49-77``).

Without a JVM none of that contortion is needed: stages persist as
dill blobs in a versioned directory with a JSON manifest. The format is
the JAX package's, with ``"framework": "sparktorch_tpu_torch"`` in the
manifest. :class:`PysparkPipelineWrapper` keeps the ``unwrap``
entrypoint; the Spark carrier adapter is not ported yet, so ``unwrap``
returns what it is given.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import dill

from sparktorch_tpu_torch.ml.params import Estimator, Model, Transformer

_MANIFEST = "metadata.json"
_FORMAT_VERSION = 1


class _Writer:
    """`.write().overwrite().save(path)` chain parity (pipeline_util.py:88-90)."""

    def __init__(self, obj):
        self._obj = obj
        self._overwrite = False

    def overwrite(self):
        self._overwrite = True
        return self

    def save(self, path: str):
        if os.path.exists(path) and not self._overwrite:
            raise FileExistsError(f"{path} exists; use .overwrite()")
        _save_stages_dir(path, type(self._obj).__name__, getattr(self._obj, "stages", [self._obj]))


def _save_stages_dir(path: str, kind: str, stages: Sequence):
    os.makedirs(os.path.join(path, "stages"), exist_ok=True)
    names = []
    for i, stage in enumerate(stages):
        fname = f"{i}_{type(stage).__name__}.dill"
        names.append(fname)
        with open(os.path.join(path, "stages", fname), "wb") as f:
            dill.dump(stage, f)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(  # lint-obs: ok (persistence manifest, not trace events)
            {
                "format_version": _FORMAT_VERSION,
                "kind": kind,
                "framework": "sparktorch_tpu_torch",
                "stages": names,
            },
            f,
            indent=2,
        )


def _load_stages_dir(path: str):
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    stages = []
    for fname in manifest["stages"]:
        with open(os.path.join(path, "stages", fname), "rb") as f:
            stages.append(dill.load(f))
    return manifest, stages


class Pipeline(Estimator):
    def __init__(self, stages: Optional[List] = None):
        super().__init__()
        self.stages = stages or []

    def setStages(self, stages: List):
        self.stages = stages
        return self

    def getStages(self) -> List:
        return self.stages

    def _fit(self, dataset) -> "PipelineModel":
        transformers = []
        df = dataset
        for i, stage in enumerate(self.stages):
            if isinstance(stage, Estimator):
                model = stage.fit(df)
                transformers.append(model)
                if i < len(self.stages) - 1:
                    df = model.transform(df)
            elif isinstance(stage, Transformer):
                transformers.append(stage)
                if i < len(self.stages) - 1:
                    df = stage.transform(df)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(transformers)

    def write(self) -> _Writer:
        return _Writer(self)

    def save(self, path: str):
        self.write().overwrite().save(path)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        _, stages = _load_stages_dir(path)
        return cls(stages)


class PipelineModel(Model):
    def __init__(self, stages: Optional[List] = None):
        super().__init__()
        self.stages = stages or []

    def _transform(self, dataset):
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df

    def write(self) -> _Writer:
        return _Writer(self)

    def save(self, path: str):
        self.write().overwrite().save(path)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        _, stages = _load_stages_dir(path)
        return cls(stages)


class PysparkPipelineWrapper:
    """Parity shim for ``PysparkPipelineWrapper.unwrap``: native
    pipelines need no carrier decoding, so unwrap is identity."""

    @staticmethod
    def unwrap(pipeline):
        return pipeline
