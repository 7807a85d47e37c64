"""A JVM-free Spark-ML-style Params/Estimator/Transformer layer.

The reference's entire config surface is Spark ML ``Param``
declarations with typed converters, ``@keyword_only`` ctors and
``getOrDefault`` getters (``torch_distributed.py:141-264``;
SURVEY §5 "Config / flag system"). That surface is the public API
contract, so this module reimplements its semantics natively —
typed params, defaults vs. explicitly-set values, ``copy()`` with
extra-param overlay — without PySpark or Py4J.

The port's own copy of ``sparktorch_tpu/ml/params.py``: importing
that module would run ``sparktorch_tpu/__init__.py``, which imports
jax.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional


class TypeConverters:
    """Parity with pyspark.ml.param.TypeConverters' common members."""

    @staticmethod
    def toString(v) -> str:
        return str(v)

    @staticmethod
    def toInt(v) -> int:
        return int(v)

    @staticmethod
    def toFloat(v) -> float:
        return float(v)

    @staticmethod
    def toBoolean(v) -> bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return v.lower() in ("true", "1", "yes")
        return bool(v)

    @staticmethod
    def identity(v):
        return v

    @staticmethod
    def toList(v) -> list:
        return list(v)


class Param:
    def __init__(self, parent: Any, name: str, doc: str = "",
                 typeConverter: Callable = TypeConverters.identity):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter

    def __repr__(self):
        return f"Param(name={self.name!r})"


def keyword_only(func):
    """Record kwargs on ``self._input_kwargs`` like pyspark's decorator."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(f"{func.__name__} accepts keyword arguments only")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


class Params:
    """Typed param storage: class-level Param declarations, instance
    value maps split into defaults and explicitly-set values."""

    @classmethod
    def _dummy(cls):
        return None

    def __init__(self):
        self._paramMap: Dict[str, Any] = {}
        self._defaultParamMap: Dict[str, Any] = {}

    # -- declaration helpers ------------------------------------------------

    @property
    def params(self):
        out = []
        for klass in type(self).__mro__:
            for name, value in vars(klass).items():
                if isinstance(value, Param) and all(p.name != value.name for p in out):
                    out.append(value)
        return sorted(out, key=lambda p: p.name)

    def getParam(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"no param {name!r} on {type(self).__name__}")

    def hasParam(self, name: str) -> bool:
        return any(p.name == name for p in self.params)

    # -- get / set ----------------------------------------------------------

    def _resolve(self, param) -> Param:
        return param if isinstance(param, Param) else self.getParam(param)

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            if value is None:
                continue
            p = self.getParam(name)
            self._paramMap[p.name] = p.typeConverter(value)
        return self

    def _setDefault(self, **kwargs):
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._defaultParamMap[p.name] = value
        return self

    def set(self, param, value):
        p = self._resolve(param)
        self._paramMap[p.name] = p.typeConverter(value)
        return self

    def isSet(self, param) -> bool:
        return self._resolve(param).name in self._paramMap

    def isDefined(self, param) -> bool:
        name = self._resolve(param).name
        return name in self._paramMap or name in self._defaultParamMap

    def getOrDefault(self, param):
        name = self._resolve(param).name
        if name in self._paramMap:
            return self._paramMap[name]
        if name in self._defaultParamMap:
            return self._defaultParamMap[name]
        raise KeyError(f"param {name!r} is not set and has no default")

    def extractParamMap(self, extra: Optional[dict] = None) -> dict:
        out = dict(self._defaultParamMap)
        out.update(self._paramMap)
        if extra:
            out.update({self._resolve(k).name: v for k, v in extra.items()})
        return out

    def explainParams(self) -> str:
        lines = []
        for p in self.params:
            current = self.extractParamMap().get(p.name, "undefined")
            lines.append(f"{p.name}: {p.doc} (current: {current!r})")
        return "\n".join(lines)

    def copy(self, extra: Optional[dict] = None):
        import copy as _copy

        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        new._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for k, v in extra.items():
                new.set(k, v)
        return new


class _ColParams(Params):
    """The 3 inherited column params (HasInputCol/HasLabelCol/
    HasPredictionCol analogs — torch_distributed.py:130-139)."""

    inputCol = Param(Params._dummy(), "inputCol", "input column name",
                     TypeConverters.toString)
    labelCol = Param(Params._dummy(), "labelCol", "label column name",
                     TypeConverters.toString)
    predictionCol = Param(Params._dummy(), "predictionCol", "prediction column name",
                          TypeConverters.toString)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol) if self.isDefined(self.labelCol) else None

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)

    def setInputCol(self, value):
        return self._set(inputCol=value)

    def setLabelCol(self, value):
        return self._set(labelCol=value)

    def setPredictionCol(self, value):
        return self._set(predictionCol=value)


class Estimator(_ColParams):
    def fit(self, dataset, params: Optional[dict] = None):
        est = self.copy(params) if params else self
        return est._fit(dataset)

    def _fit(self, dataset):  # pragma: no cover - abstract
        raise NotImplementedError


class Transformer(_ColParams):
    def transform(self, dataset, params: Optional[dict] = None):
        t = self.copy(params) if params else self
        return t._transform(dataset)

    def _transform(self, dataset):  # pragma: no cover - abstract
        raise NotImplementedError


class Model(Transformer):
    pass
