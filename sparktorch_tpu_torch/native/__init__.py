"""ctypes bindings for the repository's native C++ runtime — the port of ``sparktorch_tpu/native``.

The C++ sources in ``native/`` at the repository root are shared with the
JAX package and compiled unchanged; the port builds its own copy into
``sparktorch_tpu_torch/_build/`` (:mod:`.build`).
"""

from sparktorch_tpu_torch.native.build import load_library

__all__ = ["load_library"]
