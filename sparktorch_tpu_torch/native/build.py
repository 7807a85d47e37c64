"""Build-on-demand loader for the native libraries — the port of ``sparktorch_tpu/native/build.py``.

``load_library(name)`` compiles ``native/<name>.cpp`` (the repository's
C++ sources, shared with the JAX package and never edited for the
port) with ``g++`` into ``sparktorch_tpu_torch/_build/``, under a name
keyed by a hash of the source and the flags, as ``ops/_build.py`` keys
the CUDA kernels: editing the source builds it anew, and the JAX
package's ``native/build/`` is left alone. A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LOCK = threading.Lock()
_CACHE: dict = {}


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """``native/<name>.cpp`` as a loaded library, compiled first when no
    build of this source exists. The compiler runs outside the lock, so
    a load of a library already built never waits for another one's
    build; each build writes a file of its own and renames it into
    place, so concurrent builds of one source leave one whole file."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
    src = NATIVE_DIR / f"{name}.cpp"
    if not src.exists():
        raise FileNotFoundError(f"no native source {src}")
    out = _library_path(src)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / (f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
               str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)}\n(exit {proc.returncode})"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    with _LOCK:
        if name not in _CACHE:
            _CACHE[name] = ctypes.CDLL(str(out))
        return _CACHE[name]
