"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles alone into one shared library with a
plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds). The library lands in ``sparktorch_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags: editing a
``.cu`` or ``.cuh`` file builds it anew. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "CUDA kernels are built from source at first use"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile ``csrc/<name>.cu`` for every name not yet built, one
    ``nvcc`` process per source, all started together. Returns each
    name's compiler output (ptxas register and spill report). Raises
    with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no CUDA source {src}")
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, cmd)
    logs, failed = {}, []
    for name, (proc, tmp, out, cmd) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n(exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


_LOADS = 0


def loads() -> int:
    """How many kernel libraries this process has loaded (each built
    first where it was not yet): it grows only at a kernel's first use,
    which the trainers' goodput step spans count as ``compile``."""
    return _LOADS


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    global _LOADS
    path = _library_path(name)
    if not path.exists():
        build([name])
    _LOADS += 1
    return ctypes.CDLL(str(path))


def kernel_sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
