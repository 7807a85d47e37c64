"""The port stands alone: no jax, no ``sparktorch_tpu``, no silent CPU runs."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sparktorch_tpu_torch as port
from sparktorch_tpu_torch.models import tiny_transformer
from sparktorch_tpu_torch.models.transformer import SequenceClassifier
from sparktorch_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sparktorch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparktorch_tpu")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, sparktorch_tpu_torch, sparktorch_tpu_torch.models, "
        "sparktorch_tpu_torch.convert\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_roots(tree):
            if name.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


def test_entry_points_refuse_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = SequenceClassifier(tiny_transformer(dtype="float32"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.BatchPredictor(model)
    stm = port.create_spark_torch_model(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stm.transform({"features": [[1.0] * 8]})


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_fwd"])


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "flash_fwd.cu"
    src.write_text((_build.CSRC / "flash_fwd.cu").read_text())
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._library_path("flash_fwd")
    assert first == _build._library_path("flash_fwd")
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._library_path("flash_fwd") != first
    assert _build.kernel_sources() == ["flash_fwd"]
