"""The port stands alone: no jax, no ``sparktorch_tpu``, no silent CPU runs."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sparktorch_tpu_torch as port
from sparktorch_tpu_torch.models import MnistMLP, tiny_transformer
from sparktorch_tpu_torch.models.transformer import SequenceClassifier
from sparktorch_tpu_torch.ops import _build
from sparktorch_tpu_torch.serve.param_server import ParameterServer
from sparktorch_tpu_torch.train.hogwild import train_async

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sparktorch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "sparktorch_tpu")
# Imported inside the Parquet functions only.
NOT_ON_IMPORT = FORBIDDEN + ("pyarrow", "orbax")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, sparktorch_tpu_torch, sparktorch_tpu_torch.models, "
        "sparktorch_tpu_torch.convert, sparktorch_tpu_torch.train.sync, "
        "sparktorch_tpu_torch.train.step, sparktorch_tpu_torch.utils.losses, "
        "sparktorch_tpu_torch.ops.fused_ce, sparktorch_tpu_torch.models.simple, "
        "sparktorch_tpu_torch.models.resnet, sparktorch_tpu_torch.net.wire, "
        "sparktorch_tpu_torch.net.transport, sparktorch_tpu_torch.utils.locks, "
        "sparktorch_tpu_torch.serve.param_server, "
        "sparktorch_tpu_torch.train.hogwild, "
        "sparktorch_tpu_torch.utils.checkpoint, sparktorch_tpu_torch.bench, "
        "sparktorch_tpu_torch.parallel, sparktorch_tpu_torch.parallel.launch, "
        "sparktorch_tpu_torch.native, sparktorch_tpu_torch.native.gang, "
        "sparktorch_tpu_torch.ops.roofline, sparktorch_tpu_torch.native.rowpack, "
        "sparktorch_tpu_torch.obs, sparktorch_tpu_torch.ft, "
        "sparktorch_tpu_torch.serve.infer, sparktorch_tpu_torch.serve.router, "
        "sparktorch_tpu_torch.serve.fleet, sparktorch_tpu_torch.net.sharded, "
        "sparktorch_tpu_torch.ctl, sparktorch_tpu_torch.ctl.worker, "
        "sparktorch_tpu_torch.ft.supervisor\n"
        "from sparktorch_tpu_torch import SparkTorch\n"
        "from sparktorch_tpu_torch.spark import localsession\n"
        "assert localsession.install()\n"
        "import sparktorch_tpu_torch.spark.torch_distributed, "
        "sparktorch_tpu_torch.spark.pipeline_util, "
        "sparktorch_tpu_torch.spark._executor\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {NOT_ON_IMPORT!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "sparktorch_tpu_torch.obs.log", "sparktorch_tpu_torch.obs.prom",
    "sparktorch_tpu_torch.utils.tracing", "sparktorch_tpu_torch.utils.metrics",
    "sparktorch_tpu_torch.serve.fleet", "sparktorch_tpu_torch.net.sharded",
    "sparktorch_tpu_torch.ctl,sparktorch_tpu_torch.ctl.worker",
    "sparktorch_tpu_torch.ft.supervisor",
    "sparktorch_tpu_torch.obs.history,sparktorch_tpu_torch.obs.alerts,"
    "sparktorch_tpu_torch.obs.skew,sparktorch_tpu_torch.obs.goodput,"
    "sparktorch_tpu_torch.obs.blackbox,sparktorch_tpu_torch.obs.profile,"
    "sparktorch_tpu_torch.obs.collector",
    "sparktorch_tpu_torch.obs.health", "sparktorch_tpu_torch.obs.replay",
    "sparktorch_tpu_torch.obs.xprof", "sparktorch_tpu_torch.obs",
    "sparktorch_tpu_torch.obs.rpctrace", "sparktorch_tpu_torch.obs.timeline",
    "sparktorch_tpu_torch.lint,sparktorch_tpu_torch.lint.cli",
    "sparktorch_tpu_torch.net.bench_wire",
    "sparktorch_tpu_torch.parallel.mesh,"
    "sparktorch_tpu_torch.parallel.sharding_rules,"
    "sparktorch_tpu_torch.train.sharded",
    "sparktorch_tpu_torch.parallel.tp",
])
def test_obs_and_tracing_modules_import_no_jax(module):
    # The copies of the JAX package's obs/log.py and obs/prom.py, the
    # torch.profiler port of utils/tracing.py, the sharded fleet's two
    # halves, the control plane, the supervisor and the obs modules they
    # import, each group on its own; the health lane, its replay, the
    # trace analyzer, the package as a whole, the request tracer, the
    # renderer, the port's sparklint and the wire benchmark; the dp × fsdp
    # mesh, its sharding rules and the sharded trainer; the tp layout.
    code = ("import sys, importlib\n"
            f"for name in {module.split(',')!r}:\n"
            "    importlib.import_module(name)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
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


def test_fit_refuses_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = SequenceClassifier(tiny_transformer(dtype="float32", max_len=8))
    est = port.SparkTorch(inputCol="features", labelCol="label",
                          torchObj=port.serialize_torch_obj(model), iters=1)
    assert est.getDevice() == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit({"features": [[1.0] * 8], "label": [0.0]})


def test_hogwild_refuses_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    obj = port.serialize_torch_obj(MnistMLP(), input_shape=(784,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParameterServer(obj)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_async(obj, [[0.0] * 784], labels=[0], iters=1)
    est = port.SparkTorch(inputCol="features", labelCol="label",
                          torchObj=obj, iters=1, mode="hogwild")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit({"features": [[0.0] * 784], "label": [0.0]})


def test_fleet_refuses_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet

    obj = port.serialize_torch_obj(MnistMLP(), input_shape=(784,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParamServerFleet(obj, n_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_async(obj, [[0.0] * 784], labels=[0], iters=1,
                    transport="http", shards=2)


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
