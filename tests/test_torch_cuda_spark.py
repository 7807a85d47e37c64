"""The Spark tier on the card: checks (a), (b) and (e) of ``chip_smoke.py``'s spark phase, at 2 layers of BERT-base.

(a) BERT-base (flash) fitted through ``SparkTorch(deployMode="barrier",
partitions=1, device="cuda")`` in an executor process equals the
in-process fit within 1e-6 × max|param|, and an executor's BERT step
launches the flash forward, dq and dk/dv kernels once a layer; (b) the
pandas UDF's argmaxes equal the estimator's on the same batches, with one
forward launch a layer for each UDF batch; (e) a Pipeline holding a
fitted model, saved and loaded through the carrier, predicts as the
model did, bit for bit.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy, the port and ``chip_smoke``, so it runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_spark.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

LAYERS, ROWS, ITERS, SERVE_ROWS = 2, 32, 2, 300


@pytest.fixture(scope="module")
def spark():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sparktorch_tpu_torch.ops import _build
    from sparktorch_tpu_torch.spark import localsession

    # Built here, so the executor processes load the kernels, never
    # build them.
    _build.build(_build.kernel_sources())
    saved = localsession.pyspark_entries()
    session = chip_smoke.spark_session()
    yield session
    session.stop()
    for name in localsession.pyspark_entries():
        del sys.modules[name]
    sys.modules.update(saved)


@pytest.fixture(scope="module")
def fitted(spark):
    return chip_smoke.spark_bert_fit(torch, spark, rows=ROWS, iters=ITERS,
                                     layers=LAYERS)


@pytest.mark.cuda
def test_barrier_bert_fit_equals_the_in_process_fit(fitted):
    # spark_bert_fit raises unless the supervised barrier fit equals the
    # in-process fit bit for bit, without a restart.
    _, counts, info = fitted
    assert info["max_abs_diff"] == 0.0 and info["restarts"] == 0
    assert counts["spark_barrier_bert"]["flash_fwd"] == 0  # all in the executor
    assert len(info["losses"]) == ITERS


@pytest.mark.cuda
def test_an_executor_bert_step_launches_the_training_kernels(spark):
    # spark_executor_step raises on any other launch count than one a
    # layer, or on jax in the executor.
    assert chip_smoke.spark_executor_step(spark, ROWS, LAYERS) == dict(
        flash_fwd=LAYERS, flash_bwd_dq=LAYERS, flash_bwd_dkv=LAYERS,
        ce_fwd=0, ce_bwd=0)


@pytest.mark.cuda
def test_udf_transform_equals_the_estimator(spark, fitted):
    pytest.importorskip("pandas", reason="localspark's withColumn needs "
                        "pandas")
    _, _, preds, _, whole, counts, info = chip_smoke.spark_udf_serve(
        torch, spark, fitted[0], layers=LAYERS, rows=SERVE_ROWS)
    assert preds.shape == whole.shape == (SERVE_ROWS,)
    assert counts["flash_fwd"] == 2 * LAYERS
    assert info["rows_per_s"] > 0


@pytest.mark.cuda
def test_a_pipeline_through_the_carrier_predicts_bit_for_bit(spark):
    pytest.importorskip("pandas", reason="localspark's withColumn needs "
                        "pandas")
    import os

    import numpy as np

    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    x, _ = chip_smoke.bert_ids(SERVE_ROWS, 5, TransformerConfig().vocab_size)
    frame = chip_smoke.spark_frame(spark, x)
    model, preds, counts = chip_smoke.spark_carrier_model(
        torch, spark, frame, layers=LAYERS)
    assert counts["flash_fwd"] == 2 * LAYERS
    os.makedirs(chip_smoke.SCRATCH, exist_ok=True)
    carried = {}
    chip_smoke.spark_carrier_round_trip(model, frame, carried)
    assert carried["done"] and carried["metadata_bytes"] > 0
    again = np.asarray([r["predictions"] for r in
                        carried["loaded"].transform(frame).collect()])
    assert np.array_equal(again, preds)
