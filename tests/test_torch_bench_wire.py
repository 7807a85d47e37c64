"""The port's wire microbenchmark (``sparktorch_tpu_torch.net.bench_wire``)
and ``wire.tree_nbytes`` against the JAX package's.

The same seeded state dict leaf for leaf, the same payload bytes, the
binary frames (plain and bf16) byte for byte, the same byte rows in a
run's record, and the gate: the CLI exits non-zero when the binary
wire loses to dill.
"""

import json

import numpy as np
import pytest
import torch

from sparktorch_tpu.net import bench_wire as jax_bench_wire
from sparktorch_tpu.net import wire as jax_wire
from sparktorch_tpu_torch.net import bench_wire
from sparktorch_tpu_torch.net import wire

SIZES = [dict(layers=1, d_model=32, vocab=64, seed=0),
         dict(layers=2, d_model=48, vocab=128, seed=3)]


def _leaves(tree):
    return [(path, np.asarray(a)) for path, a in wire.flatten_tree(tree)]


@pytest.mark.parametrize("size", SIZES)
def test_state_dict_equals_the_jax_one_leaf_for_leaf(size):
    port = bench_wire.transformer_state_dict(**size)
    want = jax_bench_wire.transformer_state_dict(**size)
    got, ref = _leaves(port), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("size", SIZES)
def test_tree_nbytes_agrees(size):
    tree = bench_wire.transformer_state_dict(**size)
    n = jax_wire.tree_nbytes(tree)
    assert wire.tree_nbytes(tree) == n
    # Tensor leaves count their storage as the numpy ones do.
    as_torch = wire.unflatten_tree(
        [(path, torch.from_numpy(np.asarray(a)))
         for path, a in wire.flatten_tree(tree)])
    assert wire.tree_nbytes(as_torch) == n
    assert wire.tree_nbytes({"b": torch.zeros(3, dtype=torch.bfloat16)}) == 6


@pytest.mark.parametrize("size", SIZES)
def test_binary_frames_are_the_jax_frames_byte_for_byte(size):
    tree = bench_wire.transformer_state_dict(**size)
    port = wire.frame_bytes(wire.encode(tree, version=7))
    want = jax_wire.frame_bytes(jax_wire.encode(tree, version=7))
    assert port == want
    port_bf16 = wire.frame_bytes(wire.encode(
        wire.quantize_tree(tree, "bf16")[0], version=7))
    want_bf16 = jax_wire.frame_bytes(jax_wire.encode(
        jax_wire.quantize_tree(tree, "bf16")[0], version=7))
    assert port_bf16 == want_bf16
    version, back = wire.decode(port)
    assert version == 7
    for (path, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_record_bytes_equal_the_jax_record_and_the_gate_holds(capsys):
    size = dict(layers=2, d_model=256, vocab=2048)
    rec = bench_wire.run(repeats=3, **size)
    want = jax_bench_wire.run(repeats=1, **size)
    for key in ("state_dict_mb", "n_tensors", "dill_bytes", "binary_bytes",
                "binary_bf16_bytes", "bytes_saved"):
        assert rec[key] == want[key], key
    assert set(rec) == set(want)
    assert rec["ok"], rec
    assert bench_wire.main(["--layers", "2", "--d-model", "256",
                            "--vocab", "2048"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["ok"] is True


def test_gate_exits_nonzero_when_binary_loses(monkeypatch, capsys):
    """A binary decode slower than dill's whole round trip: the record
    says ``ok: false`` and the CLI exits 1 with its message."""
    import time

    decode = wire.decode

    def slow_decode(data):
        time.sleep(0.5)
        return decode(data)

    monkeypatch.setattr(wire, "decode", slow_decode)
    rc = bench_wire.main(["--layers", "1", "--d-model", "32", "--vocab",
                          "64", "--repeats", "1"])
    out = capsys.readouterr()
    assert rc == 1
    assert json.loads(out.out.strip())["ok"] is False
    assert "binary wire must beat dill" in out.err
