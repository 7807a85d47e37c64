"""The binary wire in both packages: the same bytes, either way round.

bfloat16 leaves are ``ml_dtypes`` arrays on the JAX side and
``torch.bfloat16`` tensors on the port's.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from sparktorch_tpu.net import wire as jax_wire
from sparktorch_tpu_torch.net import wire


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                "b": rng.standard_normal(4).astype(np.float32)},
        "ints": {"i32": np.arange(6, dtype=np.int32).reshape(2, 3),
                 "i64": np.arange(3, dtype=np.int64),
                 "u8": np.arange(5, dtype=np.uint8)},
        "scalars": {"zero_d": np.float32(2.5), "count": np.int64(7)},
        "nested": {"a": {"b": {"c": rng.standard_normal((2, 2)).astype(
            np.float64)}}, "empty": np.zeros((0, 3), np.float32)},
        "big_endian": {"x": np.arange(4, dtype=">f4")},
        "bare_leaf": rng.standard_normal(5).astype(np.float32),
        "non_contiguous": {"t": rng.standard_normal((4, 3)).astype(
            np.float32).T},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_frames_are_byte_identical(name):
    tree = _trees()[name]
    want = jax_wire.frame_bytes(jax_wire.encode(tree, version=11, run_tag=9))
    got = wire.frame_bytes(wire.encode(tree, version=11, run_tag=9))
    assert got == want
    assert wire.frame_run_tag(got) == 9


def test_bfloat16_leaves_are_byte_identical():
    values = np.random.default_rng(1).standard_normal((4, 5)
                                                      ).astype(np.float32)
    jax_tree = {"g": values.astype(ml_dtypes.bfloat16), "n": np.arange(2)}
    port_tree = {"g": torch.from_numpy(values).to(torch.bfloat16),
                 "n": np.arange(2)}
    want = jax_wire.frame_bytes(jax_wire.encode(jax_tree))
    assert wire.frame_bytes(wire.encode(port_tree)) == want
    _, decoded = wire.decode(want)
    assert decoded["g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(decoded["g"].float().numpy(),
                                  jax_tree["g"].astype(np.float32))
    _, back = jax_wire.decode(wire.frame_bytes(wire.encode(port_tree)))
    assert back["g"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["g"], jax_tree["g"])


def _leaves_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    else:
        assert np.asarray(got).shape == np.asarray(want).shape
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_decodes_the_others_frames(direction):
    for name, tree in _trees(2).items():
        enc, dec = ((jax_wire, wire) if direction == "jax_to_port"
                    else (wire, jax_wire))
        version, decoded = dec.decode(enc.frame_bytes(enc.encode(tree,
                                                                 version=3)))
        assert version == 3, name
        _leaves_equal(decoded, tree)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_pushes_and_residuals_match(mode):
    rng = np.random.default_rng(3)
    jax_res, port_res = {}, {}
    for _ in range(3):
        grads = {"layer": {"kernel": rng.standard_normal((6, 7)).astype(
            np.float32)}, "bias": rng.standard_normal(7).astype(np.float32),
            "step": np.arange(2, dtype=np.int32)}
        jax_leaves, _ = jax_wire.quantize_tree(grads, mode, jax_res)
        port_leaves, _ = wire.quantize_tree(grads, mode, port_res)
        frame = jax_wire.frame_bytes(jax_wire.encode(jax_leaves))
        assert wire.frame_bytes(wire.encode(port_leaves)) == frame
        assert set(port_res) == set(jax_res)
        for path, value in jax_res.items():
            np.testing.assert_array_equal(port_res[path], value)
        _, want = jax_wire.decode(frame)
        _, got = wire.decode(frame)
        np.testing.assert_array_equal(np.asarray(torch.as_tensor(
            got["bias"]).float()), np.asarray(want["bias"], np.float32))


def _delta_leaves(pkg, quant, seed=5):
    """A partial tree's leaves (nested paths, an int leaf, an empty one)
    and their version tags; int8 leaves quantized by ``pkg``'s wire."""
    rng = np.random.default_rng(seed)
    leaves = [(("enc", "w"), rng.standard_normal((4, 3)).astype(np.float32)),
              (("enc", "b"), rng.standard_normal(3).astype(np.float32)),
              (("steps",), np.arange(2, dtype=np.int64)),
              (("empty",), np.zeros((0, 2), np.float32))]
    if quant == "int8":
        leaves = [(p, pkg.quantize_leaf_int8(a)[0] if p[0] == "enc" else a)
                  for p, a in leaves]
    return leaves, {("enc", "w"): 7, ("enc", "b"): 3, ("steps",): 7}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_delta_frames_are_byte_identical(quant):
    # Version-2 frames: a per-leaf version tag in each entry (-1 where
    # the map has none), the same bytes as the JAX package's.
    jax_leaves, vers = _delta_leaves(jax_wire, quant)
    want = jax_wire.frame_bytes(jax_wire.encode(
        jax_leaves, version=9, run_tag=4, leaf_versions=vers))
    leaves, vers = _delta_leaves(wire, quant)
    got = wire.frame_bytes(wire.encode(leaves, version=9, run_tag=4,
                                       leaf_versions=vers))
    assert got == want and got[4] == wire.WIRE_VERSION_DELTA == 2
    version, flat, got_vers = wire.decode_delta(got)
    assert version == 9 and got_vers == {**vers, ("empty",): -1}
    assert set(flat) == {p for p, _ in leaves}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_decodes_the_others_delta_frames(direction):
    for quant in (None, "int8"):
        enc, dec = ((jax_wire, wire) if direction == "jax_to_port"
                    else (wire, jax_wire))
        leaves, vers = _delta_leaves(enc, quant)
        frame = enc.frame_bytes(enc.encode(leaves, version=2,
                                           leaf_versions=vers))
        version, got, got_vers = dec.decode_delta(frame)
        _, want, want_vers = enc.decode_delta(frame)
        assert version == 2 and got_vers == want_vers
        assert set(got) == set(want)
        for path in want:
            _leaves_equal(got[path], want[path])


def test_v1_and_v2_decoders_reject_each_others_frames():
    delta = wire.frame_bytes(wire.encode({"w": np.ones(2, np.float32)},
                                         leaf_versions={("w",): 1}))
    full = wire.frame_bytes(wire.encode({"w": np.ones(2, np.float32)}))
    with pytest.raises(wire.WireError, match="decode_delta"):
        wire.decode(delta)
    with pytest.raises(wire.WireError, match="v1"):
        wire.decode_delta(full)
    with pytest.raises(wire.WireError, match="v1"):
        wire.decode_delta(jax_wire.frame_bytes(jax_wire.encode(
            {"w": np.ones(2, np.float32)})))
    bad = bytearray(delta)
    bad[4] = 3
    with pytest.raises(wire.WireError, match="unsupported wire version"):
        wire.decode_delta(bytes(bad))


def test_bfloat16_delta_leaves_stay_torch_tensors():
    values = np.random.default_rng(6).standard_normal(6).astype(np.float32)
    frame = jax_wire.frame_bytes(jax_wire.encode(
        {"g": values.astype(ml_dtypes.bfloat16)}, leaf_versions={("g",): 4}))
    port = wire.frame_bytes(wire.encode(
        {"g": torch.from_numpy(values).to(torch.bfloat16)},
        leaf_versions={("g",): 4}))
    assert port == frame
    _, flat, vers = wire.decode_delta(frame)
    assert flat[("g",)].dtype == torch.bfloat16 and vers == {("g",): 4}
    np.testing.assert_array_equal(
        flat[("g",)].float().numpy(),
        values.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_int8_leaf_quantization_matches():
    value = np.random.default_rng(4).standard_normal((5, 5)).astype(
        np.float32)
    residual = 0.01 * np.ones_like(value)
    jq, jerr = jax_wire.quantize_leaf_int8(value, residual)
    pq, perr = wire.quantize_leaf_int8(value, residual)
    np.testing.assert_array_equal(pq.data, jq.data)
    assert pq.scale == jq.scale
    np.testing.assert_array_equal(perr, jerr)


def _frame():
    return wire.frame_bytes(wire.encode(
        {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}, version=1))


def _corrupt_table(frame):
    header = wire.HEADER_SIZE
    return frame[:header] + b"\x00" + frame[header + 1:]


def _oversize_shape(frame):
    return frame.replace(b"[3,4]", b"[9,4]")


@pytest.mark.parametrize("mangle", [
    lambda f: f[:10],                       # shorter than the header
    lambda f: f[:-4],                       # truncated payload
    lambda f: b"XXXX" + f[4:],              # bad magic
    lambda f: f[:4] + b"\x07" + f[5:],      # unknown wire version
    _corrupt_table,
    _oversize_shape,                        # a tensor outside the payload
    lambda f: f + b"\x00",                  # trailing bytes
], ids=["header", "truncated", "magic", "version", "table", "bounds",
        "trailing"])
def test_malformed_frames_raise(mangle):
    bad = mangle(_frame())
    with pytest.raises(wire.WireError):
        wire.decode(bad)
    with pytest.raises(jax_wire.WireError):
        jax_wire.decode(bad)
