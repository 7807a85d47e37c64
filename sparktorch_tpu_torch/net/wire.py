"""Framed binary tensor wire — the port of ``sparktorch_tpu/net/wire.py``.

A frame is a fixed header, a JSON table that mirrors the tree, and the
tensors' raw bytes:

    offset  size  field
    0       4     magic  b"STWR"
    4       1     wire format version (1, or 2 for a delta frame)
    5       1     flags (bit 0: a 25-byte trace-context extension follows
                  the header: 16 bytes trace id, 8 bytes span id, 1
                  flag byte whose bit 0 is the sampled bit)
    6       2     run tag (uint16 LE; 0 = untagged)
    8       8     snapshot version tag (int64 LE; -1 = untagged)
    16      4     table length in bytes (uint32 LE)
    20      8     payload length in bytes (uint64 LE)
    28      ...   table: UTF-8 JSON; interior nodes are objects, leaves
                  ``[dtype-str, shape]`` (+ ``{"scale": s, "d": dtype}``
                  for an int8-quantized tensor); a version-2 leaf is
                  ``[dtype-str, shape, quant-or-null, leaf_version]``
    28+T    ...   payload: C-contiguous little-endian buffers in the
                  table's depth-first order

For the same numpy tree the frame is byte for byte the JAX package's,
and each package decodes the other's frames. Trees are nested
string-keyed mappings of numpy arrays or CPU torch tensors.

bfloat16 has no numpy dtype without ``ml_dtypes``, which the port does
not use: a bfloat16 leaf is a ``torch.bfloat16`` tensor, encoded as its
raw 2-byte payload under the dtype name ``"bfloat16"``, and decoded as
a ``torch.bfloat16`` tensor by a ``uint16`` view. Every other leaf
decodes to a read-only numpy view of the body.

:func:`quantize_tree` implements the error-feedback push compression
(bf16 or per-tensor int8): the quantization residual stays with the
sender and is added to its next push.

Version 2 is the DELTA frame the sharded fleet's ``/delta.bin`` route
serves (:func:`encode` with ``leaf_versions``, :func:`decode_delta`):
each leaf carries its own version tag beside the frame's snapshot
version, and the tree may hold only the leaves that advanced, for the
client to merge into its cached tree. :func:`decode` reads version-1
frames only and rejects a delta frame loudly, so a v1 consumer never
mistakes a partial tree for a whole one.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MAGIC = b"STWR"
WIRE_VERSION = 1
# Delta frames: the same header and payload layout; each leaf entry
# carries a 4th element (its version tag) and the tree may be partial.
WIRE_VERSION_DELTA = 2
# magic, version, flags, run tag, snapshot version, table len, payload len
_HEADER = struct.Struct("<4sBBHqIQ")
HEADER_SIZE = _HEADER.size
FLAG_TRACE = 0x01
_TRACE_EXT = struct.Struct("<16s8sB")
TRACE_EXT_SIZE = _TRACE_EXT.size

CONTENT_TYPE = "application/x-sparktorch-wire"
BFLOAT16 = "bfloat16"

Buffers = List[Union[bytes, memoryview]]
Leaf = Union[np.ndarray, torch.Tensor]


class WireError(ValueError):
    """Malformed frame: bad magic, truncated body, out-of-bounds table."""


# ---------------------------------------------------------------------------
# Tree <-> leaves
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: Tuple[str, ...], out: list) -> None:
    if isinstance(tree, Mapping):
        for k in tree:
            if not isinstance(k, str):
                raise WireError(
                    f"wire trees are string-keyed mappings; got key {k!r}")
            _flatten(tree[k], prefix + (k,), out)
    elif isinstance(tree, (list, tuple)):
        raise WireError(
            "wire trees are nested dicts of arrays; lists/tuples are not "
            f"encodable (at path {'/'.join(prefix) or '<root>'})")
    else:
        out.append((prefix, tree if isinstance(tree, (torch.Tensor,
                                                      QuantLeaf))
                    else np.asarray(tree)))


def flatten_tree(tree: Any) -> List[Tuple[Tuple[str, ...], Leaf]]:
    """``tree`` -> ordered ``[(path, leaf), ...]``; a bare array is a
    single leaf with the empty path."""
    out: list = []
    _flatten(tree, (), out)
    return out


def unflatten_tree(leaves: Sequence[Tuple[Tuple[str, ...], Any]]) -> Any:
    if len(leaves) == 1 and leaves[0][0] == ():
        return leaves[0][1]
    tree: Dict[str, Any] = {}
    for path, value in leaves:
        if not path:
            raise WireError("root leaf mixed with pathed leaves")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# Leaves as wire arrays: explicit little-endian numpy dtype strings
# ("<f4", "|i1", ...); bfloat16 by name, as raw uint16.
# ---------------------------------------------------------------------------


def _wire_array(leaf: Leaf) -> Tuple[str, np.ndarray]:
    """(dtype string, C-contiguous little-endian array) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BFLOAT16, t.view(torch.int16).numpy().view(np.uint16)
        leaf = t.numpy()
    # Not ascontiguousarray: it promotes 0-d arrays to 1-d.
    a = leaf if leaf.flags.c_contiguous else np.ascontiguousarray(leaf)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a.dtype.newbyteorder("<").str, a


def _dtype_of(name: str) -> np.dtype:
    if name == BFLOAT16:
        return np.dtype("<u2")
    try:
        return np.dtype(name)
    except TypeError as e:
        raise WireError(f"unknown wire dtype {name!r}") from e


# ---------------------------------------------------------------------------
# Quantization with sender-side error feedback
# ---------------------------------------------------------------------------


class QuantLeaf:
    """An int8-quantized leaf: data + scale + the dtype to dequantize
    back into."""

    __slots__ = ("data", "scale", "dequant_dtype")

    def __init__(self, data: np.ndarray, scale: float, dequant_dtype: str):
        self.data = data
        self.scale = float(scale)
        self.dequant_dtype = dequant_dtype


def _as_f32(leaf: Leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, dtype=np.float32)


def _is_float(leaf: Leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(leaf.dtype, np.floating)


def quantize_leaf_int8(value: Leaf, residual: Optional[np.ndarray] = None
                       ) -> Tuple[QuantLeaf, np.ndarray]:
    """Symmetric per-tensor int8 quantization of one float leaf, and
    the residual to add to the next quantization of the same leaf."""
    value = _as_f32(value)
    if residual is not None:
        value = value + residual
    amax = float(np.max(np.abs(value))) if value.size else 0.0
    scale = amax / 127.0 if amax > 0 else 1.0
    q = np.clip(np.rint(value / scale), -127, 127).astype(np.int8)
    return QuantLeaf(q, scale, "<f4"), value - q.astype(np.float32) * scale


def quantize_leaves_int8_on_card(
        values: Sequence[torch.Tensor],
        residuals: Sequence[Optional[torch.Tensor]]
) -> List[Tuple[QuantLeaf, torch.Tensor]]:
    """:func:`quantize_leaf_int8` for float leaves on the card, done
    there: ``[(QuantLeaf, residual)]`` with the residuals left on the
    card, and only the int8 bodies and the per-leaf maxima coming to the
    host (into pinned memory, one wait for them all). Byte for byte the
    host function's result on the host copies: the same float32 add,
    divide (by the float32 rounding of the float64 scale, which is the
    float32 quotient), round half to even, clip and multiply-subtract;
    the scale in the frame is the same float64 ``amax / 127``. The work
    runs on a side stream (:func:`~sparktorch_tpu_torch.utils.streams.
    copy_stream`), off the queue of the card's default stream."""
    if not values:
        return []
    from sparktorch_tpu_torch.utils.streams import copy_stream

    with copy_stream(values[0].device):
        staged = []
        for value, residual in zip(values, residuals):
            v = value.float()
            if residual is not None:
                v = v + residual
            amax = v.abs().max()
            scale = torch.where(amax > 0, amax / 127.0,
                                torch.ones_like(amax))
            q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
            host = torch.empty(q.shape, dtype=torch.int8, pin_memory=True)
            host.copy_(q, non_blocking=True)
            staged.append((host, amax, v - q.float() * scale))
        # The maxima's read waits for the bodies' copies on this stream.
        amaxes = torch.stack([a for _, a, _ in staged]).cpu().tolist()
    return [(QuantLeaf(host.numpy(), amax / 127.0 if amax > 0 else 1.0,
                       "<f4"), residual)
            for (host, _, residual), amax in zip(staged, amaxes)]


def quantize_tree(tree: Any, mode: str,
                  residuals: Optional[Dict[Tuple[str, ...], np.ndarray]] = None):
    """Compress float leaves for the push wire: ``mode='bf16'`` rounds
    them to bfloat16 (to nearest even, as ``ml_dtypes`` does),
    ``mode='int8'`` quantizes per tensor. With ``residuals`` (a dict the
    caller owns), each leaf's quantization error is stored there and
    added to its next push. Integer and empty leaves pass through.
    Returns ``(leaves, residuals)`` ready for :func:`encode`."""
    if mode not in ("bf16", "int8"):
        raise ValueError(f"quantize mode {mode!r}; use 'bf16' or 'int8'")
    new_residuals: Dict[Tuple[str, ...], np.ndarray] = {}
    leaves: list = []
    for path, leaf in flatten_tree(tree):
        size = leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size
        if not _is_float(leaf) or size == 0:
            leaves.append((path, leaf))
            continue
        value = _as_f32(leaf)
        if residuals is not None and path in residuals:
            value = value + residuals[path]
        if mode == "bf16":
            q = torch.from_numpy(value).to(torch.bfloat16)
            if residuals is not None:
                new_residuals[path] = value - q.float().numpy()
            leaves.append((path, q))
        else:
            qleaf, err = quantize_leaf_int8(value)
            if residuals is not None:
                new_residuals[path] = err
            leaves.append((path, qleaf))
    if residuals is not None:
        residuals.update(new_residuals)
    return leaves, (residuals if residuals is not None else {})


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def _encode_node(node: Any, table_out: Any, buffers: Buffers,
                 offset: int, prefix: Tuple[str, ...] = (),
                 leaf_versions: Optional[Mapping] = None) -> int:
    if isinstance(node, Mapping):
        for k in node:
            if not isinstance(k, str):
                raise WireError(
                    f"wire trees are string-keyed mappings; got key {k!r}")
            entry: Any = {} if isinstance(node[k], Mapping) else []
            offset = _encode_node(node[k], entry, buffers, offset,
                                  prefix + (k,), leaf_versions)
            table_out[k] = entry
        return offset
    if isinstance(node, (list, tuple)):
        raise WireError("wire trees are nested dicts of arrays; "
                        "lists/tuples are not encodable")
    if isinstance(node, QuantLeaf):
        dtype, arr = _wire_array(node.data)
        quant: Any = {"scale": node.scale, "d": node.dequant_dtype}
    else:
        dtype, arr = _wire_array(node if isinstance(node, torch.Tensor)
                                 else np.asarray(node))
        quant = None
    if leaf_versions is None:
        table_out.extend([dtype, list(arr.shape)]
                         + ([quant] if quant is not None else []))
    else:
        table_out.extend([dtype, list(arr.shape), quant,
                          int(leaf_versions.get(prefix, -1))])
    if arr.nbytes:
        buffers.append(memoryview(arr.reshape(-1).view(np.uint8)))
    return offset + arr.nbytes


def encode(tree_or_leaves: Any, version: int = -1, run_tag: int = 0,
           leaf_versions: Optional[Mapping] = None,
           trace: Optional[Any] = None) -> Buffers:
    """Frame a tree (or the flattened/quantized leaves of one) for the
    wire: ``[header+table bytes, buffer, buffer, ...]``, each buffer a
    view of the array's own memory. ``leaf_versions`` (``{path-tuple:
    int}``) makes it a version-2 delta frame, each leaf tagged with its
    version (-1 where the map has none).

    ``trace`` (anything with ``trace_id``/``span_id``/``sampled``, an
    :class:`~sparktorch_tpu_torch.obs.rpctrace.SpanContext`) embeds the
    request's tracing context as the ``FLAG_TRACE`` extension. Only a
    sampled context travels: ``None`` or an unsampled one leaves the
    frame byte-identical to an untraced one."""
    if isinstance(tree_or_leaves, list) and (
            not tree_or_leaves
            or (isinstance(tree_or_leaves[0], tuple)
                and isinstance(tree_or_leaves[0][0], tuple))):
        tree = unflatten_tree(tree_or_leaves)
    else:
        tree = tree_or_leaves
    buffers: Buffers = []
    table: Any = {} if isinstance(tree, Mapping) else []
    payload_len = _encode_node(tree, table, buffers, 0, (), leaf_versions)
    table_bytes = json.dumps(table, separators=(",", ":")).encode()
    wire_ver = WIRE_VERSION if leaf_versions is None else WIRE_VERSION_DELTA
    flags = 0
    ext = b""
    if trace is not None and getattr(trace, "sampled", False):
        try:
            ext = _TRACE_EXT.pack(bytes.fromhex(str(trace.trace_id)),
                                  bytes.fromhex(str(trace.span_id)), 1)
        except (ValueError, struct.error) as e:
            raise WireError(f"malformed trace context {trace!r}") from e
        flags |= FLAG_TRACE
    header = _HEADER.pack(MAGIC, wire_ver, flags, int(run_tag) & 0xFFFF,
                          int(version), len(table_bytes), payload_len)
    return [header + ext + table_bytes, *buffers]


def frame_nbytes(buffers: Buffers) -> int:
    return sum(len(b) for b in buffers)


def frame_bytes(buffers: Buffers) -> bytes:
    return b"".join(buffers)


def frame_run_tag(data: Union[bytes, bytearray, memoryview]) -> int:
    """The 16-bit run tag of a frame (0 = untagged), from its header
    alone. Raises :class:`WireError` on a non-frame."""
    mv = memoryview(data)
    if len(mv) < HEADER_SIZE:
        raise WireError(f"frame truncated: {len(mv)} < header {HEADER_SIZE}")
    magic, _ver, _flags, tag, _v, _t, _p = _HEADER.unpack_from(mv, 0)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    return int(tag)


def frame_trace(data: Union[bytes, bytearray, memoryview]):
    """The tracing context in a frame's ``FLAG_TRACE`` extension, as an
    :class:`~sparktorch_tpu_torch.obs.rpctrace.SpanContext`, or None on
    an untraced frame. Reads the header alone, so a server opens its
    serve span before it decodes the body. Raises :class:`WireError` on
    a non-frame or a truncated extension."""
    mv = memoryview(data)
    if len(mv) < HEADER_SIZE:
        raise WireError(f"frame truncated: {len(mv)} < header {HEADER_SIZE}")
    magic, _ver, flags, _tag, _v, _t, _p = _HEADER.unpack_from(mv, 0)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if not flags & FLAG_TRACE:
        return None
    if len(mv) < HEADER_SIZE + TRACE_EXT_SIZE:
        raise WireError("frame truncated inside the trace extension")
    trace_id, span_id, tflags = _TRACE_EXT.unpack_from(mv, HEADER_SIZE)
    from sparktorch_tpu_torch.obs.rpctrace import SpanContext

    return SpanContext.from_parts(trace_id.hex(), span_id.hex(),
                                  bool(tflags & 1))


def _decode_impl(data: Union[bytes, bytearray, memoryview], want: int
                 ) -> Tuple[int, Any, Dict[Tuple[str, ...], int]]:
    """``(version, tree, {path: leaf_version})`` of a frame of wire
    version ``want`` (the map is empty for version 1)."""
    mv = memoryview(data)
    if len(mv) < HEADER_SIZE:
        raise WireError(f"frame truncated: {len(mv)} < header {HEADER_SIZE}")
    magic, wire_ver, flags, _tag, version, table_len, payload_len = (
        _HEADER.unpack_from(mv, 0))
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if wire_ver == WIRE_VERSION_DELTA and want == WIRE_VERSION:
        raise WireError("got a delta (v2) frame; read it with decode_delta")
    if wire_ver == WIRE_VERSION and want == WIRE_VERSION_DELTA:
        raise WireError("expected a delta (v2) frame, got v1")
    if wire_ver != want:
        raise WireError(f"unsupported wire version {wire_ver}")
    body_off = HEADER_SIZE + (TRACE_EXT_SIZE if flags & FLAG_TRACE else 0)
    if len(mv) != body_off + table_len + payload_len:
        raise WireError(
            f"frame length {len(mv)} != header+table+payload "
            f"{body_off + table_len + payload_len}")
    try:
        table = json.loads(bytes(mv[body_off:body_off + table_len]))
    except ValueError as e:
        raise WireError(f"corrupt tensor table: {e}") from e
    if not isinstance(table, (dict, list)):
        raise WireError("tensor table is neither object nor leaf")
    payload = mv[body_off + table_len:]
    leaf_versions: Dict[Tuple[str, ...], int] = {}

    def read_leaf(entry: list, offset: int,
                  path: Tuple[str, ...]) -> Tuple[Any, int]:
        try:
            name = entry[0]
            dtype = _dtype_of(name)
            shape = tuple(int(d) for d in entry[1])
            quant = entry[2] if len(entry) > 2 else None
            if quant is not None:
                quant = (float(quant["scale"]),
                         _dtype_of(quant["d"]).newbyteorder("="))
            if wire_ver == WIRE_VERSION_DELTA:
                if len(entry) < 4:
                    raise WireError(
                        f"delta frame leaf missing version tag: {entry!r}")
                leaf_versions[path] = int(entry[3])
        except (IndexError, KeyError, TypeError, ValueError) as e:
            if isinstance(e, WireError):
                raise
            raise WireError(f"malformed table entry {entry!r}") from e
        if any(d < 0 for d in shape):
            raise WireError(f"negative dim in shape {shape}")
        count = 1
        for d in shape:
            count *= d
        nbytes = count * dtype.itemsize
        if offset + nbytes > payload_len:
            raise WireError(f"tensor spans [{offset}, {offset + nbytes}) "
                            f"outside payload of {payload_len}")
        try:
            arr = np.frombuffer(payload, dtype=dtype, count=count,
                                offset=offset).reshape(shape)
        except ValueError as e:
            raise WireError(f"unreadable tensor {entry!r}: {e}") from e
        if dtype.byteorder == "<" and dtype.itemsize > 1:
            arr = arr.astype(dtype.newbyteorder("="), copy=False)
        if quant is not None:
            scale, dq = quant
            return arr.astype(dq) * np.asarray(scale, dtype=dq), \
                offset + nbytes
        if name == BFLOAT16:
            # A copy: torch will not wrap a read-only buffer.
            return (torch.from_numpy(arr.view(np.int16).copy())
                    .view(torch.bfloat16), offset + nbytes)
        return arr, offset + nbytes

    def read_node(node: Any, offset: int,
                  path: Tuple[str, ...]) -> Tuple[Any, int]:
        if isinstance(node, dict):
            out = {}
            for k, child in node.items():
                out[k], offset = read_node(child, offset, path + (k,))
            return out, offset
        if not isinstance(node, list):
            raise WireError(f"malformed table node {node!r}")
        return read_leaf(node, offset, path)

    tree, consumed = read_node(table, 0, ())
    if consumed != payload_len:
        raise WireError(
            f"payload length {payload_len} != tensor bytes {consumed}")
    return int(version), tree, leaf_versions


def decode(data: Union[bytes, bytearray, memoryview]) -> Tuple[int, Any]:
    """``(snapshot_version, tree)`` of a version-1 frame. Numpy leaves
    are read-only views of ``data``; bfloat16 leaves are
    ``torch.bfloat16`` tensors; int8-quantized leaves come back
    dequantized. Raises :class:`WireError` on anything malformed or
    truncated, and on a delta (v2) frame."""
    version, tree, _ = _decode_impl(data, WIRE_VERSION)
    return version, tree


def decode_delta(data: Union[bytes, bytearray, memoryview]
                 ) -> Tuple[int, Dict[Tuple[str, ...], Any],
                            Dict[Tuple[str, ...], int]]:
    """``(snapshot_version, {path: leaf}, {path: leaf_version})`` of a
    delta (v2) frame, flat by path, ready to merge into a cached tree.
    Leaves decode as :func:`decode`'s do. Raises :class:`WireError` on
    a v1 frame: a full snapshot must never pass for a delta."""
    version, tree, vers = _decode_impl(data, WIRE_VERSION_DELTA)
    return version, dict(flatten_tree(tree)), vers



def tree_nbytes(tree: Any) -> int:
    """Payload bytes a plain (unquantized) encode of ``tree`` ships: a
    tensor leaf counts ``numel * element_size`` (no host copy), any
    other leaf its numpy ``nbytes``."""
    total = 0
    for _, a in flatten_tree(tree):
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        else:
            total += np.asarray(a).nbytes
    return total
