"""Binary wire, its HTTP client and the sharded fleet's client — the port of ``sparktorch_tpu/net``."""

from sparktorch_tpu_torch.net.wire import (
    CONTENT_TYPE as WIRE_CONTENT_TYPE,
    QuantLeaf,
    WireError,
    decode,
    decode_delta,
    encode,
    flatten_tree,
    frame_bytes,
    frame_nbytes,
    quantize_tree,
    unflatten_tree,
)
from sparktorch_tpu_torch.net.transport import BinaryTransport, TransportError
from sparktorch_tpu_torch.net.sharded import (
    HashRing,
    HttpFleetView,
    ShardedTransport,
    StaticFleetView,
)

__all__ = [
    "HashRing",
    "HttpFleetView",
    "ShardedTransport",
    "StaticFleetView",
    "WIRE_CONTENT_TYPE",
    "QuantLeaf",
    "WireError",
    "decode",
    "decode_delta",
    "encode",
    "flatten_tree",
    "frame_bytes",
    "frame_nbytes",
    "quantize_tree",
    "unflatten_tree",
    "BinaryTransport",
    "TransportError",
]
