"""Dill-vs-binary wire microbenchmark — the port of
``sparktorch_tpu/net/bench_wire.py`` over the port's ``net/wire.py``.

Builds a transformer-sized state dict (encoder layers + embedding
table, ~tens of MB of f32 — the shape of what the hogwild wire
actually ships), then round-trips it through both wires:

- **dill**: ``dill.dumps`` -> one blob -> ``dill.loads`` (the
  original sparktorch's hogwild wire);
- **binary**: :func:`wire.encode` -> scatter-joined body (the copy a
  socket write performs either way) -> :func:`wire.decode`
  (``np.frombuffer`` views).

Prints one JSON line and EXITS NON-ZERO if the binary wire does not
beat dill on BOTH bytes on the wire and encode+decode wall time —
a CI-style smoke gate for the zero-copy claim. The quantized (bf16)
binary row rides along for scale but is lossy, so it never gates.

CLI: ``python -m sparktorch_tpu_torch.net.bench_wire [--layers N]
[--d-model D] [--vocab V] [--repeats R]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import dill
import numpy as np

from sparktorch_tpu_torch.net import wire


def transformer_state_dict(layers: int = 4, d_model: int = 768,
                           vocab: int = 8192, seed: int = 0) -> dict:
    """A nested state dict with transformer-shaped tensors (qkv/o
    projections, 4x FFN, layernorms, embedding table) — the realistic
    mix of a few big matrices and many small vectors that a wire
    format has to handle well at BOTH ends of the size range."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree: dict = {
        "embed": {"table": w(vocab, d_model)},
        "pos_embed": w(512, d_model),
    }
    for i in range(layers):
        tree[f"layer_{i}"] = {
            "attn": {
                "query": {"kernel": w(d_model, d_model), "bias": w(d_model)},
                "key": {"kernel": w(d_model, d_model), "bias": w(d_model)},
                "value": {"kernel": w(d_model, d_model), "bias": w(d_model)},
                "out": {"kernel": w(d_model, d_model), "bias": w(d_model)},
            },
            "mlp": {
                "up": {"kernel": w(d_model, 4 * d_model),
                       "bias": w(4 * d_model)},
                "down": {"kernel": w(4 * d_model, d_model),
                         "bias": w(d_model)},
            },
            "ln1": {"scale": w(d_model), "bias": w(d_model)},
            "ln2": {"scale": w(d_model), "bias": w(d_model)},
        }
    return tree


def _time_best(fn: Callable[[], object], repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(layers: int = 4, d_model: int = 768, vocab: int = 8192,
        repeats: int = 3) -> Dict[str, object]:
    tree = transformer_state_dict(layers, d_model, vocab)
    payload_mb = wire.tree_nbytes(tree) / 1e6

    # dill roundtrip (version tag shipped like the pull wire does).
    dill_body = dill.dumps((7, tree))
    dill_enc_s = _time_best(lambda: dill.dumps((7, tree)), repeats)
    dill_dec_s = _time_best(lambda: dill.loads(dill_body), repeats)

    # binary roundtrip: encode (headers only — tensor memory is NOT
    # copied) + the one join a non-scatter writer would pay + decode.
    bin_body = wire.frame_bytes(wire.encode(tree, version=7))
    bin_enc_s = _time_best(
        lambda: wire.frame_bytes(wire.encode(tree, version=7)), repeats
    )
    bin_hdr_s = _time_best(lambda: wire.encode(tree, version=7), repeats)
    bin_dec_s = _time_best(lambda: wire.decode(bin_body), repeats)

    # Lossy bf16 row, reported but never gating.
    leaves, _ = wire.quantize_tree(tree, "bf16")
    bf16_body = wire.frame_bytes(wire.encode(leaves, version=7))

    roundtrip_dill = dill_enc_s + dill_dec_s
    roundtrip_bin = bin_enc_s + bin_dec_s
    record: Dict[str, object] = {
        "bench": "wire_micro",
        "state_dict_mb": round(payload_mb, 2),
        "n_tensors": len(wire.flatten_tree(tree)),
        "dill_bytes": len(dill_body),
        "binary_bytes": len(bin_body),
        "binary_bf16_bytes": len(bf16_body),
        "dill_encode_s": round(dill_enc_s, 5),
        "dill_decode_s": round(dill_dec_s, 5),
        "binary_encode_s": round(bin_enc_s, 5),
        "binary_encode_headers_only_s": round(bin_hdr_s, 6),
        "binary_decode_s": round(bin_dec_s, 6),
        "roundtrip_speedup": round(
            roundtrip_dill / max(roundtrip_bin, 1e-12), 2),
        "bytes_saved": len(dill_body) - len(bin_body),
        "ok": (len(bin_body) < len(dill_body)
               and roundtrip_bin < roundtrip_dill),
    }
    return record


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sparktorch_tpu_torch.net.bench_wire")
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--d-model", type=int, default=768)
    parser.add_argument("--vocab", type=int, default=8192)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    record = run(args.layers, args.d_model, args.vocab, args.repeats)
    print(json.dumps(record))
    if not record["ok"]:
        print("bench-wire FAILED: binary wire must beat dill on both "
              "bytes and encode+decode wall time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
