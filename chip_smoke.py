#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it computes.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (the script exits nonzero on the first
failure, and at once when no CUDA device is present — it never runs
the CPU path):

1. device: the card's name and power limit, as ``nvidia-smi`` gives them;
2. build: every kernel under ``sparktorch_tpu_torch/ops/csrc`` built with
   ``nvcc`` from the checkout's sources, all sources at once;
3. kernels: each kernel against its plain PyTorch version on the same
   seeded inputs, at the serving path's shapes and a few more, with
   its time beside the plain version's, the library call's (SDPA) and
   the bound (the least time the card could take);
4. slice: full-width BERT-base (``bert_base(attn_impl="flash")``, seeded
   random weights) packaged with ``serialize_torch_obj`` and served by
   ``create_spark_torch_model(...).transform`` over 2,000 rows of 128
   token ids (one full 1024-row chunk and one padded chunk). The
   kernel must be launched 12 layers × 2 chunks = 24 times, and the
   logits must agree with the dense-attention path on the same weights;
   then 256 rows at the model's max_len of 512. One more served pass
   runs under torch.profiler for the device time by kernel family.

The second-to-last line is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (dense, no sparsity) at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version: bf16 rounds P before P·V in both, but sums in
# another order; f32 differs only by summation order.
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
LSE_TOL = {"bfloat16": (1e-3, 1e-3), "float32": (1e-4, 1e-4)}

SLICE_ROWS, SLICE_SEQ, CHUNK = 2000, 128, 1024


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, s, h, d, causal, dtype, with_lse, itemsize):
    """Least time (ms) for one attention forward on an H100, and which
    of bytes or operations sets it: QKᵀ and PV at 2 FLOPs per MAC over
    the (query, key) pairs the mask keeps; q, k, v read and o (and lse)
    written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * s * h * d * itemsize + (4 * b * h * s if with_lse else 0)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance "
            f"(atol {atol}, rtol {rtol}); max abs err {float(err.max()):.3e}")
    return float(err.max())


def kernel_phase(torch):
    import torch.nn.functional as F

    from sparktorch_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    # (label, b, s, h, d, causal, dtype, return_lse, q/k/v as views of one qkv)
    cases = [
        ("serving chunk", CHUNK, SLICE_SEQ, 12, 64, False, bf16, False, True),
        ("slice b=8", 8, 128, 12, 64, False, bf16, False, False),
        ("max_len pass", 256, 512, 12, 64, False, bf16, False, True),
        ("long causal lse", 2, 2048, 16, 128, True, bf16, True, False),
        ("ragged causal", 4, 1000, 12, 64, True, bf16, False, False),
        ("head_dim 32 causal", 4, 256, 8, 32, True, bf16, True, False),
        ("f32", 4, 512, 8, 64, False, f32, True, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for label, b, s, h, d, causal, dtype, with_lse, fused in cases:
        if fused:
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                              dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda", dtype=dtype)
                       for _ in range(3))
        dname = str(dtype).split(".")[-1]
        with torch.inference_mode():
            got = flash_attention(q, k, v, causal, return_lse=with_lse)
            want = flash_attention_reference(q, k, v, causal,
                                             return_lse=with_lse)
            torch.cuda.synchronize()
            if with_lse:
                (got, lse), (want, want_lse) = got, want
                lse_err = check_close(f"{label} lse", lse, want_lse,
                                      *LSE_TOL[dname])
            err = check_close(f"{label} o", got, want, *TOL[dname])
            del got, want
            big = b * s * s * h > 2 ** 30
            ms = time_ms(torch, lambda: flash_attention(
                q, k, v, causal, return_lse=with_lse), 20)
            plain_ms = time_ms(torch, lambda: flash_attention_reference(
                q, k, v, causal, return_lse=with_lse), 3 if big else 10)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 20)
        bound_ms, bound_by = attention_bound(b, s, h, d, causal, dname,
                                             with_lse, q.element_size())
        row = dict(label=label, b=b, s=s, h=h, d=d, causal=causal,
                   dtype=dname, return_lse=with_lse, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if with_lse:
            row["lse_max_abs_err"] = lse_err
        results.append(row)
        log(f"kernel flash_fwd [{label}] b={b} s={s} h={h} d={d} {dname} "
            f"causal={causal} lse={with_lse}: max_abs_err={err:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}; roofline share "
            f"{100 * bound_ms / ms:.1f}%)")
        del q, k, v
        torch.cuda.empty_cache()
    return results


def profile_pass(torch, stm, frame):
    """Device time by kernel family over one served pass, from a
    torch.profiler trace (its wall is inflated by the profiler, so it
    is not the throughput). Prints "not measured" if the trace holds
    no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stm.transform(frame)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_family, other = [], {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        name = evt.name.lower()
        family = ("flash_fwd" if "flash_fwd" in name else
                  "memcpy" if "memcpy" in name else
                  "gemm" if any(k in name for k in ("gemm", "cutlass", "xmma",
                                                    "nvjet", "cublas"))
                  else "other")
        by_family[family] = by_family.get(family, 0.0) + (end - start)
        if family == "other":
            other[evt.name] = other.get(evt.name, 0.0) + (end - start)
    if not spans:
        log("profile: no device events in the trace; not measured")
        return
    spans.sort()
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    total = sum(by_family.values())
    shares = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)"
                       for k, v in sorted(by_family.items(),
                                          key=lambda kv: -kv[1]))
    log(f"profile [one served pass, {len(spans)} device events]: {shares}; "
        f"device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
        f"({100 * (1 - busy / wall_us):.1f}% idle, profiler on)")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  other: {us / 1e3:.2f} ms {name[:110]}")


def slice_phase(torch):
    from sparktorch_tpu_torch import (
        BatchPredictor,
        create_spark_torch_model,
        deserialize_model,
        serialize_torch_obj,
    )
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.ops.flash_attention import flash_attention

    torch.manual_seed(0)
    t0 = time.perf_counter()
    payload = serialize_torch_obj(bert_base(attn_impl="flash"),
                                  criterion="cross_entropy", optimizer="adam",
                                  optimizer_params={"lr": 2e-5},
                                  input_shape=(SLICE_SEQ,))
    module = deserialize_model(payload).make_module()
    cfg = module.config
    stm = create_spark_torch_model(module, inputCol="features",
                                   predictionCol="predicted").setDevice("cuda")
    log(f"slice: bert_base d_model={cfg.d_model} heads={cfg.n_heads} "
        f"layers={cfg.n_layers} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{cfg.dtype} attn_impl={cfg.attn_impl}; packaged in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size,
                       size=(SLICE_ROWS, SLICE_SEQ)).astype(np.float32)
    frame = {"features": ids}
    stm.transform({"features": ids[:CHUNK]})  # weights to the card, warm-up
    torch.cuda.synchronize()

    flash_attention.launches = 0
    t0 = time.perf_counter()
    preds = stm.transform(frame)["predicted"]
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    expected = cfg.n_layers * -(-SLICE_ROWS // CHUNK)
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"the served pass, expected {expected}")
    log(f"slice: transform {SLICE_ROWS} rows x {SLICE_SEQ} ids in "
        f"{wall:.3f} s = {SLICE_ROWS / wall:.1f} rows/s; flash launches "
        f"{launches}")
    profile_pass(torch, stm, frame)

    dense = bert_base(attn_impl="dense")
    dense.load_state_dict(stm.getModel().module.state_dict())
    dense_pred = BatchPredictor(dense, device="cuda", chunk=CHUNK)

    def compare(name, x, flash_preds=None):
        got = np.stack(stm.transform({"features": x},
                                     {"useVectorOut": True})["predicted"])
        want = dense_pred.predict(x)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: logits {got.shape}, finite="
                                 f"{np.isfinite(got).all()}")
        diff = float(np.abs(got - want).max())
        limit = 5e-2 * max(1.0, float(np.abs(want).max()))
        margin = np.abs(want[:, 0] - want[:, 1]) > 1e-2
        agree = float((got.argmax(1) == want.argmax(1))[margin].mean()) \
            if margin.any() else 1.0
        log(f"slice [{name}]: flash vs dense max abs diff {diff:.3e} "
            f"(limit {limit:.3e}); argmax agreement {100 * agree:.2f}% over "
            f"{int(margin.sum())} rows with margin > 1e-2")
        if diff > limit or agree < 0.99:
            raise AssertionError(f"{name}: flash path disagrees with dense")
        if flash_preds is not None and not np.array_equal(
                flash_preds, got.argmax(1).astype(np.float64)):
            raise AssertionError(f"{name}: argmax column != vector argmax")

    compare(f"{SLICE_ROWS} x {SLICE_SEQ}", ids, preds)

    ids512 = rng.integers(0, cfg.vocab_size,
                          size=(256, cfg.max_len)).astype(np.float32)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    preds512 = stm.transform({"features": ids512})["predicted"]
    wall512 = time.perf_counter() - t0
    if flash_attention.launches != cfg.n_layers or preds512.shape != (256,):
        raise AssertionError(f"max_len pass: {flash_attention.launches} "
                             f"launches, predictions {preds512.shape}")
    log(f"slice: transform 256 rows x {cfg.max_len} ids in {wall512:.3f} s "
        f"= {256 / wall512:.1f} rows/s; flash launches {cfg.n_layers}")
    compare(f"256 x {cfg.max_len}", ids512, preds512)
    return launches, SLICE_ROWS / wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is checked on a GPU only",
              file=sys.stderr)
        return 1
    from sparktorch_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    names = _build.kernel_sources()
    logs = _build.build(names)
    log(f"build: {names} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cases = kernel_phase(torch)
    launches, rows_per_s = slice_phase(torch)
    main_case = cases[0]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "sparktorch_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "sparktorch_tpu/ops/flash_attention.py:155",
        "launches": launches,
        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        "cases": cases,
    }]
    log(json.dumps({"kernels": kernels, "slice_rows_per_s": rows_per_s}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
