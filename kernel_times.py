#!/usr/bin/env python3
"""Device time against call time of the bf16 flash kernels at short
sequences, where a call's host work can outlast its kernel, and of the
BERT-base training step that launches them at s = 128.

    python3 kernel_times.py [--root DIR]

Imports ``sparktorch_tpu_torch`` from DIR (default: this script's
checkout), so the same script times another tree's kernels, such as an
unpacked parent commit; run trees alternately in one machine session to
compare them. For each case it prints one JSON line:

- ``device_ms``: the kernel's own time, the sum of the flash kernels'
  device durations in a torch.profiler trace of N = 50 calls, over N;
- ``call_ms``: CUDA events around N back-to-back calls, over N (what
  ``chip_smoke.py`` reports as ``ms``);
- ``host_ms``: the host's wall time of one call (the wrapper, its checks
  and the launch, which is asynchronous), the mean over N calls.

``call_ms`` well above ``device_ms`` means the host sets the pace. The
"BERT training step" case is one ``train_step`` of ``bert_base`` (flash
attention, Adam, 128 rows of 128 seeded ids, as ``chip_smoke.py`` fits
it); its ``device_ms`` sums every kernel of the step, not only the
flash ones. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ITERS = 50  # calls timed per case, each way

# (label, kernel, b, s, h, d, causal, q/k/v as views of one qkv); the
# causal forwards also write lse, as in chip_smoke.py.
CASES = [
    ("head_dim 32 causal", "fwd", 4, 256, 8, 32, True, False),
    ("tile edge s=129 causal", "fwd", 4, 129, 8, 64, True, True),
    ("serving chunk", "fwd", 1024, 128, 12, 64, False, True),
    ("BERT training forward", "fwd", 128, 128, 12, 64, False, True),
    ("BERT training dq", "dq", 128, 128, 12, 64, False, True),
    ("BERT training dk/dv", "dkv", 128, 128, 12, 64, False, True),
    ("BERT training step", "step", 128, 128, 12, 64, False, True),
]


def flash_call(torch, gen, kind, b, s, h, d, causal, fused):
    """One call of a flash kernel on seeded bf16 inputs; the causal
    forwards also write lse, as in chip_smoke.py."""
    from sparktorch_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    if fused:
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
    if kind == "fwd":
        return lambda: flash_attention(q, k, v, causal, return_lse=causal)
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    args = (q, k, v, do, lse, _delta(o, do), causal)
    kernel = flash_bwd_dq if kind == "dq" else flash_bwd_dkv
    return lambda: kernel(*args)


def bert_step(torch):
    """One BERT-base training step on 128 rows of 128 seeded ids."""
    from sparktorch_tpu_torch import deserialize_model, serialize_torch_obj
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch

    torch.manual_seed(2)
    spec = deserialize_model(serialize_torch_obj(
        bert_base(attn_impl="flash"), criterion="cross_entropy",
        optimizer="adam", optimizer_params={"lr": 2e-5}))
    module = spec.make_module().cuda().train()
    opt = spec.make_optimizer(module.parameters())
    loss_fn = spec.loss_fn()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, module.config.vocab_size, (128, 128))
    batch = DataBatch(torch.from_numpy(ids.astype(np.float32)),
                      torch.from_numpy(rng.integers(0, 2, 128)),
                      torch.ones(128)).to("cuda")
    return lambda: train_step(module, loss_fn, opt, batch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import sparktorch_tpu_torch from")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, args.root)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, kind, b, s, h, d, causal, fused in CASES:
        call = (bert_step(torch) if kind == "step" else
                flash_call(torch, gen, kind, b, s, h, d, causal, fused))
        with torch.set_grad_enabled(kind == "step"):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            host = 0.0
            start.record()
            for _ in range(ITERS):
                t0 = time.perf_counter()
                call()
                host += time.perf_counter() - t0
            end.record()
            end.synchronize()
            call_ms = start.elapsed_time(end) / ITERS
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    call()
                torch.cuda.synchronize()
        device_us = sum(
            e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (kind == "step" or "flash_" in e.name))
        print(json.dumps({
            "root": args.root or ".", "case": label, "kind": kind, "b": b,
            "s": s, "h": h, "d": d, "causal": causal,
            "device_ms": device_us / 1e3 / ITERS if device_us else None,
            "call_ms": call_ms, "host_ms": host * 1e3 / ITERS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
