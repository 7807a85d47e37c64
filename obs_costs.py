#!/usr/bin/env python3
"""Time the long-context LM's training step through ``train_distributed``: what the trainer's obs and chaos hooks cost a step.

    python3 obs_costs.py [--root DIR] [--steps N] [--repeats R]

Imports the port from ``--root`` (default: this checkout; give an
unpacked older tree to compare, e.g. ``git archive <commit> | tar -x -C
DIR``) and fits the JAX bench's ``long_context_lm`` model (CausalLM,
vocab 32,768, d 512, 8 heads, 4 layers, s = 8,192, batch 2, AdamW 3e-4,
remat, flash attention; seeded weights and ids) on one CUDA device with
the trainer's defaults: the process-global bus, no profiler. For chunks
of 1 step (a read-back and the hooks every step) and of 8 steps, each of
``--repeats`` fits of ``--steps`` steps gives the median of its
``step_time_s`` records past the first chunk. Prints one JSON line with
the card's name and power limit. Compare two trees on one card, back
to back: older, newer, newer, older.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("obs_costs: no CUDA device", file=sys.stderr)
        return 1
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.models.transformer import TransformerConfig
    from sparktorch_tpu_torch.train.sync import train_distributed

    import sparktorch_tpu_torch

    if not sparktorch_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {sparktorch_tpu_torch.__file__}, not "
                           f"the tree under {root}")
    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    seq, batch = 8192, 2
    cfg = TransformerConfig(vocab_size=32768, d_model=512, n_heads=8,
                            n_layers=4, d_ff=2048, max_len=seq, remat=True,
                            attn_impl="flash")
    torch.manual_seed(0)
    payload = serialize_torch_obj(CausalLM(cfg), criterion="cross_entropy",
                                  optimizer="adamw",
                                  optimizer_params={"lr": 3e-4})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (batch, seq + 1))
    x, y = ids[:, :-1].astype(np.float32), ids[:, 1:]
    t0 = time.perf_counter()
    train_distributed(payload, x, labels=y, iters=2, device="cuda")
    warm_s = time.perf_counter() - t0
    step_ms = {}
    for chunk in (1, 8):
        medians = []
        for _ in range(args.repeats):
            result = train_distributed(payload, x, labels=y,
                                       iters=args.steps,
                                       steps_per_call=chunk, device="cuda")
            times = [r["step_time_s"] for r in result.metrics[chunk:]]
            medians.append(round(1e3 * float(np.median(times)), 4))
        step_ms[str(chunk)] = medians
    print(json.dumps({"root": root, "device": device,
                      "torch": torch.__version__, "steps": args.steps,
                      "warm_s": round(warm_s, 2),
                      "median_step_ms_by_chunk": step_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
