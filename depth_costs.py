#!/usr/bin/env python3
"""What two of ``chip_smoke.py``'s choices cost on the card: the bench's
shorter sync span, and supervising the Spark phase's barrier fit.

    python3 depth_costs.py [--part span|barrier|all]

``span``: each bench config that ``chip_smoke.BENCH_DEPTH`` runs at 2
slope samples (the sync configs and ``resnet18_hogwild``'s sync twin),
at that depth, with ``bench.SYNC_SPAN_S`` at ``chip_smoke.BENCH_SPAN_S``
(0.8 s) and at the bench's own 1.6 s, in the order cut, full, full, cut;
prints each run's wall and the mean seconds the cut saves a config.

``barrier``: the Spark phase's barrier BERT-base fit (one executor
process on the card, ``chip_smoke.spark_bert_fit``'s model, rows, steps
and seed) with ``supervise=False`` and ``supervise=True``, in the order
plain, supervised, supervised, plain; every fit must equal the first bit
for bit and no supervised stage may restart. Prints each fit's wall.

One JSON line of all the walls at the end, after the card's name and
power limit. Builds the kernels from this checkout first.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def span_costs(torch):
    from sparktorch_tpu_torch import bench

    names = [n for n, kw in smoke.BENCH_DEPTH.items() if "repeats" in kw]
    walls = {}
    for name in names:
        walls[name] = {"cut": [], "full": []}
        for leg in ("cut", "full", "full", "cut"):
            bench.SYNC_SPAN_S = (smoke.BENCH_SPAN_S if leg == "cut"
                                 else 1.6)
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rec = bench.CONFIGS[name](**smoke.BENCH_DEPTH[name])
            wall = time.perf_counter() - t0
            walls[name][leg].append(wall)
            print(f"span {name} {leg} ({bench.SYNC_SPAN_S} s): {wall:.2f} s, "
                  f"{rec['examples_per_sec_per_chip']} examples/s/chip",
                  flush=True)
    bench.SYNC_SPAN_S = 1.6
    saved = {n: float(np.mean(w["full"]) - np.mean(w["cut"]))
             for n, w in walls.items()}
    print(f"span: the {smoke.BENCH_SPAN_S} s span saves "
          f"{sum(saved.values()):.2f} s over the configs "
          f"({ {n: round(v, 2) for n, v in saved.items()} })", flush=True)
    return {"walls": walls, "saved_s": saved,
            "saved_total_s": sum(saved.values())}


def barrier_costs(torch):
    spark = smoke.spark_session()  # before the adapter's import

    from sparktorch_tpu_torch.models.transformer import TransformerConfig
    from sparktorch_tpu_torch.obs import get_telemetry
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    payload = smoke.bert_payload(torch, 2)
    x, y = smoke.bert_ids(smoke.BERT_ROWS, 2, TransformerConfig().vocab_size)
    frame = smoke.spark_frame(spark, x, y)
    stage = {"worker": "spark_barrier_stage"}
    walls = {"plain": [], "supervised": []}
    first = None
    for leg in ("plain", "supervised", "supervised", "plain"):
        supervise = leg == "supervised"
        extra = dict(supervise=True, ftMaxRestarts=2) if supervise else {}
        est = SparkTorch(inputCol="features", labelCol="label",
                         torchObj=payload, iters=smoke.BERT_ITERS,
                         deployMode="barrier", partitions=1, device="cuda",
                         **extra)
        restarts0 = get_telemetry().counter_value("ft_restarts_total", stage)
        t0 = time.perf_counter()
        params = est.fit(frame).getPytorchModel()["params"]
        wall = time.perf_counter() - t0
        restarts = get_telemetry().counter_value("ft_restarts_total",
                                                 stage) - restarts0
        walls[leg].append(wall)
        if first is None:
            first = params
        worst = max(float((params[k].float() - v.float()).abs().max())
                    for k, v in first.items())
        print(f"barrier BERT-base fit ({leg}): {wall:.2f} s, {restarts:.0f} "
              f"restarts, largest difference from the first fit "
              f"{worst:.3e}", flush=True)
        if worst != 0.0 or restarts != 0:
            raise AssertionError(f"barrier fit ({leg}): not the first fit "
                                 f"bit for bit, or restarted")
    cost = float(np.mean(walls["supervised"]) - np.mean(walls["plain"]))
    print(f"barrier: supervision costs {cost:.2f} s a fit", flush=True)
    return {"walls": walls, "supervise_cost_s": cost}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("span", "barrier", "all"),
                        default="all")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("depth_costs: no CUDA device", file=sys.stderr)
        return 1
    from sparktorch_tpu_torch.ops import _build

    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(device, flush=True)
    _build.build(_build.kernel_sources())
    out = {"device": device}
    if args.part in ("span", "all"):
        out["span"] = span_costs(torch)
    if args.part in ("barrier", "all"):
        out["barrier"] = barrier_costs(torch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
