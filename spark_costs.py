#!/usr/bin/env python3
"""Host costs of the Spark tier at BERT-base size: the carrier's save and
load, piece by piece, and the start of a localspark executor process.

    python3 spark_costs.py [--params N]

The carrier holds a fitted ``SparkTorchModel`` whose bundle is a
base64 string of the dill of N f32 parameters (default 109,482,242,
BERT-base's count). The script times, each once and alone, what
``spark/pipeline_util.py`` and the localspark pipeline writer do with
it: the dill of the stage, ``zlib.compress`` on one core beside the
port's block deflate on threads (``_compress``), the decimal rendering,
the JSON write, then the JSON read, the decimal parse, the inflate and
the dill load. It then times a barrier task that does nothing, one that
starts CUDA and one that runs a convolution, each in a fresh executor
process, and ``python -c "import torch"`` for comparison. One line per
piece, then one JSON object of all of them; the card's name and power
limit first. Writes its one temporary file under ``.chip_smoke_tmp/``.
"""

import argparse
import base64
import json
import os
import shutil
import subprocess
import sys
import time
import zlib

import dill
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TIMES = {}


def timed(name, fn):
    t0 = time.perf_counter()
    result = fn()
    TIMES[name] = time.perf_counter() - t0
    print(f"{name:28s} {TIMES[name]:.3f} s", flush=True)
    return result


def idle(rows):
    list(rows)
    yield 0


def cuda_start(rows):
    import torch

    list(rows)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    yield 0


def conv(rows):
    import torch

    list(rows)
    layer = torch.nn.Conv2d(3, 8, 3).cuda()
    layer(torch.zeros(2, 3, 8, 8, device="cuda"))
    torch.cuda.synchronize()
    yield 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--params", type=int, default=109_482_242)
    args = parser.parse_args()
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    print(f"{os.cpu_count()} host cores; zlib {zlib.ZLIB_RUNTIME_VERSION}")

    from sparktorch_tpu_torch.spark import localsession

    localsession.install()
    from sparktorch_tpu_torch.spark import pipeline_util

    params = np.random.default_rng(0).standard_normal(args.params).astype(
        np.float32)
    bundle = base64.b64encode(dill.dumps({"params": params})).decode()
    del params
    pickled = timed("save: dill", lambda: dill.dumps({"modStr": bundle}))
    timed("save: zlib.compress, 1 core", lambda: zlib.compress(pickled))
    packed = timed("save: block deflate", lambda: pipeline_util._compress(
        pickled))
    text = timed("save: decimal text",
                 lambda: pipeline_util._decimal_text(packed))
    print(f"dill {len(pickled) / 2**20:,.1f} MiB, deflated "
          f"{len(packed) / 2**20:,.1f} MiB, text {len(text) / 2**20:,.1f} MiB")
    del pickled, packed
    os.makedirs(os.path.join(ROOT, ".chip_smoke_tmp"), exist_ok=True)
    path = os.path.join(ROOT, ".chip_smoke_tmp", "carrier_metadata.json")

    def dump():
        with open(path, "w") as f:
            json.dump({"stages": [{"paramMap": {"stopWords": [
                text, pipeline_util.CARRIER_GUID]}}]}, f)

    timed("save: json.dump", dump)
    del text

    def load():
        with open(path) as f:
            return json.load(f)

    meta = timed("load: json.load", load)
    os.remove(path)
    words = meta["stages"][0]["paramMap"]["stopWords"]
    del meta
    packed = timed("load: decimal parse",
                   lambda: pipeline_util._decimal_bytes(words[0]))
    del words
    pickled = timed("load: zlib.decompress", lambda: zlib.decompress(packed))
    stage = timed("load: dill", lambda: dill.loads(pickled))
    timed("transform: base64 decode",
          lambda: base64.b64decode(stage["modStr"]))
    del stage, pickled, packed

    import torch

    spark = localsession.SparkSession.builder.master("local[1]").getOrCreate()
    frame = spark.createDataFrame([(1.0,)], ["x"])
    tasks = [("executor: nothing", idle)]
    if torch.cuda.is_available():
        tasks += [("executor: CUDA start", cuda_start),
                  ("executor: a convolution", conv)]
    for name, fn in tasks:
        timed(name, lambda: frame.rdd.barrier().mapPartitions(fn).collect())
    spark.stop()
    timed("python -c 'import torch'", lambda: subprocess.run(
        [sys.executable, "-c", "import torch"], check=True))
    print(json.dumps({k: round(v, 4) for k, v in TIMES.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
