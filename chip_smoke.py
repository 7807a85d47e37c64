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
   seeded inputs, at the shapes its paths give it (the forward also at
   the serving tier's buckets of 1, 8 and 32 rows) and a few more, with
   its time beside the plain version's, the library call's and the
   bound (the least time the card could take): the flash forward
   (library: SDPA), the flash backward's dq and dk/dv kernels (library:
   SDPA's backward alone) and the fused cross-entropy forward and
   backward (library: ``F.cross_entropy`` and its backward);
4. serve: full-width BERT-base (``bert_base(attn_impl="flash")``, seeded
   random weights) packaged with ``serialize_torch_obj`` and served by
   ``create_spark_torch_model(...).transform`` over 2,000 rows of 128
   token ids (one full 1024-row chunk and one padded chunk). The
   forward kernel must be launched 12 layers × 2 chunks = 24 times, and
   the logits must agree with the dense-attention path on the same
   weights; then 256 rows at the model's max_len of 512. One more served
   pass runs under torch.profiler for the device time by kernel family;
5. train LM: the JAX package's long-context LM training config
   (``bench_long_context_lm``: CausalLM, vocab 32768, d_model 512, 8
   heads, 4 layers, d_ff 2048, s = 8192, flash attention, remat, AdamW
   lr 3e-4) at full width and depth, fitted by ``SparkTorch(...).fit``
   for 6 steps on 2 rows of 8,192 seeded ids with next-token labels. Per
   step: 2·4 forward launches (remat recomputes each layer), 4 dq, 4
   dk/dv, 1 CE forward and 1 CE backward; every loss finite and the last
   below the first; its step time is taken with the obs hooks on (the
   process bus) and no profiler. One step runs under torch.profiler.
   Then the obs and chaos hooks on that LM through ``train_distributed``:
   (a) TRACE_STEPS steps with a fresh ``Telemetry`` and a
   ``profile_dir``: the Chrome trace's ``train_step`` ranges number
   ``tracing.annotated_steps``, the five kernels launch 8/4/4/1/1 a step
   inside them and never outside, ``train.steps`` and ``train.examples``
   match the records; (b) the same fit without the profiler, its losses
   within 1e-6·max|loss| of (a)'s; (c) a seeded ``worker.step`` kill at
   step 2 raises ``ChaosKill`` after two steps;
6. train parity: one step of that LM at s = 2048 with flash attention and
   the fused CE against the same weights with dense attention and the
   dense CE: loss within 1e-2 (relative), grad norm within 1e-2, and a
   gradient cosine above 0.99 for every parameter;
7. bench: the configs of ``sparktorch_tpu_torch.bench.CONFIGS`` but
   ``serve_online``, ``hogwild_ps_fleet``, ``rpc_trace`` and the other
   obs configs but ``skew`` (OBS_CONFIGS: CPU tests only) (the port's
   benchmark entry: BASELINE configs 1–5,
   the MNIST-CNN headline, ``hogwild_wire``, the long-context LM, the
   MoE LM, ``hogwild_chaos``, ``hogwild_chaos_soak``, ``skew`` and
   ``sharded_trace`` (in a world of one), whose JAX gates raise inside
   them; those of BENCH_DEPTH at a cut depth; ``hogwild_wire`` at the
   JAX depth through the CLI's ``main`` with ``--telemetry-dump``, whose
   dump must hold the ``bench/*`` spans), each record printed on its own
   line and held to the JAX config's record keys less the documented
   omissions, with
   8/4/4/1/1 launches per LM step (the dense 2k leg: the CE kernels
   only), 12/12/12/0/0 per BERT-base step, 0/0/0/1/1 per step of either
   ``moe_lm`` leg and none elsewhere;
   moe: (a) a tiny f32 MoE LM at top-1 and top-2 on the card against
   the same weights on the CPU — routing equal, logits within
   1e-4·max(1, max|logit|), one step's loss within 1e-5 — and the expert
   Function's gradients within 1e-5 of autograd through the plain
   einsums; the MoE layer's pieces timed at ``moe_lm``'s shape; (b) the
   ``moe_lm`` model at full width through ``SparkTorch.fit``, 8 steps:
   the loss finite and falling, ``moe_drop_fraction`` in [0, 1], 1 CE
   forward and backward a step and no flash launch, one step under
   torch.profiler; (c) ``bert_base(n_experts=8, moe_every=2,
   attn_impl="flash")`` serving 2,000 × 128 ids through ``transform``,
   12 forward launches a chunk, 64 rows within 5e-2·max(1, max|logit|)
   of the dense-attention twin; (d) Adafactor, Lamb, Lion and centered
   RMSprop, 3 MnistMLP steps each, card within 1e-5 of the CPU;
   train BERT: ``bert_base(attn_impl="flash")``, Adam lr 2e-5, 128 rows of
   128 ids with 2 classes, 4 steps through ``SparkTorch.fit`` and
   ``transform``: 12 forward, 12 dq and 12 dk/dv launches per step and
   no CE kernel (2-D logits take the dense loss); its step time is the
   bench's ``bert_dp`` record;
8. quick start: README.md's quick start as written (MnistMLP, 4,096 rows,
   ``Pipeline.fit`` and ``transform``), then the lazily packaged MnistCNN
   (BASELINE config 2) for 8 steps;
9. train LM streaming: the LM of phase 5 through
   ``train_distributed_streaming``: 16 host sequences in 4-row chunks,
   2-row minibatch steps (2 a chunk), 2 epochs, a snapshot every 4 steps,
   then a resume of 1 epoch: phase 5's launches per step times the
   steps, every loss finite, the second epoch's mean below the first's,
   the latest snapshot at the steps run; the snapshot's size and its
   save and restore seconds; one chunk boundary under torch.profiler,
   where the next chunk's host→device copy must run on a stream other
   than the kernels' and overlap them;
10. train LM resume: ``SparkTorch(checkpointDir=..., checkpointEvery=3)``
   fits of the LM, 6 steps straight against 3 + ``resume=True`` + 3:
   parameters within 1e-6 × max|param|, exact launch counts;
11. hogwild: ResNet-18 on CIFAR-10 shapes (BASELINE config 3) through the
   parameter server — (a) ``train_async``, local, 1 worker (its rate is
   the bench's ``resnet18_hogwild`` record); (b)
   ``SparkTorch(mode="hogwild", partitions=4).fit`` and ``transform``; (c)
   binary HTTP with bf16 pushes, 2 workers, on a run-scoped bus whose
   ``GET /metrics`` scrape must equal its JSONL dump, with
   ``param_server.applies`` equal to the workers' ``hogwild.pushes`` —
   and (d) ``train_distributed`` at the same minibatch; every loss
   finite, applies equal to pushes, the loss falling in (a), (b) and (d);
   one iteration of (a) under torch.profiler;
12. serve ResNet-50: ``resnet50()`` at 224×224×3 served over 2,048 rows,
   the first chunk's bf16 logits against the module in f32;
13. serve ResNet-50 stream (BASELINE config 5): 8,192 seeded uint8 rows
   written with ``write_rows_parquet`` and streamed by
   ``stream_parquet_predict`` in 1,024-row chunks, normalised and
   argmaxed on the card, with ``device_outputs`` off and on; argmaxes
   against the f32-input host path on ≥ 99.9% of rows; the
   device-resident rate; one chunk's pinning and upload times; an
   ``update_params`` swap that changes the predictions;
14. DP: MnistMLP, 1,024 rows, full batch, 5 steps through
   ``train_distributed(mesh=build_mesh())`` — (i) a world of one under
   NCCL (a TCP store on 127.0.0.1), whose Adam fit must equal the fit
   without a process group bit for bit, with the NCCL calls and kernels
   of a traced fit; (ii) two processes on the card under gloo with CUDA
   tensors, each rank's SGD parameters within 1e-5 × max|param| of the
   world of one's (a correctness check: gloo stages through the host);
   then the sharded trainer (``train/sharded.py``) through its tp-aware
   path: the LM of phase 5 at full width, 6 steps of
   ``create_sharded_state`` -> ``make_sharded_train_step`` on an NCCL
   world of one with ``MeshConfig(tp=1)`` (the 3-D (dp, fsdp, tp) mesh;
   the token embedding an FSDP2 DTensor shard of a one-rank fsdp axis,
   every other leaf replicated), its losses bitwise
   equal to phase 5's ``train_distributed`` losses, phase 5's launches
   per step, and one profiled step whose ``train_step`` range holds one
   step's launches; its step time printed beside phase 5's; then the tp
   = 2 pair: two processes on the card under gloo with CUDA tensors
   (NCCL refuses two ranks on one device; gloo stages through the host,
   so a correctness check only), ``MeshConfig(tp=2)``, the same LM split
   over tp (4 heads a rank), SHARDED_TP_STEPS SGD steps at
   SHARDED_TP_SEQ, each peer's losses and gathered parameters against
   the world of one's from the same weights (TP_LOSS_RTOL,
   TP_UPDATE_RTOL), 8/4/4/1/1 launches a step on each peer;
15. spark: BASELINE config 4's topology through the port's localspark
   runtime (``sparktorch_tpu_torch.spark``, executors as processes): (a)
   BERT-base fitted by ``SparkTorch(deployMode="barrier", partitions=1,
   supervise=True)`` in an executor on the card (128 × 128 ids, Adam
   2e-5, 4 steps; the stage under ``ft.supervise_run``, no restart), its
   parameters equal to the in-process fit's bit for bit, and one
   executor BERT step shipped through ``rdd.barrier().mapPartitions``
   launching 12/12/12/0/0 with no jax imported there; (b) 2,000 rows
   through the pandas UDF, 12 forward launches a UDF batch, argmaxes
   equal to the estimator's on the same batches; (c) config 2's lazy
   MnistCNN through the barrier path, its loss falling; (d) config 3's
   ResNet-18 hogwild on two executor processes against the driver's
   server (binary wire, bf16 pushes, 64 iterations each): applies ==
   pushes, the loss falling; (e) a Pipeline holding (a)'s model saved and
   loaded through the carrier, its predictions (b)'s bit for bit; (f)
   ``setMesh`` on a world-of-one mesh bit for bit. Without pandas, (b),
   (e) and (f) print that they are skipped;
16. serve_online: the online serving tier — (a) the bench's
   ``serve_online`` (``bench.CONFIGS``, the JAX depth: 300 Poisson
   requests a leg, legs twice, the replica kill, the weight push) with
   every gate holding, its drift ``no_prior_record``; (b) BERT-base
   (flash, bf16 compute, seeded) behind ``InferenceTier(n_replicas=2)``
   with buckets (1, 8, 32): 300 open-loop single-row requests of 128
   ids at twice the serial capacity of ``BatchPredictor``, the same
   schedule for the serial leg, every request completed, rows within
   5e-2·max(1, max|logit|) of dense attention and 2e-2·max(1,
   max|logit|) of ``BatchPredictor.predict``, 12 forward launches a
   batch exactly, one batch of each bucket under torch.profiler; (c) a
   weight push from a ``ParameterServer`` over ``ParamServerHttp`` to
   both replicas' ``WeightPuller``s (poll 0.05 s) under a background
   load: staleness within 20 polls + 1 s, each replica at the server's
   version and serving its newest weights within 2e-2·max(1,
   max|logit|), the swaps' ``install_params`` seconds printed;
17. fleet: the sharded parameter-server fleet — (a) the bench's
   ``hogwild_ps_fleet`` (the 66 MB MLP, 4 shards, 6 pullers, quota 10,
   single and fleet legs interleaved ×2 — the JAX bench's ×3 cut by
   BENCH_DEPTH — and an int8 leg, the seeded shard kill in
   ``train_async(shards=4)``) with every
   JAX gate holding and its record keys; (b) BERT-base (flash) behind an
   ``InferenceTier`` of 2 replicas whose ``WeightPuller``s read a 4-shard
   ``ParamServerFleet`` on the card through
   ``ShardedTransport(pull_quant="int8")``: a dense push of ones on every
   leaf, then a sparse one on the last encoder layer and the classifier,
   each replica's staleness within 20 polls + 1 s (serve_online (c)'s
   bound) and its int8 delta bytes beside one f32 full pull's, every
   leaf each replica installed within one int8 step of the fleet's
   (peak|x| / 126.5: the error feedback's bound), 64 served rows after
   each install within 5e-2·max(1, max|logit|) of dense attention on
   the installed weights, 12 forward launches a batch; (c) ``train_async(transport="http", shards=4,
   pull_quant="int8")`` of BERT-base, 2 workers × 2 steps of 8 rows:
   records exact, applies equal to the pushed partials less the dropped
   ones, losses finite, 12/12/12 launches a step; (d) one worker of a
   2-layer encoder at BERT-base width, 3 steps, float32 pulls, on 4
   shards against the single server: parameters within 1e-6·max|param|;
   rpc, a leg of (b) on its module and fleet, every request sampled:
   (a) 32 traced single-row requests through a fresh 2-replica
   ``InferenceTier``: 32 trees ``infer`` → ``replica`` →
   {``queue_wait``, ``execute``}, each root's wall at least its slowest
   child's, 12 ``flash_fwd`` launches a batch the trace shows, the rows
   equal to an untraced rerun's bit for bit and within 5e-2·max(1,
   max|logit|) of dense attention; (b) traced int8 delta pulls of the
   fleet's leaves through a ``ShardedTransport`` — the first sync, a
   dense push's pull, whose hops' ``shard_pull``, ``serve`` and
   ``render`` seconds are (d), and a pull with shard 2 slowed 1.0 s —
   each one tree of 4 ``shard_pull`` → ``serve`` → ``render`` hops, the
   slowed shard the critical path in ``FleetCollector.rpc_traces()`` and
   in ``timeline --rpc`` from the collector's JSONL sink; (c) the
   bench's ``rpc_trace`` at the JAX depth, every gate holding;
18. supervise: the ft supervisor and ``ctl/`` on the LM of phase 5 at
   s = 2,048 (no remat) on 2 rows — (a) ``train_async(supervise=True,
   ft_policy=...)`` over local transport, 8 steps clean and under
   ``kill_worker_at={0: 3}``: one restart, the clean run's record count,
   ``ft_recovery_latency_s`` ≤ 10 s, the loss finite and falling, 4/4/4/1/1
   launches of every step either run computed (the killed attempt's 3
   too); (b) this process serving the LM from ``ParameterServer`` +
   ``ParamServerHttp`` while a ``ctl.spawn_worker(kind="hogwild_worker")``
   child trains it on the card for 4 steps under a ``Supervisor``, and
   ``kill_process_at={0: 2}`` SIGKILLs the first child: one restart, the
   rerun's first pull at the current version, the server's applies equal
   to the killed child's pushes plus the rerun's, exit codes -9 and 0,
   with the kill → relaunch latency, each child's start and the rerun's
   push times; (c) is phase 15 (a): the barrier fit under
   ``supervise=True``;
19. lint and wire: the port's sparklint CLI (``python -m
   sparktorch_tpu_torch.lint sparktorch_tpu_torch/ --json``, its
   ``main`` in this process) clean (exit 0, no finding, more than 80
   files) on the card machine's Python; then ``bench_wire``'s CLI
   (``python -m sparktorch_tpu_torch.net.bench_wire``) at its defaults
   (4 layers, d_model 768, vocab 8,192), exit 0 (the binary wire beats
   dill on bytes and on encode+decode wall time), its row printed.

No kernel of KERNELS lies on phases 8, 11–14, 19, on 15 (c), (d), on 16
(a), on 17 (a), on 17's rpc (b) and (c), on the bench's chaos configs, in this process during
18 (b) and on the moe phase's (d): each expects 0 launches. Phase 15 runs after every kernel is built, so its
executor processes load the built kernels.
The total wall time prints before the last two lines.
Snapshots, the Parquet file and traces go to ``.chip_smoke_tmp/`` beside
the script and are deleted at the end.

The second-to-last line is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# The H100's peaks and the kernels' bounds live in the package, one
# source for this script and the bench's roofline fields.
from sparktorch_tpu_torch.ops.roofline import (
    attention_bound,
    ce_bound,
    flash_bwd_bound,
)

# Kernel vs plain version: bf16 rounds P before P·V in both, but sums in
# another order; f32 differs only by summation order.
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
LSE_TOL = {"bfloat16": (1e-3, 1e-3), "float32": (1e-4, 1e-4)}
# Flash kernels vs plain (forward O beside TOL, and every backward
# output): relative L2 error of every 64-row tile of each (batch, head),
# each against its own reference, so the small values of late causal rows
# are held as closely as the first. bf16 outputs round at 2^-9 of their
# size, so 1e-2 is a few ulps; f32 differs by summation order only.
TILE_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# CE backward vs plain on the same lse, every entry relative to itself:
# a bf16 entry may round one ulp (2^-8) the other way; f32 differs by
# expf's few ulps.
CE_GRAD_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}

# Threads and dynamic shared memory (bytes) a block of each bf16 flash
# kernel, as its source sets them (flash_fwd.cu ``fwd::Config``,
# flash_bwd.cu ``dq::Config`` and ``dkv::Config``); ptxas reports static
# shared memory only.
LAUNCH = {
    "flash_fwd_bf16_kernel<32>": (288, 25664),
    "flash_fwd_bf16_kernel<64>": (288, 50240),
    "flash_fwd_bf16_kernel<128>": (384, 99392),
    "flash_bwd_dq_bf16_kernel<32>": (416, 42040),
    "flash_bwd_dq_bf16_kernel<64>": (416, 83000),
    "flash_bwd_dq_bf16_kernel<128>": (288, 132152),
    "flash_bwd_dkv_bf16_kernel<32>": (384, 35880),
    "flash_bwd_dkv_bf16_kernel<64>": (384, 68648),
    "flash_bwd_dkv_bf16_kernel<128>": (384, 134184),
}

SLICE_ROWS, SLICE_SEQ, CHUNK = 2000, 128, 1024
# The traced LM fit (train_lm_obs_phase): steps under torch.profiler, one
# a chunk, so each step is one train_step range.
TRACE_STEPS = 3

# The health phase: phase 5's LM (its payload) on HEALTH_ROWS rows of
# HEALTH_SEQ ids; the drill poisons the batch at step HEALTH_POISON of
# HEALTH_ITERS; the lane-on/off timing runs HEALTH_TIMING_ITERS steps a
# fit, the first HEALTH_WARM of them left out of the medians.
HEALTH_ROWS, HEALTH_SEQ, HEALTH_ITERS, HEALTH_POISON = 8, 2048, 8, 4
HEALTH_TIMING_ITERS, HEALTH_WARM = 16, 4

# The JAX package's bench_long_context_lm (sparktorch_tpu/bench.py).
LM = dict(vocab_size=32768, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
          remat=True)
LM_BATCH, LM_SEQ, LM_ITERS, PARITY_SEQ = 2, 8192, 6, 2048
BERT_ROWS, BERT_SEQ, BERT_ITERS = 128, 128, 4

# README.md's quick start as written, then BASELINE config 2 (the lazy
# MnistCNN of bench_lazy_cnn_sync: 1,024 rows, Adam 1e-3, full batch).
QUICK_ROWS, QUICK_ITERS, QUICK_MB = 4096, 50, 256
CNN_ROWS, CNN_ITERS = 1024, 8
# BASELINE config 3 (bench_resnet18_hogwild): ResNet-18 on CIFAR-10
# shapes, SGD 1e-2, minibatch 256, push_every 4. Iterations per worker
# of each leg: (a) local, 1 worker (its rate is the bench's record, at
# the JAX bench's 1,024); (b) the estimator, 4 workers, HW_EST_REPEATS
# times (the median is reported); (c) binary HTTP wire, bf16 pushes, 2
# workers; (d) sync steps. Before the spark phase joined the script,
# (a) and (d) ran 512, (b) 256 three times and (c) 128.
HW_ROWS, HW_MB, HW_PUSH = 2048, 256, 4
HW_ITERS = dict(local=256, estimator=128, http=64, sync=256)
HW_EST_REPEATS = 1
# The DP checks: MnistMLP (BASELINE config 1's model and batch), full
# batch, DP_STEPS steps; a rank's results must arrive within DP_JOIN_S.
DP_ROWS, DP_STEPS, DP_JOIN_S = 1024, 5, 300
# BASELINE config 5's model: ResNet-50 (1000 classes, 224x224x3, 7x7
# stem), served over 2,048 flat rows in 1,024-row chunks.
R50_ROWS, R50_HW = 2048, (224, 224, 3)
# The streaming LM: 16 host sequences of the LM above in 4-row chunks,
# 2-row minibatch steps (2 a chunk), 2 epochs, a snapshot every 4 steps,
# then a resume of 1 epoch. The checkpoint/resume check: SparkTorch.fit
# of 6 steps straight against 3 + resume + 3, a snapshot every 3.
STREAM_ROWS, STREAM_CHUNK, STREAM_MB, STREAM_EPOCHS = 16, 4, 2, 2
STREAM_EVERY, RESUME_ITERS, RESUME_EVERY = 4, 6, 3
# BASELINE config 5's stream: 8,192 seeded uint8 rows of 224x224x3 in a
# Parquet file of 1,024-row groups, streamed in 1,024-row chunks.
R50_STREAM_ROWS = 8192
# The bench's moe_lm (sparktorch_tpu/bench.py bench_moe_lm): an 8-expert
# top-1 CausalLM at full width, fitted for MOE_FIT_ITERS full-batch steps
# of MOE_BATCH × MOE_SEQ ids. The card-vs-CPU check (a) runs a tiny f32
# MoE LM on MOE_TINY_ROWS rows of 64 ids; (c) serves an MoE BERT-base
# and holds MOE_SERVE_CHECK rows to its dense-attention twin; (d) steps
# MnistMLP with each of MOE_OPTIMIZERS.
MOE_LM = dict(vocab_size=32768, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
              n_experts=8, moe_every=2)
MOE_BATCH, MOE_SEQ, MOE_FIT_ITERS = 8, 1024, 8
MOE_TINY = dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_len=64, n_experts=4, moe_every=2, dtype="float32",
                moe_group_size=64)
MOE_TINY_ROWS, MOE_SERVE_CHECK = 4, 64
MOE_OPTIMIZERS = [("adafactor", {}), ("lamb", {"lr": 1e-3}),
                  ("lion", {"lr": 1e-4}),
                  ("rmsprop", {"lr": 1e-3, "centered": True})]
# Keyword arguments of bench configs run at a cut depth (the JAX bench's
# in parentheses): resnet18_hogwild 2 runs of 32 iterations and 2 slope
# samples of its sync twin (5 of 1,024, 5; the hogwild phase's legs
# (a)-(d) hold that path at their own depths); mnist_mlp_sync,
# mnist_cnn_sync, lazy_cnn_sync, bert_dp, long_context_lm and moe_lm 2
# slope samples a leg (5); every sync leg's long span grown to a
# BENCH_SPAN_S difference (bench.SYNC_SPAN_S, 1.6 s); hogwild_chaos_soak
# 2 rounds and 1 freeze round (4 and 2); hogwild_ps_fleet 2 interleaved
# single/fleet pairs (3), run by the fleet phase.
BENCH_SPAN_S = 0.8
_SYNC_DEPTH = dict(repeats=2)
BENCH_DEPTH = {"resnet18_hogwild": dict(iters=32, **_SYNC_DEPTH),
               "mnist_mlp_sync": _SYNC_DEPTH,
               "mnist_cnn_sync": _SYNC_DEPTH,
               "lazy_cnn_sync": _SYNC_DEPTH,
               "bert_dp": _SYNC_DEPTH,
               "long_context_lm": _SYNC_DEPTH,
               "moe_lm": _SYNC_DEPTH,
               "hogwild_chaos_soak": dict(rounds=2, freeze_rounds=1),
               "hogwild_ps_fleet": dict(pairs=2)}
# The bench's obs configs left out of the bench phase: rpc_trace runs in
# the fleet phase's rpc leg; goodput, profile and obs_history (no kernel
# on their paths, ~1 minute together) run in the CPU tests only. health's
# A/A gate does not hold on the card: the lane's mean host cost is a
# large share of its 0.19 ms step (F9, open; health_costs.py times it
# there). skew runs in the bench phase.
OBS_CONFIGS = ("rpc_trace", "health", "goodput", "profile", "obs_history")
# The serving tier's phase: BERT-base (flash, bf16 compute) behind an
# InferenceTier of SERVE_REPLICAS replicas with buckets SERVE_BUCKETS,
# SERVE_REQUESTS open-loop single-row requests of SERVE_SEQ ids at twice
# the serial capacity; the weight push's pullers poll every SERVE_POLL_S.
SERVE_REPLICAS, SERVE_BUCKETS, SERVE_SEQ = 2, (1, 8, 32), 128
SERVE_REQUESTS, SERVE_POLL_S = 300, 0.05
# The fleet phase: FLEET_SHARDS shards; its hogwild BERT-base run takes
# FLEET_PARTS workers of FLEET_ITERS minibatch steps of FLEET_MB rows, out
# of FLEET_ROWS rows of BERT_SEQ ids.
FLEET_SHARDS, FLEET_PARTS, FLEET_ITERS = 4, 2, 2
FLEET_ROWS, FLEET_MB = 32, 8
# Snapshots, the Parquet file and traces, deleted when each phase ends.
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".chip_smoke_tmp")

# name: (source, the TPU kernel it replaces, design). "wgmma+tma": a
# warp-specialised Hopper kernel (TMA loads into a ring of mbarrier-guarded
# stages, wgmma products); "simt": a streaming kernel with no matrix
# products.
KERNELS = {
    "flash_fwd": ("sparktorch_tpu_torch/ops/csrc/flash_fwd.cu",
                  "sparktorch_tpu/ops/flash_attention.py:155", "wgmma+tma"),
    "flash_bwd_dq": ("sparktorch_tpu_torch/ops/csrc/flash_bwd.cu",
                     "sparktorch_tpu/ops/flash_attention.py:375",
                     "wgmma+tma"),
    "flash_bwd_dkv": ("sparktorch_tpu_torch/ops/csrc/flash_bwd.cu",
                      "sparktorch_tpu/ops/flash_attention.py:394",
                      "wgmma+tma"),
    "ce_fwd": ("sparktorch_tpu_torch/ops/csrc/fused_ce.cu",
               "sparktorch_tpu/ops/fused_ce.py:99", "simt"),
    "ce_bwd": ("sparktorch_tpu_torch/ops/csrc/fused_ce.cu",
               "sparktorch_tpu/ops/fused_ce.py:159", "simt"),
}


def log(msg):
    print(msg, flush=True)


def counters():
    """Each kernel's wrapper, which carries its launch count."""
    from sparktorch_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from sparktorch_tpu_torch.ops.fused_ce import (
        fused_ce_backward,
        fused_ce_forward,
    )

    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "ce_fwd": fused_ce_forward,
            "ce_bwd": fused_ce_backward}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expect_counts(path, got, want):
    if got != want:
        raise AssertionError(f"{path}: kernel launches {got}, expected {want}")
    log(f"{path}: kernel launches {got}")


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


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance "
            f"(atol {atol}, rtol {rtol}); max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_tiles(torch, name, got, want, tol, tile=64):
    """Hold each ``tile``-row tile of every (batch, head) of a (batch,
    seq, heads, head_dim) result to its own reference's size: late rows
    of a causal sequence, whose gradients are small, are checked as
    closely as the first. Returns (max abs error, worst tile's relative
    L2 error)."""
    import torch.nn.functional as F

    b, s, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -s % tile)
    diff = F.pad(got.float() - want.float(), pad).view(b, -1, tile, h, d)
    ref = F.pad(want.float(), pad).view(b, -1, tile, h, d)
    rel = (diff.square().sum((2, 4))
           / ref.square().sum((2, 4)).clamp_min(1e-30)).sqrt()
    worst = float(rel.max())
    if not worst <= tol:  # a NaN fails too
        raise AssertionError(
            f"{name}: worst {tile}-row tile has relative L2 error "
            f"{worst:.3e} > {tol}")
    return float(diff.abs().max()), worst


def check_rel(torch, name, got, want, rtol):
    """Every entry within ``rtol`` of its own reference value. Returns
    (max abs error, worst relative error)."""
    err = (got.float() - want.float()).abs()
    rel = err / want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    worst = float(rel.max())
    if not worst <= rtol:
        raise AssertionError(f"{name}: {int((rel > rtol).sum())} entries "
                             f"off by more than {rtol} of themselves; worst "
                             f"{worst:.3e}")
    return float(err.max()), worst


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
        ("LM training forward", LM_BATCH, LM_SEQ, 8, 64, True, bf16, True,
         True),
        # A tp = 2 rank's share of the LM: 4 of its 8 heads.
        ("LM tp=2 local forward", LM_BATCH, LM_SEQ, 4, 64, True, bf16,
         True, True),
        ("slice b=8", 8, 128, 12, 64, False, bf16, False, False),
        # The serving tier's buckets: a batch of 1, 8 or 32 rows.
        ("bucket b=1", 1, SERVE_SEQ, 12, 64, False, bf16, False, True),
        ("bucket b=8", 8, SERVE_SEQ, 12, 64, False, bf16, False, True),
        ("bucket b=32", 32, SERVE_SEQ, 12, 64, False, bf16, False, True),
        ("max_len pass", 256, 512, 12, 64, False, bf16, False, True),
        ("long causal lse", 2, 2048, 16, 128, True, bf16, True, False),
        ("ragged causal", 4, 1000, 12, 64, True, bf16, False, False),
        ("head_dim 32 causal", 4, 256, 8, 32, True, bf16, True, False),
        ("tile edge s=129 causal", 4, 129, 8, 64, True, bf16, True, True),
        ("head_dim 128 s=8192 causal", 1, 8192, 8, 128, True, bf16, True,
         False),
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
            _, rel = check_tiles(torch, f"{label} o", got, want,
                                 TILE_TOL[dname])
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
                   max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        if with_lse:
            row["lse_max_abs_err"] = lse_err
        results.append(row)
        log(f"kernel flash_fwd [{label}] b={b} s={s} h={h} d={d} {dname} "
            f"causal={causal} lse={with_lse}: max_abs_err={err:.3e} "
            f"worst_tile_rel_err={rel:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}; roofline share "
            f"{100 * bound_ms / ms:.1f}%)")
        del q, k, v
        torch.cuda.empty_cache()
    return results


def bwd_kernel_phase(torch):
    """dq and dk/dv kernels against their plain versions, on the same
    (q, k, v, dO) and the forward kernel's o and lse."""
    import torch.nn.functional as F

    from sparktorch_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    # (label, b, s, h, d, causal, dtype, q/k/v as views of one qkv)
    cases = [
        ("LM path", LM_BATCH, LM_SEQ, 8, 64, True, bf16, True),
        ("LM tp=2 local", LM_BATCH, LM_SEQ, 4, 64, True, bf16, True),
        ("BERT path", BERT_ROWS, BERT_SEQ, 12, 64, False, bf16, True),
        ("ragged causal", 4, 1000, 12, 64, True, bf16, False),
        ("head_dim 32 causal", 4, 256, 8, 32, True, bf16, False),
        ("head_dim 128 causal", 2, 2048, 16, 128, True, bf16, False),
        ("tile edge s=129 causal", 4, 129, 8, 64, True, bf16, True),
        # A partial third Q tile (one row of 192), which dq runs first.
        ("tile edge s=385 causal", 4, 385, 8, 64, True, bf16, True),
        ("head_dim 128 s=8192 causal", 1, 8192, 8, 128, True, bf16, False),
        ("f32", 4, 512, 8, 64, False, f32, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {"dq": [], "dkv": []}
    for label, b, s, h, d, causal, dtype, fused in cases:
        if fused:
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                              dtype=dtype)
            q, k, v = qkv.unbind(2)
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda", dtype=dtype)
                       for _ in range(3))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda",
                         dtype=dtype)
        dname = str(dtype).split(".")[-1]
        with torch.no_grad():
            o, lse = flash_attention(q, k, v, causal, return_lse=True)
            delta = _delta(o, do)
            args = (q, k, v, do, lse, delta, causal)
            got = {"dq": (flash_bwd_dq(*args),), "dkv": flash_bwd_dkv(*args)}
            torch.cuda.synchronize()
            errs, rels = {}, {}
            for kind, ref in (("dq", flash_bwd_dq_reference),
                              ("dkv", flash_bwd_dkv_reference)):
                want = ref(*args)
                want = want if isinstance(want, tuple) else (want,)
                pairs = [check_tiles(torch, f"{label} {kind}", g_, w_,
                                     TILE_TOL[dname])
                         for g_, w_ in zip(got[kind], want)]
                errs[kind] = max(a for a, _ in pairs)
                rels[kind] = max(r for _, r in pairs)
                del want
            del got
            big = b * s * s * h > 2 ** 30
            ms = {"dq": time_ms(torch, lambda: flash_bwd_dq(*args), 10),
                  "dkv": time_ms(torch, lambda: flash_bwd_dkv(*args), 10)}
            plain = {"dq": time_ms(torch, lambda: flash_bwd_dq_reference(
                         *args), 2 if big else 5),
                     "dkv": time_ms(torch, lambda: flash_bwd_dkv_reference(
                         *args), 2 if big else 5)}
            torch.cuda.empty_cache()
        # Library yardstick: the backward alone of SDPA (it computes dq,
        # dk and dv together, so it stands beside both kernels' sum).
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        gt = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), gt, retain_graph=True), 10)
        del out, qt, kt, vt
        for kind in ("dq", "dkv"):
            bound_ms, bound_by = flash_bwd_bound(kind, b, s, h, d, causal,
                                                 dname, q.element_size())
            results[kind].append(dict(
                label=label, b=b, s=s, h=h, d=d, causal=causal, dtype=dname,
                max_abs_err=errs[kind], max_rel_err=rels[kind], ms=ms[kind],
                plain_ms=plain[kind], library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by))
            log(f"kernel flash_bwd_{kind} [{label}] b={b} s={s} h={h} d={d} "
                f"{dname} causal={causal}: max_abs_err={errs[kind]:.3e} "
                f"worst_tile_rel_err={rels[kind]:.3e} "
                f"ms={ms[kind]:.4f} plain_ms={plain[kind]:.4f} "
                f"sdpa_bwd_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
                f"({bound_by}; roofline share {100 * bound_ms / ms[kind]:.1f}%)")
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    return results


def ce_kernel_phase(torch):
    """CE forward and backward kernels against their plain versions."""
    import torch.nn.functional as F

    from sparktorch_tpu_torch.ops.fused_ce import (
        fused_ce_backward,
        fused_ce_backward_reference,
        fused_ce_forward,
        fused_ce_reference,
    )

    cases = [
        ("LM path", LM_BATCH * LM_SEQ, LM["vocab_size"], torch.float32),
        ("ragged vocab 30522", LM_BATCH * LM_SEQ, 30522, torch.float32),
        ("bf16", 4096, LM["vocab_size"], torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {"fwd": [], "bwd": []}
    for label, t, v, dtype in cases:
        logits = (4 * torch.randn((t, v), generator=gen, device="cuda")
                  ).to(dtype)
        labels = torch.randint(0, v, (t,), generator=gen, device="cuda")
        g = torch.rand((t,), generator=gen, device="cuda")
        dname = str(dtype).split(".")[-1]
        loss, lse = fused_ce_forward(logits, labels)
        want_loss, want_lse = fused_ce_reference(logits, labels)
        # f32 loss/lse differ by summation order (running vs one-shot
        # logsumexp); the gradient is in the logits' dtype.
        err_fwd = max(check_close(f"CE {label} loss", loss, want_loss,
                                  1e-4, 1e-5),
                      check_close(f"CE {label} lse", lse, want_lse,
                                  1e-4, 1e-5))
        # The backward on the same lse, so the check is the kernel's alone.
        grad = fused_ce_backward(logits, labels, lse, g)
        want_grad = fused_ce_backward_reference(logits, labels, lse, g)
        err_bwd, rel_bwd = check_rel(torch, f"CE {label} grad", grad,
                                     want_grad, CE_GRAD_RTOL[dname])
        del grad, want_grad, loss, want_loss
        ms = {"fwd": time_ms(torch, lambda: fused_ce_forward(logits, labels),
                             20),
              "bwd": time_ms(torch, lambda: fused_ce_backward(
                  logits, labels, lse, g), 20)}
        plain = {"fwd": time_ms(torch, lambda: fused_ce_reference(
                     logits, labels), 5),
                 "bwd": time_ms(torch, lambda: fused_ce_backward_reference(
                     logits, labels, lse, g), 5)}
        library = {"fwd": time_ms(torch, lambda: F.cross_entropy(
            logits, labels, reduction="none"), 20)}
        x = logits.detach().requires_grad_()
        out = F.cross_entropy(x, labels, reduction="none")
        library["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            out, x, g, retain_graph=True), 20)
        del out, x
        for kind, err, rel in (("fwd", err_fwd, None),
                               ("bwd", err_bwd, rel_bwd)):
            bound_ms, bound_by = ce_bound(kind, t, v, logits.element_size())
            results[kind].append(dict(
                label=label, t=t, v=v, dtype=dname, max_abs_err=err,
                ms=ms[kind], plain_ms=plain[kind], library_ms=library[kind],
                bound_ms=bound_ms, bound_by=bound_by,
                **({} if rel is None else {"max_rel_err": rel})))
            log(f"kernel ce_{kind} [{label}] t={t} v={v} {dname}: "
                f"max_abs_err={err:.3e} "
                + ("" if rel is None else f"max_rel_err={rel:.3e} ")
                + f"ms={ms[kind]:.4f} "
                f"plain_ms={plain[kind]:.4f} library_ms={library[kind]:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}; roofline share "
                f"{100 * bound_ms / ms[kind]:.1f}%)")
        del logits, labels, g, lse
        torch.cuda.empty_cache()
    return results


def kernel_name(mangled):
    """``flash_fwd_bf16_kernel<64>`` from an Itanium-mangled entry name.
    Each name in it is its length, then its characters; nvcc nests the
    kernels of an anonymous namespace in a hashed one
    (``_ZN44_GLOBAL__N__<hash>_12_flash_fwd_cu_<hash>21flash_fwd_bf16_
    kernelILi64EEEv...``), so names are read by length, not by pattern."""
    i = 0
    while i < len(mangled):
        n = re.match(r"\d+", mangled[i:])
        if n is None:
            i += 1
            continue
        start = i + n.end()
        ident = mangled[start:start + int(n.group())]
        i = start + len(ident)
        if ident.endswith("_kernel"):
            arg = re.match(r"I(?:Li(\d+)|\d*([A-Za-z_]\w*?))E", mangled[i:])
            return f"{ident}<{arg.group(1) or arg.group(2)}>" if arg else ident
    return mangled


def ptxas_report(log):
    """(kernel, registers, spill stores, spill loads, static shared
    bytes) of every entry function in an ``nvcc -Xptxas -v`` log."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), *spills,
                         int(smem.group(1)) if smem else 0))
            name, spills = None, (0, 0)
    return rows


def kernel_family(name):
    name = name.lower()
    for family in ("flash_fwd", "flash_bwd", "ce_fwd_kernel", "ce_bwd_kernel"):
        if family in name:
            return family.replace("_kernel", "")
    if "memcpy" in name or "memset" in name:
        return "memcpy"
    # Before "cudnn": cuDNN's own BatchNorm kernels are cudnn::bn_*.
    if "batch_norm" in name or "batchnorm" in name or "bn_" in name:
        return "batchnorm"
    if any(k in name for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                               "implicit", "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if any(k in name for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "multi_tensor_apply" in name or "foreach" in name:
        return "foreach"
    if any(k in name for k in ("elementwise", "vectorized", "reduce",
                               "pool", "index", "cat", "copy")):
        return "elementwise"
    return "other"


def profile_pass(torch, label, fn):
    """Device time by kernel family over one call of ``fn``, from a
    torch.profiler trace (its wall is inflated by the profiler, so it
    is not the throughput). Prints "not measured" if the trace holds
    no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_family, by_name = [], {}, {}
    for evt in prof.events():
        # A train_step range (the trainers' step annotation) shows on the
        # device timeline too; it is a span over kernels, not one.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.is_user_annotation):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        family = kernel_family(evt.name)
        by_family[family] = by_family.get(family, 0.0) + (end - start)
        key = (family, evt.name)
        by_name[key] = by_name.get(key, 0.0) + (end - start)
    if not spans:
        log(f"profile [{label}]: no device events in the trace; not measured")
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
    log(f"profile [{label}, {len(spans)} device events]: {shares}; "
        f"device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
        f"({100 * (1 - busy / wall_us):.1f}% idle, profiler on)")
    # The largest kernels of each family, so the split can be checked.
    for family in by_family:
        top = sorted(((us, name) for (f, name), us in by_name.items()
                      if f == family), reverse=True)[:3]
        for us, name in top:
            short = name.replace("at::native::", "").replace(
                "(anonymous namespace)::", "")
            log(f"  {family}: {us / 1e3:.3f} ms {short[:160]}")
    return {"device_ms": {k: v / 1e3 for k, v in by_family.items()},
            "busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
            "idle_pct": 100 * (1 - busy / wall_us)}


def slice_phase(torch):
    from sparktorch_tpu_torch import (
        BatchPredictor,
        create_spark_torch_model,
        deserialize_model,
    )
    from sparktorch_tpu_torch.models import bert_base

    t0 = time.perf_counter()
    payload = bert_payload(torch, 2)
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

    none = dict.fromkeys(KERNELS, 0)
    reset_counts()
    t0 = time.perf_counter()
    preds = stm.transform(frame)["predicted"]
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("serve", counts, dict(
        none, flash_fwd=cfg.n_layers * -(-SLICE_ROWS // CHUNK)))
    log(f"slice: transform {SLICE_ROWS} rows x {SLICE_SEQ} ids in "
        f"{wall:.3f} s = {SLICE_ROWS / wall:.1f} rows/s")
    profile_pass(torch, "one served pass", lambda: stm.transform(frame))

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
    reset_counts()
    t0 = time.perf_counter()
    preds512 = stm.transform({"features": ids512})["predicted"]
    wall512 = time.perf_counter() - t0
    expect_counts(f"serve 256 x {cfg.max_len}", read_counts(),
                  dict(none, flash_fwd=cfg.n_layers))
    if preds512.shape != (256,):
        raise AssertionError(f"max_len pass: predictions {preds512.shape}")
    log(f"slice: transform 256 rows x {cfg.max_len} ids in {wall512:.3f} s "
        f"= {256 / wall512:.1f} rows/s")
    compare(f"256 x {cfg.max_len}", ids512, preds512)
    return counts, SLICE_ROWS / wall


def fit(torch, payload, frame, iters, path, expected):
    """``SparkTorch(...).fit`` on the card: one 1-step fit to warm up
    (cuBLAS handles, allocator), then the measured fit with every
    launch count set to 0 just before it. Returns the fitted model, the
    step records, the counts and the fit's wall time."""
    from sparktorch_tpu_torch import SparkTorch

    def estimator(n):
        return SparkTorch(inputCol="features", labelCol="label",
                          torchObj=payload, iters=n, device="cuda")

    estimator(1).fit(frame)
    torch.cuda.synchronize()
    est = estimator(iters)
    reset_counts()
    t0 = time.perf_counter()
    model = est.fit(frame)
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_counts(path, counts, expected)
    records = est._last_metrics
    losses = [r["loss"] for r in records]
    if len(records) != iters or not np.isfinite(losses).all():
        raise AssertionError(f"{path}: {len(records)} steps, losses {losses}")
    return model, records, counts, wall


def lm_config(seq, attn_impl):
    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(max_len=seq, attn_impl=attn_impl, **LM)


def lm_step_counts(steps):
    """Launches of each kernel in ``steps`` LM training steps: 2 forward
    launches a layer (remat recomputes it), 1 dq and 1 dk/dv a layer, 1
    CE forward and 1 CE backward."""
    n_layers = LM["n_layers"]
    return dict(flash_fwd=2 * n_layers * steps, flash_bwd_dq=n_layers * steps,
                flash_bwd_dkv=n_layers * steps, ce_fwd=steps, ce_bwd=steps)


def train_lm_phase(torch):
    from sparktorch_tpu_torch import deserialize_model
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch

    cfg = lm_config(LM_SEQ, "flash")
    t0 = time.perf_counter()
    payload = lm_payload(torch, 0)
    n_params = sum(p.numel() for p in
                   deserialize_model(payload).abstract_module().parameters())
    log(f"train LM: CausalLM vocab={cfg.vocab_size} d_model={cfg.d_model} "
        f"heads={cfg.n_heads} layers={cfg.n_layers} d_ff={cfg.d_ff} "
        f"s={LM_SEQ} {cfg.dtype} flash remat={cfg.remat}, {n_params:,} "
        f"params; packaged in {time.perf_counter() - t0:.1f} s")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (LM_BATCH, LM_SEQ + 1))
    frame = {"features": list(ids[:, :-1].astype(np.float32)),
             "label": list(ids[:, 1:])}
    n = LM_ITERS
    _, records, counts, wall = fit(torch, payload, frame, n, "train LM",
                                   lm_step_counts(n))
    losses = [r["loss"] for r in records]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train LM: loss did not fall: {losses}")
    step_s = records[0]["step_time_s"]  # one read-back per chunk: its mean
    tokens_per_s = LM_BATCH * LM_SEQ / step_s
    log(f"train LM: {n} steps, losses {[round(x, 4) for x in losses]}; "
        f"step {step_s * 1e3:.1f} ms = {tokens_per_s:,.0f} tokens/s with "
        f"the hooks on (the process bus, no profiler) (fit wall "
        f"{wall:.2f} s incl. unpacking and H2D)")

    # One more step under the profiler, on the module as the fit built it.
    spec = deserialize_model(payload)
    module = spec.make_module().cuda().train()
    opt = spec.make_optimizer(module.parameters())
    batch = DataBatch(torch.from_numpy(ids[:, :-1].astype(np.float32)),
                      torch.from_numpy(ids[:, 1:]),
                      torch.ones(LM_BATCH)).to("cuda")
    loss_fn = spec.loss_fn()
    train_step(module, loss_fn, opt, batch)
    profile_pass(torch, "one LM training step",
                 lambda: train_step(module, loss_fn, opt, batch))
    del module, opt, batch
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_s * 1e3, tokens_per_s=tokens_per_s,
                        losses=losses), (payload, ids)


def trace_kernel(name):
    """The KERNELS key of a kernel event's name in a Chrome trace, or
    None for any other kernel."""
    for key, part in (("flash_fwd", "flash_fwd_"),
                      ("flash_bwd_dq", "flash_bwd_dq_"),
                      ("flash_bwd_dkv", "flash_bwd_dkv_"),
                      ("ce_fwd", "ce_fwd_kernel"),
                      ("ce_bwd", "ce_bwd_kernel")):
        if part in name:
            return key
    return None


def step_kernel_launches(path):
    """From a torch.profiler Chrome trace: the number of ``train_step``
    ranges, and each kernel's launches whose launch call (matched to the
    kernel by its correlation id) lies inside one of them, and outside
    all of them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == "train_step" and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    inside, outside = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    for e in events:
        key = trace_kernel(e["name"]) if e.get("cat") == "kernel" else None
        if key is None:
            continue
        t = launched.get(e["args"].get("correlation"))
        hit = t is not None and any(a <= t <= b for a, b in ranges)
        (inside if hit else outside)[key] += 1
    return len(ranges), inside, outside


def trace_analysis_check(tele, path, n, inside):
    """``profile_run``'s analysis of the traced fit (``obs/xprof.py``,
    published on the run's bus as the ``xprof`` section): one step per
    annotated step, each step's compute within its wall, no comm on one
    card, and the hand kernels' launches by family (a full analysis of
    the same file, every op kept) equal to :func:`step_kernel_launches`'
    count inside the ``train_step`` ranges."""
    from sparktorch_tpu_torch.obs import xprof

    xp = tele.get_section("xprof")
    annotated = tele.counter_value("tracing.annotated_steps")
    if xp is None or xp["n_steps"] != annotated or annotated != n:
        raise AssertionError(f"train LM traced: analysis "
                             f"{xp and xp['n_steps']} steps, {annotated} "
                             f"annotated, {n} run")
    steps = xp["steps"]
    if any(st["compute_s"] > st["wall_s"] for st in steps) \
            or xp["comm_s"] != 0:
        raise AssertionError(f"train LM traced: analysis steps {steps}")
    t0 = time.perf_counter()
    full = xprof.analyze_trace(path, top_k=10 ** 6)
    analyse_s = time.perf_counter() - t0
    by_family = dict.fromkeys(KERNELS, 0)
    for op in full.top_ops:
        key = trace_kernel(op["name"])
        if key is not None:
            by_family[key] += op["count"]
    if by_family != inside:
        raise AssertionError(f"train LM traced: analysis launches "
                             f"{by_family}, step_kernel_launches {inside}")
    log(f"train LM traced analysis: {xp['n_steps']} steps (device "
        f"projections of train_step), wall "
        f"{[round(1e3 * st['wall_s'], 2) for st in steps]} ms, compute "
        f"{[round(1e3 * st['compute_s'], 2) for st in steps]} ms, comm "
        f"{xp['comm_s']} s; launches by family {by_family}; "
        f"{full.n_device_events} device events, analysed in "
        f"{analyse_s:.2f} s")
    return dict(n_steps=xp["n_steps"], wall_s=[st["wall_s"] for st in steps],
                compute_s=[st["compute_s"] for st in steps],
                comm_s=xp["comm_s"], launches=by_family)


def train_lm_obs_phase(torch, payload, ids):
    """Phase 5's LM through ``train_distributed`` with the obs and chaos
    hooks: (a) TRACE_STEPS steps, one a chunk, with a fresh
    ``Telemetry`` and a ``profile_dir``: the Chrome trace holds
    ``tracing.annotated_steps`` ``train_step`` ranges, the five kernels
    launch 8/4/4/1/1 a step inside them and never outside, and the bus's
    ``train.steps`` and ``train.examples`` match the records; (b) the
    same fit on the process bus and no profiler: its losses within
    1e-6·max|loss| of (a)'s; (c) a seeded ``worker.step`` kill at step 2
    raises ``ChaosKill`` there, after two steps."""
    from sparktorch_tpu_torch.ft import ChaosConfig, ChaosKill, inject
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.sync import train_distributed
    from sparktorch_tpu_torch.utils.serde import deserialize_model

    # One unpickling of the 0.2 GB payload for the phase's fits (each fit
    # copies the spec's module).
    payload = deserialize_model(payload)
    x, y = ids[:, :-1].astype(np.float32), ids[:, 1:]
    n = TRACE_STEPS
    common = dict(labels=y, steps_per_call=1, device="cuda")
    counts, out = {}, {}

    tele = Telemetry(run_id="train_lm_traced")
    trace_dir = os.path.join(SCRATCH, "lm_trace")
    reset_counts()
    t0 = time.perf_counter()
    traced = train_distributed(payload, x, iters=n, telemetry=tele,
                               profile_dir=trace_dir, **common)
    fit_s = time.perf_counter() - t0
    counts["train_lm_traced"] = read_counts()
    expect_counts("train LM traced", counts["train_lm_traced"],
                  lm_step_counts(n))
    (name,) = os.listdir(trace_dir)
    path = os.path.join(trace_dir, name)
    size_mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    n_ranges, inside, outside = step_kernel_launches(path)
    parse_s = time.perf_counter() - t0
    analysis = trace_analysis_check(tele, path, n, inside)
    shutil.rmtree(trace_dir)
    snap = tele.snapshot()
    annotated = snap["counters"]["tracing.annotated_steps"]
    if not n_ranges == annotated == n:
        raise AssertionError(f"train LM traced: {n_ranges} train_step ranges,"
                             f" {annotated} annotated steps, {n} steps")
    if inside != lm_step_counts(n) or any(outside.values()):
        raise AssertionError(f"train LM traced: launches inside the ranges "
                             f"{inside}, outside {outside}")
    examples = sum(r["examples"] for r in traced.metrics)
    if (snap["counters"]["train.steps"] != len(traced.metrics) == n
            or snap["counters"]["train.examples"] != examples):
        raise AssertionError(f"train LM traced: bus {snap['counters']}, "
                             f"{len(traced.metrics)} records")
    log(f"train LM traced: {n} steps, {n_ranges} train_step ranges == "
        f"tracing.annotated_steps; launches inside them {inside} = "
        f"8/4/4/1/1 a step, outside {outside}; train.steps "
        f"{snap['counters']['train.steps']:.0f}, train.examples "
        f"{examples:.0f}; trace {size_mb:.1f} MB (fit {fit_s:.1f} s with "
        f"the export, parsed in {parse_s:.1f} s); spans "
        f"{sorted(snap['spans'])}")

    reset_counts()
    plain = train_distributed(payload, x, iters=n, **common)
    counts["train_lm_untraced"] = read_counts()
    expect_counts("train LM untraced", counts["train_lm_untraced"],
                  lm_step_counts(n))
    a = np.asarray([r["loss"] for r in traced.metrics])
    b = np.asarray([r["loss"] for r in plain.metrics])
    diff, tol = float(np.abs(a - b).max()), 1e-6 * float(np.abs(b).max())
    if not diff <= tol:
        raise AssertionError(f"train LM traced vs untraced: losses {a} vs "
                             f"{b}, max diff {diff:.3e} > {tol:.3e}")
    step_ms = [1e3 * r["step_time_s"] for r in plain.metrics]
    log(f"train LM untraced: losses {[round(v, 4) for v in b]}, max diff "
        f"to traced {diff:.3e} (limit {tol:.3e}); one step a chunk, hooks "
        f"on, no profiler: steps {[round(v, 2) for v in step_ms]} ms")

    reset_counts()
    records = []
    with inject(ChaosConfig(kill_worker_at={0: 2})) as inj:
        try:
            train_distributed(payload, x, iters=4,
                              metrics_hook=records.append, **common)
        except ChaosKill as e:
            killed = str(e)
        else:
            raise AssertionError("chaos: the worker.step kill did not fire")
    counts["train_lm_chaos_kill"] = read_counts()
    expect_counts("train LM chaos kill", counts["train_lm_chaos_kill"],
                  lm_step_counts(2))
    want = [{"site": "worker.step", "worker": 0, "step": 2}]
    if inj.events != want or [r["iter"] for r in records] != [0, 1]:
        raise AssertionError(f"chaos: events {inj.events}, records "
                             f"{[r['iter'] for r in records]}")
    log(f"train LM chaos: ChaosKill '{killed}' after steps "
        f"{[r['iter'] for r in records]}; events {inj.events}")
    torch.cuda.empty_cache()
    out.update(traced_losses=a.tolist(), untraced_losses=b.tolist(),
               max_loss_diff=diff, trace_mb=size_mb, ranges=n_ranges,
               analysis=analysis,
               launches_in_ranges=inside, untraced_step_ms=step_ms,
               chaos_events=inj.events)
    return counts, out


def health_ids(seed):
    ids = np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                               (HEALTH_ROWS, HEALTH_SEQ + 1))
    return ids[:, :-1].astype(np.float32), ids[:, 1:]


def health_replay_child(meta):
    """``python -m sparktorch_tpu_torch.obs.replay`` (run through
    ``runpy``, as ``-m`` runs it) started in a fresh process on the card;
    :func:`health_replay_wait` collects it."""
    code = ("import json, runpy, sys\n"
            "import chip_smoke as s\n"
            "s.reset_counts()\n"
            "sys.argv = ['replay', sys.argv[1]]\n"
            "rc = 0\n"
            "try:\n"
            "    runpy.run_module('sparktorch_tpu_torch.obs.replay',"
            " run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('LAUNCHES ' + json.dumps(s.read_counts()), flush=True)\n"
            "sys.exit(rc)\n")
    proc = subprocess.Popen([sys.executable, "-c", code, meta],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, time.perf_counter()


def health_replay_wait(child):
    """The replay child's exit code, output, launches and wall."""
    proc, t0 = child
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    launches = next((json.loads(x[len("LAUNCHES "):])
                     for x in stdout.splitlines()
                     if x.startswith("LAUNCHES ")), None)
    return proc.returncode, stdout, stderr, launches, wall


def health_determinism(torch, spec):
    """One LM step with the health vector twice from one state (the
    state restored bit for bit between them): which of loss, grad norm,
    update ratio and leaf norms come back bitwise; then a step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
    warnings name the ops without a deterministic implementation. Also
    times the replay anchor's host copy of the state (the module's
    ``state_dict`` and AdamW's moments)."""
    import warnings

    from sparktorch_tpu_torch.obs import health
    from sparktorch_tpu_torch.train.step import health_buffer, train_step
    from sparktorch_tpu_torch.train.sync import _build_trainer
    from sparktorch_tpu_torch.utils.data import DataBatch

    module, opt, loss_fn = _build_trainer(spec, spec, torch.device("cuda"))
    x, y = health_ids(12)
    batch = DataBatch(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(),
                      torch.ones(len(x), device="cuda"))
    buf = health_buffer(module)
    train_step(module, loss_fn, opt, batch, health_buf=buf)  # AdamW state
    torch.cuda.synchronize()
    copy_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = health.tree_to_host(health.trainer_state(module, opt))
        copy_s.append(time.perf_counter() - t0)
    nbytes = sum(a.nbytes for a in state.values())

    def one():
        m = train_step(module, loss_fn, opt, batch, health_buf=buf)
        vals = {"loss": m.loss, "grad_norm": m.grad_norm,
                "update_ratio": m.health.update_ratio,
                "finite": m.health.finite}
        out = {k: health.float_bits(float(v)) for k, v in vals.items()}
        out["leaf_norms"] = m.health.leaf_norms.cpu().numpy().view(
            np.uint32).tolist()
        return out

    first = one()
    health.load_trainer_state(module, opt, state)
    second = one()
    equal = {k: first[k] == second[k] for k in first}
    health.load_trainer_state(module, opt, state)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            one()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught})
    del module, opt, buf, batch
    torch.cuda.empty_cache()
    return dict(bitwise_equal=equal, nondeterministic_warnings=ops,
                anchor_copy_s=copy_s, anchor_mb=nbytes / 1e6)


def health_phase(torch, payload):
    """Phase 5's LM with the health lane (``obs/health.py``) at full
    width on HEALTH_ROWS rows of HEALTH_SEQ ids: (a) a fit poisoned at
    step HEALTH_POISON by ``ChaosConfig(poison_batch_at=...)`` under a
    ledger with a replay dir: the NaN sentinel at that step within 2
    steps of the delayed fetch, the leaf table in the port's dotted
    names, one ``health_nonfinite`` alert episode, one bundle, 8/4/4/1/1
    launches a step; (b) the bundle replayed by ``python -m
    sparktorch_tpu_torch.obs.replay`` in a fresh process on the card:
    exit 0, every metric's bits equal, 8/4/4/1/1 launches a replayed
    step; the determinism probe of :func:`health_determinism`, run while
    the child starts; (c) the
    LM step with the lane on and with ``SPARKTORCH_TPU_HEALTH=0``, A/B/B/A,
    median step times; (d) the lane-on fits raise no anomaly and their
    goodput ledgers hold ``data_wait{site=health}`` > 0, the lane-off
    fits exactly 0."""
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.obs import (
        AlertManager,
        GoodputLedger,
        MetricsHistory,
        Telemetry,
        health,
    )
    from sparktorch_tpu_torch.train.sync import train_distributed
    from sparktorch_tpu_torch.utils.serde import deserialize_model

    t_phase = time.perf_counter()
    counts, out = {}, {}
    # One unpickling of the 0.2 GB payload for the phase's fits (each fit
    # copies the spec's module).
    spec = deserialize_model(payload)
    x, y = health_ids(11)
    common = dict(labels=y, steps_per_call=1, device="cuda")

    # (a) the drill.
    replay_dir = os.path.join(SCRATCH, "health_replay")
    shutil.rmtree(replay_dir, ignore_errors=True)
    cfg = health.HealthConfig(
        replay_dir=replay_dir, replay_max_bundles=1,
        replay_builder="sparktorch_tpu_torch.obs.replay:lm_builder",
        replay_builder_kwargs=dict(rows=HEALTH_ROWS, seq=HEALTH_SEQ,
                                   lr=3e-4, max_len=LM_SEQ,
                                   attn_impl="flash", **LM))
    tele = Telemetry(run_id="health_drill")
    history = MetricsHistory()
    alerts = AlertManager(history, health.health_alert_rules(),
                          telemetry=tele)
    events = []

    def sweep(_record=None):
        history.append(tele.snapshot())
        events.extend(alerts.evaluate())

    ledger = health.TrainHealthLedger(rank=0, config=cfg, telemetry=tele)
    prev = health.install(ledger)
    reset_counts()
    t0 = time.perf_counter()
    try:
        with inject(ChaosConfig(poison_batch_at={0: HEALTH_POISON})) as inj:
            drill = train_distributed(spec, x, iters=HEALTH_ITERS,
                                      telemetry=tele, metrics_hook=sweep,
                                      **common)
    finally:
        health.install(prev)
    drill_s = time.perf_counter() - t0
    sweep()
    counts["health_drill"] = read_counts()
    expect_counts("health drill", counts["health_drill"],
                  lm_step_counts(HEALTH_ITERS))
    doc = ledger.snapshot()
    first = doc["anomalies"][0] if doc["anomalies"] else None
    if (first is None or first["akind"] != "nonfinite"
            or first["step"] != HEALTH_POISON
            or not 0 <= first["detect_lag"] - cfg.fetch_lag <= 2):
        raise AssertionError(f"health drill: first anomaly {first}, "
                             f"chaos {inj.events}")
    losses = [r["loss"] for r in drill.metrics]
    if not (all(np.isfinite(losses[:HEALTH_POISON]))
            and np.isnan(losses[HEALTH_POISON])):
        raise AssertionError(f"health drill: losses {losses}")
    names = [n for n, p in spec.abstract_module().named_parameters()
             if p.requires_grad]
    top = [k for k, _ in doc["top_grad_leaves"]]
    if ledger.leaf_keys != names or not set(top) <= set(names) or not top:
        raise AssertionError(f"health drill: leaf keys {ledger.leaf_keys}"
                             f" against {names}, top {top}")
    fired = [e["alert"] for e in events if e["event"] == "fired"]
    if fired != ["health_nonfinite"]:
        raise AssertionError(f"health drill: alert firings {fired}")
    bundles = doc["replay"]["bundles"]
    want = os.path.join(replay_dir, f"replay_step{HEALTH_POISON:06d}_r0.json")
    if bundles != [want]:
        raise AssertionError(f"health drill: bundles {bundles}")
    log(f"health (a) drill: {HEALTH_ITERS} steps of the phase-5 LM on "
        f"{HEALTH_ROWS}x{HEALTH_SEQ} ids, batch poisoned at step "
        f"{HEALTH_POISON}: losses {[round(v, 4) for v in losses]}; first "
        f"anomaly {first['akind']} at step {first['step']}, detect lag "
        f"{first['detect_lag']} (fetch lag {cfg.fetch_lag}), ingested "
        f"{first['ingest_lag']} steps after it; anomalies "
        f"{doc['counts']}; alert firings {fired}; top grad leaves {top}; "
        f"bundle {os.path.basename(want)} "
        f"({os.path.getsize(want[:-5] + '.npz') / 1e6:.1f} MB npz); launches "
        f"{counts['health_drill']}; fit {drill_s:.1f} s")
    out["drill"] = dict(losses=losses, first_anomaly=first,
                        counts=doc["counts"], alerts=fired, top_leaves=top,
                        fit_s=drill_s)

    # (b) the replay in a fresh process; the determinism probe runs
    # while the child starts (its import and the card's context).
    child = health_replay_child(want)
    det = health_determinism(torch, spec)
    rc, stdout, stderr, launches, replay_s = health_replay_wait(child)
    steps_run = 1
    if rc != 0 or launches != lm_step_counts(steps_run):
        raise AssertionError(f"health replay: exit {rc}, launches "
                             f"{launches}\n{stdout}\n{stderr[-3000:]}")
    shutil.rmtree(replay_dir)
    log(f"health (b) replay: python -m sparktorch_tpu_torch.obs.replay in a "
        f"fresh process: exit {rc}, {replay_s:.1f} s wall, launches "
        f"{launches}\n" + "\n".join(
            line for line in stdout.splitlines()
            if not line.startswith("LAUNCHES")))
    log(f"health (b) determinism: one clean step twice from one state, "
        f"bits equal {det['bitwise_equal']}; under "
        f"use_deterministic_algorithms(warn_only=True): "
        f"{det['nondeterministic_warnings'] or 'no warning'}; anchor copy "
        f"of {det['anchor_mb']:.1f} MB: "
        f"{[round(v, 4) for v in det['anchor_copy_s']]} s")
    out["replay"] = dict(exit=rc, wall_s=replay_s, launches=launches,
                         determinism=det)

    # (c) and (d): the lane on (A) and off (B), A/B/B/A.
    arms = []
    reset_counts()
    try:
        for on in (True, False, False, True):
            os.environ[health.ENV_GATE] = "1" if on else "0"
            t = Telemetry(run_id=f"health_{'on' if on else 'off'}")
            led = GoodputLedger(t, rank=0)
            with led.activate():
                fit = train_distributed(spec, x, iters=HEALTH_TIMING_ITERS,
                                        telemetry=t, **common)
            steps = [r["step_time_s"] for r in fit.metrics[HEALTH_WARM:]]
            section = (t.get_section(health.SECTION) or {}).get("ranks", {})
            arms.append(dict(
                on=on, step_ms=1e3 * float(np.median(steps)),
                fetch_s=led.site_s("data_wait", health.GOODPUT_SITE),
                anomalies=sum(len(d["anomalies"]) for d in section.values()),
                ingested=sum(d["steps_ingested"] for d in section.values())))
    finally:
        os.environ.pop(health.ENV_GATE, None)
    counts["health_timing"] = read_counts()
    expect_counts("health timing", counts["health_timing"],
                  lm_step_counts(4 * HEALTH_TIMING_ITERS))
    on = [a for a in arms if a["on"]]
    off = [a for a in arms if not a["on"]]
    if (any(a["anomalies"] or a["ingested"] != HEALTH_TIMING_ITERS
            or not a["fetch_s"] > 0 for a in on)
            or any(a["fetch_s"] != 0.0 or a["ingested"] for a in off)):
        raise AssertionError(f"health (c/d): arms {arms}")
    on_ms = float(np.mean([a["step_ms"] for a in on]))
    off_ms = float(np.mean([a["step_ms"] for a in off]))
    fetch_ms = 1e3 * float(np.mean([a["fetch_s"] for a in on])) / \
        HEALTH_TIMING_ITERS
    log(f"health (c) lane on/off, A/B/B/A, median step of "
        f"{HEALTH_TIMING_ITERS - HEALTH_WARM} after {HEALTH_WARM}: "
        f"{[round(a['step_ms'], 3) for a in arms]} ms; on {on_ms:.3f} ms, "
        f"off {off_ms:.3f} ms, difference {on_ms - off_ms:+.3f} ms "
        f"({100 * (on_ms - off_ms) / off_ms:+.2f}%); delayed fetch "
        f"{fetch_ms:.4f} ms a step (data_wait{{site=health}})")
    log(f"health (d) clean fits: anomalies {[a['anomalies'] for a in on]}; "
        f"data_wait{{site=health}} lane on "
        f"{[round(a['fetch_s'], 6) for a in on]} s, lane off "
        f"{[a['fetch_s'] for a in off]} s")
    torch.cuda.empty_cache()
    out["timing"] = dict(arms=arms, on_ms=on_ms, off_ms=off_ms,
                         overhead_pct=100 * (on_ms - off_ms) / off_ms,
                         fetch_ms_per_step=fetch_ms)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"health phase: {out['wall_s']:.1f} s")
    return counts, out


def train_parity_phase(torch):
    """One step of the LM with flash attention and the fused CE against
    dense attention and the dense CE, on the same weights."""
    import torch.nn.functional as F

    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.losses import resolve_loss
    from sparktorch_tpu_torch.utils.serde import resolve_optimizer

    torch.manual_seed(1)
    flash = CausalLM(lm_config(PARITY_SEQ, "flash")).cuda()
    dense = CausalLM(lm_config(PARITY_SEQ, "dense")).cuda()
    dense.load_state_dict(flash.state_dict())
    ids = np.random.default_rng(1).integers(0, LM["vocab_size"],
                                            (LM_BATCH, PARITY_SEQ + 1))
    batch = DataBatch(torch.from_numpy(ids[:, :-1].astype(np.float32)),
                      torch.from_numpy(ids[:, 1:]),
                      torch.ones(LM_BATCH)).to("cuda")
    out = {}
    for name, module, loss in (("flash", flash, "cross_entropy"),
                               ("dense", dense, "cross_entropy_dense")):
        opt = resolve_optimizer("sgd", {"lr": 0.0})(module.parameters())
        reset_counts()
        m = train_step(module, resolve_loss(loss), opt, batch)
        out[name] = (float(m.loss), float(m.grad_norm), read_counts())
    expect_counts("train parity (flash step)", out["flash"][2],
                  lm_step_counts(1))
    expect_counts("train parity (dense step)", out["dense"][2],
                  dict.fromkeys(KERNELS, 0))
    (loss_f, norm_f, _), (loss_d, norm_d, _) = out["flash"], out["dense"]
    worst, worst_name = 1.0, None
    for (name, pf), pd in zip(flash.named_parameters(), dense.parameters()):
        gf, gd = pf.grad.float().flatten(), pd.grad.float().flatten()
        if name.endswith("attn.qkv.bias"):
            # The key third's gradient is zero in exact arithmetic
            # (softmax ignores a per-query constant): rounding noise only.
            gf, gd = (g.view(3, -1)[[0, 2]].flatten() for g in (gf, gd))
        cos = float(F.cosine_similarity(gf, gd, dim=0))
        if cos < worst:
            worst, worst_name = cos, name
    rel_loss = abs(loss_f - loss_d) / abs(loss_d)
    rel_norm = abs(norm_f - norm_d) / abs(norm_d)
    log(f"train parity s={PARITY_SEQ}: loss flash {loss_f:.6f} dense "
        f"{loss_d:.6f} (rel {rel_loss:.2e}); grad norm flash {norm_f:.6f} "
        f"dense {norm_d:.6f} (rel {rel_norm:.2e}); lowest per-parameter "
        f"grad cosine {worst:.6f} ({worst_name})")
    if rel_loss > 1e-2 or rel_norm > 1e-2 or worst < 0.99:
        raise AssertionError("train parity: flash + fused CE disagrees "
                             "with dense attention + dense CE")
    del flash, dense, batch
    torch.cuda.empty_cache()
    return dict(rel_loss=rel_loss, rel_grad_norm=rel_norm, min_cosine=worst)


@functools.cache
def bert_payload(torch, seed, layers=12):
    """BERT-base (flash) packaged under ``seed`` with Adam 2e-5; one
    packaging a (seed, depth), shared by the phases that fit it."""
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import bert_base

    torch.manual_seed(seed)
    return serialize_torch_obj(bert_base(attn_impl="flash", n_layers=layers),
                               criterion="cross_entropy", optimizer="adam",
                               optimizer_params={"lr": 2e-5})


def train_bert_phase(torch, bench_rec):
    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    layers, vocab = 12, TransformerConfig().vocab_size
    payload = bert_payload(torch, 2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, vocab, (BERT_ROWS, BERT_SEQ))
    frame = {"features": list(ids.astype(np.float32)),
             "label": rng.integers(0, 2, BERT_ROWS).astype(np.float32)}
    n = BERT_ITERS
    fitted, records, counts, wall = fit(
        torch, payload, frame, n, "train BERT",
        dict(flash_fwd=layers * n, flash_bwd_dq=layers * n,
             flash_bwd_dkv=layers * n, ce_fwd=0, ce_bwd=0))
    preds = fitted.setDevice("cuda").transform(frame)["predictions"]
    if preds.shape != (BERT_ROWS,) or not np.isin(preds, (0.0, 1.0)).all():
        raise AssertionError(f"train BERT: predictions {preds[:8]}")
    step_s = bench_rec["step_time_p50_s"]
    log(f"train BERT: {n} steps, losses "
        f"{[round(r['loss'], 4) for r in records]} (fit wall {wall:.2f} s); "
        f"the fitted model serves {BERT_ROWS} rows; step {step_s * 1e3:.1f} "
        f"ms = {bench_rec['examples_per_sec_per_chip']:,.1f} examples/s "
        f"(bench bert_dp)")
    return counts, dict(step_ms=step_s * 1e3,
                        examples_per_s=bench_rec["examples_per_sec_per_chip"])


@functools.cache
def lm_payload(torch, seed):
    """The phase-5 LM packaged under ``seed``; one packaging a seed
    (the payload is an immutable string, so phases share it)."""
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import CausalLM

    torch.manual_seed(seed)
    return serialize_torch_obj(CausalLM(lm_config(LM_SEQ, "flash")),
                               criterion="cross_entropy", optimizer="adamw",
                               optimizer_params={"lr": 3e-4})


def lm_ids(rows, seed):
    ids = np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                               (rows, LM_SEQ + 1))
    return ids[:, :-1].astype(np.float32), ids[:, 1:]


def add_up(total, counts):
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def upload_trace(torch, fn):
    """Run ``fn`` under torch.profiler and return, from its trace, the
    host→device copies on streams other than the flash kernels' and
    how many of them overlap a flash-stream kernel. Only the card's
    activity is traced: host-side op events would slow the launches
    toward the card's pace, and a chunk's upload hides only while the
    host runs ahead."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(SCRATCH, "stream_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    compute = {e["args"]["stream"] for e in kernels if "flash" in e["name"]}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e["name"]]
    side = [c for c in copies if c["args"]["stream"] not in compute]
    busy = [(k["ts"], k["ts"] + k["dur"]) for k in kernels
            if k["args"]["stream"] in compute]
    overlapped = [c for c in side if any(
        a < c["ts"] + c["dur"] and c["ts"] < b for a, b in busy)]
    return dict(compute_streams=sorted(compute),
                copy_streams=sorted({c["args"]["stream"] for c in side}),
                side_copies=len(side), overlapped=len(overlapped),
                all_htod=len(copies),
                side_copy_us=[round(c["dur"], 1) for c in side])


def train_lm_streaming_phase(torch, resident_tokens_per_s):
    """The LM through train_distributed_streaming: host data in 4-row
    chunks, one chunk ahead on the card, snapshots at chunk boundaries,
    then a resume."""
    from sparktorch_tpu_torch.train.sync import train_distributed_streaming
    from sparktorch_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        latest_step,
    )

    payload = lm_payload(torch, 0)
    x, y = lm_ids(STREAM_ROWS, 6)
    d = os.path.join(SCRATCH, "stream_ckpt")
    per_epoch = (STREAM_ROWS // STREAM_CHUNK) * (STREAM_CHUNK // STREAM_MB)
    kw = dict(labels=y, chunk_rows=STREAM_CHUNK, mini_batch=STREAM_MB,
              seed=6, device="cuda", checkpoint_dir=d,
              checkpoint_every=STREAM_EVERY)
    total, runs = {}, []
    for epochs, resume in ((STREAM_EPOCHS, False), (1, True)):
        steps = epochs * per_epoch
        reset_counts()
        t0 = time.perf_counter()
        result = train_distributed_streaming(payload, x, epochs=epochs,
                                             resume=resume, **kw)
        wall = time.perf_counter() - t0
        counts = read_counts()
        label = "train LM streaming" + (" (resumed)" if resume else "")
        expect_counts(label, counts, lm_step_counts(steps))
        total = add_up(total, counts)
        losses = [r["loss"] for r in result.metrics]
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{label}: {len(losses)} steps, {losses}")
        done = sum(len(r.metrics) for r in runs) + steps
        if latest_step(d) != done:
            raise AssertionError(f"{label}: latest step {latest_step(d)}, "
                                 f"expected {done}")
        runs.append(result)
        step_s = float(np.median([r["step_time_s"] for r in result.metrics]))
        log(f"{label}: {steps} steps of {STREAM_MB} x {LM_SEQ} tokens in "
            f"{wall:.2f} s (snapshots included); median step "
            f"{step_s * 1e3:.1f} ms = {STREAM_MB * LM_SEQ / step_s:,.0f} "
            f"tokens/s (resident trainer: {resident_tokens_per_s:,.0f}); "
            f"latest step {latest_step(d)}; losses "
            f"{[round(v, 4) for v in losses]}")
    first = runs[0].metrics
    means = [np.mean([r["loss"] for r in first if r["round"] == e])
             for e in range(STREAM_EPOCHS)]
    if not means[-1] < means[0]:
        raise AssertionError(f"train LM streaming: epoch means {means}")
    step_s = float(np.median([r["step_time_s"] for r in first]))

    mgr = CheckpointManager(d)
    step = mgr.latest_step()
    snapshot = os.path.join(d, str(step), "state.pt")
    nbytes = os.path.getsize(snapshot)
    t0 = time.perf_counter()
    state = mgr.restore()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(SCRATCH, "resave")).save(step, state)
    save_s = time.perf_counter() - t0
    del state
    log(f"train LM streaming: snapshot of step {step} {nbytes / 2**20:,.1f} "
        f"MiB (params, AdamW moments, step); save {save_s:.2f} s, restore "
        f"{restore_s:.2f} s (local disk, host clock)")

    # One chunk boundary under the profiler: chunk 1's upload against
    # chunk 0's steps.
    trace = upload_trace(torch, lambda: train_distributed_streaming(
        payload, x[:2 * STREAM_CHUNK], labels=y[:2 * STREAM_CHUNK],
        chunk_rows=STREAM_CHUNK, mini_batch=STREAM_MB, seed=6,
        device="cuda"))
    log(f"train LM streaming, one chunk boundary traced: {trace}")
    if not trace["overlapped"] or set(trace["copy_streams"]) & set(
            trace["compute_streams"]):
        raise AssertionError("train LM streaming: no chunk upload on a side "
                             "stream overlapped the steps")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(os.path.join(SCRATCH, "resave"), ignore_errors=True)
    torch.cuda.empty_cache()
    return total, dict(step_ms=step_s * 1e3,
                       tokens_per_s=STREAM_MB * LM_SEQ / step_s,
                       resident_tokens_per_s=resident_tokens_per_s,
                       epoch_mean_losses=[float(m) for m in means],
                       snapshot_bytes=nbytes, save_s=save_s,
                       restore_s=restore_s, upload_trace=trace)


def train_lm_resume_phase(torch):
    """SparkTorch.fit of the LM with checkpointDir: 6 steps straight
    against 3 steps and a resume of 3, on the same seeded weights."""
    from sparktorch_tpu_torch import SparkTorch
    from sparktorch_tpu_torch.utils.checkpoint import latest_step

    payload = lm_payload(torch, 0)
    x, y = lm_ids(LM_BATCH, 7)
    frame = {"features": list(x), "label": list(y)}
    total = {}

    def fit(iters, d, resume=False):
        nonlocal total
        est = SparkTorch(inputCol="features", labelCol="label",
                         torchObj=payload, iters=iters, device="cuda",
                         checkpointDir=d, checkpointEvery=RESUME_EVERY,
                         resume=resume)
        reset_counts()
        model = est.fit(frame)
        counts = read_counts()
        expect_counts(f"train LM resume ({iters} steps"
                      f"{', resumed' if resume else ''})", counts,
                      lm_step_counts(iters))
        total = add_up(total, counts)
        losses = [r["loss"] for r in est._last_metrics]
        if not np.isfinite(losses).all():
            raise AssertionError(f"train LM resume: losses {losses}")
        return model.getModel().params, losses

    straight_dir = os.path.join(SCRATCH, "straight")
    split_dir = os.path.join(SCRATCH, "split")
    half = RESUME_ITERS // 2
    straight, straight_losses = fit(RESUME_ITERS, straight_dir)
    _, first_losses = fit(half, split_dir)
    t0 = time.perf_counter()
    resumed, resumed_losses = fit(half, split_dir, resume=True)
    resumed_s = time.perf_counter() - t0
    if latest_step(split_dir) != RESUME_ITERS or latest_step(
            straight_dir) != RESUME_ITERS:
        raise AssertionError("train LM resume: latest steps "
                             f"{latest_step(straight_dir)}, "
                             f"{latest_step(split_dir)}")
    diff = max(float((resumed[k].float() - v.float()).abs().max())
               for k, v in straight.items())
    scale = max(float(v.float().abs().max()) for v in straight.values())
    identical = all(torch.equal(resumed[k], v) for k, v in straight.items())
    log(f"train LM resume: straight losses "
        f"{[round(v, 6) for v in straight_losses]}, split "
        f"{[round(v, 6) for v in first_losses + resumed_losses]}; largest "
        f"parameter difference {diff:.3e} (limit {1e-6 * scale:.3e} = 1e-6 x "
        f"max|param| {scale:.3f}); bit for bit: {identical}; the resumed "
        f"fit took {resumed_s:.2f} s (restore, 3 steps, snapshot)")
    if diff > 1e-6 * scale:
        raise AssertionError("train LM resume: resumed parameters differ "
                             "from the straight run's")
    shutil.rmtree(straight_dir, ignore_errors=True)
    shutil.rmtree(split_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return total, dict(max_param_diff=diff, max_abs_param=scale,
                       bitwise=identical, straight_losses=straight_losses,
                       split_losses=first_losses + resumed_losses)


# ---------------------------------------------------------------------------
# The vision and hogwild paths: no kernel of KERNELS lies on them (their
# convolutions, BatchNorm and dense layers are cuDNN/cuBLAS calls).
# ---------------------------------------------------------------------------

NO_KERNELS = dict.fromkeys(KERNELS, 0)


def quickstart_phase(torch):
    """README.md's quick start on the card as written, then BASELINE
    config 2 (the lazily packaged MnistCNN)."""
    from sparktorch_tpu_torch import (
        Pipeline,
        SparkTorch,
        serialize_torch_obj,
        serialize_torch_obj_lazy,
    )
    from sparktorch_tpu_torch.models import MnistCNN, MnistMLP

    rng = np.random.default_rng(0)
    x = rng.random((QUICK_ROWS, 784), dtype=np.float32)
    y = rng.integers(0, 10, QUICK_ROWS)
    df = {"features": list(x), "label": y.astype(np.float32)}
    torch.manual_seed(0)
    torch_obj = serialize_torch_obj(
        MnistMLP(), criterion="cross_entropy",
        optimizer="adam", optimizer_params={"lr": 1e-3},
        input_shape=(784,),
    )
    est = SparkTorch(inputCol="features", labelCol="label",
                     predictionCol="predictions", torchObj=torch_obj,
                     iters=QUICK_ITERS, miniBatch=QUICK_MB,
                     validationPct=0.1, earlyStopPatience=10)
    reset_counts()
    t0 = time.perf_counter()
    model = Pipeline(stages=[est]).fit(df)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = model.transform(df)["predictions"]
    transform_s = time.perf_counter() - t0
    expect_counts("quick start", read_counts(), NO_KERNELS)
    records = est._last_metrics
    losses = [r["loss"] for r in records]
    if not np.isfinite(losses + [r["val_loss"] for r in records]).all():
        raise AssertionError(f"quick start: losses {losses}")
    if preds.shape != (QUICK_ROWS,) or not np.isin(preds, range(10)).all():
        raise AssertionError(f"quick start: predictions {preds[:8]}")
    step_ms = 1e3 * float(np.median([r["step_time_s"] for r in records]))
    log(f"quick start: MnistMLP {len(records)} steps of {QUICK_MB} rows "
        f"(stop at {len(records)} of {QUICK_ITERS}), loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; median step {step_ms:.2f} ms (each step reads "
        f"its loss and val_loss back); fit {fit_s:.2f} s; transform "
        f"{QUICK_ROWS} rows in {transform_s:.3f} s = "
        f"{QUICK_ROWS / transform_s:,.0f} rows/s")

    payload = serialize_torch_obj_lazy(
        MnistCNN, criterion="cross_entropy", optimizer="adam",
        optimizer_params={"lr": 1e-3}, input_shape=(784,))
    xc = rng.normal(0, 1, (CNN_ROWS, 784)).astype(np.float32)
    yc = rng.integers(0, 10, CNN_ROWS).astype(np.float32)
    frame = {"features": list(xc), "label": yc}
    _, cnn_records, counts, wall = fit(torch, payload, frame, CNN_ITERS,
                                       "lazy MnistCNN", NO_KERNELS)
    cnn_ms = 1e3 * cnn_records[0]["step_time_s"]
    log(f"lazy MnistCNN: {CNN_ITERS} full-batch steps of {CNN_ROWS} rows, "
        f"losses {[round(r['loss'], 4) for r in cnn_records]}; step "
        f"{cnn_ms:.2f} ms = {CNN_ROWS / cnn_ms * 1e3:,.0f} examples/s "
        f"(fit wall {wall:.2f} s)")
    return counts, dict(steps=len(records), step_ms=step_ms,
                        transform_rows_per_s=QUICK_ROWS / transform_s,
                        cnn_step_ms=cnn_ms,
                        cnn_examples_per_s=CNN_ROWS / cnn_ms * 1e3)


def patterned_rows(n, shape, scale, seed=0):
    """``n`` rows of ``shape`` in 10 classes: seeded noise plus ``scale``
    times a fixed seeded pattern per class, so that training learns."""
    rng = np.random.default_rng(seed)
    patterns = rng.normal(0, 1, (10, *shape)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = rng.normal(0, 1, (n, *shape)).astype(np.float32)
    x += scale * patterns[y]
    return x, y


def cifar_like(n, seed=0):
    """CIFAR-10 shapes (NHWC 32x32x3, 10 classes) that a few hundred
    steps learn."""
    return patterned_rows(n, (32, 32, 3), 0.5, seed)


def check_hogwild(leg, metrics, summary, falls):
    """Hold one hogwild run: every loss finite, applies == pushes, and
    (where ``falls``) the last window's mean loss below the first's."""
    from sparktorch_tpu_torch.bench import steady_examples_per_s

    losses = [r["loss"] for r in sorted(metrics,
                                        key=lambda r: (r["t"], r["iter"]))]
    budget = summary["hogwild_budget"]
    applied = summary["server_applied"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"hogwild {leg}: losses {losses}")
    if applied != budget["pushes"]:
        raise AssertionError(f"hogwild {leg}: {applied} applies, "
                             f"{budget['pushes']} pushes")
    window = HW_PUSH * 2
    first, last = np.mean(losses[:window]), np.mean(losses[-window:])
    if falls and not last < first:
        raise AssertionError(f"hogwild {leg}: loss did not fall "
                             f"({first:.4f} -> {last:.4f})")
    rate = steady_examples_per_s(metrics, HW_MB)
    per_worker = ", ".join(
        f"w{p['worker']} pull {p['pull_s']:.3f} s + place "
        f"{p['pull_place_s']:.3f} s, push {p['push_materialize_s']:.3f} + "
        f"{p['push_wire_s']:.3f} s of {p['loop_s']:.2f} s"
        for p in sorted(summary["hogwild_phases"], key=lambda p: p["worker"]))
    log(f"hogwild {leg}: {len(losses)} iterations, {applied} applies == "
        f"{int(budget['pushes'])} pushes (server apply host time "
        f"{summary['server_apply_s']:.3f} s), loss {first:.4f} -> "
        f"{last:.4f}; {rate:,.0f} examples/s steady; {per_worker}")
    return dict(examples_per_s=rate, applies=applied,
                pushes=int(budget["pushes"]), first_loss=float(first),
                last_loss=float(last),
                pull_bytes=int(budget["pull_bytes"]),
                push_bytes=int(budget["push_bytes"]))


def median_of(leg, runs):
    """The median run of ``runs`` by examples/s, with every run's rate
    and the spread (max - min) / median."""
    rates = sorted(r["examples_per_s"] for r in runs)
    med = sorted(runs, key=lambda r: r["examples_per_s"])[len(runs) // 2]
    spread = 100 * (rates[-1] - rates[0]) / med["examples_per_s"]
    log(f"{leg}: median {med['examples_per_s']:,.0f} examples/s over "
        f"{len(runs)} runs {[round(r) for r in rates]}, spread "
        f"{spread:.1f}%")
    return dict(med, rates=rates, spread_pct=spread)


def add_counts(total, path):
    """Read the counts after one run of ``path``, hold them at 0 and add
    them into ``total``."""
    got = read_counts()
    expect_counts(path, got, NO_KERNELS)
    return {k: total.get(k, 0) + v for k, v in got.items()}


def hogwild_iteration_profile(torch, payload, x, y):
    """One steady-state leg-(a) iteration under torch.profiler: a pull,
    a push_every-step gradient window, the push and the server's apply,
    on a server and worker already warmed by one iteration."""
    import copy as _copy

    from sparktorch_tpu_torch.serve.param_server import ParameterServer
    from sparktorch_tpu_torch.train import hogwild
    from sparktorch_tpu_torch.utils.data import DataBatch

    server = ParameterServer(payload, device="cuda")
    try:
        transport = hogwild.LocalTransport(server)
        spec = server.spec
        module = _copy.deepcopy(spec.make_module()).cuda().eval()
        shard = DataBatch(torch.from_numpy(x), torch.from_numpy(y).long(),
                          torch.ones(len(x))).to("cuda")
        loss_fn = spec.loss_fn()
        windows = hogwild.make_grad_windows(loss_fn, HW_MB, HW_PUSH, HW_PUSH)

        def iteration():
            errors = []
            hogwild._worker_loop(0, transport, module, None, shard, None,
                                 HW_PUSH, 0, False, 0, [], errors, HW_PUSH,
                                 None, windows)
            if errors:
                raise errors[0]
            server.drain()

        iteration()
        torch.cuda.synchronize()
        return profile_pass(torch, "one hogwild ResNet-18 iteration "
                            f"(pull, {HW_PUSH} grad steps, push, apply)",
                            iteration)
    finally:
        server.stop()


def hogwild_scrape(torch, payload, tele, summary):
    """Leg (c)'s bus served on ``GET /metrics`` by a parameter server
    started on it after the run: the scrape parses to the values of the
    bus's JSONL dump, and the server's applies equal the workers'
    pushes and the summary's."""
    import urllib.request

    from sparktorch_tpu_torch.obs import (
        parse_prometheus,
        read_jsonl,
        render_prometheus,
    )
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )

    server = ParameterServer(payload, telemetry=tele, device="cuda")
    http = ParamServerHttp(server, port=0).start()
    try:
        with urllib.request.urlopen(http.url + "/metrics", timeout=30) as r:
            scraped = parse_prometheus(r.read().decode())
    finally:
        http.stop()
        server.stop()
    path = os.path.join(SCRATCH, "hogwild_http.jsonl")
    snap = tele.dump(path)
    (line,) = read_jsonl(path)
    os.remove(path)
    dumped = parse_prometheus(render_prometheus(line))
    if scraped != dumped:
        diff = sorted(k for k in set(scraped) | set(dumped)
                      if scraped.get(k) != dumped.get(k))
        raise AssertionError(f"hogwild (c): /metrics differs from the dump "
                             f"at {diff[:8]}")
    counters = snap["counters"]
    pushes = sum(v for k, v in counters.items()
                 if k.startswith("hogwild.pushes"))
    applies = counters["param_server.applies"]
    if not applies == pushes == summary["hogwild_budget"]["pushes"]:
        raise AssertionError(f"hogwild (c): {applies} applies, {pushes} "
                             f"pushes on the bus, summary "
                             f"{summary['hogwild_budget']['pushes']}")
    log(f"hogwild (c) /metrics: {len(scraped)} series equal to the dump; "
        f"param_server.applies {applies:.0f} == hogwild.pushes "
        f"{pushes:.0f}; http_requests "
        f"{ {k: v for k, v in counters.items() if 'http_requests' in k} }")
    return dict(series=len(scraped), applies=applies, pushes=pushes)


def hogwild_phase(torch, bench_rec):
    """BASELINE config 3: ResNet-18 through the parameter server, in
    three legs, and the sync trainer at the same minibatch, each on
    learnable CIFAR-shaped rows and held to its checks: (a) local, 1
    worker; (b) ``SparkTorch(mode="hogwild", partitions=4)`` with
    ``transform``; (c) binary HTTP, bf16 pushes, 2 workers; (d)
    ``train_distributed`` with minibatch sampling. Leg (a)'s rate is the
    bench's ``resnet18_hogwild`` record (phase ``bench``), which times
    that workload at the JAX bench's depth; the other legs' rates are
    their own runs'. Profiles one leg-(a) iteration. Returns the kernel
    counts of each leg's runs and the numbers."""
    from sparktorch_tpu_torch import SparkTorch, serialize_torch_obj
    from sparktorch_tpu_torch.models import resnet18
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.hogwild import train_async
    from sparktorch_tpu_torch.train.sync import train_distributed

    x, y = cifar_like(HW_ROWS)
    torch.manual_seed(3)
    kw = dict(criterion="cross_entropy", optimizer="sgd",
              optimizer_params={"lr": 1e-2})
    payload = serialize_torch_obj(resnet18(num_classes=10), **kw,
                                  input_shape=(32, 32, 3))
    common = dict(labels=y, mini_batch=HW_MB, push_every=HW_PUSH,
                  device="cuda")
    train_async(payload, x, iters=2 * HW_PUSH, partitions=1, **common)
    train_distributed(payload, x, labels=y, iters=8, mini_batch=HW_MB,
                      device="cuda", steps_per_call=8)
    torch.cuda.synchronize()

    reset_counts()
    result = train_async(payload, x, iters=HW_ITERS["local"], partitions=1,
                         **common)
    counts = {"hogwild_local": add_counts({}, "hogwild (a) local")}
    local = check_hogwild("(a) local, 1 worker", result.metrics,
                          result.summary, falls=True)
    out = {"local": dict(local, examples_per_s=bench_rec[
        "examples_per_sec_per_chip"], rates=bench_rec["repeat_rates"],
        spread_pct=bench_rec["repeat_spread_pct"]),
        "hogwild_over_sync": bench_rec["async_efficiency_vs_sync"]}
    log(f"hogwild (a) rate: {out['local']['examples_per_s']:,.0f} "
        f"examples/s (bench resnet18_hogwild, median of "
        f"{bench_rec['repeat_rates']}; over its sync twin "
        f"{bench_rec['async_efficiency_vs_sync']})")

    reset_counts()
    window = 2 * HW_PUSH
    sync = train_distributed(payload, x, labels=y, iters=HW_ITERS["sync"],
                             mini_batch=HW_MB, device="cuda",
                             steps_per_call=8)
    counts["sync_resnet18"] = add_counts({}, "sync ResNet-18 (d)")
    sync_losses = [r["loss"] for r in sync.metrics]
    first = float(np.mean(sync_losses[:window]))
    last = float(np.mean(sync_losses[-window:]))
    if not (np.isfinite(sync_losses).all() and last < first):
        raise AssertionError(f"sync ResNet-18: losses {sync_losses}")
    step_s = float(np.median([r["step_time_s"] for r in sync.metrics[8:]]))
    out["sync"] = dict(examples_per_s=HW_MB / step_s, step_ms=1e3 * step_s,
                       first_loss=first, last_loss=last)
    log(f"sync ResNet-18 (d): train_distributed, {len(sync_losses)} steps of "
        f"{HW_MB} sampled from {HW_ROWS} rows, median step "
        f"{1e3 * step_s:.2f} ms = {HW_MB / step_s:,.0f} examples/s; loss "
        f"{first:.4f} -> {last:.4f}")

    flat = serialize_torch_obj(resnet18(num_classes=10, input_hw=(32, 32, 3)),
                               **kw, input_shape=(32 * 32 * 3,))
    frame = {"features": x.reshape(HW_ROWS, -1), "label": y.astype(np.float32)}
    est_runs = []
    for rep in range(HW_EST_REPEATS):
        est = SparkTorch(inputCol="features", labelCol="label",
                         torchObj=flat, mode="hogwild", partitions=4,
                         iters=HW_ITERS["estimator"], miniBatch=HW_MB,
                         pushEvery=HW_PUSH, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        fitted = est.fit(frame)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds = fitted.setDevice("cuda").transform(frame)["predictions"]
        transform_s = time.perf_counter() - t0
        counts["hogwild_estimator"] = add_counts(
            counts.get("hogwild_estimator", {}), "hogwild (b) estimator")
        state = fitted.getModel().params
        if not any(k.endswith("running_var") for k in state):
            raise AssertionError("hogwild (b): the fitted state has no BN "
                                 "buffers")
        if preds.shape != (HW_ROWS,) or not np.isin(preds, range(10)).all():
            raise AssertionError(f"hogwild (b): predictions {preds[:8]}")
        if len(est._last_metrics) != 4 * HW_ITERS["estimator"]:
            raise AssertionError(f"hogwild (b): {len(est._last_metrics)} "
                                 "losses")
        run = check_hogwild(
            f"(b) SparkTorch(mode='hogwild', partitions=4).fit, run {rep}",
            est._last_metrics, est._last_summary, falls=True)
        run.update(fit_s=fit_s, transform_rows_per_s=HW_ROWS / transform_s)
        log(f"hogwild (b) run {rep}: fit {fit_s:.2f} s; transform {HW_ROWS} "
            f"rows {HW_ROWS / transform_s:,.0f} rows/s")
        est_runs.append(run)
    out["estimator"] = median_of("hogwild (b) estimator, 4 workers", est_runs)

    tele = Telemetry(run_id="hogwild_http")
    reset_counts()
    result = train_async(payload, x, iters=HW_ITERS["http"], partitions=2,
                         transport="http", wire="binary", quant="bf16",
                         telemetry=tele, **common)
    counts["hogwild_http"] = add_counts({}, "hogwild (c) http")
    out["http"] = check_hogwild("(c) binary HTTP, bf16 pushes, 2 workers",
                                result.metrics, result.summary, falls=False)
    out["http"]["scrape"] = hogwild_scrape(torch, payload, tele,
                                           result.summary)

    out["profile"] = hogwild_iteration_profile(torch, payload, x[:HW_MB * 2],
                                               y[:HW_MB * 2])
    torch.cuda.empty_cache()
    return counts, out


def roughen_batchnorm(torch, module, seed):
    """Seeded BatchNorm scales and running variances in [0.5, 1.5] and
    running means N(0, 0.1²): no residual branch is zeroed out."""
    from sparktorch_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))


def serve_resnet50_phase(torch):
    """BASELINE config 5's model served by SparkTorchModel.transform."""
    import copy as _copy

    from sparktorch_tpu_torch import BatchPredictor, create_spark_torch_model
    from sparktorch_tpu_torch.models import resnet50

    torch.manual_seed(5)
    module = resnet50(input_hw=R50_HW)
    roughen_batchnorm(torch, module, 5)
    stm = create_spark_torch_model(module, inputCol="features",
                                   predictionCol="predicted").setDevice("cuda")
    x = np.random.default_rng(5).standard_normal(
        (R50_ROWS, int(np.prod(R50_HW))), dtype=np.float32)
    stm.transform({"features": x[:CHUNK]})  # weights to the card, warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    preds = stm.transform({"features": x})["predicted"]
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("serve ResNet-50", counts, NO_KERNELS)
    if preds.shape != (R50_ROWS,) or not np.isin(preds, range(1000)).all():
        raise AssertionError(f"serve ResNet-50: predictions {preds[:8]}")
    log(f"serve ResNet-50 (bf16, 224x224x3, 1000 classes): transform "
        f"{R50_ROWS} rows in {wall:.3f} s = {R50_ROWS / wall:,.1f} rows/s "
        f"(host clock, H2D of {x.nbytes / 2**30:.2f} GiB included)")

    served = stm._predictor()
    got = served.predict(x[:CHUNK])
    f32 = _copy.deepcopy(served.module)
    f32.compute_dtype = torch.float32
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = BatchPredictor(f32, device="cuda", chunk=CHUNK).predict(
            x[:CHUNK])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    diff = float(np.abs(got - want).max())
    limit = 5e-2 * max(1.0, float(np.abs(want).max()))
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    log(f"serve ResNet-50: bf16 vs f32 logits max abs diff {diff:.3e} "
        f"(limit {limit:.3e}, max |logit| {np.abs(want).max():.3f}); argmax "
        f"agreement {100 * agree:.2f}%")
    if not np.isfinite(got).all() or diff > limit:
        raise AssertionError("serve ResNet-50: bf16 disagrees with f32")
    del f32
    profile = profile_pass(torch, "one served ResNet-50 chunk of 1024 rows",
                           lambda: served.predict(x[:CHUNK]))
    torch.cuda.empty_cache()
    return counts, dict(rows_per_s=R50_ROWS / wall, max_abs_diff=diff,
                        argmax_agreement=agree, profile=profile)


def pin_and_upload_ms(torch, arr):
    """Host milliseconds to copy ``arr`` into page-locked memory (twice:
    the first allocates, the second reuses torch's cached block) and
    device milliseconds of its host→device copy (CUDA events)."""
    pin = []
    for _ in range(2):
        t0 = time.perf_counter()
        pinned = torch.from_numpy(arr).pin_memory()
        pin.append((time.perf_counter() - t0) * 1e3)
    up = time_ms(torch, lambda: pinned.to("cuda", non_blocking=True), 5)
    return dict(mib=arr.nbytes / 2**20, pin_first_ms=pin[0],
                pin_again_ms=pin[1], h2d_ms=up,
                h2d_gb_per_s=arr.nbytes / up / 1e6)


def check_agreement(what, got, want):
    """Share of equal argmaxes; at least 99.9% (two runs of one bf16
    model may take other cuDNN kernels for a convolution)."""
    agree = float((got == want).mean())
    log(f"serve ResNet-50 stream vs {what}: argmax agreement "
        f"{100 * agree:.3f}% of {len(want)} rows")
    if agree < 0.999:
        raise AssertionError(f"serve ResNet-50 stream disagrees with {what}")
    return agree


def serve_resnet50_stream_phase(torch, transform_rows_per_s):
    """BASELINE config 5's path: the seeded bf16 ResNet-50 over a Parquet
    file of uint8 rows, normalised and argmaxed on the card."""
    from sparktorch_tpu_torch import BatchPredictor, inference
    from sparktorch_tpu_torch.models import resnet50

    import pyarrow

    log(f"serve ResNet-50 stream: pyarrow {pyarrow.__version__}")
    torch.manual_seed(5)
    module = resnet50(input_hw=R50_HW)
    roughen_batchnorm(torch, module, 5)
    row = int(np.prod(R50_HW))
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 256, (R50_STREAM_ROWS, row), dtype=np.uint8)
    path = os.path.join(SCRATCH, "rows.parquet")
    t0 = time.perf_counter()
    written = inference.write_rows_parquet(
        path, (raw[i:i + CHUNK] for i in range(0, R50_STREAM_ROWS, CHUNK)),
        rows_per_group=CHUNK)
    write_s = time.perf_counter() - t0
    log(f"serve ResNet-50 stream: wrote {written} rows x {row} uint8 "
        f"({os.path.getsize(path) / 2**30:.2f} GiB) in {write_s:.2f} s")

    def normalise(t):
        return t.float() / 255

    def argmax(y):
        return y.argmax(-1)

    # The reader alone: the Parquet pull and decode of every batch, no
    # pinning, no card.
    read_only = []
    for _ in range(2):
        t0 = time.perf_counter()
        n = sum(b.shape[0] for b in inference.parquet_batches(
            path, (row,), np.uint8, batch_rows=CHUNK))
        read_only.append(n / (time.perf_counter() - t0))
    log(f"serve ResNet-50 stream: the Parquet reader alone "
        f"{[round(r, 1) for r in read_only]} rows/s (two passes, one "
        f"thread, host clock)")

    pred = BatchPredictor(module, device="cuda", chunk=CHUNK,
                          preprocess=normalise, postprocess=argmax)
    pred.predict(raw[:CHUNK])  # weights to the card, warm-up
    torch.cuda.synchronize()
    counts, legs = {}, {}
    preds = None
    for device_outputs in (False, True):
        outs = []
        reset_counts()
        t0 = time.perf_counter()
        stats = inference.stream_parquet_predict(
            pred, path, row_shape=(row,), dtype=np.uint8, drain=outs.append,
            device_outputs=device_outputs)
        got = (torch.cat(outs).cpu().numpy() if device_outputs
               else np.concatenate(outs))
        synced_s = time.perf_counter() - t0
        counts = add_counts(counts, "serve ResNet-50 stream")
        if stats["n_rows"] != R50_STREAM_ROWS or got.shape != (
                R50_STREAM_ROWS,):
            raise AssertionError(f"serve ResNet-50 stream: {stats}, "
                                 f"predictions {got.shape}")
        if preds is not None:
            check_agreement("device_outputs", got, preds)
        preds = got
        leg = dict(stats, rows_per_sec_synced=R50_STREAM_ROWS / synced_s)
        legs["device_outputs" if device_outputs else "host_outputs"] = leg
        log(f"serve ResNet-50 stream (device_outputs={device_outputs}): "
            f"{stats}; {R50_STREAM_ROWS / synced_s:,.1f} rows/s to the last "
            f"prediction on the host")

    # The same rows as float32 on the host (x / 255 there), through the
    # same bf16 model: the f32-input host path, 4x the upload bytes.
    f32 = BatchPredictor(module, device="cuda", chunk=CHUNK,
                         postprocess=argmax)
    reset_counts()
    want, busy = [], 0.0
    for i in range(0, R50_STREAM_ROWS, CHUNK):
        part = raw[i:i + CHUNK].astype(np.float32) / 255
        t0 = time.perf_counter()
        want.append(f32.predict(part))
        busy += time.perf_counter() - t0
    want = np.concatenate(want)
    counts = add_counts(counts, "serve ResNet-50 f32 host path")
    agree = check_agreement("the f32-input host path", preds, want)
    log(f"serve ResNet-50 stream: the f32-input host path "
        f"{R50_STREAM_ROWS / busy:,.1f} rows/s in predict (f32 rows made "
        f"outside the clock); transform {transform_rows_per_s:,.1f} rows/s")

    # Device-resident rate (the JAX bench's chip_rate): rows on the card.
    dev = torch.from_numpy(raw).cuda()
    pred.predict(dev[:CHUNK])
    torch.cuda.synchronize()
    resident = {}
    for name, fn in (("predict", lambda: pred.predict(dev)),
                     ("predict_device", lambda: pred.predict_device(dev))):
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            rates.append(R50_STREAM_ROWS / (time.perf_counter() - t0))
        check_agreement(f"device-resident {name}",
                        out.cpu().numpy() if isinstance(out, torch.Tensor)
                        else out, preds)
        resident[name] = max(rates)
        log(f"serve ResNet-50 device-resident {name}: "
            f"{[round(r, 1) for r in rates]} rows/s (best of 3)")
    del dev

    # Where the upload time goes: pinning and copying one chunk.
    h2d = {"uint8": pin_and_upload_ms(torch, raw[:CHUNK]),
           "float32": pin_and_upload_ms(
               torch, raw[:CHUNK].astype(np.float32) / 255)}
    for kind, m in h2d.items():
        log(f"serve ResNet-50 chunk upload, {kind} ({m['mib']:.1f} MiB): pin "
            f"{m['pin_first_ms']:.1f} ms first, {m['pin_again_ms']:.1f} ms "
            f"again (host clock); pinned H2D {m['h2d_ms']:.2f} ms = "
            f"{m['h2d_gb_per_s']:.1f} GB/s (CUDA events)")
    pinned = torch.from_numpy(raw[:CHUNK]).pin_memory()
    profile = profile_pass(torch, "one streamed ResNet-50 chunk of 1024 "
                           "pinned uint8 rows", lambda: pred.predict(pinned))
    counts = add_counts(counts, "serve ResNet-50 stream (profiled)")

    # A live weight swap: fresh seeded weights change the predictions.
    torch.manual_seed(55)
    other = resnet50(input_hw=R50_HW)
    roughen_batchnorm(torch, other, 55)
    pred.update_params(other.state_dict())
    swapped = pred.predict(raw[:CHUNK])
    changed = float((swapped != preds[:CHUNK]).mean())
    log(f"serve ResNet-50 update_params: {100 * changed:.1f}% of "
        f"{CHUNK} argmaxes changed with the new weights")
    if changed == 0.0:
        raise AssertionError("serve ResNet-50: update_params changed nothing")
    os.remove(path)
    del pred, f32, other
    torch.cuda.empty_cache()
    return counts, dict(legs=legs, read_only_rows_per_s=read_only,
                        argmax_agreement=agree,
                        f32_host_rows_per_s=R50_STREAM_ROWS / busy,
                        transform_rows_per_s=transform_rows_per_s,
                        resident_rows_per_s=resident, h2d=h2d,
                        update_params_changed=changed, write_s=write_s,
                        profile=profile)


def bench_counts(name, rec):
    """The launches each bench config must make: 8/4/4/1/1 per LM step
    (the 2k dense leg: the CE kernels only), 12/12/12/0/0 per BERT-base
    step, 0/0/0/1/1 per step of either ``moe_lm`` leg (dense attention),
    none elsewhere."""
    if name == "moe_lm":
        steps = rec["steps_run"] + rec["steps_run_dense"]
        return dict(NO_KERNELS, ce_fwd=steps, ce_bwd=steps)
    if name == "long_context_lm":
        flash = rec["steps_run"] + rec["steps_run_at_2k"]["flash"]
        counts = lm_step_counts(flash)
        for ce in ("ce_fwd", "ce_bwd"):
            counts[ce] += rec["steps_run_at_2k"]["dense"]
        return counts
    if name == "bert_dp":
        n = 12 * rec["steps_run"]
        return dict(NO_KERNELS, flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n)
    return NO_KERNELS


def check_record_keys(bench, name, rec):
    jax_keys, omitted, added = bench.RECORD_KEYS[name]
    want = jax_keys - omitted
    if not want <= set(rec) or not set(rec) - want <= added:
        raise AssertionError(
            f"bench {name}: missing {sorted(want - set(rec))}, "
            f"unexpected {sorted(set(rec) - want - added)}")


def bench_hogwild_wire_dump(torch, bench):
    """``hogwild_wire`` at the JAX depth through the CLI's ``main`` with
    ``--telemetry-dump``: the record's keys, the dump's ``bench/*`` spans
    and the workers' counters on the process bus, no kernel launched."""
    import contextlib
    import io

    from sparktorch_tpu_torch.obs import Telemetry, read_jsonl, set_telemetry

    path = os.path.join(SCRATCH, "bench_telemetry.jsonl")
    set_telemetry(Telemetry(run_id="bench"))
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            bench.main(["--config", "hogwild_wire", "--telemetry-dump", path])
    finally:
        set_telemetry(None)
    wall = time.perf_counter() - t0
    got = read_counts()
    (rec,) = [json.loads(line) for line in buf.getvalue().splitlines()]
    rec.pop("ts"), rec.pop("device")
    log(json.dumps(rec))
    check_record_keys(bench, "hogwild_wire", rec)
    expect_counts("bench hogwild_wire", got, NO_KERNELS)
    (dump,) = read_jsonl(path)
    os.remove(path)
    spans, counters = dump["spans"], dump["counters"]
    phases = {k: spans[f"bench/{k}"]["count"]
              for k in ("data", "init", "compile_warmup", "measure")}
    for leg in ("dill", "binary"):
        if not (rec[leg]["pushes"] > 0 and np.isfinite(rec[leg]["final_loss"])
                and rec[leg]["push_wire_s_per_push"] > 0):
            raise AssertionError(f"bench hogwild_wire {leg}: {rec[leg]}")
    if (set(phases.values()) != {1} or counters["hogwild.rounds"] != 3
            or counters["param_server.applies"]
            != sum(v for k, v in counters.items()
                   if k.startswith("hogwild.pushes"))):
        raise AssertionError(f"bench hogwild_wire dump: spans {phases}, "
                             f"counters {counters}")
    log(f"bench hogwild_wire: {wall:.1f} s; --telemetry-dump: "
        f"{len(counters)} counters, spans {sorted(spans)}")
    return got, rec


def bench_phase(torch):
    """The configs of ``bench.CONFIGS`` (the port's benchmark entry; those
    of BENCH_DEPTH at a cut depth, the sync legs' span at BENCH_SPAN_S)
    but ``serve_online``, ``hogwild_ps_fleet`` and ``rpc_trace``, which
    their own phases run, and OBS_CONFIGS' other four (CPU tests only),
    each record printed on a line of its own and held to the JAX
    config's keys less the documented omissions, with the launches it
    made; ``hogwild_wire`` runs once through the CLI with
    ``--telemetry-dump``."""
    import gc

    from sparktorch_tpu_torch import bench

    records, counts = {}, {}
    counts["bench_hogwild_wire"], records["hogwild_wire"] = (
        bench_hogwild_wire_dump(torch, bench))
    span_s, bench.SYNC_SPAN_S = bench.SYNC_SPAN_S, BENCH_SPAN_S
    chaos = ("hogwild_chaos", "hogwild_chaos_soak", "gang_obs", "skew",
             "sharded_trace")
    configs = {k: v for k, v in bench.CONFIGS.items()
               if k not in ("serve_online", "hogwild_wire",
                            "hogwild_ps_fleet", "elastic_ctl", *chaos,
                            *OBS_CONFIGS)}
    for name, config in configs.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        rec = config(**BENCH_DEPTH.get(name, {}))
        wall = time.perf_counter() - t0
        got = read_counts()
        log(json.dumps(rec))
        check_record_keys(bench, name, rec)
        rate = rec["examples_per_sec_per_chip"]
        if not (np.isfinite(rate) and rate > 0):
            raise AssertionError(f"bench {name}: rate {rate}")
        if "final_loss" in rec and not np.isfinite(rec["final_loss"]):
            raise AssertionError(f"bench {name}: final loss "
                                 f"{rec['final_loss']}")
        expect_counts(f"bench {name}", got, bench_counts(name, rec))
        counts[f"bench_{name}"] = got
        records[name] = rec
        log(f"bench {name}: {wall:.1f} s")
    for name in chaos:
        # The JAX gates raise inside the config; no kernel runs (gang_obs
        # and elastic_ctl do no device work at all; skew's step is two
        # 768 x 768 matmul pairs; sharded_trace's tiny classifier runs
        # dense attention and the dense CE, in an NCCL world of one,
        # MeshConfig() as the JAX bench builds on an odd rig).
        reset_counts()
        t0 = time.perf_counter()
        rec = bench.CONFIGS[name](**BENCH_DEPTH.get(name, {}))
        wall = time.perf_counter() - t0
        got = read_counts()
        log(json.dumps(rec))
        check_record_keys(bench, name, rec)
        expect_counts(f"bench {name}", got, NO_KERNELS)
        counts[f"bench_{name}"] = got
        records[name] = rec
        log(f"bench {name}: {wall:.1f} s")
    bench.SYNC_SPAN_S = span_s
    if not 0 < records["bert_dp"]["mfu_honest"] < 1:
        raise AssertionError(f"bench bert_dp: mfu {records['bert_dp']}")
    moe = records["moe_lm"]
    if not (np.isfinite(moe["tokens_per_sec_per_chip"])
            and moe["moe_vs_dense_step_ratio"] > 0
            and moe["comm_budget"]["comm_s"] == 0
            and moe["comm_fraction"] == 0):
        raise AssertionError(f"bench moe_lm: {moe}")
    if records["resnet50_inference"]["stream_n_rows"] != 2048:
        raise AssertionError("bench resnet50_inference: streamed "
                             f"{records['resnet50_inference']['stream_n_rows']}"
                             " rows")
    return counts, records


def lint_wire_phase(torch):
    """19. The port's sparklint over the package and ``bench_wire`` at
    its defaults, each through its CLI's ``main`` in this process (a
    child's interpreter start and ``import torch`` cost ~10 s on the
    card's host); no kernel runs."""
    import contextlib
    import io

    from sparktorch_tpu_torch.lint import cli as lint_cli
    from sparktorch_tpu_torch.net import bench_wire

    package = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "sparktorch_tpu_torch")
    reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint_cli.main([package, "--json"])
    lint_wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"lint exited {rc}:\n{out.getvalue()[-4000:]}")
    doc = json.loads(out.getvalue())
    if doc["findings"] or doc["counts"] or doc["files_scanned"] <= 80:
        raise AssertionError(f"lint: {doc['files_scanned']} files, "
                             f"counts {doc['counts']}")
    log(f"lint: {doc['files_scanned']} files, {len(doc['rules'])} rules, "
        f"clean; analysis {doc['wall_s']} s, {lint_wall:.1f} s in all")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_wire.main([])
    wire_wall = time.perf_counter() - t0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"bench_wire: {json.dumps(row)}")
    if rc != 0 or not row["ok"]:
        raise AssertionError(f"bench_wire exited {rc}: {row}")
    got = read_counts()
    expect_counts("lint and wire", got, NO_KERNELS)
    return {"lint_wire": got}, {
        "lint": {"files": doc["files_scanned"], "rules": len(doc["rules"]),
                 "analysis_s": doc["wall_s"], "wall_s": round(lint_wall, 2)},
        "bench_wire": row, "bench_wire_wall_s": round(wire_wall, 2)}


def moe_card_parity(torch):
    """(a) A tiny f32 MoE LM at top-1 and top-2 on the card against the
    same weights on the CPU: the routing of its MoE layer equal, the
    logits within 1e-4·max(1, max|logit|), one SGD step's loss within
    1e-5 and its drop fraction equal; then the expert Function's
    gradients against autograd through the plain einsums on the card."""
    import torch.nn.functional as F

    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        TransformerConfig,
        expert_ffn,
        moe_group_partition,
    )
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.losses import resolve_loss

    ids = np.random.default_rng(11).integers(0, MOE_TINY["vocab_size"],
                                             (MOE_TINY_ROWS, 65))
    out = {}
    for k in (1, 2):
        cfg = TransformerConfig(moe_top_k=k, **MOE_TINY)
        torch.manual_seed(20 + k)
        models = {"cpu": CausalLM(cfg)}
        models["card"] = CausalLM(cfg)
        models["card"].load_state_dict(models["cpu"].state_dict())
        models["card"].cuda()
        logits, routes, steps = {}, {}, {}
        for where, model in models.items():
            dev = next(model.parameters()).device
            layer = model.backbone.layers[1].moe
            seen = {}
            hook = layer.register_forward_pre_hook(
                lambda mod, args: seen.setdefault("h", args[0]))
            x = torch.from_numpy(ids[:, :-1]).to(dev)
            with torch.no_grad():
                logits[where] = model(x).float().cpu()
                h = seen["h"]
                g, n_groups = moe_group_partition(cfg, h.shape[0] * h.shape[1])
                routes[where] = layer.route(h.reshape(n_groups, g, -1))[2].cpu()
            hook.remove()
            batch = DataBatch(x, torch.from_numpy(ids[:, 1:]).to(dev),
                              torch.ones(len(ids), device=dev))
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            m = train_step(model, resolve_loss("cross_entropy"), opt, batch)
            steps[where] = (float(m.loss), float(m.drop_fraction))
        flips = int((routes["card"] != routes["cpu"]).sum())
        diff = float((logits["card"] - logits["cpu"]).abs().max())
        limit = 1e-4 * max(1.0, float(logits["cpu"].abs().max()))
        loss_diff = abs(steps["card"][0] - steps["cpu"][0])
        log(f"moe (a) top-{k}: {routes['cpu'].numel()} routing choices, "
            f"{flips} differ card vs CPU; logits max abs diff {diff:.3e} "
            f"(limit {limit:.3e}); step loss card {steps['card'][0]:.6f} "
            f"CPU {steps['cpu'][0]:.6f} (diff {loss_diff:.2e}), drop "
            f"fraction {steps['card'][1]:.4f} / {steps['cpu'][1]:.4f}")
        if (flips or not diff <= limit or not loss_diff <= 1e-5
                or steps["card"][1] != steps["cpu"][1]):
            raise AssertionError(f"moe (a) top-{k}: the card disagrees with "
                                 "the CPU")
        out[f"top{k}"] = dict(routing_flips=flips, logits_max_abs_diff=diff,
                              limit=limit, loss_card=steps["card"][0],
                              loss_cpu=steps["cpu"][0],
                              drop_fraction=steps["card"][1])

    # The expert Function's backward against autograd through the plain
    # einsums of its forward, f32 on the card.
    n_groups, e, cap, d, f = 2, 4, 16, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)
                ).requires_grad_()

    args = [rand(n_groups, e, cap, d), rand(e, d, f, scale=d ** -0.5),
            rand(e, f, scale=0.1), rand(e, f, d, scale=f ** -0.5),
            rand(e, d, scale=0.1)]
    ct = torch.randn(n_groups, e, cap, d, device="cuda", generator=gen)
    got = torch.autograd.grad(expert_ffn(*args), args, ct)
    x, w_in, b_in, w_out, b_out = args
    z = torch.einsum("gecd,edf->gecf", x, w_in) + b_in[None, :, None]
    plain = (torch.einsum("gecf,efd->gecd", F.gelu(z, approximate="tanh"),
                          w_out) + b_out[None, :, None])
    want = torch.autograd.grad(plain, args, ct)
    errs = {}
    for name, a, b in zip(("x", "w_in", "b_in", "w_out", "b_out"), got, want):
        errs[name] = check_close(f"moe (a) expert grad {name}", a, b,
                                 1e-5, 1e-5)
    log(f"moe (a) expert Function gradients vs plain autograd (f32): max "
        f"abs err {max(errs.values()):.2e} (atol 1e-5, rtol 1e-5)")
    out["expert_grad_max_abs_err"] = max(errs.values())
    return out


def moe_lm_pieces(torch):
    """Device ms of one MoE layer's forward and of its pieces at the
    bench ``moe_lm``'s shape (CUDA events, bf16): the routing, the
    dispatch einsum, the experts, the two combine einsums."""
    from sparktorch_tpu_torch.models.transformer import (
        MoEFFN,
        TransformerConfig,
        expert_ffn,
        moe_group_partition,
    )

    cfg = TransformerConfig(max_len=MOE_SEQ, **MOE_LM)
    torch.manual_seed(0)
    layer = MoEFFN(cfg).cuda()
    dt = cfg.compute_dtype
    x = torch.randn(MOE_BATCH, MOE_SEQ, cfg.d_model, device="cuda",
                    dtype=dt)
    g, n_groups = moe_group_partition(cfg, MOE_BATCH * MOE_SEQ)
    e = cfg.n_experts
    cap = math.ceil(cfg.capacity_factor * g * cfg.moe_top_k / e)
    tokens = x.reshape(n_groups, g, -1)
    dispatch = torch.zeros(n_groups, g, e, cap, device="cuda", dtype=dt)
    gates = torch.rand(n_groups, g, 1, device="cuda", dtype=dt)
    disp = dispatch[:, :, None]
    expert_in = torch.randn(n_groups, e, cap, cfg.d_model, device="cuda",
                            dtype=dt)
    with torch.no_grad():
        pieces = {
            "layer_forward": time_ms(torch, lambda: layer(x), 10),
            "routing": time_ms(torch, lambda: layer.route(tokens), 10),
            "dispatch_einsum": time_ms(torch, lambda: torch.einsum(
                "gnec,gnd->gecd", dispatch, tokens), 10),
            "experts": time_ms(torch, lambda: expert_ffn(
                expert_in, layer.moe_w_in, layer.moe_b_in, layer.moe_w_out,
                layer.moe_b_out), 10),
            "combine_einsums": time_ms(torch, lambda: torch.einsum(
                "gnec,gecd->gnd", torch.einsum("gnk,gnkec->gnec", gates,
                                               disp), expert_in), 10),
        }
    log("moe_lm MoE layer forward at G=%d g=%d e=%d cap=%d d=%d d_ff=%d bf16 "
        "(CUDA events, ms): %s" % (n_groups, g, e, cap, cfg.d_model,
                                   cfg.d_ff, ", ".join(
                                       f"{k} {v:.3f}" for k, v in
                                       pieces.items())))
    del layer, x, dispatch, disp, expert_in
    torch.cuda.empty_cache()
    return pieces


def moe_fit(torch):
    """(b) The bench ``moe_lm``'s MoE LM at full width through
    ``SparkTorch(...).fit``: seeded weights, MOE_FIT_ITERS full-batch
    steps, the loss finite and falling, ``moe_drop_fraction`` in [0, 1]
    on every record, 1 CE forward and backward a step and no flash
    launch (dense attention); then one step under torch.profiler."""
    from sparktorch_tpu_torch import deserialize_model, serialize_torch_obj
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.models.transformer import TransformerConfig
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch

    cfg = TransformerConfig(max_len=MOE_SEQ, **MOE_LM)
    torch.manual_seed(31)
    payload = serialize_torch_obj(CausalLM(cfg), criterion="cross_entropy",
                                  optimizer="adamw",
                                  optimizer_params={"lr": 3e-4})
    ids = np.random.default_rng(31).integers(0, cfg.vocab_size,
                                             (MOE_BATCH, MOE_SEQ + 1))
    frame = {"features": list(ids[:, :-1].astype(np.float32)),
             "label": list(ids[:, 1:])}
    n = MOE_FIT_ITERS
    _, records, counts, wall = fit(torch, payload, frame, n, "moe (b) fit",
                                   dict(NO_KERNELS, ce_fwd=n, ce_bwd=n))
    losses = [r["loss"] for r in records]
    drops = [r.get("moe_drop_fraction") for r in records]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe (b): loss did not fall: {losses}")
    if not all(d is not None and 0.0 <= d <= 1.0 for d in drops):
        raise AssertionError(f"moe (b): drop fractions {drops}")
    step_s = records[0]["step_time_s"]
    log(f"moe (b) fit: CausalLM vocab={cfg.vocab_size} d_model="
        f"{cfg.d_model} layers={cfg.n_layers} d_ff={cfg.d_ff} experts="
        f"{cfg.n_experts} every {cfg.moe_every} top-{cfg.moe_top_k} s="
        f"{MOE_SEQ} batch {MOE_BATCH} {cfg.dtype}: {n} steps, losses "
        f"{[round(x, 4) for x in losses]}, drop fractions "
        f"{[round(d, 4) for d in drops]}; step {step_s * 1e3:.1f} ms = "
        f"{MOE_BATCH * MOE_SEQ / step_s:,.0f} tokens/s (fit wall {wall:.2f} "
        f"s)")
    spec = deserialize_model(payload)
    module = spec.make_module().cuda().train()
    opt = spec.make_optimizer(module.parameters())
    batch = DataBatch(torch.from_numpy(ids[:, :-1].astype(np.float32)),
                      torch.from_numpy(ids[:, 1:]),
                      torch.ones(MOE_BATCH)).to("cuda")
    loss_fn = spec.loss_fn()
    train_step(module, loss_fn, opt, batch)
    profile = profile_pass(torch, "one MoE LM training step (moe_lm)",
                           lambda: train_step(module, loss_fn, opt, batch))
    del module, opt, batch
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_s * 1e3,
                        tokens_per_s=MOE_BATCH * MOE_SEQ / step_s,
                        losses=losses, drop_fractions=drops, profile=profile)


def moe_route_flips(torch, a, b, x):
    """The routing choices that differ between two SequenceClassifiers'
    MoE layers on the ids ``x`` (each layer routing its own input)."""
    from sparktorch_tpu_torch.models.transformer import moe_group_partition

    routes = []
    for model in (a, b):
        seen = []
        hooks = [layer.moe.register_forward_pre_hook(
            lambda mod, args: seen.append((mod, args[0])))
            for layer in model.backbone.layers if layer.use_moe]
        with torch.no_grad():
            model(x)
        for h in hooks:
            h.remove()
        idx = []
        for mod, h in seen:
            g, n_groups = moe_group_partition(mod.config,
                                              h.shape[0] * h.shape[1])
            with torch.no_grad():
                idx.append(mod.route(h.reshape(n_groups, g, -1))[2])
        routes.append(torch.stack(idx))
    return int((routes[0] != routes[1]).sum()), routes[0].numel()


def moe_serve(torch):
    """(c) ``bert_base(n_experts=8, moe_every=2, attn_impl="flash")``,
    seeded, serving SLICE_ROWS × SLICE_SEQ ids through
    ``SparkTorchModel.transform``: rows/s, 12 forward launches a chunk,
    and MOE_SERVE_CHECK rows held to the same model with dense attention
    within the BERT serving check's 5e-2·max(1, max|logit|)."""
    from sparktorch_tpu_torch import BatchPredictor, create_spark_torch_model
    from sparktorch_tpu_torch.models import bert_base

    # 307M parameters: initialised on the card (on the host, truncated
    # normals of that size take tens of seconds), served as a user's
    # module is, with no payload round trip.
    torch.manual_seed(41)
    with torch.device("cuda"):
        module = bert_base(n_experts=8, moe_every=2, attn_impl="flash")
    cfg = module.config
    stm = create_spark_torch_model(module, inputCol="features",
                                   predictionCol="predicted").setDevice("cuda")
    ids = np.random.default_rng(41).integers(
        0, cfg.vocab_size, (SLICE_ROWS, SLICE_SEQ)).astype(np.float32)
    stm.transform({"features": ids[:CHUNK]})  # weights to the card, warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    preds = stm.transform({"features": ids})["predicted"]
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("moe (c) serve", counts, dict(
        NO_KERNELS, flash_fwd=cfg.n_layers * -(-SLICE_ROWS // CHUNK)))
    if len(preds) != SLICE_ROWS:
        raise AssertionError(f"moe (c): {len(preds)} predictions")
    rows_per_s = SLICE_ROWS / wall
    log(f"moe (c) serve: bert_base {cfg.n_experts} experts every "
        f"{cfg.moe_every} layers, flash: {SLICE_ROWS} rows x {SLICE_SEQ} ids "
        f"in {wall:.3f} s = {rows_per_s:,.1f} rows/s")

    with torch.device("cuda"):
        dense = bert_base(n_experts=8, moe_every=2, attn_impl="dense")
    dense.load_state_dict(stm.getModel().module.state_dict())
    x = ids[:MOE_SERVE_CHECK]
    got = np.stack(stm.transform({"features": x},
                                 {"useVectorOut": True})["predicted"])
    want = BatchPredictor(dense, device="cuda", chunk=CHUNK).predict(x)
    diff = float(np.abs(got - want).max())
    limit = 5e-2 * max(1.0, float(np.abs(want).max()))
    log(f"moe (c) serve: {MOE_SERVE_CHECK} rows flash vs dense max abs diff "
        f"{diff:.3e} (limit {limit:.3e})")
    if not (np.isfinite(got).all() and diff <= limit):
        flash_module = stm.getModel().module.cuda()
        flips, total = moe_route_flips(
            torch, flash_module, dense.cuda(),
            torch.from_numpy(x).cuda())
        log(f"moe (c) serve: {flips} of {total} routing choices differ "
            "between the flash and the dense model")
        raise AssertionError("moe (c): flash serving disagrees with dense")
    return counts, dict(rows_per_s=rows_per_s, max_abs_diff=diff,
                        limit=limit)


def moe_optimizers(torch):
    """(d) The optax-only optimizers (Adafactor, Lamb, Lion) and centered
    RMSprop, 3 full-batch MnistMLP steps each on the card against the
    same steps on the CPU: every parameter within 1e-5."""
    import copy

    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.losses import resolve_loss
    from sparktorch_tpu_torch.utils.serde import resolve_optimizer

    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.normal(0, 1, (256, 784)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 256))
    out = {}
    for name, kw in MOE_OPTIMIZERS:
        torch.manual_seed(51)
        models = {"cpu": MnistMLP()}
        models["card"] = copy.deepcopy(models["cpu"]).cuda()
        start = {n: p.detach().clone()
                 for n, p in models["cpu"].named_parameters()}
        for model in models.values():
            opt = resolve_optimizer(name, kw)(model.parameters())
            batch = DataBatch(x, y, torch.ones(256)).to(
                next(model.parameters()).device)
            for _ in range(3):
                train_step(model, resolve_loss("cross_entropy"), opt, batch)
        ref = dict(models["cpu"].named_parameters())
        diff = max(float((p.detach().cpu() - ref[n].detach()).abs().max())
                   for n, p in models["card"].named_parameters())
        moved = max(float((p.detach() - start[n]).abs().max())
                    for n, p in models["cpu"].named_parameters())
        log(f"moe (d) {name} {kw}: 3 MnistMLP steps moved a parameter by up "
            f"to {moved:.2e}; card vs CPU max abs diff {diff:.2e} (limit "
            f"1e-5)")
        if not (diff <= 1e-5 and moved > 1e-5):
            raise AssertionError(f"moe (d) {name}: card and CPU differ by "
                                 f"{diff:.2e}")
        out[name] = diff
    return out


def moe_phase(torch):
    """The MoE checks (a)–(d) (module docstring); each raises on a
    failure. Returns the launch counts of each path and the numbers."""
    marks = [time.perf_counter()]
    walls = {}

    def done(name):
        marks.append(time.perf_counter())
        walls[name] = marks[-1] - marks[-2]

    counts = {}
    reset_counts()
    parity = moe_card_parity(torch)
    counts["moe_parity"] = read_counts()
    expect_counts("moe (a) card steps", counts["moe_parity"],
                  dict(NO_KERNELS, ce_fwd=2, ce_bwd=2))
    done("a")
    pieces = moe_lm_pieces(torch)
    done("pieces")
    counts["moe_lm_fit"], lm = moe_fit(torch)
    done("b")
    counts["moe_serve"], serve = moe_serve(torch)
    done("c")
    reset_counts()
    optimizers = moe_optimizers(torch)
    counts["moe_optimizers"] = read_counts()
    expect_counts("moe (d) optimizers", counts["moe_optimizers"], NO_KERNELS)
    done("d")
    wall = marks[-1] - marks[0]
    log(f"moe phase: {wall:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + ")")
    return counts, dict(parity=parity, layer_pieces_ms=pieces, fit=lm,
                        serve=serve, optimizers=optimizers, wall_s=wall,
                        walls_s=walls)


def dp_data():
    rng = np.random.default_rng(7)
    return (rng.normal(0, 1, (DP_ROWS, 784)).astype(np.float32),
            rng.integers(0, 10, DP_ROWS).astype(np.int32))


def dp_fit(torch, optimizer, mesh=None):
    """MnistMLP from seeded weights, full batch, DP_STEPS steps on the
    card (over ``mesh`` when given): the losses and the parameters."""
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.train.sync import train_distributed

    torch.manual_seed(7)
    payload = serialize_torch_obj(
        MnistMLP(), criterion="cross_entropy", optimizer=optimizer,
        optimizer_params={"lr": 1e-3 if optimizer == "adam" else 0.1},
        input_shape=(784,))
    x, y = dp_data()
    result = train_distributed(payload, x, labels=y, iters=DP_STEPS,
                               device="cuda", mesh=mesh)
    return [r["loss"] for r in result.metrics], result.params


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_world_of_one(torch):
    """A world of one under NCCL on the card: ``train_distributed``
    over ``build_mesh()`` makes its all-reduce, and its Adam fit must
    equal the fit without a process group bit for bit. Returns the SGD
    fit of that world (the reference of :func:`dp_gloo_pair`) and what
    the trace saw of NCCL."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from sparktorch_tpu_torch.obs import xprof
    from sparktorch_tpu_torch.parallel.mesh import build_mesh

    plain = dp_fit(torch, "adam")
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = build_mesh()
        if mesh.batch_shards != 1 or mesh.batch_group is None:
            raise AssertionError(f"dp: mesh {mesh}")
        dp_fit(torch, "adam", mesh)  # NCCL's communicator comes up here
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            meshed = dp_fit(torch, "adam", mesh)
            torch.cuda.synchronize()
        sgd = dp_fit(torch, "sgd", mesh)
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "dp_world_of_one.pt.trace.json")
        prof.export_chrome_trace(trace)
        analysis = xprof.analyze_trace(trace)
    all_reduce_s = analysis.family_s().get("all_reduce", 0.0)
    if not all_reduce_s > 0:
        raise AssertionError(f"dp world of one: the analysed capture saw no "
                             f"all-reduce: {analysis.to_dict()['steps']}")
    events = [e for e in prof.events() if "nccl" in e.name.lower()]
    calls = sum("all_reduce" in e.name for e in events
                if e.device_type == torch.autograd.DeviceType.CPU)
    nccl = sorted({e.name for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA})
    if calls < DP_STEPS:
        raise AssertionError(f"dp world of one: {calls} nccl:all_reduce "
                             f"calls in {DP_STEPS} steps")
    if meshed[0] != plain[0]:
        raise AssertionError(f"dp world of one: losses {meshed[0]} != "
                             f"{plain[0]} without a process group")
    for key, value in plain[1].items():
        if not torch.equal(meshed[1][key], value):
            raise AssertionError(f"dp world of one: {key} differs")
    log(f"dp (i) NCCL world of one: {DP_STEPS} Adam steps of MnistMLP on "
        f"{DP_ROWS} rows equal the fit without a process group bit for bit "
        f"(losses {[round(x, 6) for x in plain[0]]}); {calls} "
        f"nccl:all_reduce calls, NCCL kernels on the card: {nccl or 'none'}; "
        f"the analysed capture: all-reduce {all_reduce_s:.6f} s over "
        f"{analysis.family_counts().get('all_reduce', 0)} calls in "
        f"{len(analysis.steps)} step(s), comm fraction "
        f"{analysis.comm_fraction:.4f}")
    return sgd, dict(bitwise_equal=True, all_reduce_calls=calls,
                     nccl_kernels=nccl, all_reduce_s=all_reduce_s,
                     comm_fraction=analysis.comm_fraction)


def dp_gloo_rank(rank, world, port, queue):
    """One rank of :func:`dp_gloo_pair`: the SGD fit over a gloo world,
    with CUDA tensors."""
    import traceback

    import torch
    import torch.distributed as dist

    from sparktorch_tpu_torch.parallel.mesh import build_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        losses, params = dp_fit(torch, "sgd", build_mesh())
        queue.put((rank, losses, {k: v.numpy() for k, v in params.items()}))
    except Exception:
        queue.put((rank, traceback.format_exc(), None))
    finally:
        dist.destroy_process_group()


def dp_gloo_pair(torch, reference):
    """Two processes on the one card under gloo, with CUDA tensors (a
    correctness check only: gloo stages through the host): each rank's
    SGD parameters within 1e-5 × max|param| of the world of one's."""
    import multiprocessing as mp
    import queue as _queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=dp_gloo_rank, args=(r, 2, port, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(2):
            rank, losses, params = results.get(timeout=DP_JOIN_S)
            if params is None:
                raise AssertionError(f"dp (ii) rank {rank} raised:\n{losses}")
            got[rank] = (losses, params)
    except _queue.Empty:
        raise AssertionError(f"dp (ii): no result within {DP_JOIN_S} s")
    finally:
        for p in procs:
            p.join(timeout=DP_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    ref_losses, ref_params = reference
    scale = max(float(v.abs().max()) for v in ref_params.values())
    worst = 0.0
    for rank, (losses, params) in got.items():
        for key, value in ref_params.items():
            worst = max(worst, float(np.abs(params[key]
                                            - value.numpy()).max()))
    log(f"dp (ii) gloo, 2 ranks on one card: {DP_STEPS} SGD steps, losses "
        f"{[round(x, 6) for x in got[0][0]]} against "
        f"{[round(x, 6) for x in ref_losses]}; worst parameter difference "
        f"{worst:.3e} (limit {1e-5 * scale:.3e})")
    if not worst <= 1e-5 * scale:
        raise AssertionError("dp (ii): the gloo ranks disagree with the "
                             "world of one")
    return dict(max_abs_diff=worst, limit=1e-5 * scale)


def dp_phase(torch):
    """(i) a world of one under NCCL, (ii) two gloo ranks on the card.
    Returns the launches of (i) (none) and the results."""
    reset_counts()
    sgd, one = dp_world_of_one(torch)
    counts = add_counts({}, "dp world of one")
    return counts, dict(world_of_one=one, gloo_pair=dp_gloo_pair(torch, sgd))


# The sharded phase: the long-context LM (phase 5's payload and ids)
# through create_sharded_state -> make_sharded_train_step on an NCCL world
# of one, MeshConfig(tp=1): the 3-D (dp, fsdp, tp) mesh, one batch shard;
# the token embedding is an FSDP2 DTensor shard of a one-rank fsdp axis,
# every other leaf replicated, as the sharding rules lay out the JAX mesh.
# Its losses must equal phase 5's train_distributed losses bit for bit
# (the same bf16 steps: the objective is scaled by 1/Σw before the
# backward in both).
#
# The tp pair: the LM at SHARDED_TP_SEQ for SHARDED_TP_STEPS steps of SGD
# (lr SHARDED_TP_LR), the world of one against two gloo processes with
# CUDA tensors on the card, MeshConfig(tp=2), from the same weights on the
# same batch. tp sums each row-parallel product's bf16 partials in another
# order, so the losses agree within TP_LOSS_RTOL (relative; 1.73e-5 was
# read on the H100) and each leaf's update (final - initial) within
# TP_UPDATE_RTOL of its L2 norm. A leaf whose update is under
# TP_SMALL_UPDATE of the largest leaf's is held absolutely instead, to
# TP_UPDATE_RTOL of that floor (TP_UPDATE_RTOL x TP_SMALL_UPDATE of the
# largest update), and named in the log: its relative error is rounding
# noise. A replicated leaf's gradient scaled by 1/tp, or a head in the
# wrong shard, moves an update by half or more.
SHARDED_TP_SEQ, SHARDED_TP_STEPS, SHARDED_TP_LR = 2048, 3, 0.1
TP_LOSS_RTOL, TP_UPDATE_RTOL, TP_SMALL_UPDATE = 1e-4, 5e-2, 1e-3


def sharded_steps(torch, run, state, batch, n):
    """``n`` sharded steps; the losses and the mean wall of all but the
    first (which builds FSDP2's lazy state), synchronised."""
    losses = []
    for i in range(n):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = run(state, batch)
        losses.append(m.loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    return [float(v) for v in losses], step_ms


def tp_pair_spec(torch):
    """The LM (phase 5's config, its weights loaded later) under SGD."""
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    torch.manual_seed(0)
    return ModelSpec(module=CausalLM(lm_config(LM_SEQ, "flash")),
                     loss="cross_entropy", optimizer="sgd",
                     optimizer_params={"lr": SHARDED_TP_LR})


def tp_pair_run(torch, mesh, ref):
    """SHARDED_TP_STEPS sharded steps of :func:`tp_pair_spec` from
    ``ref["init"]`` on ``ref``'s batch: the losses, the gathered final
    parameters, the launches and the heads a rank's attention holds."""
    from sparktorch_tpu_torch.convert import full_state_dict, load_full_state_dict
    from sparktorch_tpu_torch.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )
    from sparktorch_tpu_torch.utils.data import DataBatch

    spec = tp_pair_spec(torch)
    state, shardings = create_sharded_state(spec, mesh, device="cuda")
    load_full_state_dict(state.module, ref["init"])
    heads = (state.module.backbone.layers[0].attn.qkv.weight.shape[0]
             // (3 * (LM["d_model"] // LM["n_heads"])))
    batch = shard_batch(DataBatch(ref["x"], ref["y"],
                                  torch.ones(LM_BATCH)), mesh).to("cuda")
    run = make_sharded_train_step(spec.loss_fn(), mesh, shardings)
    reset_counts()
    losses = [run(state, batch)[1].loss for _ in range(SHARDED_TP_STEPS)]
    counts = read_counts()
    return ([float(v) for v in losses], full_state_dict(state.module),
            counts, heads)


def tp_update_errors(init, final, want):
    """Each leaf's L2 error of the update ``final - init`` against
    ``want - init``, over the larger of that update's norm and
    TP_SMALL_UPDATE of the largest leaf's; and the leaves under that
    floor (name -> their update's norm over the largest)."""
    deltas = {k: (want[k].float() - v.float()) for k, v in init.items()}
    top = max(float(d.norm()) for d in deltas.values())
    floor = TP_SMALL_UPDATE * top
    errs = {k: float((final[k].float() - init[k].float() - d).norm())
            / max(float(d.norm()), floor) for k, d in deltas.items()}
    small = {k: float(d.norm()) / top for k, d in deltas.items()
             if float(d.norm()) < floor}
    return errs, small


def sharded_tp_rank(rank, world, port, path, queue):
    """One rank of :func:`sharded_tp_pair`: the tp = 2 run over gloo with
    CUDA tensors, checked against the world of one's file at ``path``."""
    import traceback

    import torch
    import torch.distributed as dist

    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        ref = torch.load(path)
        mesh = build_mesh(MeshConfig(tp=2))
        losses, final, counts, heads = tp_pair_run(torch, mesh, ref)
        errs, small = tp_update_errors(ref["init"], final, ref["final"])
        queue.put((rank, dict(losses=losses, counts=counts, heads=heads,
                              update_errs=errs, small_updates=small,
                              tp_rank=mesh.tp_rank)))
    except Exception:
        queue.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def sharded_tp_pair(torch, path, ref_losses):
    """The tp = 2 pair (above): two gloo processes on the card, each held
    to the world of one's losses and updates. Returns rank 0's launches
    and the results."""
    import multiprocessing as mp
    import queue as _queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=sharded_tp_rank,
                         args=(r, 2, port, path, results)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(2):
            rank, out = results.get(timeout=DP_JOIN_S)
            if not isinstance(out, dict):
                raise AssertionError(f"sharded tp pair: rank {rank} "
                                     f"raised:\n{out}")
            got[rank] = out
    except _queue.Empty:
        raise AssertionError(f"sharded tp pair: no result within "
                             f"{DP_JOIN_S} s")
    finally:
        for p in procs:
            p.join(timeout=DP_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    worst_loss = max(abs(a - b) / abs(b) for out in got.values()
                     for a, b in zip(out["losses"], ref_losses))
    worst_update = max(max(out["update_errs"].values())
                       for out in got.values())
    worst_leaf = max(((k, v) for out in got.values()
                      for k, v in out["update_errs"].items()),
                     key=lambda kv: kv[1])[0]
    small = {k: (f, max(out["update_errs"][k] for out in got.values()))
             for k, f in got[0]["small_updates"].items()}
    small_txt = ", ".join(f"{k} {f:.2e} / {e:.2e}"
                          for k, (f, e) in small.items())
    for rank, out in got.items():
        expect_counts(f"sharded tp pair rank {rank}", out["counts"],
                      lm_step_counts(SHARDED_TP_STEPS))
    heads = [got[r]["heads"] for r in range(2)]
    log(f"sharded tp pair (gloo, 2 ranks on one card, MeshConfig(tp=2), "
        f"{heads} local heads, {SHARDED_TP_STEPS} SGD steps at s="
        f"{SHARDED_TP_SEQ}): losses {[round(v, 5) for v in got[0]['losses']]}"
        f" / {[round(v, 5) for v in got[1]['losses']]} against the world of "
        f"one's {[round(v, 5) for v in ref_losses]}: worst relative "
        f"difference {worst_loss:.3e} (limit {TP_LOSS_RTOL}); worst leaf "
        f"update relative L2 error {worst_update:.3e} ({worst_leaf}; limit "
        f"{TP_UPDATE_RTOL}); {len(small)} leaves under the "
        f"{TP_SMALL_UPDATE} floor, held absolutely (update over the "
        f"largest / error over the floor): [{small_txt}]; "
        f"{wall:.1f} s with the processes' starts")
    if heads != [LM["n_heads"] // 2] * 2:
        raise AssertionError(f"sharded tp pair: local heads {heads}")
    if not (worst_loss <= TP_LOSS_RTOL and worst_update <= TP_UPDATE_RTOL):
        raise AssertionError("sharded tp pair: the tp ranks disagree with "
                             "the world of one")
    return got[0]["counts"], dict(
        losses=[got[r]["losses"] for r in range(2)],
        reference_losses=ref_losses, max_rel_loss_diff=worst_loss,
        max_update_rel_err=worst_update, worst_leaf=worst_leaf,
        small_updates=small, local_heads=heads, wall_s=wall)


def sharded_phase(torch, lm):
    """The sharded trainer on the card: LM_ITERS steps of the LM at full
    width, its kernel launches counted and its losses held to phase 5's
    (``lm``: train_lm_phase's numbers), then one step's device time by
    kernel family and one profiled step whose ``train_step`` range must
    hold one step's launches; then the tp pair's reference in the same
    world, and the pair. Returns the launches of the LM_ITERS steps and
    of the pair's rank 0, by path, and the results."""
    import glob

    import torch.distributed as dist

    from sparktorch_tpu_torch import deserialize_model
    from sparktorch_tpu_torch.convert import full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )
    from sparktorch_tpu_torch.utils.data import DataBatch

    spec = deserialize_model(lm_payload(torch, 0))
    x, y = lm_ids(LM_BATCH, 0)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    trace_dir = os.path.join(SCRATCH, "sharded_trace")
    pair_path = os.path.join(SCRATCH, "sharded_tp_reference.pt")
    try:
        mesh = build_mesh(MeshConfig(tp=1))
        state, shardings = create_sharded_state(spec, mesh, device="cuda")
        fsdp = sorted(k for k, v in shardings.items() if "fsdp" in v)
        dtensors = sorted(k for k, p in state.module.named_parameters()
                          if type(p).__name__ == "DTensor")
        if (mesh.device_mesh.mesh_dim_names != ("dp", "fsdp", "tp")
                or fsdp != ["backbone.tok_embed.weight"] or dtensors != fsdp):
            raise AssertionError(f"sharded: mesh {mesh.device_mesh}, fsdp "
                                 f"leaves {fsdp}, DTensor leaves {dtensors}")
        batch = shard_batch(DataBatch(torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.ones(LM_BATCH)), mesh).to("cuda")
        run = make_sharded_train_step(spec.loss_fn(), mesh, shardings)
        reset_counts()
        losses, step_ms = sharded_steps(torch, run, state, batch, LM_ITERS)
        counts = read_counts()
        expect_counts("sharded LM", counts, lm_step_counts(LM_ITERS))
        want = lm["losses"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        log(f"sharded LM: {LM_ITERS} steps of make_sharded_train_step on "
            f"an NCCL world of one, MeshConfig(tp=1) on the 3-D mesh (FSDP2 "
            f"DTensor leaves {dtensors}, a one-rank fsdp axis), losses "
            f"{[round(v, 4) for v in losses]} against train_distributed's "
            f"{[round(v, 4) for v in want]}: bitwise equal "
            f"{losses == want} (worst relative difference {worst:.3e})")
        if not (np.isfinite(losses).all() and losses == want
                and losses[-1] < losses[0]):
            raise AssertionError("sharded LM: losses differ from "
                                 "train_distributed's or did not fall")
        busy = profile_pass(torch, "one sharded LM step",
                            lambda: run(state, batch))
        profiled = make_sharded_train_step(spec.loss_fn(), mesh, shardings,
                                           profile_dir=trace_dir)
        profiled(state, batch)
        torch.cuda.synchronize()
        analysis = profiled.finish()
        path, = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        ranges, inside, outside = step_kernel_launches(path)
        if ranges != 1 or inside != lm_step_counts(1) or any(
                outside.values()):
            raise AssertionError(f"sharded LM profiled step: {ranges} "
                                 f"train_step ranges, launches inside "
                                 f"{inside}, outside {outside}")
        del state, run, profiled, batch
        torch.cuda.empty_cache()
        # The tp pair's reference: the world of one from the LM's
        # weights, SGD at SHARDED_TP_SEQ.
        init = {k: v.detach().cpu().clone() for k, v in
                spec.make_module().state_dict().items()}
        ref = dict(init=init,
                   x=torch.from_numpy(x[:, :SHARDED_TP_SEQ].copy()),
                   y=torch.from_numpy(y[:, :SHARDED_TP_SEQ].copy()))
        ref_losses, ref["final"], _, _ = tp_pair_run(torch, mesh, ref)
        torch.save(ref, pair_path)
        del ref, init
    finally:
        dist.destroy_process_group()
        shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    try:
        pair_counts, pair = sharded_tp_pair(torch, pair_path, ref_losses)
    finally:
        os.remove(pair_path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"sharded LM on {smi}: step {step_ms:.2f} ms (mean of steps 2-"
        f"{LM_ITERS}, synchronised; the health lane on) beside the resident "
        f"train_distributed step's {lm['step_ms']:.2f} ms (phase 5, the "
        f"chunk's mean); a profiled step's train_step range holds "
        f"{inside} (a record, not a claim); the tp pair took "
        f"{pair['wall_s']:.1f} s")
    return ({"sharded": counts, "sharded_tp_pair": pair_counts},
            dict(losses=losses, resident_losses=want,
                 bitwise_equal=losses == want, max_rel_loss_diff=worst,
                 step_ms=step_ms, resident_step_ms=lm["step_ms"],
                 profiled_step_launches=inside,
                 comm_fraction=None if analysis is None
                 else analysis.comm_fraction, profile=busy, tp_pair=pair,
                 card=smi))


# The spark phase (BASELINE config 4's topology, the localspark runtime):
# (a) BERT-base fitted through SparkTorch(deployMode="barrier",
# partitions=1) on BERT_ROWS x BERT_SEQ ids for BERT_ITERS steps, (b)
# SPARK_SERVE_ROWS rows through the pandas UDF, (c) the lazy MnistCNN
# (CNN_ROWS rows, SPARK_CNN_ITERS steps) and (d) ResNet-18 hogwild on 2
# executors, SPARK_HW_ITERS iterations each. (c) runs 32 full-batch Adam
# steps: from the lazy model's unseeded init the loss may first rise
# (2.7167 -> 6.1758 -> ... -> 2.8118 over 8 steps in one run), so 8 steps
# need not end below the first.
SPARK_SERVE_ROWS, SPARK_HW_ITERS, SPARK_CNN_ITERS = 2000, 64, 32


def spark_session():
    """The port's localspark session (its pyspark shim installed)."""
    from sparktorch_tpu_torch.spark import localsession

    if not localsession.install():
        raise AssertionError("spark: a real pyspark is installed; the phase "
                             "drives the port's localspark runtime")
    return localsession.SparkSession.builder.master("local[1]").getOrCreate()


def spark_frame(spark, x, y=None):
    from sparktorch_tpu_torch.spark.localsession import DenseVector

    if y is None:
        return spark.createDataFrame([(DenseVector(r),) for r in x],
                                     ["features"])
    return spark.createDataFrame(
        [(float(y[i]), DenseVector(x[i])) for i in range(len(x))],
        ["label", "features"])


def bert_ids(rows, seed, vocab):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (rows, BERT_SEQ)).astype(np.float32),
            rng.integers(0, 2, rows).astype(np.float32))


def executor_bert_step(rows, seq, layers, seed):
    """A closure for ``rdd.barrier().mapPartitions``: one BERT-base
    training step in the executor process, returning its kernel launches
    and whether jax or the JAX package was imported there. Self-contained:
    its imports are its own (in the executor, ``__main__`` is the
    executor's module)."""

    def step(iterator):
        import sys

        import numpy as np
        import torch

        from sparktorch_tpu_torch.models import bert_base
        from sparktorch_tpu_torch.ops.flash_attention import (
            flash_attention,
            flash_bwd_dkv,
            flash_bwd_dq,
        )
        from sparktorch_tpu_torch.ops.fused_ce import (
            fused_ce_backward,
            fused_ce_forward,
        )
        from sparktorch_tpu_torch.train.step import train_step
        from sparktorch_tpu_torch.utils.data import DataBatch
        from sparktorch_tpu_torch.utils.losses import resolve_loss
        from sparktorch_tpu_torch.utils.serde import resolve_optimizer

        list(iterator)
        torch.manual_seed(seed)
        model = bert_base(attn_impl="flash", n_layers=layers).cuda().train()
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, model.config.vocab_size, (rows, seq))
        batch = DataBatch(torch.from_numpy(ids.astype(np.float32)),
                          torch.from_numpy(rng.integers(0, 2, rows)),
                          torch.ones(rows)).to("cuda")
        optimizer = resolve_optimizer("adam", {"lr": 2e-5})(model.parameters())
        wrappers = {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
                    "flash_bwd_dkv": flash_bwd_dkv, "ce_fwd": fused_ce_forward,
                    "ce_bwd": fused_ce_backward}
        for fn in wrappers.values():
            fn.launches = 0
        metrics = train_step(model, resolve_loss("cross_entropy"), optimizer,
                             batch)
        torch.cuda.synchronize()
        yield {"launches": {k: fn.launches for k, fn in wrappers.items()},
               "loss": float(metrics.loss),
               "foreign": sorted(m for m in sys.modules if m.split(".")[0]
                                 in ("jax", "jaxlib", "flax",
                                     "sparktorch_tpu"))}

    return step


def spark_bert_fit(torch, spark, rows=BERT_ROWS, iters=BERT_ITERS, layers=12):
    """(a): BERT-base (flash) through ``SparkTorch(deployMode="barrier",
    partitions=1, supervise=True, device="cuda")`` — one executor process
    trains on the card, its stage under ``ft.supervise_run`` (supervise
    phase (c): no kill, so no restart) — against the same fit in this
    process through ``ml.estimator.SparkTorch``: every parameter equal
    bit for bit. Each fit is timed with nothing beside it; the barrier
    fit launches no kernel in this process. Returns (fitted model,
    counts by path, numbers)."""
    from sparktorch_tpu_torch import SparkTorch
    from sparktorch_tpu_torch.models.transformer import TransformerConfig
    from sparktorch_tpu_torch.obs import get_telemetry
    from sparktorch_tpu_torch.spark.torch_distributed import (
        SparkTorch as BarrierSparkTorch,
    )

    payload = bert_payload(torch, 2, layers)
    x, y = bert_ids(rows, 2, TransformerConfig().vocab_size)
    est = BarrierSparkTorch(inputCol="features", labelCol="label",
                            torchObj=payload, iters=iters,
                            deployMode="barrier", partitions=1,
                            supervise=True, ftMaxRestarts=2, device="cuda")
    stage = {"worker": "spark_barrier_stage"}
    restarts0 = get_telemetry().counter_value("ft_restarts_total", stage)
    frame = spark_frame(spark, x, y)
    reset_counts()
    t0 = time.perf_counter()
    fitted = est.fit(frame)
    fit_s = time.perf_counter() - t0
    counts = {"spark_barrier_bert": read_counts()}
    expect_counts("spark (a) driver during the barrier fit",
                  counts["spark_barrier_bert"], NO_KERNELS)
    losses = [r["loss"] for r in est._last_metrics]
    if len(losses) != iters or not np.isfinite(losses).all():
        raise AssertionError(f"spark (a): losses {losses}")
    restarts = get_telemetry().counter_value("ft_restarts_total",
                                             stage) - restarts0

    t0 = time.perf_counter()
    reference = SparkTorch(inputCol="features", labelCol="label",
                           torchObj=payload, iters=iters, device="cuda").fit(
        {"features": list(x), "label": y})
    ref_s = time.perf_counter() - t0
    want = reference.getModel().params
    got = fitted.getPytorchModel()["params"]
    if set(got) != set(want):
        raise AssertionError("spark (a): parameter names differ")
    scale = max(float(v.abs().max()) for v in want.values())
    worst = max(float((got[k].float() - v.float()).abs().max())
                for k, v in want.items())
    log(f"spark (a) barrier BERT-base fit (1 executor, {layers} layers, "
        f"supervise=True: supervise (c)): {iters} steps of {rows} x "
        f"{BERT_SEQ} ids, losses {[round(v, 4) for v in losses]}, "
        f"{restarts:.0f} stage restarts; fit {fit_s:.2f} s (executor start, "
        f"payload and result included) against the in-process fit's "
        f"{ref_s:.2f} s; largest parameter difference {worst:.3e}")
    if worst != 0.0 or restarts != 0:
        raise AssertionError("spark (a): the supervised barrier fit is not "
                             "the in-process fit bit for bit, or restarted")
    return fitted, counts, dict(fit_s=fit_s, in_process_fit_s=ref_s,
                                max_abs_diff=worst, restarts=restarts,
                                losses=losses)


def spark_executor_step(spark, rows=BERT_ROWS, layers=12):
    """(a), the executor's launches: a chip_smoke closure shipped through
    ``rdd.barrier().mapPartitions`` runs one BERT-base step in an
    executor process and returns its launches (one forward, dq and dk/dv
    a layer) and the jax modules it imported (none). Returns the
    launches."""
    t0 = time.perf_counter()
    (probe,) = spark_frame(spark, np.zeros((1, 1), np.float32)).rdd.barrier(
    ).mapPartitions(executor_bert_step(rows, BERT_SEQ, layers, 2)).collect()
    probe_s = time.perf_counter() - t0
    expect_counts("spark (a) executor BERT step", probe["launches"],
                  dict(NO_KERNELS, flash_fwd=layers, flash_bwd_dq=layers,
                       flash_bwd_dkv=layers))
    if probe["foreign"] or not np.isfinite(probe["loss"]):
        raise AssertionError(f"spark (a) executor: imported "
                             f"{probe['foreign']}, loss {probe['loss']}")
    log(f"spark (a) executor step: loss {probe['loss']:.4f}, no jax or JAX "
        f"package module in the executor; {probe_s:.2f} s with its start")
    return probe["launches"]


def spark_carrier_round_trip(fitted, frame, out):
    """(e)'s host work: a Pipeline holding ``fitted`` saved through the
    carrier, loaded and unwrapped; the loaded pipeline, the seconds and
    ``done`` go to ``out``."""
    from sparktorch_tpu_torch import PysparkPipelineWrapper
    from sparktorch_tpu_torch.spark.localsession import Pipeline, PipelineModel

    path = os.path.join(SCRATCH, "spark_pipeline")
    t0 = time.perf_counter()
    Pipeline(stages=[fitted]).fit(frame).write().overwrite().save(path)
    out["save_s"] = time.perf_counter() - t0
    out["metadata_bytes"] = os.path.getsize(os.path.join(path,
                                                         "metadata.json"))
    t0 = time.perf_counter()
    out["loaded"] = PysparkPipelineWrapper.unwrap(PipelineModel.load(path))
    out["load_s"] = time.perf_counter() - t0
    shutil.rmtree(path, ignore_errors=True)
    out["done"] = True


def spark_carrier_model(torch, spark, frame, layers=2):
    """(e)'s model: a ``spark.torch_distributed.SparkTorchModel`` over a
    seeded BERT-base-width model of ``layers`` layers, and its UDF
    predictions and launches on ``frame``."""
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.ml.estimator import _encode_bundle
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorchModel
    from sparktorch_tpu_torch.utils.serde import deserialize_model, meta_copy

    torch.manual_seed(6)
    module = bert_base(attn_impl="flash", n_layers=layers)
    spec = deserialize_model(serialize_torch_obj(module,
                                                 criterion="cross_entropy"))
    # As a fit's bundle holds it: the module's structure without its
    # weights, which travel once, as ``params``.
    spec = dataclasses.replace(spec, module=meta_copy(module))
    params = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    model = SparkTorchModel(inputCol="features",
                            modStr=_encode_bundle(spec, params), device="cuda")
    reset_counts()
    preds = np.asarray([r["predictions"]
                        for r in model.transform(frame).collect()])
    counts = read_counts()
    expect_counts(f"spark (e) {layers}-layer model before the save", counts,
                  dict(NO_KERNELS, flash_fwd=2 * layers))
    return model, preds, counts


def spark_udf_serve(torch, spark, fitted, layers=12, rows=SPARK_SERVE_ROWS):
    """(b): ``transform`` of ``rows`` rows through the pandas UDF in
    this process; 12 forward launches (one a layer) for each UDF batch.
    Its argmaxes must equal ``ml.estimator.SparkTorchModel.transform``'s
    on the same bundle, run on the same batches (localspark evaluates a
    UDF in two). Returns (the rows, their frame, predictions, the
    estimator's model and its whole-frame predictions, counts,
    numbers)."""
    from sparktorch_tpu_torch.ml.estimator import SparkTorchModel
    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    x, _ = bert_ids(rows, 4, TransformerConfig().vocab_size)
    frame = spark_frame(spark, x)
    batches = [b for b in np.array_split(np.arange(rows), 2) if len(b)]
    reset_counts()
    t0 = time.perf_counter()
    preds = np.asarray([r["predictions"]
                        for r in fitted.transform(frame).collect()])
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("spark (b) UDF transform", counts,
                  dict(NO_KERNELS, flash_fwd=layers * len(batches)))
    plain = SparkTorchModel(inputCol="features",
                            modStr=fitted.getOrDefault(fitted.modStr)
                            ).setDevice("cuda")
    want = np.concatenate([plain.transform({"features": x[b]})["predictions"]
                           for b in batches])
    whole = plain.transform({"features": x})["predictions"]
    if preds.shape != (rows,) or not np.array_equal(preds, want):
        raise AssertionError(f"spark (b): UDF argmaxes differ from the "
                             f"estimator's on {int((preds != want).sum())} rows")
    log(f"spark (b) UDF transform: {rows} rows x {BERT_SEQ} ids in "
        f"{wall:.3f} s = {rows / wall:,.1f} rows/s (the broadcast bundle "
        f"decoded and put on the card once, host clock); argmaxes equal the "
        f"estimator's on the UDF's {len(batches)} batches, and "
        f"{100 * float(np.mean(preds == whole)):.2f}% of its whole-frame "
        f"transform's")
    return x, frame, preds, plain, whole, counts, dict(rows_per_s=rows / wall,
                                                       wall_s=wall)


def spark_phase(torch):
    """BASELINE config 4's topology through the port's localspark runtime
    (``sparktorch_tpu_torch.spark``): (a) the barrier BERT-base fit and an
    executor's launches, (b) 2,000 rows through the pandas UDF, (c) config
    2's lazy MnistCNN through ``deployMode="barrier"``, (d) config 3's
    ResNet-18 hogwild on two executor processes against the driver's
    parameter server (binary wire, bf16 pushes), (e) a Pipeline holding
    a 2-layer BERT-base-width model saved and loaded through the carrier,
    (f) ``SparkTorchModel.setMesh`` on a world-of-one mesh. Without
    pandas (b), (e) and (f) are skipped with a printed reason."""
    import importlib.util

    t_phase = time.perf_counter()
    spark = spark_session()  # before the adapter's import: it needs pyspark

    from sparktorch_tpu_torch import serialize_torch_obj, serialize_torch_obj_lazy
    from sparktorch_tpu_torch.models import MnistCNN, resnet18
    from sparktorch_tpu_torch.parallel.mesh import build_mesh
    from sparktorch_tpu_torch.spark.torch_distributed import SparkTorch

    out = {}
    try:
        fitted, counts, out["barrier_bert"] = spark_bert_fit(torch, spark)
        pandas = importlib.util.find_spec("pandas") is not None
        if pandas:
            import pandas as pd

            log(f"spark: pandas {pd.__version__}")
            (x_serve, frame, _, model, plain, counts["spark_udf_serve"],
             out["udf_serve"]) = spark_udf_serve(torch, spark, fitted)
        else:
            log("spark: pandas is not installed on this machine: (b) the UDF "
                "transform, (e) pipeline persistence and (f) setMesh are "
                "skipped (localspark's withColumn needs pandas)")
            out["skipped"] = ["b", "e", "f"]

        # Learnable rows: on noise labels a few steps from a lazy model's
        # unseeded init need not lower the loss.
        xc, yc = patterned_rows(CNN_ROWS, (784,), 1.0, seed=5)
        cnn = SparkTorch(
            inputCol="features", labelCol="label",
            torchObj=serialize_torch_obj_lazy(
                MnistCNN, criterion="cross_entropy", optimizer="adam",
                optimizer_params={"lr": 1e-3}, input_shape=(784,)),
            iters=SPARK_CNN_ITERS, deployMode="barrier", partitions=1,
            device="cuda")
        cnn_frame = spark_frame(spark, xc, yc.astype(np.float32))
        # (a)'s executor step runs on a thread beside (c), whose fit wall
        # is therefore not the layer metric ((a)'s is, timed alone).
        probe = {}
        step = threading.Thread(target=lambda: probe.update(
            launches=spark_executor_step(spark)), daemon=True)
        reset_counts()
        step.start()
        t0 = time.perf_counter()
        cnn.fit(cnn_frame)
        cnn_s = time.perf_counter() - t0
        step.join()
        counts["spark_barrier_cnn"] = add_counts(
            {}, "spark (c) lazy MnistCNN and (a)'s executor step, driver")
        if "launches" not in probe:
            raise AssertionError("spark (a): the executor step failed (its "
                                 "traceback is above)")
        counts["spark_executor_bert_step"] = probe["launches"]
        losses = [r["loss"] for r in cnn._last_metrics]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"spark (c): losses {losses}")
        log(f"spark (c) lazy MnistCNN through deployMode='barrier': "
            f"{SPARK_CNN_ITERS} steps of {CNN_ROWS} rows, losses "
            f"{[round(v, 4) for v in losses]}; fit {cnn_s:.2f} s (beside the "
            f"executor step)")
        out["barrier_cnn"] = dict(losses=losses, fit_s=cnn_s)

        x, y = cifar_like(HW_ROWS)
        torch.manual_seed(3)
        hw = SparkTorch(
            inputCol="features", labelCol="label",
            torchObj=serialize_torch_obj(
                resnet18(num_classes=10, input_hw=(32, 32, 3)),
                criterion="cross_entropy", optimizer="sgd",
                optimizer_params={"lr": 1e-2}, input_shape=(32 * 32 * 3,)),
            iters=SPARK_HW_ITERS, mode="hogwild", deployMode="barrier",
            partitions=2, miniBatch=HW_MB, pushEvery=HW_PUSH, compress=True,
            wire="binary", device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        hw.fit(spark_frame(spark, x.reshape(HW_ROWS, -1), y))
        hw_s = time.perf_counter() - t0
        counts["spark_hogwild_executors"] = add_counts(
            {}, "spark (d) hogwild executors")
        summaries = hw._last_hogwild_summaries
        pushes = sum(s["pushes"] for s in summaries)
        applied = hw._last_hogwild_applied
        window = 2 * HW_PUSH
        all_losses = [v for s in summaries for v in s["losses"]]
        first = float(np.mean([v for s in summaries
                               for v in s["losses"][:window]]))
        last = float(np.mean([v for s in summaries
                              for v in s["losses"][-window:]]))
        rate = (sum(s["examples"] for s in summaries)
                / max(s["loop_s"] for s in summaries))
        log(f"spark (d) ResNet-18 hogwild, 2 executor processes on the card "
            f"against the driver's server (binary wire, bf16 pushes): "
            f"{len(all_losses)} iterations, {applied} applies == {pushes} "
            f"pushes, loss {first:.4f} -> {last:.4f} (first and last "
            f"{window}-iteration windows of each worker); {rate:,.0f} "
            f"examples/s over both workers' loops; fit {hw_s:.2f} s")
        if (len(summaries) != 2 or applied != pushes
                or not np.isfinite(all_losses).all() or not last < first):
            raise AssertionError("spark (d): hogwild executors failed their "
                                 "checks")
        out["hogwild_executors"] = dict(
            applies=applied, pushes=pushes, first_loss=first,
            last_loss=last, examples_per_s=rate, fit_s=hw_s)

        if pandas:
            # (e) carries a BERT-base-width model cut to 2 layers
            # (spark_costs.py times the carrier of a 12-layer one); its
            # save and load run on a thread beside (f), which is not timed.
            small, small_preds, counts["spark_pipeline"] = spark_carrier_model(
                torch, spark, frame)
            carried = {}
            carrier = threading.Thread(target=spark_carrier_round_trip,
                                       args=(small, frame, carried),
                                       daemon=True)
            carrier.start()
            mesh = build_mesh()
            reset_counts()
            meshed = model.setMesh(mesh).transform(
                {"features": x_serve})["predictions"]
            counts["spark_set_mesh"] = read_counts()
            expect_counts("spark (f) setMesh", counts["spark_set_mesh"],
                          dict(NO_KERNELS, flash_fwd=12 * -(
                              -SPARK_SERVE_ROWS // CHUNK)))
            if mesh.dp != 1 or not np.array_equal(meshed, plain):
                raise AssertionError("spark (f): setMesh on a world of one "
                                     "differs from the plain transform")
            log(f"spark (f) setMesh (dp {mesh.dp}): {len(meshed)} predictions "
                f"equal the plain transform's bit for bit")
            carrier.join()
            if not carried.get("done"):
                raise AssertionError("spark (e): the carrier round trip "
                                     "failed (its traceback is above)")
            reset_counts()
            again = np.asarray([r["predictions"] for r in
                                carried.pop("loaded").transform(frame)
                                .collect()])
            expect_counts("spark (e) loaded pipeline", read_counts(),
                          counts["spark_pipeline"])
            if not np.array_equal(again, small_preds):
                raise AssertionError("spark (e): the loaded pipeline's "
                                     "predictions differ")
            log(f"spark (e) pipeline through the carrier (BERT-base width, 2 "
                f"layers): saved in {carried['save_s']:.2f} s "
                f"({carried['metadata_bytes'] / 2**20:,.1f} MiB of "
                f"metadata), loaded and unwrapped in {carried['load_s']:.2f} "
                f"s (beside (f)); predictions equal the model's before the "
                f"save bit for bit")
            out["pipeline"] = {k: carried[k] for k in
                               ("save_s", "load_s", "metadata_bytes")}
    finally:
        spark.stop()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"spark phase: {out['wall_s']:.1f} s")
    return counts, out


def serve_online_phase(torch):
    """The online serving tier: (a) the bench's ``serve_online`` at the
    JAX depth, every gate holding; (b) BERT-base through an
    ``InferenceTier`` of 2 replicas under open-loop Poisson load at twice
    the serial capacity, against the serial ``BatchPredictor`` on the
    same schedule, one batch of each bucket profiled; (c) a weight push
    from a ``ParameterServer`` over ``ParamServerHttp`` reaching both
    replicas' pullers within the staleness bound."""
    from sparktorch_tpu_torch import bench
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.net.transport import BinaryTransport
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )
    from sparktorch_tpu_torch.serve.router import InferenceTier
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    t_phase = time.perf_counter()
    counts, out = {}, {}

    # (a) the bench's serve_online at the JAX depth: no kernel runs.
    reset_counts()
    t0 = time.perf_counter()
    rec = bench.CONFIGS["serve_online"]()
    wall = time.perf_counter() - t0
    counts["serve_online_bench"] = read_counts()
    log(json.dumps(rec))
    expect_counts("serve_online (a) bench", counts["serve_online_bench"],
                  NO_KERNELS)
    jax_keys, omitted, added = bench.RECORD_KEYS["serve_online"]
    if set(rec) != (jax_keys - omitted) | added:
        raise AssertionError(f"serve_online (a): keys {sorted(rec)}")
    if rec["serve_drift"]["status"] != "no_prior_record":
        raise AssertionError(f"serve_online (a): drift {rec['serve_drift']}")
    log(f"serve_online (a) bench: throughput x{rec['throughput_ratio']} "
        f"({rec['continuous']['rows_per_s']} vs {rec['baseline']['rows_per_s']}"
        f" rows/s), p99 x{rec['p99_ratio']} ({rec['continuous']['p99_ms']} vs "
        f"{rec['baseline']['p99_ms']} ms), serial {rec['serial_service_ms']} "
        f"ms, staleness {rec['weight_push']['staleness_s']} s; {wall:.1f} s")
    out["bench"] = rec

    # (b) BERT-base behind a tier of two replicas on the card.
    torch.manual_seed(0)
    with torch.device("cuda"):
        module = bert_base(attn_impl="flash")
        dense = bert_base(attn_impl="dense")
    dense.load_state_dict(module.state_dict())
    cfg = module.config
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size,
                       (SERVE_REQUESTS, SERVE_SEQ)).astype(np.int64)
    serial = BatchPredictor(module, device="cuda", chunk=SERVE_BUCKETS[-1],
                            telemetry=Telemetry(run_id="serve_serial"))
    serial.predict(ids[:1])
    svc = []
    for i in range(30):
        t0 = time.perf_counter()
        serial.predict(ids[i:i + 1])
        svc.append(time.perf_counter() - t0)
    svc_s = float(np.median(svc))
    arrivals = np.cumsum(rng.exponential(svc_s / 2.0, SERVE_REQUESTS))
    lock = threading.Lock()

    def serial_submit(x):
        with lock:
            return serial.predict(x)

    serial_leg = bench.poisson_leg(serial_submit, ids, arrivals)

    tele = Telemetry(run_id="serve_tier")
    t0 = time.perf_counter()
    tier = InferenceTier(module, n_replicas=SERVE_REPLICAS,
                         telemetry=tele, buckets=SERVE_BUCKETS,
                         max_queue_rows=1024, warm_input=ids[:1],
                         probe_interval_s=0.05, device="cuda")
    build_s = time.perf_counter() - t0

    def batches():
        return sum(tele.counter_value("serve.batches_total", {"replica": r})
                   for r in tier.replicas)

    try:
        outs = [None] * SERVE_REQUESTS
        reset_counts()
        tier_leg = bench.poisson_leg(
            lambda x: tier.submit(x, deadline_s=60.0), ids, arrivals, outs)
        counts["serve_online_tier"] = read_counts()
        n_batches = batches()
        expect_counts("serve_online (b) tier", counts["serve_online_tier"],
                      dict(NO_KERNELS, flash_fwd=cfg.n_layers * int(n_batches)))
        for name, leg in (("serial", serial_leg), ("tier", tier_leg)):
            if leg["errors"] or leg["completed"] != SERVE_REQUESTS:
                raise AssertionError(
                    f"serve_online (b) {name} leg: {leg['completed']}/"
                    f"{SERVE_REQUESTS} completed, {leg['errors']} errors "
                    f"{leg['error_samples']}")
        got = np.concatenate(outs)
        want_dense = BatchPredictor(dense, device="cuda", chunk=CHUNK
                                    ).predict(ids)
        want_serial = serial.predict(ids)
        if got.shape != want_dense.shape or not np.isfinite(got).all():
            raise AssertionError(f"serve_online (b): logits {got.shape}")
        diffs = {}
        for name, want, tol in (("dense attention", want_dense, 5e-2),
                                ("BatchPredictor", want_serial, 2e-2)):
            diff = float(np.abs(got - want).max())
            limit = tol * max(1.0, float(np.abs(want).max()))
            diffs[name] = (diff, limit)
            log(f"serve_online (b): {SERVE_REQUESTS} served rows vs {name}: "
                f"max abs diff {diff:.3e} (limit {limit:.3e})")
            if not diff <= limit:
                raise AssertionError(f"serve_online (b): rows disagree with "
                                     f"{name}")
        fills = [tele.histogram("serve.batch_fill", {"replica": r})["p50"]
                 for r in tier.replicas]
        depths = [tele.histogram("serve.queue_depth", {"replica": r})["p99"]
                  for r in tier.replicas]
        log(f"serve_online (b) BERT-base, {SERVE_REPLICAS} replicas, buckets "
            f"{SERVE_BUCKETS}, {SERVE_REQUESTS} requests of {SERVE_SEQ} ids "
            f"at {2 / svc_s:,.1f}/s (serial one-row predict "
            f"{svc_s * 1e3:.3f} ms): tier {tier_leg['rows_per_s']:,.1f} rows/s,"
            f" p50 {tier_leg['p50_ms']:.2f} ms, p99 {tier_leg['p99_ms']:.2f} "
            f"ms; serial {serial_leg['rows_per_s']:,.1f} rows/s, p50 "
            f"{serial_leg['p50_ms']:.2f} ms, p99 {serial_leg['p99_ms']:.2f} ms;"
            f" {int(n_batches)} batches, serve.batch_fill p50 by replica "
            f"{fills}, serve.queue_depth p99 by replica {depths}; tier built "
            f"and warmed in {build_s:.2f} s")
        out["tier"] = dict(serial_ms=svc_s * 1e3, serial=serial_leg,
                           tier=tier_leg, batches=n_batches,
                           batch_fill_p50=fills, queue_depth_p99=depths,
                           diffs=diffs, build_s=build_s)

        # One batch of each bucket under the profiler (idle replicas: a
        # request of b rows is one batch of bucket b).
        replica = tier.replicas["0"]
        out["profile"] = {}
        for b in SERVE_BUCKETS:
            out["profile"][b] = profile_pass(
                torch, f"serve_online one batch of bucket {b}",
                lambda: replica.infer(ids[:b]))

        # (c) a weight push from a parameter server over the wire.
        torch.manual_seed(1)
        with torch.device("cuda"):
            newer = bert_base(attn_impl="flash")
        server = ParameterServer(ModelSpec(
            module=newer, loss="cross_entropy", optimizer="sgd",
            optimizer_params={"lr": 1e-3}, input_shape=(SERVE_SEQ,)),
            device="cuda")
        http = ParamServerHttp(server, port=0).start()
        try:
            t0 = time.perf_counter()
            tier.start_pullers(lambda: BinaryTransport(http.url, quant=None),
                               poll_s=SERVE_POLL_S)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and any(
                    tele.counter_value("serve.weight_updates_total",
                                       {"replica": r}) < 1
                    for r in tier.replicas):
                time.sleep(0.01)
            first_sync_s = time.perf_counter() - t0
            stop_load = threading.Event()
            load_errors = []

            def background_load():
                i = 0
                while not stop_load.is_set():
                    try:
                        tier.submit(ids[i % SERVE_REQUESTS][None], 30.0)
                    except Exception as e:  # noqa: BLE001 - checked below
                        load_errors.append(repr(e))
                    i += 1
                    time.sleep(0.005)

            reset_counts()
            b0 = batches()
            loader = threading.Thread(target=background_load, daemon=True)
            loader.start()
            time.sleep(0.3)
            _, params0 = server.slot.read()
            server.push_gradients({k: torch.ones_like(v)
                                   for k, v in params0.items()}, wait=True)
            pushed = server.slot.version
            t_push = time.monotonic()
            bound = 20 * SERVE_POLL_S + 1.0
            staleness = {}
            while (len(staleness) < SERVE_REPLICAS
                   and time.monotonic() < t_push + bound + 30.0):
                for rid, r in tier.replicas.items():
                    if rid not in staleness and r.params_version >= pushed:
                        staleness[rid] = time.monotonic() - t_push
                time.sleep(0.01)
            stop_load.set()
            loader.join(timeout=60)
            counts["serve_online_push"] = read_counts()
            pushed_batches = batches() - b0
            expect_counts("serve_online (c) push under load",
                          counts["serve_online_push"],
                          dict(NO_KERNELS, flash_fwd=cfg.n_layers
                               * int(pushed_batches)))
            installs = [tele.histogram("serve.weight_install_s",
                                       {"replica": r}) for r in tier.replicas]
            # A fresh poll: the pull of the whole model over the wire, its
            # decode and the install.
            polls = [tele.histogram("serve.weight_poll_s", {"replica": r})
                     for r in tier.replicas]
            log(f"serve_online (c) push: both replicas' pullers at version "
                f"{[r.params_version for r in tier.replicas.values()]} "
                f"(server {server.slot.version}); staleness {staleness} s "
                f"(bound {bound:.2f} s); install_params (update_params: the "
                f"module's deep copy and the load) {[round(h['max'], 4) for h in installs]} "
                f"s max, {[round(h['p50'], 4) for h in installs]} s p50 by "
                f"replica over {[h['count'] for h in installs]} swaps; the "
                f"slowest poll (pull, decode, install) "
                f"{[round(h['max'], 4) for h in polls]} s by replica; first "
                f"sync {first_sync_s:.2f} s; {int(pushed_batches)} batches "
                f"under the background load, {len(load_errors)} errors")
            if load_errors:
                raise AssertionError(f"serve_online (c): {load_errors[:3]}")
            if len(staleness) < SERVE_REPLICAS or max(
                    staleness.values()) > bound:
                raise AssertionError(f"serve_online (c): staleness "
                                     f"{staleness} past {bound} s")
            _, newest = server.slot.read()
            newer.load_state_dict(newest)
            want = BatchPredictor(newer, device="cuda", chunk=CHUNK
                                  ).predict(ids[:64])
            for rid, r in tier.replicas.items():
                if r.params_version != server.slot.version:
                    raise AssertionError(f"serve_online (c): replica {rid} at "
                                         f"{r.params_version}")
                served = np.concatenate([r.infer(ids[i:i + 8])
                                         for i in range(0, 64, 8)])
                diff = float(np.abs(served - want).max())
                limit = 2e-2 * max(1.0, float(np.abs(want).max()))
                log(f"serve_online (c): replica {rid}, 64 rows vs "
                    f"BatchPredictor on the server's newest weights: max abs "
                    f"diff {diff:.3e} (limit {limit:.3e})")
                if not diff <= limit:
                    raise AssertionError(f"serve_online (c): replica {rid} "
                                         "does not serve the pushed weights")
            out["push"] = dict(staleness_s=staleness, bound_s=bound,
                               install_s=[h["max"] for h in installs],
                               poll_s=[h["max"] for h in polls],
                               first_sync_s=first_sync_s)
        finally:
            http.stop()
            server.stop()
    finally:
        tier.stop()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"serve_online phase: {out['wall_s']:.1f} s")
    return counts, out


def fleet_check_served(torch, what, replica, leaves, ids, dense):
    """``replica``'s rows against the dense-attention twin loaded with the
    weights its puller installed (``leaves``: the puller's cache)."""
    from sparktorch_tpu_torch.inference import BatchPredictor

    dense.load_state_dict({p[0]: torch.as_tensor(np.asarray(v))
                           for p, v in leaves.items()})
    want = BatchPredictor(dense, device="cuda", chunk=CHUNK).predict(ids)
    got = np.concatenate([replica.infer(ids[i:i + 8])
                          for i in range(0, len(ids), 8)])
    diff = float(np.abs(got - want).max())
    limit = 5e-2 * max(1.0, float(np.abs(want).max()))
    log(f"{what}: {len(ids)} rows vs dense attention on the installed "
        f"weights: max abs diff {diff:.3e} (limit {limit:.3e})")
    if not (np.isfinite(got).all() and diff <= limit):
        raise AssertionError(f"{what}: served rows disagree")
    return diff, limit


def fleet_leaves_on_host(fleet, peaks):
    """The fleet's leaves as host arrays, each leaf's max |x| folded into
    ``peaks`` (its peak over every version so far)."""
    leaves = {(n,): v.detach().float().cpu().numpy()
              for n, v in fleet.assemble().items()}
    for path, v in leaves.items():
        peaks[path] = max(peaks.get(path, 0.0),
                          float(np.abs(v).max()) if v.size else 0.0)
    return leaves


def fleet_check_leaves(what, pullers, want, peaks):
    """Every leaf each puller installed against the fleet's own leaf.

    An int8 pull with the server's error feedback serves a version as
    x + r_prev - r, each residual at most half its version's scale s,
    and s = max|x + r_prev| / 127 <= (peak + s_max / 2) / 127, so the
    error is at most s_max <= peak / 126.5 (peak: the leaf's max |x|
    over its versions). Returns the worst leaf's error over its limit."""
    worst = (0.0, None)
    for rid, puller in pullers.items():
        cache = puller.transport._leaves
        if set(cache) != set(want):
            raise AssertionError(f"{what}: replica {rid} holds "
                                 f"{len(cache)} leaves, the fleet "
                                 f"{len(want)}")
        for path, v in want.items():
            err = float(np.abs(np.asarray(cache[path], np.float32) - v)
                        .max()) if v.size else 0.0
            limit = peaks[path] / 126.5
            if not err <= limit:
                raise AssertionError(
                    f"{what}: replica {rid} leaf {path[0]} off the fleet's "
                    f"by {err:.3e}, past one int8 step {limit:.3e}")
            ratio = err / limit if limit else 0.0
            if worst[1] is None or ratio > worst[0]:
                worst = (ratio, dict(replica=rid, leaf=path[0], err=err,
                                     limit=limit))
    return worst


def fleet_push_to_replicas(torch, what, fleet, tier, grads, tele, peaks,
                           bound):
    """One push through ``fleet.scatter_push``, then each replica's
    staleness (push return to its install of the fleet's versions),
    held to ``bound``, the bytes of its pulls meanwhile, and each
    installed leaf against the fleet's."""
    pullers = tier._pullers
    bytes0 = {r: p.transport.stats["pull_bytes"] for r, p in pullers.items()}
    polls0 = {r: tele.histogram("serve.weight_poll_s", {"replica": r})
              ["count"] for r in pullers}
    t0 = time.monotonic()
    fleet.scatter_push(grads, wait=True)
    pushed = sum(s.slot.version for s in fleet._shards.values())
    t_push = time.monotonic()
    staleness = {}
    while (len(staleness) < len(pullers)
           and time.monotonic() < t_push + bound + 30.0):
        for rid, r in tier.replicas.items():
            if rid not in staleness and r.params_version >= pushed:
                staleness[rid] = time.monotonic() - t_push
        time.sleep(0.005)
    if len(staleness) < len(pullers) or max(staleness.values()) > bound:
        raise AssertionError(
            f"{what}: staleness {staleness} past {bound:.2f} s (replicas "
            f"at {[r.params_version for r in tier.replicas.values()]}, "
            f"fleet at {pushed})")
    time.sleep(2 * SERVE_POLL_S)  # the pullers' next polls: 304s
    worst, where = fleet_check_leaves(what, pullers,
                                      fleet_leaves_on_host(fleet, peaks),
                                      peaks)
    nbytes = {r: p.transport.stats["pull_bytes"] - bytes0[r]
              for r, p in pullers.items()}
    installs = [tele.histogram("serve.weight_install_s", {"replica": r})
                ["max"] for r in pullers]
    # The slowest /delta.bin reply of each shard so far (its render —
    # the host copy and the int8 quantization of a new version — and the
    # send): the server's part of a pull.
    renders = {sid: round(fleet.telemetry.histogram(
        "param_server.wire_latency_s",
        {"route": "/delta.bin", "shard": sid})["max"], 4)
        for sid in fleet._shards}
    polls = [tele.histogram("serve.weight_poll_s", {"replica": r})
             for r in pullers]
    log(f"{what}: {len(grads)} leaves pushed in {t_push - t0:.3f} s "
        f"(the shards' applies); staleness {staleness} s (bound "
        f"{bound:.2f} s); installed leaves against the fleet's: worst "
        f"{worst:.3f} of one int8 step ({where}); int8 delta bytes "
        f"per replica {nbytes}; slowest /delta.bin reply by shard "
        f"{renders} s; install_params max {installs} s; slowest "
        f"poll (pulls, dequantize, install) "
        f"{[round(h['max'], 4) for h in polls]} s over "
        f"{[h['count'] - polls0[r] for h, r in zip(polls, pullers)]} polls")
    return dict(leaves=len(grads), apply_s=t_push - t0, staleness_s=staleness,
                bound_s=bound, worst_leaf=dict(where or {}, of_step=worst),
                delta_bytes=nbytes, install_s=installs, render_s=renders,
                poll_max_s=[h["max"] for h in polls])


# The traced serving path (a leg of the fleet phase, on its BERT-base
# module and its 4-shard fleet; every request sampled): (a) RPC_REQUESTS
# single-row requests through an InferenceTier of SERVE_REPLICAS
# replicas, then the same rows untraced; (b) and (d) traced int8 delta
# pulls through a ShardedTransport: a dense push's pull, then one with
# shard RPC_SLOW_SHARD slowed by RPC_SLOW_S a request; (c) the bench's
# rpc_trace at the JAX depth.
RPC_REQUESTS, RPC_SLOW_SHARD, RPC_SLOW_S = 32, "2", 1.0


def rpc_tree_shape(node):
    """A stitched tree's names, kinds and children, as nested tuples."""
    return (node["name"], node["kind"],
            tuple(sorted(rpc_tree_shape(c) for c in node["children"])))


def rpc_serve_leg(torch, module, dense, ids):
    """(a): each traced request one ``infer`` -> ``replica`` ->
    {``queue_wait``, ``execute``} tree, every root's wall at least its
    slowest child's, ``flash_fwd`` launched 12 times a batch the trace
    shows, and the rows equal to an untraced run's bit for bit (one row
    a request: bucket 1 both times)."""
    from sparktorch_tpu_torch.obs import Telemetry, rpctrace
    from sparktorch_tpu_torch.serve.router import InferenceTier

    n_layers = module.config.n_layers
    tele = Telemetry(run_id="rpc_serve")
    tracer = rpctrace.tracer_for(tele)
    tracer.sample_rate = 1.0
    tracer.resize(8 * RPC_REQUESTS)
    tier = InferenceTier(module, n_replicas=SERVE_REPLICAS, telemetry=tele,
                         buckets=SERVE_BUCKETS, warm_input=ids[:1],
                         device="cuda")
    try:
        reset_counts()
        t0 = time.perf_counter()
        traced = [tier.submit(ids[i:i + 1]) for i in range(RPC_REQUESTS)]
        traced_s = time.perf_counter() - t0
        got = read_counts()
        deadline = time.monotonic() + 10.0
        while (len(tracer.spans) < 4 * RPC_REQUESTS
               and time.monotonic() < deadline):
            time.sleep(0.01)
        spans = tracer.spans
        tracer.sample_rate = -1.0  # the tracer off: the untraced run
        t0 = time.perf_counter()
        untraced = [tier.submit(ids[i:i + 1]) for i in range(RPC_REQUESTS)]
        untraced_s = time.perf_counter() - t0
        if len(tracer.spans) != len(spans):
            raise AssertionError("rpc (a): the untraced run recorded spans")
    finally:
        tier.stop()
    trees = rpctrace.stitch_spans(spans)
    want = ("infer", "client", (("replica", "client", (
        ("execute", "server", ()), ("queue_wait", "server", ()))),))
    shapes = {rpc_tree_shape(t["root"]) for t in trees}
    if len(trees) != RPC_REQUESTS or shapes != {want} or any(
            t["orphans"] or t["extra_roots"] for t in trees):
        raise AssertionError(f"rpc (a): {len(trees)} trees of shapes "
                             f"{shapes}, want {RPC_REQUESTS} of {want}")
    for t in trees:
        kids = [c for n in (t["root"], t["root"]["children"][0])
                for c in n["children"]]
        if t["wall_s"] < max(float(c["dur_s"]) for c in kids):
            raise AssertionError(f"rpc (a): root wall {t['wall_s']} below "
                                 f"a child's {[c['dur_s'] for c in kids]}")
    executes = [s for s in spans if s["name"] == "execute"]
    batches = len({(s["ann"]["replica"], s["ts"]) for s in executes})
    if {s["ann"]["bucket"] for s in executes} != {1}:
        raise AssertionError(f"rpc (a): buckets "
                             f"{sorted({s['ann']['bucket'] for s in executes})}")
    expect_counts("rpc (a) traced requests", got,
                  dict(NO_KERNELS, flash_fwd=n_layers * batches))
    unequal = [i for i, (a, b) in enumerate(zip(traced, untraced))
               if not np.array_equal(a, b)]
    if unequal:
        raise AssertionError(f"rpc (a): traced rows {unequal} differ from "
                             "the untraced run's")
    from sparktorch_tpu_torch.inference import BatchPredictor

    dense.load_state_dict(module.state_dict())
    ref = BatchPredictor(dense, device="cuda", chunk=CHUNK).predict(
        ids[:RPC_REQUESTS])
    err = float(np.abs(np.concatenate(traced) - ref).max())
    limit = 5e-2 * max(1.0, float(np.abs(ref).max()))
    if not err <= limit:
        raise AssertionError(f"rpc (a): rows off dense attention by {err} "
                             f"(limit {limit})")
    walls = sorted(t["wall_s"] for t in trees)
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(float(s["dur_s"]))
    p50 = {k: round(float(np.median(v)) * 1e3, 3) for k, v in by_name.items()}
    log(f"rpc (a) {RPC_REQUESTS} traced single-row requests, "
        f"{SERVE_REPLICAS} replicas: {len(trees)} trees infer -> replica -> "
        f"{{queue_wait, execute}}, {batches} batches, span p50 ms {p50}, "
        f"root wall p50 {walls[len(walls) // 2] * 1e3:.3f} ms, max "
        f"{walls[-1] * 1e3:.3f} ms; rows equal to the untraced run's bit "
        f"for bit; off dense attention by {err:.3e} (limit {limit:.3e}); "
        f"traced {traced_s:.2f} s, untraced {untraced_s:.2f} s")
    return got, dict(requests=RPC_REQUESTS, trees=len(trees),
                     batches=batches, span_p50_ms=p50,
                     root_wall_p50_ms=walls[len(walls) // 2] * 1e3,
                     traced_s=traced_s, untraced_s=untraced_s,
                     max_abs_err=err)


def rpc_pull_hops(tree):
    """``{shard: {hop, serve, render}}`` seconds of one stitched pull."""
    hops = {}
    for hop in tree["root"]["children"]:
        serve = hop["children"][0] if hop["children"] else None
        render = (serve["children"][0]
                  if serve is not None and serve["children"] else None)
        hops[hop["ann"]["shard"]] = {
            "hop_s": round(float(hop["dur_s"]), 4),
            "serve_s": serve and round(float(serve["dur_s"]), 4),
            "render_s": render and round(float(render["dur_s"]), 4)}
    return hops


def rpc_fleet_leg(torch, fleet):
    """(b) and (d): traced int8 delta pulls of the fleet's BERT-base
    leaves through a ShardedTransport: each pull one tree of 4
    ``shard_pull`` -> ``serve`` -> ``render`` hops; a dense push's pull
    timed hop by hop (d); the next with one shard slowed, that shard the
    critical path in the collector's stitched trees and in
    ``timeline --rpc`` from its JSONL sink (b)."""
    import contextlib
    import io

    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry, rpctrace
    from sparktorch_tpu_torch.obs import timeline

    tele = Telemetry(run_id="rpc_fleet")
    rpctrace.tracer_for(tele).sample_rate = 1.0
    t = ShardedTransport(fleet, pull_quant="int8", telemetry=tele)
    sink = os.path.join(SCRATCH, "rpc_collector.jsonl")
    collector = None
    try:
        version = t.pull(-1)[0]
        ones = {(n,): torch.ones_like(v) for n, v in fleet.assemble().items()}
        walls = {}
        for label in ("dense", "slowed"):
            fleet.scatter_push(ones, wait=True)
            slow = (inject(ChaosConfig(seed=0, slow_shard_s={
                RPC_SLOW_SHARD: RPC_SLOW_S})) if label == "slowed"
                else contextlib.nullcontext())
            t0 = time.perf_counter()
            with slow:
                version = t.pull(version)[0]
            walls[label] = time.perf_counter() - t0
        time.sleep(0.2)  # the handlers close their serve spans
        collector = FleetCollector.for_fleet(fleet, poll_interval_s=0,
                                             jsonl_path=sink, telemetry=tele)
        collector.poll()
        traces = [tr for tr in collector.rpc_traces()
                  if tr["root"]["name"] == "pull"]
    finally:
        t.close()
        if collector is not None:
            collector.stop()
    hop = ("shard_pull", "client", (
        ("serve", "server", (("render", "server", ()),)),))
    want = ("pull", "client", (hop,) * FLEET_SHARDS)
    shapes = {rpc_tree_shape(tr["root"]) for tr in traces}
    if len(traces) != 3 or shapes != {want}:
        raise AssertionError(f"rpc (b): {len(traces)} pull trees of shapes "
                             f"{shapes}")
    slowed, dense_pull, first = traces  # newest first
    crit = slowed["critical"]
    if str(crit["shard"]) != RPC_SLOW_SHARD:
        raise AssertionError(f"rpc (b): critical path {crit}, want shard "
                             f"{RPC_SLOW_SHARD}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = timeline.main(["--rpc", sink])
    rendered = buf.getvalue()
    head = [ln for ln in rendered.splitlines() if ln.startswith("trace ")]
    if rc != 0 or not head or f"shard {RPC_SLOW_SHARD}" not in head[0] \
            or "bound by" not in head[0]:
        raise AssertionError(f"rpc (b): timeline --rpc (rc={rc}):\n"
                             f"{rendered[:1200]}")
    hops = {"first": rpc_pull_hops(first), "dense": rpc_pull_hops(dense_pull),
            "slowed": rpc_pull_hops(slowed)}
    log(f"rpc (b) traced int8 delta pulls of BERT-base from "
        f"{FLEET_SHARDS} shards: 3 trees of {FLEET_SHARDS} shard_pull -> "
        f"serve -> render hops; with shard {RPC_SLOW_SHARD} slowed by "
        f"{RPC_SLOW_S} s the pull took {walls['slowed']:.3f} s and its "
        f"critical path is {crit['name']} on shard {crit['shard']} "
        f"({crit['fraction']:.0%} of the wall), in the collector and in "
        f"timeline --rpc: {head[0].strip()}")
    log(f"rpc (d) the dense push's pull without chaos, "
        f"{walls['dense']:.3f} s (root {dense_pull['wall_s']:.4f} s), by "
        f"shard (hop, serve, render s): {hops['dense']}; the first sync: "
        f"{hops['first']}")
    return dict(walls_s=walls, critical=crit, hops=hops,
                timeline_head=head[0].strip())


def rpc_phase(torch, module, dense, fleet, ids):
    """The traced serving path on the fleet phase's BERT-base and its
    fleet: (a), (b) and (d) above, and (c) the bench's rpc_trace at the
    JAX depth with its gates and record keys."""
    from sparktorch_tpu_torch import bench

    t_phase = time.perf_counter()
    counts, out = {}, {}
    counts["rpc_serve"], out["serve"] = rpc_serve_leg(torch, module, dense,
                                                      ids)
    reset_counts()
    out["fleet"] = rpc_fleet_leg(torch, fleet)
    counts["rpc_fleet"] = read_counts()
    expect_counts("rpc (b) traced pulls", counts["rpc_fleet"], NO_KERNELS)
    reset_counts()
    t0 = time.perf_counter()
    rec = bench.CONFIGS["rpc_trace"]()
    wall = time.perf_counter() - t0
    counts["rpc_bench"] = read_counts()
    log(json.dumps(rec))
    expect_counts("rpc (c) bench", counts["rpc_bench"], NO_KERNELS)
    check_record_keys(bench, "rpc_trace", rec)
    log(f"rpc (c) bench: overhead {rec['overhead_pct']}% at the default "
        f"{rec['sample_rate_default']} sampling (fast path "
        f"{rec['fast_path_us']} us, sampled chain {rec['sampled_chain_us']}"
        f" us, wire op p50 {rec['wire_op_p50_ms']} ms), {rec['pull_trees']} "
        f"pull trees, reconcile {rec['reconcile']}, slow shard "
        f"{rec['slow_shard']}; {wall:.1f} s")
    out["bench"] = rec
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase rpc: {out['wall_s']:.1f} s")
    return counts, out


def fleet_phase(torch):
    """The sharded parameter-server fleet: (a) the bench's
    ``hogwild_ps_fleet`` (2 interleaved pairs, BENCH_DEPTH), every gate
    holding; (b)
    BERT-base behind the serving tier, its weights in a 4-shard fleet on
    the card and each replica pulling int8 deltas through a
    ``ShardedTransport``, after a dense push and a sparse one, then
    ``rpc_phase`` on that module and fleet; (c)
    ``train_async(shards=4, pull_quant="int8")`` of BERT-base; (d) one
    worker on a 4-shard fleet against the single server."""
    from sparktorch_tpu_torch import bench, serialize_torch_obj
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.serve.router import InferenceTier
    from sparktorch_tpu_torch.train.hogwild import train_async
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    t_phase = time.perf_counter()
    counts, out = {}, {}

    # (a) the bench's hogwild_ps_fleet (BENCH_DEPTH's pairs): no kernel
    # runs.
    reset_counts()
    t0 = time.perf_counter()
    rec = bench.CONFIGS["hogwild_ps_fleet"](**BENCH_DEPTH["hogwild_ps_fleet"])
    wall = time.perf_counter() - t0
    counts["fleet_bench"] = read_counts()
    log(json.dumps(rec))
    expect_counts("fleet (a) bench", counts["fleet_bench"], NO_KERNELS)
    check_record_keys(bench, "hogwild_ps_fleet", rec)
    kill = rec["shard_kill"]
    if kill["fired"] < 1 or kill["records"] != 24 or kill["restarts"] < 1:
        raise AssertionError(f"fleet (a): shard kill {kill}")
    log(f"fleet (a) bench: {rec['model_mb']} MB, {rec['hot_leaves']}/"
        f"{rec['total_leaves']} hot leaves; bandwidth x{rec['bandwidth_ratio']}"
        f", p99 x{rec['p99_ratio']} ({rec['fleet']['pull_p99_ms']} vs "
        f"{rec['single']['pull_p99_ms']} ms); MB per fresh pull: single "
        f"{rec['single']['wire_mb_per_pull']}, fleet "
        f"{rec['fleet']['wire_mb_per_pull']}, int8 "
        f"{rec['fleet_int8']['wire_mb_per_pull']:.3f}; shard kill {kill}; "
        f"{wall:.1f} s")
    out["bench"] = rec

    # (b) BERT-base served by a tier whose pullers read a 4-shard fleet.
    torch.manual_seed(0)
    with torch.device("cuda"):
        module = bert_base(attn_impl="flash")
        dense = bert_base(attn_impl="dense")
    cfg = module.config
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (64, SERVE_SEQ)).astype(np.int64)
    torch.manual_seed(1)
    t0 = time.perf_counter()
    fleet = ParamServerFleet(ModelSpec(
        module=bert_base(attn_impl="flash"), loss="cross_entropy",
        optimizer="sgd", optimizer_params={"lr": 1e-3},
        input_shape=(SERVE_SEQ,)), n_shards=FLEET_SHARDS,
        device="cuda").start()
    fleet_s = time.perf_counter() - t0
    tele = Telemetry(run_id="fleet_tier")
    tier = InferenceTier(module, n_replicas=SERVE_REPLICAS, telemetry=tele,
                         buckets=SERVE_BUCKETS, max_queue_rows=1024,
                         warm_input=ids[:1], probe_interval_s=0.05,
                         device="cuda")
    try:
        probe = ShardedTransport(fleet, pull_quant=None)
        try:
            probe.pull(-1)
            full_f32_bytes = probe.stats["pull_bytes"]
        finally:
            probe.close()
        t0 = time.perf_counter()
        tier.start_pullers(lambda: ShardedTransport(fleet, pull_quant="int8"),
                           poll_s=SERVE_POLL_S)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and any(
                tele.counter_value("serve.weight_updates_total",
                                   {"replica": r}) < 1
                for r in tier.replicas):
            time.sleep(0.01)
        first_sync_s = time.perf_counter() - t0
        first_bytes = {r: p.transport.stats["pull_bytes"]
                       for r, p in tier._pullers.items()}
        log(f"fleet (b) BERT-base in {FLEET_SHARDS} shards on the card "
            f"(built in {fleet_s:.2f} s): one f32 full pull "
            f"{full_f32_bytes} B; the replicas' first int8 sync "
            f"{first_bytes} B in {first_sync_s:.2f} s")
        peaks = {}
        first_worst = fleet_check_leaves(
            "fleet (b) first sync", tier._pullers,
            fleet_leaves_on_host(fleet, peaks), peaks)
        log(f"fleet (b) first sync: installed leaves against the fleet's: "
            f"worst {first_worst[0]:.3f} of one int8 step "
            f"({first_worst[1]})")
        names = list(fleet.assemble())
        ones = {(n,): torch.ones_like(v)
                for n, v in fleet.assemble().items()}
        last = f"backbone.layers.{cfg.n_layers - 1}."
        sparse = {p: g for p, g in ones.items()
                  if p[0].startswith((last, "classifier."))}
        # serve_online (c)'s bound on the single server's full pull.
        bound = 20 * SERVE_POLL_S + 1.0
        pushes = {}
        for label, grads in (("dense", ones), ("sparse", sparse)):
            what = f"fleet (b) {label} push"
            pushes[label] = fleet_push_to_replicas(
                torch, what, fleet, tier, grads, tele, peaks, bound)
            b0 = sum(tele.counter_value("serve.batches_total", {"replica": r})
                     for r in tier.replicas)
            reset_counts()
            diffs = {}
            for rid, r in tier.replicas.items():
                diffs[rid] = fleet_check_served(
                    torch, f"{what}, replica {rid}", r,
                    tier._pullers[rid].transport._leaves, ids, dense)
            got = read_counts()
            n_batches = sum(tele.counter_value("serve.batches_total",
                                               {"replica": r})
                            for r in tier.replicas) - b0
            counts[f"fleet_serve_{label}"] = got
            expect_counts(f"{what}: served batches", got,
                          dict(NO_KERNELS, flash_fwd=cfg.n_layers
                               * int(n_batches)))
            pushes[label].update(diffs=diffs, batches=n_batches)
        out["serve"] = dict(full_f32_bytes=full_f32_bytes,
                            first_sync_s=first_sync_s,
                            first_sync_bytes=first_bytes, fleet_s=fleet_s,
                            params=sum(v.numel() for v in ones.values()),
                            leaves=len(names), pushes=pushes)
        # The traced serving path, on this module and this fleet, the
        # tier's pullers stopped first (their polls would share the
        # shards' renders).
        tier.stop()
        rpc_counts, out["rpc"] = rpc_phase(torch, module, dense, fleet, ids)
        counts.update(rpc_counts)
    finally:
        tier.stop()
        fleet.stop()
    del module, dense, fleet, ones, sparse

    # (c) hogwild BERT-base on a 4-shard fleet with int8 delta pulls.
    x, y = bert_ids(FLEET_ROWS, 2, cfg.vocab_size)
    payload = bert_payload(torch, 2)
    tele = Telemetry(run_id="fleet_train")
    reset_counts()
    t0 = time.perf_counter()
    result = train_async(payload, x, labels=y.astype(np.int64),
                         iters=FLEET_ITERS, partitions=FLEET_PARTS,
                         mini_batch=FLEET_MB, seed=0, transport="http",
                         shards=FLEET_SHARDS, pull_quant="int8",
                         telemetry=tele)
    wall = time.perf_counter() - t0
    got = counts["fleet_train"] = read_counts()
    steps = FLEET_ITERS * FLEET_PARTS
    expect_counts("fleet (c) train_async(shards=4, pull_quant='int8')", got,
                  dict(NO_KERNELS, flash_fwd=cfg.n_layers * steps,
                       flash_bwd_dq=cfg.n_layers * steps,
                       flash_bwd_dkv=cfg.n_layers * steps))
    summary = result.summary
    phases = summary["hogwild_phases"]
    pushes = sum(int(p["pushes"]) for p in phases)
    skipped = sum(int(p.get("pushes_skipped", 0)) for p in phases)
    owners = summary["fleet"]["shards"]
    losses = [r["loss"] for r in result.metrics]
    log(f"fleet (c) BERT-base hogwild, {FLEET_PARTS} workers x "
        f"{FLEET_ITERS} iterations of {FLEET_MB} rows x {BERT_SEQ} ids on "
        f"{owners} shards: {len(result.metrics)} records, applies "
        f"{summary['server_applied']} (pushes {pushes} x {owners} shards, "
        f"{skipped} partials dropped), pull MB "
        f"{summary['hogwild_budget']['pull_bytes'] / 1e6:.1f}, push MB "
        f"{summary['hogwild_budget']['push_bytes'] / 1e6:.1f}, losses "
        f"{[round(v, 4) for v in losses]}, fleet {summary['fleet']}; "
        f"{wall:.1f} s")
    if (len(result.metrics) != steps
            or summary["server_applied"] != pushes * owners - skipped
            or not np.isfinite(losses).all()):
        raise AssertionError(f"fleet (c): {summary['server_applied']} "
                             f"applies, {len(result.metrics)} records")
    out["train"] = dict(records=len(result.metrics), wall_s=wall,
                        applies=summary["server_applied"], pushes=pushes,
                        dropped=skipped, losses=losses,
                        budget=summary["hogwild_budget"])
    del result, payload

    # (d) one worker, float32 pulls: 4 shards against the single server.
    x, y = bert_ids(16, 3, cfg.vocab_size)
    finals, runs = {}, {}
    for shards in (FLEET_SHARDS, 1):
        torch.manual_seed(0)
        payload = serialize_torch_obj(
            bert_base(attn_impl="flash", n_layers=2),
            criterion="cross_entropy", optimizer="adam",
            optimizer_params={"lr": 2e-5}, input_shape=(BERT_SEQ,))
        reset_counts()
        t0 = time.perf_counter()
        result = train_async(payload, x, labels=y.astype(np.int64),
                             iters=3, partitions=1, seed=0,
                             transport="http", shards=shards,
                             telemetry=Telemetry(run_id=f"fleet_d{shards}"))
        runs[shards] = time.perf_counter() - t0
        got = counts[f"fleet_parity_{shards}"] = read_counts()
        expect_counts(f"fleet (d) shards={shards}", got,
                      dict(NO_KERNELS, flash_fwd=6, flash_bwd_dq=6,
                           flash_bwd_dkv=6))
        finals[shards] = result
    worst, exact = 0.0, True
    for key, want in finals[1].params.items():
        have = finals[FLEET_SHARDS].params[key]
        diff = float((have - want).abs().max())
        exact = exact and diff == 0.0
        limit = 1e-6 * float(want.abs().max())
        worst = max(worst, diff / max(limit, 1e-30))
        if not diff <= limit:
            raise AssertionError(f"fleet (d): {key} off by {diff:.3e} "
                                 f"(limit {limit:.3e})")
    log(f"fleet (d) 2-layer BERT-base-width encoder, one worker, 3 "
        f"iterations: {FLEET_SHARDS} shards vs the single server, "
        f"parameters {'bit-equal' if exact else 'within 1e-6 x max|param|'} "
        f"(worst {worst:.3f} of the limit), losses "
        f"{[r['loss'] for r in finals[FLEET_SHARDS].metrics]} vs "
        f"{[r['loss'] for r in finals[1].metrics]}; {runs[FLEET_SHARDS]:.1f}"
        f" s vs {runs[1]:.1f} s")
    out["parity"] = dict(bit_equal=exact, worst_of_limit=worst, wall_s=runs)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"fleet phase: {out['wall_s']:.1f} s")
    return counts, out


# The supervised paths: the LM of phase 5 at s = SUP_SEQ on SUP_ROWS
# rows. (a) train_async under the ft supervisor in this process, on
# phase 5's remat payload, SUP_ITERS full-batch steps, clean and with
# worker 0 killed at step SUP_KILL_AT; (b) a ctl.worker child running the
# hogwild worker for SUP_CHILD_ITERS steps against this process's binary
# parameter server, SIGKILLed once its heartbeat reports step
# SUP_CHILD_KILL_AT, on the same LM without remat (a fresh process's
# first non-reentrant torch.utils.checkpoint imports torch._dynamo, ~8 s
# on the card's host, which each child would pay).
SUP_ROWS, SUP_SEQ, SUP_ITERS, SUP_KILL_AT = 2, 2048, 8, 3
SUP_CHILD_ITERS, SUP_CHILD_KILL_AT = 4, 2


def sup_policy():
    from sparktorch_tpu_torch.ft import FtPolicy, RestartPolicy

    return FtPolicy(restart=RestartPolicy(max_restarts=2,
                                          backoff_base_s=0.05), seed=0)


def sup_lm(torch):
    """The LM at SUP_SEQ without remat, its payload and SUP_ROWS rows of
    ids with next-token labels (leg (b)'s child)."""
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import CausalLM

    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    torch.manual_seed(4)
    cfg = TransformerConfig(max_len=SUP_SEQ, attn_impl="flash",
                            **dict(LM, remat=False))
    payload = serialize_torch_obj(CausalLM(cfg), criterion="cross_entropy",
                                  optimizer="adamw",
                                  optimizer_params={"lr": 3e-4})
    ids = np.random.default_rng(4).integers(0, LM["vocab_size"],
                                            (SUP_ROWS, SUP_SEQ + 1))
    return payload, ids[:, :-1].astype(np.float32), ids[:, 1:]


def sup_hogwild(torch, payload, x, y):
    """(a) train_async(supervise=True) over local transport, clean and
    under kill_worker_at={0: SUP_KILL_AT}: one restart, the clean run's
    record count, recovery within 10 s, the loss finite and falling, and
    the launches of every step the two runs computed (the killed
    attempt's SUP_KILL_AT steps among them): with remat, two forwards
    (with lse), one dq and one dk/dv a layer and one CE forward and
    backward a step."""
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.hogwild import train_async

    kw = dict(labels=y, iters=SUP_ITERS, seed=0, supervise=True,
              ft_policy=sup_policy(), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    clean = train_async(payload, x, telemetry=Telemetry(run_id="sup_clean"),
                        **kw)
    clean_s = time.perf_counter() - t0
    tele = Telemetry(run_id="sup_chaos")
    t0 = time.perf_counter()
    with inject(ChaosConfig(kill_worker_at={0: SUP_KILL_AT}, seed=0),
                telemetry=tele) as inj:
        result = train_async(payload, x, telemetry=tele, **kw)
    chaos_s = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("supervise (a) hogwild LM, clean and killed", counts,
                  lm_step_counts(2 * SUP_ITERS + SUP_KILL_AT))
    restarts = result.summary["ft"]["restarts_total"]
    recovery = tele.histogram("ft_recovery_latency_s", labels={"worker": "0"})
    losses = [r["loss"] for r in result.metrics]
    log(f"supervise (a) hogwild LM (remat, s={SUP_SEQ}, {SUP_ROWS} rows, "
        f"{SUP_ITERS} steps, local): clean {clean_s:.2f} s, killed at step "
        f"{SUP_KILL_AT} {chaos_s:.2f} s; {restarts} restart, recovery "
        f"{recovery['max']:.3f} s; {len(result.metrics)} records (clean "
        f"{len(clean.metrics)}); losses {[round(v, 4) for v in losses]}; "
        f"chaos events {[e['site'] for e in inj.events]}")
    if (restarts != 1 or clean.summary["ft"]["restarts_total"] != 0
            or len(result.metrics) != len(clean.metrics)
            or recovery["count"] != 1 or not recovery["max"] <= 10.0
            or not np.isfinite(losses).all() or not losses[-1] < losses[0]):
        raise AssertionError("supervise (a): the supervised hogwild run "
                             "failed its checks")
    return counts, dict(clean_s=clean_s, chaos_s=chaos_s, restarts=restarts,
                        recovery_s=recovery["max"], records=len(losses),
                        losses=losses)


def sup_child(torch, payload, x, y):
    """(b) The parent serves the LM from ParameterServer + ParamServerHttp;
    a ``ctl.worker`` child (kind ``hogwild_worker``) trains it on the
    card under a Supervisor holding its ``ctl.proc.ProcessWorker``, and
    ``kill_process_at`` SIGKILLs the first child once. The rerun pulls
    the current version, the server's applies equal the killed child's
    pushes plus the rerun's, one ``ft_restarts_total``, exit code
    EXIT_OK. Prints the kill -> relaunch latency and each child's start
    (spawn to its first step: ``import torch``, the card's context, the
    model)."""
    from sparktorch_tpu_torch.ctl import EXIT_OK, spawn_worker
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.ft.supervisor import Supervisor
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )

    root = os.path.join(SCRATCH, "supervise")
    hb_dir = os.path.join(root, "hb")
    os.makedirs(hb_dir, exist_ok=True)
    shard = os.path.join(root, "shard.npz")
    np.savez(shard, x=x, y=y)
    records = os.path.join(root, "records.jsonl")
    tele = Telemetry(run_id="sup_child")
    server = ParameterServer(payload, window_len=1, device="cuda",
                             telemetry=tele)
    http = ParamServerHttp(server, port=0).start()
    spawned, handles = [], []

    def start(attempt):
        spawned.append(time.perf_counter())
        handle = spawn_worker(
            kind="hogwild_worker", rank=0, heartbeat_dir=hb_dir,
            name=f"lm{attempt}", payload_dir=root, telemetry=tele,
            kwargs=dict(torch_obj=payload, url=http.url, data=shard,
                        iters=SUP_CHILD_ITERS, records_path=records,
                        device="cuda"))
        handles.append(handle)
        return handle

    first_step, ended = {}, {}
    watching = threading.Event()

    def watch():
        # Each child's first reported step (its heartbeat's pid tells
        # the attempts apart) and its end.
        while not watching.is_set():
            for i, h in enumerate(list(handles)):
                rec = h.heartbeat_record() or {}
                if (i not in first_step and rec.get("pid") == h.pid
                        and rec.get("step") is not None):
                    first_step[i] = time.perf_counter()
                if i not in ended and h.process.poll() is not None:
                    ended[i] = time.perf_counter()
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    sup = Supervisor(policy=sup_policy(), telemetry=tele, name="sup_child")
    sup.add("lm", start, rank=0)
    reset_counts()
    t0 = time.perf_counter()
    try:
        with inject(ChaosConfig(kill_process_at={0: SUP_CHILD_KILL_AT},
                                seed=0), telemetry=tele) as inj:
            summary = sup.run(poll_interval_s=0.05, deadline_s=240)
        wall = time.perf_counter() - t0
        applied = server.applied_updates
    finally:
        watching.set()
        watcher.join()
        http.stop()
        server.stop()
    counts = read_counts()
    expect_counts("supervise (b) parent while the child trains", counts,
                  NO_KERNELS)
    with open(records) as f:
        rerun = [json.loads(line) for line in f]
    shutil.rmtree(root, ignore_errors=True)
    recovery = tele.histogram("ft_recovery_latency_s",
                              labels={"worker": "lm"})
    starts = [first_step[i] - spawned[i] for i in sorted(first_step)]
    # The rerun's push stamps (perf_counter reads CLOCK_MONOTONIC, one
    # clock for both processes): its first step, then one a step.
    pushes = [r["t"] for r in rerun]
    log(f"supervise (b) timeline, s from the first spawn: spawns "
        f"{[round(t - t0, 2) for t in spawned]}, first steps "
        f"{[round(first_step[i] - t0, 2) for i in sorted(first_step)]}, "
        f"ends {[round(ended[i] - t0, 2) for i in sorted(ended)]}; the "
        f"rerun's pushes {[round(t - t0, 2) for t in pushes]}")
    fired = [e for e in inj.events if e["site"] == "ctl.process"]
    log(f"supervise (b) ctl.worker child (hogwild_worker, LM s={SUP_SEQ}) "
        f"SIGKILLed at heartbeat step {fired[0]['step'] if fired else None}: "
        f"restarts {summary['restarts']}, kill -> relaunch "
        f"{recovery['max']:.3f} s; child start (spawn -> first step: "
        f"import torch, the card's context, the model) "
        f"{[round(v, 2) for v in starts]} s; the rerun pulled version "
        f"{rerun[0]['version']} and pushed {len(rerun)}, the server applied "
        f"{applied}; exit codes {[h.process.returncode for h in handles]}; "
        f"{wall:.1f} s")
    for h in handles:
        h.cleanup()
    if (summary["restarts"] != {"lm": 1} or len(fired) != 1
            or tele.counter_value("ft_restarts_total",
                                  labels={"worker": "lm"}) != 1
            or handles[-1].process.returncode != EXIT_OK
            or handles[0].process.returncode != -9
            or not rerun[0]["version"] >= SUP_CHILD_KILL_AT
            or len(rerun) != SUP_CHILD_ITERS
            or applied != rerun[0]["version"] + len(rerun)
            or not np.isfinite([r["loss"] for r in rerun]).all()):
        raise AssertionError("supervise (b): the process worker failed its "
                             "checks")
    return counts, dict(wall_s=wall, recovery_s=recovery["max"],
                        child_start_s=starts, applied=applied,
                        rerun_first_version=rerun[0]["version"])


def supervise_phase(torch):
    """The ft supervisor and ``ctl/`` on the card: (a) supervised hogwild
    in-process under a worker kill, on phase 5's remat LM, (b) a
    ``ctl.worker`` child under SIGKILL, on the LM without remat (see
    ``sup_hogwild`` and ``sup_child``); (c), the supervised Spark fit, is
    the spark phase's (a)."""
    t_phase = time.perf_counter()
    payload, x, y = sup_lm(torch)
    counts, out = {}, {}
    counts["supervise_hogwild"], out["hogwild"] = sup_hogwild(
        torch, lm_payload(torch, 0), x, y)
    torch.cuda.empty_cache()
    counts["supervise_child"], out["child"] = sup_child(torch, payload, x, y)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"supervise phase: {out['wall_s']:.1f} s")
    return counts, out


START = time.perf_counter()


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
        for kernel, regs, st, ld, smem in ptxas_report(text):
            launch = (f"; {LAUNCH[kernel][0]} threads, dynamic smem "
                      f"{LAUNCH[kernel][1]} B" if kernel in LAUNCH else "")
            log(f"  ptxas {name}: {kernel}: {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B, static smem {smem} B"
                + launch)

    os.makedirs(SCRATCH, exist_ok=True)
    try:
        return run_phases(torch)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)


def run_phases(torch) -> int:
    marks = [time.perf_counter()]

    def done(name):
        marks.append(time.perf_counter())
        log(f"phase {name}: {marks[-1] - marks[-2]:.1f} s")

    fwd_cases = kernel_phase(torch)
    bwd_cases = bwd_kernel_phase(torch)
    ce_cases = ce_kernel_phase(torch)
    done("kernels")
    serve_counts, rows_per_s = slice_phase(torch)
    done("slice")
    lm_counts, lm, lm_fit = train_lm_phase(torch)
    obs_counts, lm["obs"] = train_lm_obs_phase(torch, *lm_fit)
    health_counts, health = health_phase(torch, lm_fit[0])
    del lm_fit
    parity = train_parity_phase(torch)
    done("train_lm, obs, health and parity")
    bench_counts_by_path, bench = bench_phase(torch)
    done("bench")
    moe_counts, moe = moe_phase(torch)
    done("moe")
    bert_counts, bert = train_bert_phase(torch, bench["bert_dp"])
    quick_counts, quick = quickstart_phase(torch)
    stream_counts, lm_stream = train_lm_streaming_phase(
        torch, lm["tokens_per_s"])
    resume_counts, lm_resume = train_lm_resume_phase(torch)
    done("train_bert, quickstart, streaming and resume")
    hogwild_counts, hogwild = hogwild_phase(torch,
                                            bench["resnet18_hogwild"])
    done("hogwild")
    r50_counts, resnet50_serve = serve_resnet50_phase(torch)
    r50_stream_counts, resnet50_stream = serve_resnet50_stream_phase(
        torch, resnet50_serve["rows_per_s"])
    done("resnet50 serve and stream")
    dp_counts, dp = dp_phase(torch)
    done("dp")
    sharded_counts, sharded = sharded_phase(torch, lm)
    done("sharded")
    spark_counts, spark = spark_phase(torch)
    done("spark")
    serve_online_counts, serve_online = serve_online_phase(torch)
    done("serve_online")
    fleet_counts, fleet = fleet_phase(torch)
    done("fleet")
    supervise_counts, supervise = supervise_phase(torch)
    done("supervise")
    lint_wire_counts, lint_wire = lint_wire_phase(torch)
    done("lint and wire")

    # Each kernel's numbers at its main path's shape: the serving chunk
    # for the forward, the LM training step for the other four.
    main_cases = {"flash_fwd": fwd_cases, "flash_bwd_dq": bwd_cases["dq"],
                  "flash_bwd_dkv": bwd_cases["dkv"], "ce_fwd": ce_cases["fwd"],
                  "ce_bwd": ce_cases["bwd"]}
    kernels = []
    for name, (source, replaces, design) in KERNELS.items():
        by_path = {"serve": serve_counts[name], "train_lm": lm_counts[name],
                   "train_bert": bert_counts[name],
                   "train_lm_streaming": stream_counts[name],
                   "train_lm_resume": resume_counts[name],
                   "quickstart_and_lazy_cnn": quick_counts[name],
                   **{path: c[name] for path, c in obs_counts.items()},
                   **{path: c[name] for path, c in health_counts.items()},
                   **{path: c[name] for path, c in hogwild_counts.items()},
                   "serve_resnet50": r50_counts[name],
                   "serve_resnet50_stream": r50_stream_counts[name],
                   "dp": dp_counts[name],
                   **{path: c[name] for path, c in sharded_counts.items()},
                   **{path: c[name] for path, c in spark_counts.items()},
                   **{path: c[name] for path, c in moe_counts.items()},
                   **{path: c[name]
                      for path, c in serve_online_counts.items()},
                   **{path: c[name] for path, c in fleet_counts.items()},
                   **{path: c[name]
                      for path, c in supervise_counts.items()},
                   **{path: c[name]
                      for path, c in lint_wire_counts.items()},
                   **{path: c[name]
                      for path, c in bench_counts_by_path.items()}}
        cases = main_cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "design": design,
            "launches": by_path["serve" if name == "flash_fwd"
                                else "train_lm"],
            **{k: cases[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
            "max_rel_err": cases[0].get("max_rel_err"),
            "launches_by_path": by_path,
            "cases": cases,
        })
    log(f"total wall time: {time.perf_counter() - START:.1f} s")
    log(json.dumps({"kernels": kernels, "serve_rows_per_s": rows_per_s,
                    "train_lm": lm, "health": health,
                    "train_parity": parity,
                    "train_bert": bert, "train_lm_streaming": lm_stream,
                    "train_lm_resume": lm_resume, "quickstart": quick,
                    "hogwild": hogwild, "serve_resnet50": resnet50_serve,
                    "serve_resnet50_stream": resnet50_stream,
                    "bench": bench, "dp": dp, "sharded": sharded,
                    "spark": spark, "moe": moe,
                    "serve_online": serve_online, "fleet": fleet,
                    "supervise": supervise, "lint_wire": lint_wire}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
