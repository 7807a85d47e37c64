"""BASELINE.json's configs on the port — the port of the BASELINE part of ``sparktorch_tpu/bench.py``.

Configs (each keeps the JAX config's sizes, seeds and record keys):

1. ``mnist_mlp_sync``     — MNIST 3-layer MLP, synchronous DP
2. ``lazy_cnn_sync``      — MNIST CNN with lazy model materialization
3. ``resnet18_hogwild``   — ResNet-18 on CIFAR-10 shapes, async parameter
   server, with a sync leg at the same minibatch
4. ``bert_dp``            — BERT-base encoder, sync DP, with honest MFU
5. ``resnet50_inference`` — ResNet-50 batch inference, device-resident and
   over a Parquet stream

plus ``mnist_cnn_sync`` (the headline's workload), ``hogwild_wire``
(the dill wire against the binary one on real sockets),
``long_context_lm`` (the flash kernels at s = 8192), ``moe_lm`` (an
8-expert switch causal LM beside its dense twin), ``serve_online``
(the online serving tier's gates: continuous batching against the
fixed-window ``BatchPredictor`` under Poisson load, a replica kill, a
live weight push) and ``hogwild_ps_fleet`` (the 4-shard parameter-server
fleet's gates against the single server: pull bandwidth, p99 pull
latency, delta and int8 bytes, a seeded shard kill). Weights are seeded,
never pretrained.

The sync configs run :func:`_sync_epoch_bench`: data-parallel over the
mesh of :func:`~sparktorch_tpu_torch.parallel.mesh.build_mesh` (the
default process group, or a world of one), each rank stepping its shard
of the batch with :func:`~sparktorch_tpu_torch.train.step.train_step`.
Rates are per chip: divided by the world size where the JAX bench
divides by ``len(jax.devices())``.

Where the records differ from the JAX package's (``RECORD_KEYS`` below):

- ``xla_flops_per_step`` becomes ``counted_flops_per_step``
  (``torch.utils.flop_counter.FlopCounterMode`` over one step, plus the
  analytic FLOPs of every hand-written kernel launch in it, which the
  counter cannot see) and ``xla_tflops_per_chip`` becomes
  ``counted_tflops_per_chip``. ``xla_bytes_per_step`` has no counterpart,
  so the roofline fields carry the FLOPs term alone, against the H100's
  989 TFLOP/s dense bf16 (:mod:`sparktorch_tpu_torch.ops.roofline`).
- ``bert_dp`` runs the port's flash-attention kernels (the JAX config runs
  XLA's dense attention, which has no Pallas kernel).
- ``steps_run`` (train steps the harness ran) joins every sync record,
  ``long_context_lm`` adds its 2k legs' ``steps_run_at_2k`` and ``moe_lm``
  its dense twin's ``steps_run_dense``: with the kernels' launch counts
  they give the launches per step.
- ``moe_lm`` leaves out the JAX record's trace keys (``comm_budget`` with
  its ``comm_s``, ``comm_fraction``, ``overlap_fraction``, ``comm_drift``):
  they come from an analysed capture, which waits for the trace analyzer
  (``obs/xprof.py``, ROADMAP, Queue 1, item 10, step 4).
- ``serve_online``'s drift gate compares with the newest prior record,
  and every prior record is the JAX package's on a TPU (``BENCH_r*.json``,
  ``benchmarks/``), which may not carry over: its ``serve_drift`` is
  always ``{"status": "no_prior_record", "tolerance": 0.5}``.
- Left out: ``resnet50_inference``'s ``measured_run_*`` (long-haul runs
  logged on the TPU rig), the headline's append to ``benchmarks/`` (the
  port writes only where ``--log`` says) and the other non-BASELINE
  configs (item 11).

Timing: the span a sample measures ends at a read-back of the loss,
which waits for the card. Phase seconds come from a host timer that
synchronizes the card at each phase's end.

Each config's phases (``data``, ``init``, ``compile_warmup``,
``measure``, ...) are ``bench/<phase>`` spans on the process-global bus,
with the trainers' own spans and counters beneath them.

CLI: ``python -m sparktorch_tpu_torch.bench [--config headline|all|<name>]
[--log PATH] [--telemetry-dump PATH]`` (or ``sparktorch-tpu-torch-bench``);
``--telemetry-dump`` appends the bus's snapshot as one JSONL line after
the records. With no CUDA device
every config raises; the functions take ``device="cpu"`` for tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sparktorch_tpu_torch.obs import get_telemetry
from sparktorch_tpu_torch.ops.roofline import (
    PEAK_FLOPS,
    attention_flops,
    ce_ops,
    flash_bwd_flops,
)

# The reference proxy for the MNIST-CNN workload (torch on the CPU,
# forward + backward + Adam, batch 1024: the substrate the reference's
# own tests train on), measured by ``benchmarks/reference_proxy.py`` on
# the 8-core host CPU of the machine that holds the NVIDIA H100 80GB HBM3
# (700.00 W limit), torch 2.11.0: the median of 2,169.1, 2,915.0 and
# 2,745.1 examples/s.
REFERENCE_BASELINE_EXAMPLES_PER_SEC = 2745.1

H100_BF16_PEAK_TFLOPS = PEAK_FLOPS["bfloat16"] / 1e12

_SYNC_KEYS = {"examples_per_sec_per_chip", "rate_best", "rate_samples",
              "rate_spread_pct", "n_chips", "final_loss", "phase_s",
              "step_time_p50_s", "step_time_p99_s", "step_time_mean_s"}
_BUDGET_KEYS = {"budget_loop_s", "budget_pull_s", "budget_pull_place_s",
                "budget_dispatch_s", "budget_push_materialize_s",
                "budget_push_wire_s", "budget_poll_s", "budget_drain_s",
                "budget_other_s", "budget_fractions", "pull_mb", "push_mb",
                "pulls", "pull_fresh"}
# Each config's record keys in the JAX package (``main`` adds ``ts``),
# the keys the port leaves out, and the keys it adds.
RECORD_KEYS = {
    "mnist_mlp_sync": (
        {"config", "unit", *_SYNC_KEYS}, set(), {"steps_run"}),
    "mnist_cnn_sync": (
        {"config", "unit", *_SYNC_KEYS}, set(), {"steps_run"}),
    "lazy_cnn_sync": (
        {"config", "unit", "lazy_materialize_s", *_SYNC_KEYS}, set(),
        {"steps_run"}),
    "resnet18_hogwild": (
        {"config", "unit", "examples_per_sec_per_chip", "repeat_rates",
         "repeat_spread_pct", "n_chips", "pushes", "iters_recorded",
         "final_loss", "sync_examples_per_sec_per_chip",
         "async_efficiency_vs_sync", "http_examples_per_sec_per_chip",
         "async_efficiency_http_vs_local", "http_push_wire_s_per_push",
         "phase_s", "step_time_p50_s", "step_time_p99_s",
         "step_time_mean_s", *_BUDGET_KEYS}, set(), set()),
    "hogwild_wire": (
        {"config", "unit", "value", "binary", "dill",
         "push_bytes_ratio_dill_over_binary",
         "pull_bytes_ratio_dill_over_binary", "push_wire_speedup",
         "phase_s"}, set(), set()),
    "bert_dp": (
        {"config", "unit", "n_params", "n_params_embedding",
         "n_params_per_token", "achieved_tflops_per_chip", "mfu_honest",
         "achieved_tflops_6n_total_legacy", "flops_methodology",
         *_SYNC_KEYS, "xla_flops_per_step", "xla_bytes_per_step",
         "xla_tflops_per_chip", "roofline_min_step_s", "roofline_bound",
         "roofline_attainment"},
        {"xla_flops_per_step", "xla_bytes_per_step", "xla_tflops_per_chip"},
        {"counted_flops_per_step", "counted_tflops_per_chip", "steps_run"}),
    "resnet50_inference": (
        {"config", "unit", "examples_per_sec_per_chip", "phase_s",
         "chip_rate_rows_per_sec_per_chip", "stream_rows_per_sec",
         "stream_n_rows", "n_chips", "projected_1M_rows_s_chip_rate",
         "projected_1M_rows_s_host_stream", "wire_dtype",
         "measured_run_rows", "measured_run_rows_per_sec",
         "measured_run_wall_s"},
        {"measured_run_rows", "measured_run_rows_per_sec",
         "measured_run_wall_s"}, set()),
    "long_context_lm": (
        {"config", "unit", "seq_len", "tokens_per_sec_per_chip",
         "flash_vs_dense_step_ratio_at_2k", *_SYNC_KEYS}, set(),
        {"steps_run", "steps_run_at_2k"}),
    "moe_lm": (
        {"config", "unit", "n_experts", "seq_len", "tokens_per_sec_per_chip",
         "moe_vs_dense_step_ratio", *_SYNC_KEYS, "comm_budget",
         "comm_fraction", "overlap_fraction", "comm_drift"},
        {"comm_budget", "comm_fraction", "overlap_fraction", "comm_drift"},
        {"steps_run", "steps_run_dense"}),
    "serve_online": (
        {"config", "unit", "value", "n_requests", "serial_service_ms",
         "offered_rate_rps", "throughput_ratio", "p99_ratio",
         "cont_rows_per_s", "baseline", "continuous", "replica_kill",
         "weight_push", "serve_drift", "phase_s"}, set(), set()),
    "hogwild_ps_fleet": (
        {"config", "unit", "value", "n_shards", "workers", "quota",
         "model_mb", "hot_leaves", "total_leaves", "bandwidth_ratio",
         "p99_ratio", "single", "fleet", "fleet_int8",
         "delta_bytes_saved_pct", "int8_bytes_saved_pct", "shard_kill",
         "phase_s"}, set(), set()),
}


def mfu_honest(achieved_tflops_per_chip: float,
               peak_tflops: float = H100_BF16_PEAK_TFLOPS) -> float:
    """Model-FLOPs utilization from honest achieved TFLOPs per chip."""
    return achieved_tflops_per_chip / peak_tflops


def _resolve_device(device=None) -> torch.device:
    from sparktorch_tpu_torch.inference import _resolve_device as resolve

    return resolve(device)


class _Phase:
    """Host seconds of a ``with`` block, the card synchronized at its
    end, recorded on the process-global bus as the JAX bench's
    ``bench/<name>`` span (what ``--telemetry-dump`` writes out)."""

    def __init__(self, dev: torch.device, name: str):
        self.dev = dev
        self.duration_s = 0.0
        self._span = get_telemetry().span(f"bench/{name}")

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.duration_s = time.perf_counter() - self._t0
        finally:
            self._span.__exit__(*exc)


def _phase_s(**phases: _Phase) -> dict:
    return {k: round(p.duration_s, 3) for k, p in phases.items()}


def _steps_summary(times: List[float]) -> Dict[str, float]:
    ts = np.asarray(sorted(times))
    return {
        "step_time_p50_s": float(np.percentile(ts, 50)),
        "step_time_p99_s": float(np.percentile(ts, 99)),
        "step_time_mean_s": float(ts.mean()),
    }


def _kernel_wrappers() -> dict:
    """Each hand-written kernel's wrapper, which counts its launches."""
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


def _launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in _kernel_wrappers().items()}


def _flops_per_launch(module: torch.nn.Module, x: torch.Tensor) -> dict:
    """The analytic FLOPs of one launch of each kernel a transformer
    step over the ids ``x`` makes (empty for other modules: they launch
    none)."""
    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        SequenceClassifier,
    )

    if not isinstance(module, (CausalLM, SequenceClassifier)):
        return {}
    cfg = module.config
    b, s = x.shape[:2]
    h, d = cfg.n_heads, cfg.head_dim
    causal = isinstance(module, CausalLM) or cfg.causal
    return {"flash_fwd": attention_flops(b, s, h, d, causal),
            "flash_bwd_dq": flash_bwd_flops("dq", b, s, h, d, causal),
            "flash_bwd_dkv": flash_bwd_flops("dkv", b, s, h, d, causal),
            "ce_fwd": ce_ops(b * s, cfg.vocab_size),
            "ce_bwd": ce_ops(b * s, cfg.vocab_size)}


def counted_flops_per_step(module, loss_fn, optimizer, batch,
                           group=None) -> float:
    """The FLOPs of one train step on this rank: what
    ``FlopCounterMode`` counts (torch's matrix products, convolutions,
    attention) plus the analytic FLOPs of every hand-written kernel
    launch the step makes, which run outside torch's dispatcher. Runs
    one real step."""
    from torch.utils.flop_counter import FlopCounterMode

    from sparktorch_tpu_torch.train.step import train_step

    before = _launches()
    with FlopCounterMode(display=False) as counter:
        train_step(module, loss_fn, optimizer, batch, group=group)
    per = _flops_per_launch(module, batch.x)
    kernels = sum(per.get(k, 0) * (n - before[k])
                  for k, n in _launches().items())
    return float(counter.get_total_flops() + kernels)


def _world_max(value: float, group, dev: torch.device) -> float:
    """``value``'s largest over the ranks of ``group`` (itself without
    one)."""
    if group is None:
        return value
    import torch.distributed as dist

    on = dev if dist.get_backend(group) == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def steady_examples_per_s(metrics: List[dict], mb: int) -> Optional[float]:
    """A hogwild run's steady-state rate over all its workers: drop the
    windows dispatched up to the second dispatch stamp, and end the
    span where the last loss reached the host. None when the run has
    too few windows for it."""
    stamps = sorted({m["t"] for m in metrics})
    t_done = [m["t_done"] for m in metrics if "t_done" in m]
    if len(stamps) <= 2 or not t_done:
        return None
    n_steady = sum(1 for m in metrics if m["t"] > stamps[1])
    return n_steady * mb / (max(t_done) - stamps[1])


def _sync_epoch_bench(spec, x, y, batch_size: int, iters: int = 30,
                      warmup: int = 3, chunks: int = 8, repeats: int = 5,
                      with_cost_analysis: bool = False, device=None) -> dict:
    """Shared harness for the sync-DP configs.

    A "call" is ``iters`` train steps dispatched back to back, ended by
    one read-back of the loss (the analog of one fused-epoch call of
    the JAX bench). Estimator: the PAIRED-SPAN SLOPE. Each repeat times
    a short span (1 call) and a long span (``chunks`` calls back to
    back), each ended by its read-back; the per-step time is
    ``(T_long - T_short) / ((n_long - 1) * iters)``, which cancels the
    constant cost of a span's end. The long span doubles until the
    difference is at least 1.6 s (or 512 calls), and the grown span
    carries over to the remaining repeats. Reports the median over
    ``max(2, repeats)`` samples after a symmetric trim (samples at or
    below 0, or under 20% of the positive median, are dropped), with
    best and spread. ``batch_size`` is the global batch: each rank of
    the mesh steps its shard."""
    from sparktorch_tpu_torch.parallel.mesh import build_mesh
    from sparktorch_tpu_torch.train.sync import _dp_steps, _dp_trainer, _Shards
    from sparktorch_tpu_torch.utils.data import handle_features

    dev = _resolve_device(device)
    mesh = build_mesh()
    world, group = mesh.dp, mesh.group
    with _Phase(dev, "data") as p_data:
        batch, _ = handle_features(x, y)
        shards = _Shards(batch, mesh, dev, seed=0)
    with _Phase(dev, "init") as p_init:
        module, optimizer, loss_fn, _, _ = _dp_trainer(spec, spec, mesh, dev)
    steps_run = 0

    def call():
        """``iters`` steps queued back to back; the caller reads back."""
        nonlocal steps_run
        steps = _dp_steps(iters, module, loss_fn, optimizer, shards, mesh)
        steps_run += iters
        return steps[-1].loss

    with _Phase(dev, "compile_warmup") as p_warm:
        cost = None
        if with_cost_analysis:
            cost = counted_flops_per_step(module, loss_fn, optimizer,
                                          shards.batch, group)
            steps_run += 1
        for _ in range(warmup):
            loss = call()
        loss = float(loss)

    slopes = []  # per-step seconds, one sample per repeat
    n_long = max(chunks, 2)
    with _Phase(dev, "measure") as p_measure:
        for _ in range(max(2, repeats)):
            t0 = time.perf_counter()
            float(call())
            t_short = time.perf_counter() - t0
            while True:
                t0 = time.perf_counter()
                for _ in range(n_long):
                    loss = call()
                loss = float(loss)  # the long span's one read-back
                t_long = time.perf_counter() - t0
                # Every rank must run the same calls (each step is an
                # all-reduce), so the ranks grow the span on one choice:
                # the slowest rank's difference.
                if (_world_max(t_long - t_short, group, dev) >= 1.6
                        or n_long >= 512):
                    break
                n_long *= 2
            slopes.append((t_long - t_short) / max((n_long - 1) * iters, 1))

    good = [s for s in slopes if s > 0]
    if good:
        floor = 0.2 * float(np.median(good))
        good = [s for s in good if s >= floor]
    if not good:
        # Every sample non-positive: the whole-span mean, one read-back
        # included, is an upper bound on the step time.
        good = [t_long / max(n_long * iters, 1)]
    med = float(np.median(good))
    best = min(good)
    rates = [batch_size / s / world for s in good]
    spread_pct = 100.0 * (max(rates) - min(rates)) / max(float(np.median(rates)), 1e-9)
    out = {
        "examples_per_sec_per_chip": round(batch_size / med / world, 1),
        "rate_best": round(batch_size / best / world, 1),
        "rate_samples": [round(r, 1) for r in rates],
        "rate_spread_pct": round(spread_pct, 1),
        "n_chips": world,
        "final_loss": loss,
        "phase_s": _phase_s(data=p_data, init=p_init,
                            compile_warmup=p_warm, measure=p_measure),
        "steps_run": steps_run,
        **_steps_summary(good),
    }
    if cost is not None:
        out["counted_flops_per_step"] = cost
    return out


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def _mnist() -> tuple:
    rng = np.random.default_rng(0)
    batch = 1024
    x = rng.normal(0, 1, (batch, 784)).astype(np.float32)
    y = rng.integers(0, 10, (batch,)).astype(np.int32)
    return x, y, batch


def _spec(module, **kw):
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    return ModelSpec(module=module, loss="cross_entropy", **kw)


def bench_mnist_mlp_sync(device=None) -> dict:
    """BASELINE config 1 (examples/simple_dnn.py workload)."""
    from sparktorch_tpu_torch.models import MnistMLP

    _resolve_device(device)
    x, y, batch = _mnist()
    torch.manual_seed(0)
    spec = _spec(MnistMLP(), optimizer="adam", optimizer_params={"lr": 1e-3},
                 input_shape=(784,))
    out = _sync_epoch_bench(spec, x, y, batch, device=device)
    return {"config": "mnist_mlp_sync", "unit": "examples/sec/chip", **out}


def bench_mnist_cnn_sync(device=None) -> dict:
    """The headline workload (examples/simple_cnn.py)."""
    from sparktorch_tpu_torch.models import MnistCNN

    _resolve_device(device)
    x, y, batch = _mnist()
    torch.manual_seed(0)
    spec = _spec(MnistCNN(), optimizer="adam", optimizer_params={"lr": 1e-3},
                 input_shape=(784,))
    out = _sync_epoch_bench(spec, x, y, batch, device=device)
    return {"config": "mnist_cnn_sync", "unit": "examples/sec/chip", **out}


def bench_lazy_cnn_sync(device=None) -> dict:
    """BASELINE config 2: the lazy serialization path — the model class
    ships unmaterialized and is first instantiated here."""
    from sparktorch_tpu_torch.models import MnistCNN
    from sparktorch_tpu_torch.utils.serde import (
        deserialize_model,
        serialize_model_lazy,
    )

    _resolve_device(device)
    payload = serialize_model_lazy(
        MnistCNN, criterion="cross_entropy", optimizer="adam",
        optimizer_params={"lr": 1e-3}, input_shape=(784,))
    torch.manual_seed(0)
    t0 = time.perf_counter()
    spec = deserialize_model(payload)
    lazy_materialize_s = time.perf_counter() - t0
    x, y, batch = _mnist()
    out = _sync_epoch_bench(spec, x, y, batch, device=device)
    return {"config": "lazy_cnn_sync", "unit": "examples/sec/chip",
            "lazy_materialize_s": round(lazy_materialize_s, 4), **out}


def bench_resnet18_hogwild(device=None, iters: int = 1024,
                           repeats: int = 5) -> dict:
    """BASELINE config 3: ResNet-18 on CIFAR-10 shapes through the
    parameter server, ``repeats`` runs of ``iters`` iterations per worker
    (the JAX bench's 5 of 1,024: 256 push windows; the median is
    reported), a leg over the HTTP transport of ``max(64, iters // 4)``,
    and a sync ResNet-18 leg at the same minibatch per chip, so the
    async efficiency (hogwild rate / sync rate) is measured."""
    from sparktorch_tpu_torch.models import resnet18
    from sparktorch_tpu_torch.parallel.mesh import build_mesh
    from sparktorch_tpu_torch.train.hogwild import train_async

    dev = _resolve_device(device)
    with _Phase(dev, "data") as p_data:
        rng = np.random.default_rng(0)
        n, mb = 2048, 256
        x = rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, (n,)).astype(np.int32)
    with _Phase(dev, "init") as p_init:
        torch.manual_seed(0)
        spec = _spec(resnet18(num_classes=10), optimizer="sgd",
                     optimizer_params={"lr": 1e-2}, input_shape=(32, 32, 3))
    with _Phase(dev, "compile_warmup") as p_warm:
        train_async(spec, x, labels=y, iters=8, mini_batch=mb, push_every=4,
                    device=dev)

    def _one_run(transport: str = "local", run_iters: int = iters):
        t0 = time.perf_counter()
        result = train_async(spec, x, labels=y, iters=run_iters,
                             mini_batch=mb, push_every=4,
                             transport=transport, device=dev)
        dt = time.perf_counter() - t0
        n_workers = len({m["worker"] for m in result.metrics})
        # One push per window: distinct (worker, dispatch stamp) pairs.
        pushes = len({(m["worker"], m["t"]) for m in result.metrics})
        n_rec = len(result.metrics)
        steady = steady_examples_per_s(result.metrics, mb)
        steady = (n_rec * mb / dt if steady is None else steady) / n_workers
        budget = (result.summary or {}).get("hogwild_budget", {})
        return steady, {"n_chips": n_workers, "pushes": pushes,
                        "iters_recorded": n_rec, "dt": dt,
                        "final_loss": result.metrics[-1]["loss"]}, budget

    with _Phase(dev, "measure") as p_measure:
        runs = sorted([_one_run() for _ in range(max(1, repeats))],
                      key=lambda r: r[0])
        rates = [r[0] for r in runs]
        per_chip, info, budget = runs[len(runs) // 2]
        spread_pct = 100.0 * (rates[-1] - rates[0]) / max(
            rates[len(rates) // 2], 1e-9)
        times = [info["dt"] / max(1, info["iters_recorded"])] * max(
            1, info["iters_recorded"])
        http_rate, _, http_budget = _one_run(
            transport="http", run_iters=max(64, iters // 4))

    budget_rec = {}
    if budget and budget.get("loop_s"):
        loop_s = budget["loop_s"]
        phases = ("pull_s", "pull_place_s", "dispatch_s",
                  "push_materialize_s", "push_wire_s", "poll_s",
                  "drain_s", "other_s")
        budget_rec = {
            "budget_loop_s": round(loop_s, 3),
            **{f"budget_{k}": round(budget.get(k, 0.0), 3) for k in phases},
            "budget_fractions": {
                k: round(budget.get(k, 0.0) / loop_s, 4) for k in phases},
            "pull_mb": round(budget.get("pull_bytes", 0) / 1e6, 2),
            "push_mb": round(budget.get("push_bytes", 0) / 1e6, 2),
            "pulls": int(budget.get("pulls", 0)),
            "pull_fresh": int(budget.get("pull_fresh", 0)),
        }

    # The sync twin at the same per-chip batch: mb rows on every rank.
    n_sync = mb * build_mesh().dp
    reps = -(-n_sync // n)
    xs = np.tile(x, (reps, 1, 1, 1))[:n_sync]
    ys = np.tile(y, reps)[:n_sync]
    sync = _sync_epoch_bench(spec, xs, ys, n_sync, iters=16, warmup=2,
                             chunks=4, device=dev)
    sync_rate = sync["examples_per_sec_per_chip"]
    return {
        "config": "resnet18_hogwild", "unit": "examples/sec/chip",
        "examples_per_sec_per_chip": round(per_chip, 1),
        "repeat_rates": [round(r, 1) for r in rates],
        "repeat_spread_pct": round(spread_pct, 1),
        "n_chips": info["n_chips"], "pushes": info["pushes"],
        "iters_recorded": info["iters_recorded"],
        "final_loss": info["final_loss"],
        "sync_examples_per_sec_per_chip": sync_rate,
        "async_efficiency_vs_sync": round(per_chip / max(sync_rate, 1e-9), 3),
        "http_examples_per_sec_per_chip": round(http_rate, 1),
        "async_efficiency_http_vs_local": round(
            http_rate / max(per_chip, 1e-9), 3),
        "http_push_wire_s_per_push": round(
            http_budget.get("push_wire_s", 0.0)
            / max(1, http_budget.get("pushes", 1)), 4),
        **budget_rec,
        "phase_s": {**_phase_s(data=p_data, init=p_init,
                               compile_warmup=p_warm, measure=p_measure),
                    "sync_twin": round(sum(sync["phase_s"].values()), 3)},
        **_steps_summary(times),
    }


def bench_hogwild_wire(device=None, iters: int = 128) -> dict:
    """The JAX bench's ``hogwild_wire``: the same hogwild workload
    (MnistMLP, 2,048 rows, minibatch 256, ``push_every=4``, ``iters``
    iterations) over the dill wire, then the framed binary wire, both on
    real sockets. The headline numbers are per operation — seconds and
    bytes per push and per fresh pull, what the wire buys — with each
    wire's end-to-end wall beside them."""
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.train.hogwild import train_async

    dev = _resolve_device(device)
    with _Phase(dev, "data") as p_data:
        rng = np.random.default_rng(0)
        n, mb = 2048, 256
        x = rng.normal(0, 1, (n, 784)).astype(np.float32)
        y = rng.integers(0, 10, (n,)).astype(np.int32)
    with _Phase(dev, "init") as p_init:
        torch.manual_seed(0)
        spec = _spec(MnistMLP(), optimizer="adam",
                     optimizer_params={"lr": 1e-3}, input_shape=(784,))
    with _Phase(dev, "compile_warmup") as p_warm:
        train_async(spec, x, labels=y, iters=8, mini_batch=mb, push_every=4,
                    device=dev)

    wires: Dict[str, dict] = {}
    with _Phase(dev, "measure") as p_measure:
        for wire_fmt in ("dill", "binary"):
            t0 = time.perf_counter()
            result = train_async(spec, x, labels=y, iters=iters,
                                 mini_batch=mb, push_every=4,
                                 transport="http", wire=wire_fmt, seed=0,
                                 device=dev)
            wall = time.perf_counter() - t0
            b = (result.summary or {}).get("hogwild_budget", {})
            pushes = max(1, int(b.get("pushes", 0)))
            fresh = max(1, int(b.get("pull_fresh", 0)))
            wires[wire_fmt] = {
                "wall_s": round(wall, 3),
                "pull_s": round(b.get("pull_s", 0.0), 4),
                "push_wire_s": round(b.get("push_wire_s", 0.0), 4),
                "push_materialize_s": round(
                    b.get("push_materialize_s", 0.0), 4),
                "pull_mb": round(b.get("pull_bytes", 0) / 1e6, 3),
                "push_mb": round(b.get("push_bytes", 0) / 1e6, 3),
                "pulls": int(b.get("pulls", 0)),
                "pull_fresh": int(b.get("pull_fresh", 0)),
                "pushes": int(b.get("pushes", 0)),
                "push_wire_s_per_push": round(
                    b.get("push_wire_s", 0.0) / pushes, 5),
                "pull_s_per_fresh_pull": round(
                    b.get("pull_s", 0.0) / fresh, 5),
                # Steps = pushes × push_every.
                "push_bytes_per_step": round(
                    b.get("push_bytes", 0)
                    / max(1, int(b.get("pushes", 0)) * 4), 1),
                "final_loss": result.metrics[-1]["loss"],
            }

    d, bn = wires["dill"], wires["binary"]
    return {
        "config": "hogwild_wire", "unit": "s/push",
        "value": bn["push_wire_s_per_push"],
        "binary": bn, "dill": d,
        "push_bytes_ratio_dill_over_binary": round(
            d["push_mb"] / max(bn["push_mb"], 1e-9), 3),
        "pull_bytes_ratio_dill_over_binary": round(
            d["pull_mb"] / max(bn["pull_mb"], 1e-9), 3),
        "push_wire_speedup": round(
            d["push_wire_s_per_push"]
            / max(bn["push_wire_s_per_push"], 1e-9), 3),
        "phase_s": {
            **_phase_s(data=p_data, init=p_init, compile_warmup=p_warm,
                       measure=p_measure),
            # The hot-path budget the wire change targets, per wire.
            "pull": round(bn["pull_s"], 4),
            "push": round(bn["push_wire_s"] + bn["push_materialize_s"], 4),
            "pull_dill": round(d["pull_s"], 4),
            "push_dill": round(d["push_wire_s"] + d["push_materialize_s"], 4),
        },
    }


def _bert_flops_accounting(module, batch: int, seq: int) -> dict:
    """Honest model-FLOPs accounting for the BERT classifier (the JAX
    package's, parameter for parameter):

      fwd  = 2·N_tok·T  +  4·L·b·s²·d  +  2·N_head·b
      step = 3·fwd                       (backward ≈ 2× forward)

    N_tok: parameters applied per token (encoder layers and final
    LayerNorm; the embedding gather and its scatter-add backward do no
    matrix products); N_head: parameters applied per example (pooler and
    classifier); 4·L·b·s²·d: the QKᵀ and AV products. The 6·N_total·T
    figure rides along for comparison."""

    def _count(m) -> int:
        return sum(p.numel() for p in m.parameters())

    n_total = _count(module)
    backbone = module.backbone
    n_emb = _count(backbone.tok_embed) + backbone.pos_embed.numel()
    n_head = _count(module.pooler) + _count(module.classifier)
    n_tok = n_total - n_emb - n_head

    cfg = module.config
    tokens = batch * seq
    attn_fwd = 4 * cfg.n_layers * batch * seq * seq * cfg.d_model
    fwd = 2 * n_tok * tokens + attn_fwd + 2 * n_head * batch
    return {
        "n_params": n_total,
        "n_params_embedding": n_emb,
        "n_params_per_token": n_tok,
        "n_params_per_example_head": n_head,
        "model_flops_per_step": 3 * fwd,
        "legacy_6n_total_flops_per_step": 6 * n_total * tokens,
        "flops_methodology": (
            "3*(2*N_tok*T + 4*L*b*s^2*d + 2*N_head*b): matmul params per "
            "token (embedding gather/scatter and per-example head "
            "excluded from the per-token term) + attention QK^T/AV score "
            "FLOPs; bwd=2x fwd. Cross-checked against "
            "counted_flops_per_step: torch FlopCounterMode over one step "
            "plus the analytic FLOPs of each hand-written kernel launch. "
            "The roofline fields carry the FLOPs term only (no "
            "bytes-accessed count exists for a torch step), against "
            "989 TFLOP/s dense bf16 (H100 SXM)."),
    }


def bench_bert_dp(device=None) -> dict:
    """BASELINE config 4: BERT-base encoder fine-tune step, sync DP,
    with the flash kernels. MFU from the honest model FLOPs
    (``_bert_flops_accounting``), cross-checked against the counted
    FLOPs of one step."""
    from sparktorch_tpu_torch.models import bert_base

    _resolve_device(device)
    batch, seq = 128, 128
    rng = np.random.default_rng(0)
    x = rng.integers(0, 30522, (batch, seq)).astype(np.int32)
    y = rng.integers(0, 2, (batch,)).astype(np.int32)
    torch.manual_seed(0)
    module = bert_base(attn_impl="flash")
    spec = _spec(module, optimizer="adam", optimizer_params={"lr": 2e-5},
                 input_shape=(seq,))
    out = _sync_epoch_bench(spec, x, y, batch, iters=10, warmup=2, chunks=3,
                            with_cost_analysis=True, device=device)

    acct = _bert_flops_accounting(module, batch, seq)
    steps_per_sec = out["examples_per_sec_per_chip"] * out["n_chips"] / batch
    step_s = 1.0 / max(steps_per_sec, 1e-12)

    def _tflops(flops_per_step: float) -> float:
        return flops_per_step * steps_per_sec / out["n_chips"] / 1e12

    honest = _tflops(acct["model_flops_per_step"])
    rec = {
        "config": "bert_dp", "unit": "examples/sec/chip",
        "n_params": acct["n_params"],
        "n_params_embedding": acct["n_params_embedding"],
        "n_params_per_token": acct["n_params_per_token"],
        "achieved_tflops_per_chip": round(honest, 2),
        "mfu_honest": round(mfu_honest(honest), 4),
        "achieved_tflops_6n_total_legacy": round(
            _tflops(acct["legacy_6n_total_flops_per_step"]), 2),
        "flops_methodology": acct["flops_methodology"],
        **out,
    }
    # counted_flops_per_step is this rank's (its shard's) step, so the
    # achieved rate needs no division by the world.
    counted = out["counted_flops_per_step"]
    rec["counted_tflops_per_chip"] = round(counted / step_s / 1e12, 2)
    t_flops = counted / (H100_BF16_PEAK_TFLOPS * 1e12)
    rec["roofline_min_step_s"] = round(t_flops, 6)
    rec["roofline_bound"] = "flops"
    rec["roofline_attainment"] = round(t_flops / step_s, 4)
    return rec


def bench_resnet50_inference(device=None) -> dict:
    """BASELINE config 5: ResNet-50 batch inference — device-resident
    (best of 3 over 1,024 rows: the chip's rate) and streamed from a
    Parquet file of 2,048 raw uint8 rows (reader thread → uint8 upload →
    normalize, forward and argmax on the card)."""
    import os
    import tempfile

    from sparktorch_tpu_torch.inference import (
        BatchPredictor,
        stream_parquet_predict,
        write_rows_parquet,
    )
    from sparktorch_tpu_torch.models import resnet50

    dev = _resolve_device(device)
    rng = np.random.default_rng(0)
    chunk = 256
    n_stream = chunk * 8
    with tempfile.TemporaryDirectory() as d:
        with _Phase(dev, "data") as p_data:
            x = rng.integers(0, 256, (chunk * 4, 224, 224, 3), dtype=np.uint8)
            path = os.path.join(d, "bench_stream.parquet")
            write_rows_parquet(
                path,
                (rng.integers(0, 256, (chunk, 224, 224, 3), dtype=np.uint8)
                 for _ in range(n_stream // chunk)),
                rows_per_group=chunk)
        with _Phase(dev, "init") as p_init:
            torch.manual_seed(0)
            predictor = BatchPredictor(
                resnet50(), device=dev, chunk=chunk,
                preprocess=lambda v: v.float() / 255.0,
                postprocess=lambda out: out.argmax(-1).int())
        with _Phase(dev, "compile_warmup") as p_warm:
            predictor.predict(x[:chunk])
        n_chips = 1  # one predictor on this process's card

        with _Phase(dev, "measure") as p_measure:
            xd = torch.from_numpy(x).to(dev)  # device-resident: the chip
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = predictor.predict(xd)
                assert out.shape[0] == x.shape[0]
                rates.append(x.shape[0] / (time.perf_counter() - t0))
            per_chip = max(rates) / n_chips
            stats = stream_parquet_predict(
                predictor, path, row_shape=(224, 224, 3), dtype=np.uint8,
                batch_rows=4 * chunk)

    return {
        "config": "resnet50_inference", "unit": "examples/sec/chip",
        "examples_per_sec_per_chip": round(per_chip, 1),
        "phase_s": _phase_s(data=p_data, init=p_init, compile_warmup=p_warm,
                            measure=p_measure),
        "chip_rate_rows_per_sec_per_chip": round(per_chip, 1),
        "stream_rows_per_sec": stats["rows_per_sec"],
        "stream_n_rows": stats["n_rows"],
        "n_chips": n_chips,
        "projected_1M_rows_s_chip_rate": round(
            1_000_000 / (per_chip * n_chips), 1),
        "projected_1M_rows_s_host_stream": round(
            1_000_000 / max(stats["rows_per_sec"], 1e-9), 1),
        "wire_dtype": "uint8 (normalize + argmax fused on device)",
    }


def bench_long_context_lm(device=None, repeats: int = 5) -> dict:
    """Causal-LM training at s = 8192 through the flash kernels and the
    fused cross-entropy (no (s, s) logits and no softmax over the
    vocabulary in HBM), plus a dense-vs-flash step-time comparison at a
    length dense attention can hold (s = 2048). ``repeats``: slope
    samples of each leg (the JAX bench's 5)."""
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    _resolve_device(device)
    rng = np.random.default_rng(0)
    vocab, batch, seq = 32768, 2, 8192

    def spec_for(attn: str, s: int):
        cfg = TransformerConfig(vocab_size=vocab, d_model=512, n_heads=8,
                                n_layers=4, d_ff=2048, max_len=s,
                                attn_impl=attn, remat=True)
        torch.manual_seed(0)
        return _spec(CausalLM(cfg), optimizer="adamw",
                     optimizer_params={"lr": 3e-4})

    ids = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    out = _sync_epoch_bench(spec_for("flash", seq), ids[:, :-1], ids[:, 1:],
                            batch, iters=6, warmup=2, chunks=2,
                            repeats=repeats, device=device)
    tokens_per_sec = out["examples_per_sec_per_chip"] * seq

    cmp_seq = 2048
    ids_c = rng.integers(0, vocab, (batch, cmp_seq + 1)).astype(np.int32)
    cmp, cmp_steps = {}, {}
    for attn in ("dense", "flash"):
        r = _sync_epoch_bench(spec_for(attn, cmp_seq), ids_c[:, :-1],
                              ids_c[:, 1:], batch, iters=6, warmup=2,
                              chunks=2, repeats=repeats, device=device)
        cmp[attn] = r["step_time_p50_s"]
        cmp_steps[attn] = r["steps_run"]
    return {
        "config": "long_context_lm", "unit": "tokens/sec/chip",
        "seq_len": seq,
        "tokens_per_sec_per_chip": round(tokens_per_sec, 1),
        "flash_vs_dense_step_ratio_at_2k": round(
            cmp["dense"] / cmp["flash"], 3),
        "steps_run_at_2k": cmp_steps,
        **out,
    }


def bench_moe_lm(device=None, repeats: int = 5) -> dict:
    """The JAX bench's ``moe_lm``: a switch-style (top-1) MoE causal LM
    on one card — vocab 32,768, d 512, 8 heads, 4 layers, d_ff 2,048, 8
    experts on every second layer, s = 1,024, batch 8, dense attention,
    AdamW 3e-4 — and its dense twin (``n_experts=0``): tokens/s and the
    MoE/dense step-time ratio. Both legs take the fused cross-entropy.
    ``repeats``: slope samples of each leg (the JAX bench's 5)."""
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.models.transformer import TransformerConfig

    _resolve_device(device)
    rng = np.random.default_rng(0)
    vocab, batch, seq = 32768, 8, 1024

    def spec_for(n_experts: int):
        cfg = TransformerConfig(vocab_size=vocab, d_model=512, n_heads=8,
                                n_layers=4, d_ff=2048, max_len=seq,
                                n_experts=n_experts, moe_every=2)
        torch.manual_seed(0)
        return _spec(CausalLM(cfg), optimizer="adamw",
                     optimizer_params={"lr": 3e-4})

    ids = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    moe = _sync_epoch_bench(spec_for(8), ids[:, :-1], ids[:, 1:], batch,
                            iters=6, warmup=2, chunks=2, repeats=repeats,
                            device=device)
    dense = _sync_epoch_bench(spec_for(0), ids[:, :-1], ids[:, 1:], batch,
                              iters=6, warmup=2, chunks=2, repeats=repeats,
                              device=device)
    return {
        "config": "moe_lm", "unit": "tokens/sec/chip",
        "n_experts": 8, "seq_len": seq,
        "tokens_per_sec_per_chip": round(
            moe["examples_per_sec_per_chip"] * seq, 1),
        "moe_vs_dense_step_ratio": round(
            moe["step_time_p50_s"] / dense["step_time_p50_s"], 3),
        "steps_run_dense": dense["steps_run"],
        **moe,
    }


def poisson_leg(submit_fn, pool: np.ndarray, arrivals: np.ndarray,
                outputs: Optional[list] = None) -> dict:
    """Open-loop load: one single-row request per arrival time (seconds
    from the start gun), request i carrying row ``i % len(pool)``.
    Every request thread is PRE-SPAWNED, waits for the gun, sleeps to
    its own arrival, fires ``submit_fn(row[None])`` and records its own
    completion latency (arrivals never wait for completions; spawning
    threads on the clock would make the generator the bottleneck).
    Failures are collected, never swallowed. ``outputs`` (a list of
    ``len(arrivals)``) receives each request's result."""
    import threading

    n_requests = len(arrivals)
    lats: List[Optional[float]] = [None] * n_requests
    errors: list = []
    start = threading.Event()
    t_ref = [0.0]

    def _fire(i: int) -> None:
        start.wait()
        delay = arrivals[i] - (time.perf_counter() - t_ref[0])
        if delay > 0:
            time.sleep(delay)
        t0 = time.perf_counter()
        try:
            out = submit_fn(pool[i % len(pool)][None, :])
            if out.shape[0] != 1:
                raise ValueError(f"{out.shape[0]} rows for one")
            lats[i] = time.perf_counter() - t0
            if outputs is not None:
                outputs[i] = out
        except Exception as e:  # noqa: BLE001 - the gates count these
            errors.append((i, f"{type(e).__name__}: {e}"))

    threads = [threading.Thread(target=_fire, args=(i,), daemon=True)
               for i in range(n_requests)]
    for th in threads:
        th.start()
    time.sleep(0.05)  # let every thread park on the gun
    t_ref[0] = time.perf_counter()
    start.set()
    for th in threads:
        th.join(timeout=120)
    wall = time.perf_counter() - t_ref[0]
    done = [lat for lat in lats if lat is not None]
    return {
        "wall_s": wall,
        "completed": len(done),
        "errors": len(errors),
        "error_samples": [e for _, e in errors[:3]],
        "rows_per_s": len(done) / max(wall, 1e-9),
        "p50_ms": float(np.percentile(done, 50)) * 1e3 if done else -1,
        "p99_ms": float(np.percentile(done, 99)) * 1e3 if done else -1,
    }


def check_fleet_gates(rec: dict, timing: bool = True) -> None:
    """The JAX ``hogwild_ps_fleet`` gates on a record; raises on the
    first that fails. The byte gates (deltas ship fewer bytes than full
    pulls, int8 deltas fewer than f32 ones) and the shard-kill gates
    (the kill fired, no record lost, at least one monitored restart)
    are deterministic; ``timing=False`` leaves out the two that are
    not (aggregate pull bandwidth and p99 pull latency against the
    single server)."""
    single, fleet, int8 = rec["single"], rec["fleet"], rec["fleet_int8"]
    kill = rec["shard_kill"]
    if timing and not rec["bandwidth_ratio"] > 1.0:
        raise AssertionError(
            f"fleet aggregate pull bandwidth did not beat the single "
            f"server: {fleet['state_mb_per_s']:.0f} vs "
            f"{single['state_mb_per_s']:.0f} MB/s "
            f"(x{rec['bandwidth_ratio']:.2f})")
    if timing and not rec["p99_ratio"] < 1.0:
        raise AssertionError(
            f"fleet p99 pull latency did not beat the single server: "
            f"{fleet['pull_p99_ms']:.0f} vs {single['pull_p99_ms']:.0f} ms "
            f"(x{rec['p99_ratio']:.2f})")
    if not fleet["wire_mb_per_pull"] < single["wire_mb_per_pull"]:
        raise AssertionError(
            f"delta pulls did not ship fewer bytes than full pulls: "
            f"{fleet['wire_mb_per_pull']:.2f} vs "
            f"{single['wire_mb_per_pull']:.2f} MB/pull")
    if not int8["wire_mb_per_pull"] < fleet["wire_mb_per_pull"]:
        raise AssertionError(
            f"int8 delta pulls did not ship fewer bytes than f32 deltas: "
            f"{int8['wire_mb_per_pull']:.2f} vs "
            f"{fleet['wire_mb_per_pull']:.2f} MB/pull")
    if kill["fired"] < 1:
        raise AssertionError("seeded shard kill never fired")
    if kill["records"] != kill["expected_records"]:
        raise AssertionError(
            f"shard-kill run lost records: {kill['records']} != "
            f"{kill['expected_records']}")
    if kill["restarts"] < 1:
        raise AssertionError("shard kill produced no monitored restart "
                             "(fleet.shard_restarts_total empty)")


def bench_hogwild_ps_fleet(device=None, width: int = 1024, quota: int = 10,
                           pairs: int = 3, timing_gates: bool = True) -> dict:
    """The JAX bench's ``hogwild_ps_fleet``: the sharded tier must beat
    the single server where it claims to, or this raises.

    Workload: the MLP ``features=[width]*16+[10]`` on 784 inputs (66 MB
    of float32 parameters at the JAX width, 1,024), SGD lr 1e-2, under a
    sparse-update pusher (a stable hot quarter of the leaves gets
    closed-loop pushes) while 6 stateful pullers each complete
    ``quota`` fresh pulls at a 5 ms cadence. The single server re-ships
    the whole tree on every fresh pull (and applies dense zero
    gradients); the 4-shard fleet ships per-tensor deltas and applies
    the sparse partials shard-parallel. Single and fleet legs run
    interleaved ``pairs`` times, then one int8-pull fleet leg; the
    record holds the medians. Then a seeded shard kill
    (``ChaosConfig(kill_shard_at={1: 4})``) in a ``train_async(shards=4)``
    run of ``ClassificationNet``. :func:`check_fleet_gates` holds the
    record to the JAX gates (``timing_gates=False``: the deterministic
    ones only). On the card the shards and the single server keep their
    parameters on the device; every pull renders from a host copy."""
    import threading

    from sparktorch_tpu_torch import ft, serialize_torch_obj
    from sparktorch_tpu_torch.models import ClassificationNet
    from sparktorch_tpu_torch.models.simple import MLP
    from sparktorch_tpu_torch.net import wire as _wire
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.net.transport import BinaryTransport
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )
    from sparktorch_tpu_torch.train.hogwild import train_async

    dev = _resolve_device(device)
    n_shards, workers, cadence_s = 4, 6, 0.005
    with _Phase(dev, "init") as p_init:
        torch.manual_seed(0)
        spec = _spec(MLP([width] * 16 + [10], in_features=784),
                     optimizer="sgd", optimizer_params={"lr": 1e-2},
                     input_shape=(784,))

    def swarm_leg(make_pull, push_fn) -> dict:
        """A closed-loop pusher and ``workers`` stateful pullers, each
        completing ``quota`` fresh pulls; every transport opened here is
        closed before the leg returns."""
        stop = threading.Event()
        lat: List[float] = []
        lock = threading.Lock()
        wire_bytes = [0]
        opened: list = []

        def pusher():
            while not stop.is_set():
                push_fn()  # waits for the apply: versions at apply pace
                time.sleep(cadence_s)

        def puller():
            pull, bytes_fn, transport = make_pull()
            with lock:
                opened.append(transport)
            # An untimed first sync (both legs ship the whole model); the
            # quota is steady-state pulls, where delta and full differ.
            have = -1
            snap = pull(have)
            if snap is not None:
                have = snap[0]
            done, mine, b0 = 0, [], bytes_fn()
            # A server whose writer died mints no versions: fail the
            # gate instead of hanging.
            deadline = time.monotonic() + 120.0
            while done < quota and time.monotonic() < deadline:
                t0 = time.perf_counter()
                snap = pull(have)
                dt = time.perf_counter() - t0
                if snap is not None:
                    have, done = snap[0], done + 1
                    mine.append(dt)
                time.sleep(cadence_s)
            with lock:
                lat.extend(mine)
                wire_bytes[0] += bytes_fn() - b0

        pt = threading.Thread(target=pusher, daemon=True)
        pt.start()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=puller, daemon=True)
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stop.set()
        pt.join()
        for transport in opened:
            transport.close()
        pulls = workers * quota
        if len(lat) < pulls:
            raise AssertionError(
                f"swarm leg stalled: {len(lat)}/{pulls} fresh pulls "
                "completed before the 120 s deadline — the server stopped "
                "minting versions (dead writer?)")
        return {
            "wall_s": wall,
            "state_mb_per_s": pulls * model_nbytes / wall / 1e6,
            "wire_mb_per_s": wire_bytes[0] / wall / 1e6,
            "wire_mb_per_pull": wire_bytes[0] / pulls / 1e6,
            "pull_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "pull_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        }

    def single_leg() -> dict:
        server = ParameterServer(spec, window_len=workers, device=dev)
        http = ParamServerHttp(server, port=0).start()
        try:
            _, params = server.slot.read()
            zero_full = {k: np.zeros(tuple(v.shape), np.float32)
                         for k, v in params.items()}

            def push():
                try:
                    server.push_gradients(zero_full, wait=True)
                except Exception:  # noqa: BLE001 - a raced stop
                    pass

            def make_pull():
                t = BinaryTransport(http.url, quant=None)
                return (lambda have: t.pull(have)), (
                    lambda: t.stats["pull_bytes"]), t

            push()
            server.drain()
            pull, _b, t = make_pull()  # warm the render and the connection
            pull(-1)
            t.close()
            return swarm_leg(make_pull, push)
        finally:
            http.stop()
            server.stop()

    def fleet_leg(pull_quant=None) -> dict:
        fleet = ParamServerFleet(spec, n_shards=n_shards, device=dev).start()
        try:
            def push():
                try:
                    fleet.scatter_push(hot_partial, wait=True)
                except Exception:  # noqa: BLE001 - a raced stop
                    pass

            def make_pull():
                t = ShardedTransport(fleet, pull_quant=pull_quant)
                return (lambda have: t.pull(have)), (
                    lambda: t.stats["pull_bytes"]), t

            push()
            fleet.drain()
            pull, _b, t = make_pull()
            pull(-1)
            t.close()
            return swarm_leg(make_pull, push)
        finally:
            fleet.stop()

    with _Phase(dev, "compile_warmup") as p_warm:
        # One throwaway fleet: the leaf partition, the shards' first
        # optimizer steps and the hot set.
        probe = ParamServerFleet(spec, n_shards=n_shards, device=dev)
        flat = dict(_wire.flatten_tree(probe.assemble()))
        model_nbytes = sum(a.numel() * a.element_size()
                           for a in flat.values())
        paths = sorted(flat)
        hot = paths[:max(1, len(paths) // 4)]
        hot_partial = {p: np.zeros(tuple(flat[p].shape), np.float32)
                       for p in hot}
        probe.scatter_push(hot_partial, wait=True)
        probe.stop()

    with _Phase(dev, "measure") as p_measure:
        singles, fleets = [], []
        for _ in range(pairs):  # interleaved: host noise hits both legs
            singles.append(single_leg())
            fleets.append(fleet_leg())
        int8 = fleet_leg(pull_quant="int8")

    def median(legs, key):
        return float(np.median([leg[key] for leg in legs]))

    single = {k: round(median(singles, k), 3) for k in singles[0]}
    fleet = {k: round(median(fleets, k), 3) for k in fleets[0]}
    bw_ratio = fleet["state_mb_per_s"] / max(single["state_mb_per_s"], 1e-9)
    p99_ratio = fleet["pull_p99_ms"] / max(single["pull_p99_ms"], 1e-9)

    with _Phase(dev, "shard_kill") as p_kill:
        rng = np.random.default_rng(0)
        x = np.concatenate([rng.normal(0, 1, (100, 10)),
                            rng.normal(2, 1, (100, 10))]).astype(np.float32)
        y = np.concatenate([np.zeros(100), np.ones(100)]).astype(np.float32)
        torch.manual_seed(0)
        clf = serialize_torch_obj(
            ClassificationNet(n_classes=2), criterion="cross_entropy",
            optimizer="adam", optimizer_params={"lr": 5e-3},
            input_shape=(10,))
        kill_tele = Telemetry(run_id="bench_ps_fleet_kill")
        iters, parts = 12, 2
        with ft.inject(ft.ChaosConfig(kill_shard_at={1: 4}, seed=0),
                       telemetry=kill_tele) as inj:
            result = train_async(clf, x, labels=y, iters=iters,
                                 partitions=parts, seed=0, transport="http",
                                 shards=n_shards, telemetry=kill_tele,
                                 device=dev)
        kill = {"fired": len([e for e in inj.events
                              if e["site"] == "fleet.shard"]),
                "records": len(result.metrics),
                "restarts": int(result.summary["fleet"]["shard_restarts"])}

    rec = {
        "config": "hogwild_ps_fleet", "unit": "x (bandwidth ratio)",
        "value": round(bw_ratio, 3),
        "n_shards": n_shards, "workers": workers, "quota": quota,
        "model_mb": round(model_nbytes / 1e6, 1),
        "hot_leaves": len(hot), "total_leaves": len(paths),
        "bandwidth_ratio": round(bw_ratio, 3),
        "p99_ratio": round(p99_ratio, 3),
        "single": single, "fleet": fleet, "fleet_int8": int8,
        "delta_bytes_saved_pct": round(
            100 * (1 - fleet["wire_mb_per_pull"]
                   / single["wire_mb_per_pull"]), 1),
        "int8_bytes_saved_pct": round(
            100 * (1 - int8["wire_mb_per_pull"]
                   / fleet["wire_mb_per_pull"]), 1),
        "shard_kill": kill,
        "phase_s": _phase_s(init=p_init, compile_warmup=p_warm,
                            measure=p_measure, shard_kill=p_kill),
    }
    check_fleet_gates(dict(rec, shard_kill=dict(
        kill, expected_records=iters * parts)), timing=timing_gates)
    return rec


def bench_serve_online(device=None, n_requests: int = 300) -> dict:
    """The online serving gate (the JAX bench's ``serve_online``): the
    continuous-batching tier must beat the fixed-window tool where it
    claims to, and survive the faults it claims to — FAILS (raises)
    otherwise.

    Workload: ``n_requests`` Poisson open-loop single-row requests
    (seeded exponential interarrivals at 2x the measured serial
    capacity, so a one-at-a-time server is overloaded; arrivals never
    wait for completions; :func:`poisson_leg`). The throughput legs serve
    ``MLP([2048, 2048, 1024, 10])`` over a (512, 512) pool; legs run
    interleaved x2 and gate on MEDIANS.

    Gates (the JAX bench's, none loosened):

    - the continuous-batching replica behind a router beats a serially
      dispatched :class:`~sparktorch_tpu_torch.inference.BatchPredictor`
      on completed rows/s AND p99 request latency under the SAME arrival
      schedule, with every request completed and none failed;
    - a seeded replica kill (``ChaosConfig(kill_replica_at={1: 8})``)
      mid-load drops ZERO requests: the router evicts the victim,
      re-routes its admissions, the tier restarts it and the router
      re-admits it, all seen in counters;
    - a mid-load weight push lands on EVERY replica within the
      staleness bound (20 poll intervals + 1 s), and the served outputs
      equal the server's weights' outputs after the swap;
    - drift: the JAX gate compares with the newest prior
      ``serve_online`` record, and every prior record is a TPU run of
      the JAX package, which may not carry over: ``serve_drift`` is
      always ``no_prior_record``.
    """
    import threading

    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.ft.policy import FtPolicy, RestartPolicy
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.models import MLP, ClassificationNet
    from sparktorch_tpu_torch.net.transport import BinaryTransport
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.serve.infer import InferenceReplica
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )
    from sparktorch_tpu_torch.serve.router import InferenceTier, Router

    dev = _resolve_device(device)
    overload = 2.0
    rng = np.random.default_rng(0)

    with _Phase(dev, "init") as p_init:
        # Throughput legs: an MLP big enough that one row costs real
        # compute, so batching has something to amortize.
        torch.manual_seed(0)
        module = MLP(features=[2048, 2048, 1024, 10], in_features=512)
        xpool = rng.normal(0, 1, (512, 512)).astype(np.float32)
        # Fault/weight legs: the small classifier the param server
        # trains (recovery and staleness don't need the big model).
        clf_module = ClassificationNet(n_classes=2)
        xsmall = rng.normal(0, 1, (64, 10)).astype(np.float32)

    with _Phase(dev, "compile_warmup") as p_warm:
        # Calibrate the SERIAL service time (the fixed-window tool's
        # capacity) after a warm-up, then pick the arrival rate to
        # overload it: the gate compares the designs under load.
        bp = BatchPredictor(module, device=dev, chunk=32,
                            telemetry=Telemetry(run_id="serve_base"))
        bp.predict(xpool[:1])
        svc = []
        for _ in range(30):
            t0 = time.perf_counter()
            bp.predict(xpool[:1])
            svc.append(time.perf_counter() - t0)
        svc_s = float(np.median(svc))
        interarrival_s = svc_s / overload
        arrivals = np.cumsum(rng.exponential(interarrival_s, n_requests))

    def _baseline_leg() -> dict:
        # The fixed-window tool behind a serial dispatch: one predict
        # per request, one at a time (no admission queue, no
        # coalescing).
        lock = threading.Lock()

        def submit(x):
            with lock:
                return bp.predict(x)

        return poisson_leg(submit, xpool, arrivals)

    def _continuous_leg() -> dict:
        # SAME card, same arrival schedule, ONE replica: the throughput
        # win must come from admission/coalescing, not extra compute.
        leg_tele = Telemetry(run_id="serve_cont")
        replica = InferenceReplica(module, replica_id="0",
                                   telemetry=leg_tele,
                                   buckets=(1, 8, 32),
                                   max_queue_rows=1024,
                                   warm_input=xpool[:1], device=dev)
        router = Router(telemetry=leg_tele)
        router.register(replica)
        try:
            out = poisson_leg(
                lambda x: router.submit(x, deadline_s=120.0), xpool,
                arrivals)
            out["batches"] = leg_tele.counter_value(
                "serve.batches_total", {"replica": "0"})
            fill = leg_tele.histogram("serve.batch_fill",
                                      {"replica": "0"})
            out["batch_fill_p50"] = fill.get("p50")
            out["queue_depth_p99"] = leg_tele.histogram(
                "serve.queue_depth", {"replica": "0"}).get("p99")
            return out
        finally:
            router.stop()
            replica.stop()

    with _Phase(dev, "measure") as p_measure:
        bases, conts = [], []
        for _ in range(2):  # interleaved: host noise hits both legs
            bases.append(_baseline_leg())
            conts.append(_continuous_leg())

    def _median(legs, key):
        vals = [leg[key] for leg in legs if leg.get(key) is not None]
        return float(np.median(vals)) if vals else None

    base = {k: (round(_median(bases, k), 3)
                if isinstance(bases[0][k], (int, float)) else bases[0][k])
            for k in bases[0]}
    cont = {k: (round(_median(conts, k), 3)
                if isinstance(conts[0][k], (int, float)) else conts[0][k])
            for k in conts[0]}
    throughput_ratio = cont["rows_per_s"] / max(base["rows_per_s"], 1e-9)
    p99_ratio = cont["p99_ms"] / max(base["p99_ms"], 1e-9)

    # -- seeded replica kill under load --------------------------------
    with _Phase(dev, "replica_kill") as p_kill:
        kill_tele = Telemetry(run_id="serve_kill")
        policy = FtPolicy(restart=RestartPolicy(backoff_base_s=0.02,
                                                backoff_max_s=0.1,
                                                max_restarts=3))
        tier = InferenceTier(clf_module, n_replicas=2,
                             telemetry=kill_tele, ft_policy=policy,
                             buckets=(1, 8, 32), max_queue_rows=1024,
                             warm_input=xsmall[:1],
                             probe_interval_s=0.05, device=dev)
        # Deterministic victim: replica 0 carries a fat observed
        # latency so the weighted pick opens on replica 1, whose 8th
        # admission is the seeded kill.
        kill_tele.observe("serve.request_latency_s", 0.5,
                          labels={"replica": "0"})
        try:
            with inject(ChaosConfig(kill_replica_at={1: 8}),
                        telemetry=kill_tele) as inj:
                kill_leg = poisson_leg(
                    lambda x: tier.submit(x, deadline_s=60.0), xsmall,
                    arrivals)
            kills = len([e for e in inj.events
                         if e["site"] == "serve.replica"])
            deadline = time.monotonic() + 15.0
            while (kill_tele.counter_value("router.readmissions_total",
                                           {"replica": "1"}) < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            evictions = kill_tele.counter_value(
                "router.evictions_total",
                {"replica": "1", "reason": "error"})
            restarts = kill_tele.counter_value(
                "serve.replica_restarts_total", {"replica": "1"})
            readmissions = kill_tele.counter_value(
                "router.readmissions_total", {"replica": "1"})
        finally:
            tier.stop()

    # -- mid-load weight push: bounded staleness + exactness -----------
    with _Phase(dev, "weight_push") as p_push:
        poll_s = 0.05
        staleness_bound_s = 20 * poll_s + 1.0
        clf = serialize_torch_obj(
            ClassificationNet(n_classes=2), criterion="cross_entropy",
            optimizer="sgd", optimizer_params={"lr": 0.1},
            input_shape=(10,),
        )
        push_tele = Telemetry(run_id="serve_push")
        server = ParameterServer(clf, device=dev)
        http = ParamServerHttp(server, port=0).start()
        _v, params0 = server.slot.read()
        tier = InferenceTier(ClassificationNet(n_classes=2), params0,
                             n_replicas=2, telemetry=push_tele,
                             buckets=(1, 8), max_queue_rows=1024,
                             warm_input=xsmall[:1],
                             probe_interval_s=0.05, device=dev)
        tier.start_pullers(
            lambda: BinaryTransport(http.url, quant=None),
            poll_s=poll_s)
        stop_load = threading.Event()

        def _background_load():
            while not stop_load.is_set():
                tier.submit(xsmall[:1], deadline_s=30.0)
                time.sleep(0.005)

        loader = threading.Thread(target=_background_load, daemon=True)
        loader.start()
        try:
            time.sleep(0.3)  # pullers sync the initial version
            grads = {k: torch.ones_like(v) for k, v in params0.items()}
            server.push_gradients(grads, wait=True)
            pushed_version = server.slot.version
            t_push = time.monotonic()
            staleness: Dict[str, float] = {}
            deadline = t_push + staleness_bound_s + 5.0
            while (len(staleness) < len(tier.replicas)
                   and time.monotonic() < deadline):
                for rid, replica in tier.replicas.items():
                    if rid not in staleness \
                            and replica.params_version >= pushed_version:
                        staleness[rid] = time.monotonic() - t_push
                time.sleep(0.01)
            stop_load.set()
            loader.join(timeout=30)
            # Exactness: the SERVED outputs equal the pushed weights'.
            _v2, server_params = server.slot.read()
            ref_module = ClassificationNet(n_classes=2)
            ref_module.load_state_dict(server_params)
            ref_module.to(dev).eval()
            with torch.inference_mode():
                ref = ref_module(torch.from_numpy(xsmall[:8]).to(dev))
            ref = ref.cpu().numpy()
            push_exact = True
            for replica in tier.replicas.values():
                out = replica.infer(xsmall[:8])
                if not np.allclose(out, ref, rtol=1e-5, atol=1e-6):
                    push_exact = False
        finally:
            stop_load.set()
            tier.stop()
            http.stop()
            server.stop()

    # -- the gates ------------------------------------------------------
    if base["errors"] or cont["errors"]:
        raise AssertionError(
            f"load legs dropped requests: baseline {base['errors']} "
            f"({base['error_samples']}), continuous {cont['errors']} "
            f"({cont['error_samples']})"
        )
    # Completion counted SEPARATELY from errors: a future that is
    # never resolved raises nothing — its load thread just times out
    # — and an errors-only gate would report that orphaned request as
    # success.
    for leg_name, leg in (("baseline", base), ("continuous", cont),
                          ("replica_kill", kill_leg)):
        if leg["completed"] != n_requests:
            raise AssertionError(
                f"{leg_name} leg completed only {leg['completed']}/"
                f"{n_requests} requests with no error raised — "
                f"orphaned futures are silent drops"
            )
    if not throughput_ratio > 1.0:
        raise AssertionError(
            f"continuous batching did not beat the fixed-window "
            f"BatchPredictor on throughput: {cont['rows_per_s']:.0f} "
            f"vs {base['rows_per_s']:.0f} rows/s "
            f"(x{throughput_ratio:.2f})"
        )
    if not p99_ratio <= 1.0:
        raise AssertionError(
            f"continuous batching p99 regressed vs the fixed-window "
            f"baseline: {cont['p99_ms']:.1f} vs {base['p99_ms']:.1f} "
            f"ms (x{p99_ratio:.2f}) — the throughput win must not be "
            f"bought with latency"
        )
    if kill_leg["errors"]:
        raise AssertionError(
            f"replica-kill leg DROPPED {kill_leg['errors']} requests "
            f"({kill_leg['error_samples']}) — the router must re-route "
            f"every admission of the killed replica"
        )
    if kills < 1:
        raise AssertionError("seeded replica kill never fired")
    if evictions < 1 or restarts < 1 or readmissions < 1:
        raise AssertionError(
            f"recovery pipeline incomplete: evictions={evictions} "
            f"restarts={restarts} readmissions={readmissions}"
        )
    if len(staleness) < 2:
        raise AssertionError(
            f"mid-load weight push reached only {len(staleness)}/2 "
            f"replicas within {staleness_bound_s + 5.0:.1f}s"
        )
    max_staleness = max(staleness.values())
    if max_staleness > staleness_bound_s:
        raise AssertionError(
            f"weight-update staleness {max_staleness:.2f}s exceeds "
            f"the {staleness_bound_s:.2f}s bound"
        )
    if not push_exact:
        raise AssertionError(
            "served parameters != pushed parameters after the swap"
        )

    # Every prior serve_online record is the JAX package's, on a TPU; the
    # tolerance is the JAX gate's default.
    drift = {"status": "no_prior_record", "tolerance": 0.5}

    return {
        "config": "serve_online", "unit": "x (throughput ratio)",
        "value": round(throughput_ratio, 3),
        "n_requests": n_requests,
        "serial_service_ms": round(svc_s * 1e3, 3),
        "offered_rate_rps": round(1.0 / interarrival_s, 1),
        "throughput_ratio": round(throughput_ratio, 3),
        "p99_ratio": round(p99_ratio, 3),
        "cont_rows_per_s": cont["rows_per_s"],
        "baseline": base, "continuous": cont,
        "replica_kill": {**kill_leg, "kills": kills,
                         "evictions": evictions, "restarts": restarts,
                         "readmissions": readmissions},
        "weight_push": {
            "poll_s": poll_s,
            "staleness_s": {k: round(v, 3)
                            for k, v in sorted(staleness.items())},
            "staleness_bound_s": staleness_bound_s,
            "exact": push_exact,
        },
        "serve_drift": drift,
        "phase_s": _phase_s(init=p_init, compile_warmup=p_warm,
                            measure=p_measure, replica_kill=p_kill,
                            weight_push=p_push),
    }


CONFIGS: Dict[str, Callable[[], dict]] = {
    "mnist_mlp_sync": bench_mnist_mlp_sync,
    "mnist_cnn_sync": bench_mnist_cnn_sync,
    "lazy_cnn_sync": bench_lazy_cnn_sync,
    "resnet18_hogwild": bench_resnet18_hogwild,
    "hogwild_wire": bench_hogwild_wire,
    "bert_dp": bench_bert_dp,
    "resnet50_inference": bench_resnet50_inference,
    "long_context_lm": bench_long_context_lm,
    "moe_lm": bench_moe_lm,
    "serve_online": bench_serve_online,
    "hogwild_ps_fleet": bench_hogwild_ps_fleet,
}


def _headline() -> dict:
    """The one-line metric: the MNIST-CNN sync DP rate, the median of
    the paired-span slope samples, with best, spread and sample count."""
    out = bench_mnist_cnn_sync()
    per_chip = out["examples_per_sec_per_chip"]
    return {
        "metric": "examples/sec/chip (MNIST-CNN sync DP, batch 1024)",
        "value": per_chip,
        "unit": "examples/sec/chip",
        "vs_baseline": round(per_chip / REFERENCE_BASELINE_EXAMPLES_PER_SEC,
                             3),
        "best": out["rate_best"],
        "spread_pct": out["rate_spread_pct"],
        "n_samples": len(out["rate_samples"]),
        "estimator": "median of paired-span slopes (cancels the per-span "
                     "read-back)",
    }


def _device_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    index = torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="sparktorch-tpu-torch-bench")
    parser.add_argument("--config", default="headline",
                        choices=["headline", "all", *CONFIGS])
    parser.add_argument("--log", default=None,
                        help="append the result records to this JSONL file")
    parser.add_argument("--telemetry-dump", default=None, metavar="PATH",
                        help="append the run's full telemetry snapshot "
                             "(counters, gauges, histogram and span "
                             "roll-ups, the bench/* phase spans among "
                             "them) as one JSONL line after the records")
    args = parser.parse_args(argv)

    runs = {"headline": [_headline], "all": list(CONFIGS.values())}.get(
        args.config) or [CONFIGS[args.config]]
    records = []
    for i, run in enumerate(runs):
        if i:
            # Fresh allocator state per config: cached blocks and live
            # buffers of an earlier config must not depress a later one.
            gc.collect()
            torch.cuda.empty_cache()
        rec = run()
        rec["ts"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        rec["device"] = _device_label()
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.log:
        with open(args.log, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    if args.telemetry_dump:
        get_telemetry().dump(args.telemetry_dump)


if __name__ == "__main__":
    main()
