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
latency, delta and int8 bytes, a seeded shard kill), ``hogwild_chaos``
(a supervised hogwild run clean and under a seeded worker kill: one
restart, exact records, the recovery latency) and ``hogwild_chaos_soak``
(seeded kills, connection drops and heartbeat freezes over many
supervised rounds), ``gang_obs`` (the fleet collector over rank
exporters: merged scrapes, the gang trace budget, the truncation
warning) and ``elastic_ctl`` (an elastic multi-process run through a
SIGKILL, a shrink and a grow, seen through the collector's ``/gang``),
and the six obs configs that render through ``obs/timeline.py``:
``rpc_trace`` (the request tracer's overhead at 1% sampling, its spans
against the wire histograms, a slowed shard on the critical path),
``health`` (a poisoned batch caught, replayed bitwise in a fresh
process, the lane's cost), ``goodput`` (the time ledger's buckets under
training, a slowed shard and an elastic kill), ``skew`` (a straggling
rank's wait charged to it, the alert reaching a controller),
``profile`` (the stack sampler's cost and a planted hot frame) and
``obs_history`` (a sustained-p99 alert on a slowed shard, a postmortem
of a SIGKILLed worker, the history tier's sweep cost). Weights are
seeded, never pretrained.

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
- The drift gates (``moe_lm``'s ``comm_drift``, ``gang_obs``'s
  ``gang_drift``, ``elastic_ctl``'s ``elastic_drift``, ``serve_online``'s
  ``serve_drift`` and the obs configs' ``health_drift``,
  ``goodput_drift``, ``skew_drift``, ``profile_drift``, ``obs_drift``)
  compare with the newest prior record, and every prior
  record is the JAX package's on a TPU (``BENCH_r*.json``,
  ``benchmarks/``), which may not carry over: they always read
  ``{"status": "no_prior_record", "tolerance": ...}`` with the JAX
  gate's default tolerance.
- The obs configs' A/A steps are torch matmuls on the config's device
  where the JAX configs jit theirs, and ``goodput``'s training leg asks
  for the one compile the port's trainer has (its set-up; a hand
  kernel's first build would add one, and MnistMLP runs none) where the
  JAX leg asks for two (the set-up and the first chunk's jit).
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
import contextlib
import gc
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparktorch_tpu_torch.obs import get_telemetry
# The ledger's peak and mfu_honest division, so /goodput and a bench
# record divide alike.
from sparktorch_tpu_torch.obs.goodput import (  # noqa: F401
    H100_BF16_PEAK_TFLOPS,
    mfu_honest,
)
from sparktorch_tpu_torch.ops.roofline import (
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

# The least difference, in seconds, between a sync config's long and
# short span (the JAX bench's 1.6 s); a harness that runs the configs at
# a cut depth may set it lower.
SYNC_SPAN_S = 1.6

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
        set(), {"steps_run", "steps_run_dense"}),
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
    "hogwild_chaos": (
        {"config", "unit", "value", "recovery_latency_s", "restarts",
         "wall_clean_s", "wall_chaos_s", "overhead_pct", "kill_at_step",
         "victim_worker", "iters", "n_chips", "final_loss_clean",
         "final_loss_chaos", "phase_s"}, set(), set()),
    "hogwild_chaos_soak": (
        {"config", "unit", "value", "rounds", "freeze_rounds", "kills",
         "freezes", "drops", "restarts", "stall_preemptions",
         "records_exact", "n_chips", "wall_s", "per_round"}, set(), set()),
    "gang_obs": (
        {"config", "unit", "value", "n_ranks", "run_id", "gang_step_skew_s",
         "gang_comm_s", "gang_comm_fraction", "gang_drift", "merged_series",
         "truncation_trips", "scrape_reconciled", "wall_s"}, set(), set()),
    "elastic_ctl": (
        {"config", "unit", "value", "recovery_latency_s", "n_parts",
         "restarts", "resizes", "removed", "generation", "world_size",
         "parts_by_generation", "chaos_kills", "records_exact",
         "elastic_drift", "wall_s"}, set(), set()),
    "sharded_trace": (
        {"config", "unit", "value", "comm_fraction", "overlap_fraction",
         "comm_s", "compute_s", "collective_s", "collective_counts",
         "n_collective_events", "n_steps", "n_chips", "mesh", "reconcile",
         "top_ops", "scrape_parity", "comm_drift", "phase_s"}, set(), set()),
    "rpc_trace": (
        {"config", "unit", "value", "overhead_pct", "fast_path_us",
         "sampled_chain_us", "traced_cost_per_op_us", "wire_op_p50_ms",
         "sample_rate_default", "pull_trees", "reconcile", "slow_shard",
         "phase_s"}, set(), set()),
    "health": (
        {"config", "unit", "value", "note_step_us", "overhead_pct_of_step",
         "overhead_pct_aa_wall", "overhead_pct_note_floor",
         "step_wall_off_ms", "step_wall_on_ms", "detect", "replay", "aa",
         "alerts", "health_drift", "wall_s"}, set(), set()),
    "goodput": (
        {"config", "unit", "value", "ledger_span_us", "overhead_pct_of_step",
         "step_wall_ms", "training", "run_report", "wire", "elastic",
         "goodput_drift", "wall_s"}, set(), set()),
    "skew": (
        {"config", "unit", "value", "stamp_us", "stamp_pct_of_step",
         "step_wall_ms", "decomposition", "aa", "alerts", "skew_drift",
         "wall_s"}, set(), {"stamp_spread_us"}),
    "profile": (
        {"config", "unit", "value", "sample_tick_us", "overhead_pct_of_step",
         "step_wall_off_ms", "step_wall_on_ms", "hz", "hot", "run_report",
         "profile_drift", "wall_s"}, set(), {"aa_floor_pct"}),
    "obs_history": (
        {"config", "unit", "value", "sweep_on_ms", "sweep_off_ms",
         "sweep_on_min_ms", "sweep_off_min_ms", "sweep_overhead_pct",
         "alert", "postmortem", "obs_drift", "phase_s", "wall_s"},
        set(), set()),
}


def _resolve_device(device=None) -> torch.device:
    from sparktorch_tpu_torch.inference import _resolve_device as resolve

    return resolve(device)


class _Phase:
    """Host seconds of a ``with`` block, the card synchronized at its
    end, recorded on the process-global bus as the JAX bench's
    ``bench/<name>`` span (what ``--telemetry-dump`` writes out)."""

    def __init__(self, dev: torch.device, name: str):
        self.dev = dev
        self.name = name
        self.duration_s = 0.0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(get_telemetry().span(f"bench/{self.name}"))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.duration_s = time.perf_counter() - self._t0
        finally:
            self._stack.__exit__(*exc)


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
                      with_cost_analysis: bool = False, device=None,
                      with_trace: bool = False) -> dict:
    """Shared harness for the sync-DP configs.

    A "call" is ``iters`` train steps dispatched back to back, ended by
    one read-back of the loss (the analog of one fused-epoch call of
    the JAX bench). Estimator: the PAIRED-SPAN SLOPE. Each repeat times
    a short span (1 call) and a long span (``chunks`` calls back to
    back), each ended by its read-back; the per-step time is
    ``(T_long - T_short) / ((n_long - 1) * iters)``, which cancels the
    constant cost of a span's end. The long span doubles until the
    difference is at least ``SYNC_SPAN_S`` seconds or 512 calls, and the
    grown span carries over to the remaining repeats. Reports the median
    over ``max(2, repeats)`` samples after a symmetric trim (samples at or
    below 0, or under 20% of the positive median, are dropped), with
    best and spread. ``batch_size`` is the global batch: each rank of
    the mesh steps its shard. ``with_trace``: a ``trace`` phase captures
    two more calls under ``torch.profiler``, each a ``train_step``
    range, and the analysed capture (``obs/xprof.py``) gives the
    record's ``comm_budget``, ``comm_fraction`` and
    ``overlap_fraction``, as in the JAX harness."""
    from sparktorch_tpu_torch.parallel.mesh import build_mesh
    from sparktorch_tpu_torch.train.sync import _dp_steps, _dp_trainer, _Shards
    from sparktorch_tpu_torch.utils.data import handle_features

    dev = _resolve_device(device)
    mesh = build_mesh()
    world, group = mesh.batch_shards, mesh.batch_group
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
                if (_world_max(t_long - t_short, group, dev) >= SYNC_SPAN_S
                        or n_long >= 512):
                    break
                n_long *= 2
            slopes.append((t_long - t_short) / max((n_long - 1) * iters, 1))

    trace_rec, p_trace = None, None
    if with_trace:
        import tempfile

        from sparktorch_tpu_torch.utils.tracing import (
            profile_run,
            step_annotation,
        )

        tele = get_telemetry()
        with _Phase(dev, "trace") as p_trace, \
                tempfile.TemporaryDirectory() as td:
            with profile_run(td, telemetry=tele) as handle:
                for i in range(2):
                    with step_annotation(i, telemetry=tele, device=dev):
                        loss = call()
                    loss = float(loss)
        analysis = handle["analysis"]
        if analysis is not None:
            trace_rec = {
                "comm_s": round(analysis.comm_s, 6),
                "comm_fraction": round(analysis.comm_fraction, 4),
                "overlap_fraction": round(analysis.overlap_fraction, 4),
                "collective_s": {k: round(v, 6)
                                 for k, v in analysis.family_s().items()},
                "collective_counts": analysis.family_counts(),
                "n_collective_events": analysis.n_collective_events,
            }

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
    if trace_rec is not None:
        # The comm/compute budget: seconds join the phase breakdown, the
        # attribution detail rides beside it.
        out["comm_budget"] = trace_rec
        out["phase_s"]["trace"] = round(p_trace.duration_s, 3)
        out["phase_s"]["comm_s"] = trace_rec["comm_s"]
        out["comm_fraction"] = trace_rec["comm_fraction"]
        out["overlap_fraction"] = trace_rec["overlap_fraction"]
    return out


def _no_prior_drift(tolerance: float, **extra) -> dict:
    """A JAX drift gate's record when it has no prior record: every
    prior record is the JAX package's on a TPU (``BENCH_r*.json``,
    ``benchmarks/``), which does not carry over to the port."""
    return {"status": "no_prior_record", "tolerance": tolerance, **extra}


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


def bench_mnist_mlp_sync(device=None, repeats: int = 5) -> dict:
    """BASELINE config 1 (examples/simple_dnn.py workload); ``repeats``
    slope samples (the JAX bench's 5)."""
    from sparktorch_tpu_torch.models import MnistMLP

    _resolve_device(device)
    x, y, batch = _mnist()
    torch.manual_seed(0)
    spec = _spec(MnistMLP(), optimizer="adam", optimizer_params={"lr": 1e-3},
                 input_shape=(784,))
    out = _sync_epoch_bench(spec, x, y, batch, repeats=repeats, device=device)
    return {"config": "mnist_mlp_sync", "unit": "examples/sec/chip", **out}


def bench_mnist_cnn_sync(device=None, repeats: int = 5) -> dict:
    """The headline workload (examples/simple_cnn.py); ``repeats`` slope
    samples (the JAX bench's 5)."""
    from sparktorch_tpu_torch.models import MnistCNN

    _resolve_device(device)
    x, y, batch = _mnist()
    torch.manual_seed(0)
    spec = _spec(MnistCNN(), optimizer="adam", optimizer_params={"lr": 1e-3},
                 input_shape=(784,))
    out = _sync_epoch_bench(spec, x, y, batch, repeats=repeats, device=device)
    return {"config": "mnist_cnn_sync", "unit": "examples/sec/chip", **out}


def bench_lazy_cnn_sync(device=None, repeats: int = 5) -> dict:
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
    out = _sync_epoch_bench(spec, x, y, batch, repeats=repeats, device=device)
    return {"config": "lazy_cnn_sync", "unit": "examples/sec/chip",
            "lazy_materialize_s": round(lazy_materialize_s, 4), **out}


def bench_resnet18_hogwild(device=None, iters: int = 1024,
                           repeats: int = 5) -> dict:
    """BASELINE config 3: ResNet-18 on CIFAR-10 shapes through the
    parameter server, ``repeats`` runs of ``iters`` iterations per worker
    (the JAX bench's 5 of 1,024: 256 push windows; the median is
    reported), a leg over the HTTP transport of ``max(64, iters // 4)``,
    and a sync ResNet-18 leg at the same minibatch per chip (``repeats``
    slope samples), so the async efficiency (hogwild rate / sync rate)
    is measured."""
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
    n_sync = mb * build_mesh().batch_shards
    reps = -(-n_sync // n)
    xs = np.tile(x, (reps, 1, 1, 1))[:n_sync]
    ys = np.tile(y, reps)[:n_sync]
    sync = _sync_epoch_bench(spec, xs, ys, n_sync, iters=16, warmup=2,
                             chunks=4, repeats=repeats, device=dev)
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


def bench_bert_dp(device=None, repeats: int = 5) -> dict:
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
                            repeats=repeats, with_cost_analysis=True,
                            device=device)

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
                            device=device, with_trace=True)
    dense = _sync_epoch_bench(spec_for(0), ids[:, :-1], ids[:, 1:], batch,
                              iters=6, warmup=2, chunks=2, repeats=repeats,
                              device=device)
    if "comm_fraction" in moe:
        moe["comm_drift"] = _no_prior_drift(0.25, mesh=None)
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
    drift = _no_prior_drift(0.5)

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


def _n_workers(dev: torch.device) -> int:
    """``train_async``'s default worker count: one per card (the JAX
    bench's ``len(jax.devices())``), one on the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def bench_hogwild_chaos(device=None) -> dict:
    """The JAX bench's ``hogwild_chaos`` fault-tolerance gate: the same
    hogwild workload (MnistMLP, 2,048 rows, minibatch 128, Adam, 64
    iterations) run clean and under a seeded kill of one worker at step
    16, both supervised. Raises unless the chaos run restarts exactly
    one worker, keeps the clean run's record count, recovers within
    10 s (``ft_recovery_latency_s``) and costs at most 300% over the
    clean run's wall. The headline value is the recovery latency."""
    from sparktorch_tpu_torch.ft import (
        ChaosConfig,
        FtPolicy,
        RestartPolicy,
        inject,
    )
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.train.hogwild import train_async

    dev = _resolve_device(device)
    with _Phase(dev, "data") as p_data:
        rng = np.random.default_rng(0)
        n, mb = 2048, 128
        x = rng.normal(0, 1, (n, 784)).astype(np.float32)
        y = rng.integers(0, 10, (n,)).astype(np.int32)
    with _Phase(dev, "init") as p_init:
        torch.manual_seed(0)
        spec = _spec(MnistMLP(), optimizer="adam",
                     optimizer_params={"lr": 1e-3}, input_shape=(784,))
    iters, kill_at = 64, 16
    # The victim must be a worker that exists: one a card.
    n_workers = _n_workers(dev)
    victim = 1 if n_workers > 1 else 0
    policy = FtPolicy(restart=RestartPolicy(max_restarts=2,
                                            backoff_base_s=0.05), seed=0)
    with _Phase(dev, "compile_warmup") as p_warm:
        train_async(spec, x, labels=y, iters=8, mini_batch=mb, seed=0,
                    device=dev)
    with _Phase(dev, "measure") as p_measure:
        t0 = time.perf_counter()
        clean = train_async(spec, x, labels=y, iters=iters, mini_batch=mb,
                            seed=0, supervise=True, ft_policy=policy,
                            device=dev)
        t_clean = time.perf_counter() - t0
        run_tele = Telemetry(run_id="bench_hogwild_chaos")
        t0 = time.perf_counter()
        with inject(ChaosConfig(kill_worker_at={victim: kill_at}, seed=0),
                    telemetry=run_tele):
            result = train_async(spec, x, labels=y, iters=iters,
                                 mini_batch=mb, seed=0, supervise=True,
                                 ft_policy=policy, telemetry=run_tele,
                                 device=dev)
        t_chaos = time.perf_counter() - t0

    restarts = (result.summary or {}).get("ft", {}).get("restarts_total", -1)
    recovery = run_tele.histogram("ft_recovery_latency_s",
                                  labels={"worker": str(victim)})
    overhead_pct = 100.0 * (t_chaos - t_clean) / max(t_clean, 1e-9)
    if restarts != 1:
        raise AssertionError(f"expected exactly 1 restart, got {restarts}")
    if len(result.metrics) != len(clean.metrics):
        raise AssertionError(
            f"chaos run lost records: {len(result.metrics)} vs "
            f"{len(clean.metrics)} clean")
    if recovery["count"] < 1 or recovery["max"] > 10.0:
        raise AssertionError(f"recovery latency out of budget: {recovery}")
    if overhead_pct > 300.0:
        raise AssertionError(
            f"recovery overhead {overhead_pct:.0f}% exceeds 300% budget")
    return {
        "config": "hogwild_chaos", "unit": "s (recovery latency)",
        "value": round(recovery["max"], 4),
        "recovery_latency_s": round(recovery["max"], 4),
        "restarts": int(restarts),
        "wall_clean_s": round(t_clean, 3),
        "wall_chaos_s": round(t_chaos, 3),
        "overhead_pct": round(overhead_pct, 1),
        "kill_at_step": kill_at,
        "victim_worker": victim,
        "iters": iters,
        "n_chips": n_workers,
        "final_loss_clean": clean.metrics[-1]["loss"],
        "final_loss_chaos": result.metrics[-1]["loss"],
        "phase_s": _phase_s(data=p_data, init=p_init, compile_warmup=p_warm,
                            measure=p_measure),
    }


def bench_hogwild_chaos_soak(device=None, rounds: int = 4, iters: int = 16,
                             freeze_rounds: int = 2,
                             worker_steps: int = 60) -> dict:
    """The JAX bench's ``hogwild_chaos_soak``: a seeded random schedule
    of faults over many supervised rounds, in two legs.

    - Hogwild leg: each round runs ``train_async`` over real sockets
      (MnistMLP, 1,024 rows, minibatch 64) under a random schedule: with
      probability 3/4 a random worker is killed at a random step, and
      0-2 keep-alive connections drop. Each round must restart exactly
      its kills and keep an exact record count.
    - Freeze leg: three supervised heartbeat-emitting workers, one of
      which goes silent mid-run on its first attempt; the barrier
      deadline (0.3 s) must preempt it and the rerun must finish.

    Raises when restarts differ from kills, stall preemptions from
    freezes, or records are lost or doubled."""
    import tempfile
    import threading

    from sparktorch_tpu_torch.ft import (
        ChaosConfig,
        FtPolicy,
        RestartPolicy,
        inject,
    )
    from sparktorch_tpu_torch.ft.policy import BarrierPolicy
    from sparktorch_tpu_torch.ft.supervisor import Supervisor, ThreadWorker
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.obs import HeartbeatEmitter, Telemetry
    from sparktorch_tpu_torch.train.hogwild import train_async

    dev = _resolve_device(device)
    rng = np.random.default_rng(7)
    tele = Telemetry(run_id="bench_chaos_soak")
    t_start = time.perf_counter()

    # The hogwild leg: kills and drops over real sockets.
    n_workers = _n_workers(dev)
    torch.manual_seed(0)
    spec = _spec(MnistMLP(), optimizer="adam", optimizer_params={"lr": 1e-3},
                 input_shape=(784,))
    x = rng.normal(0, 1, (1024, 784)).astype(np.float32)
    y = rng.integers(0, 10, (1024,)).astype(np.int32)
    policy = FtPolicy(restart=RestartPolicy(max_restarts=2,
                                            backoff_base_s=0.05), seed=0)
    train_async(spec, x, labels=y, iters=4, mini_batch=64, seed=0,
                device=dev)  # warm-up

    kills_total = drops_total = 0
    per_round = []
    for r in range(rounds):
        kills = {}
        if rng.random() < 0.75:
            kills[int(rng.integers(0, n_workers))] = int(rng.integers(2, 8))
        drops = int(rng.integers(0, 3))
        cfg = ChaosConfig(kill_worker_at=kills, drop_connections=drops,
                          seed=r)
        with inject(cfg, telemetry=tele) as inj:
            result = train_async(spec, x, labels=y, iters=iters,
                                 mini_batch=64, seed=r, transport="http",
                                 supervise=True, ft_policy=policy,
                                 telemetry=tele, device=dev)
        restarts = (result.summary or {}).get("ft", {}).get(
            "restarts_total", 0)
        fired = [e["site"] for e in inj.events]
        if restarts != len(kills):
            raise AssertionError(
                f"soak round {r}: {restarts} restarts != {len(kills)} "
                f"injected kills (chaos events: {fired})")
        if fired.count("worker.step") != len(kills):
            raise AssertionError(
                f"soak round {r}: kill schedule {kills} but fired {fired}")
        # A killed attempt flushes nothing; its rerun repays the round.
        if len(result.metrics) != iters * n_workers:
            raise AssertionError(
                f"soak round {r}: {len(result.metrics)} records != "
                f"{iters * n_workers} expected")
        kills_total += len(kills)
        drops_total += fired.count("transport.request")
        per_round.append({"round": r, "kills": list(kills.items()),
                          "drops": fired.count("transport.request"),
                          "restarts": int(restarts)})

    def total(prefix: str) -> float:
        return sum(v for k, v in tele.snapshot()["counters"].items()
                   if k.startswith(prefix))

    if total("ft_restarts_total") != kills_total:
        raise AssertionError(
            f"bus ft_restarts_total {total('ft_restarts_total')} != "
            f"{kills_total} injected kills across the soak")

    # The freeze leg: stall-preempted heartbeats through the supervisor.
    freezes_total = 0
    for r in range(freeze_rounds):
        freeze_rank = int(rng.integers(0, 3))
        freeze_at = int(rng.integers(3, 8))
        freezes_total += 1
        with tempfile.TemporaryDirectory() as hb_dir:
            done_counts = {i: 0 for i in range(3)}
            lock = threading.Lock()

            def make_start(rank, hb_dir=hb_dir, done_counts=done_counts,
                           lock=lock, freeze_rank=freeze_rank,
                           freeze_at=freeze_at):
                def start(attempt):
                    # Freshen the slot before the handle exists: the
                    # frozen file's stale age must not preempt the rerun.
                    HeartbeatEmitter(hb_dir, rank).beat()

                    def target(cancel):
                        emitter = HeartbeatEmitter(hb_dir, rank)
                        frozen = attempt == 0 and rank == freeze_rank
                        for step in range(worker_steps):
                            if cancel.is_set():
                                return  # cooperative preemption
                            if not (frozen and step >= freeze_at):
                                emitter.notify_step(step)
                            time.sleep(0.02)
                        with lock:
                            done_counts[rank] += 1
                        emitter.close()

                    return ThreadWorker(f"soak{rank}", target,
                                        pass_cancel=True)

                return start

            fpol = FtPolicy(
                restart=RestartPolicy(max_restarts=2, backoff_base_s=0.05),
                barrier=BarrierPolicy(deadline_s=0.3), seed=r)
            sup = Supervisor(policy=fpol, telemetry=tele,
                             heartbeat_dir=hb_dir, name=f"soak_freeze{r}")
            for rank in range(3):
                sup.add(str(rank), make_start(rank), rank=rank)
            sup.run(deadline_s=60)
            if any(v != 1 for v in done_counts.values()):
                raise AssertionError(
                    f"freeze round {r}: completion counts {done_counts}")

    preempts = total("ft_stall_preemptions_total")
    if preempts != freezes_total:
        raise AssertionError(f"{preempts} stall preemptions != "
                             f"{freezes_total} injected freezes")
    restarts_all = total("ft_restarts_total")
    if restarts_all != kills_total + freezes_total:
        raise AssertionError(
            f"total restarts {restarts_all} != kills {kills_total} + "
            f"freezes {freezes_total}")
    return {
        "config": "hogwild_chaos_soak", "unit": "restarts",
        "value": int(restarts_all),
        "rounds": rounds, "freeze_rounds": freeze_rounds,
        "kills": int(kills_total), "freezes": int(freezes_total),
        "drops": int(drops_total),
        "restarts": int(restarts_all),
        "stall_preemptions": int(preempts),
        "records_exact": True,
        "n_chips": n_workers,
        "wall_s": round(time.perf_counter() - t_start, 2),
        "per_round": per_round,
    }


def _synthetic_rank_trace(rank: int, steps: int = 2) -> dict:
    """A deterministic per-rank Chrome trace in ``torch.profiler``'s
    shape: each step one ``train_step`` range on the host and its
    projection onto the card, one compute kernel and one NCCL
    all-reduce kernel — with rank-dependent timings (rank r's step walls
    are (1 + r/4)x rank 0's), the JAX bench's synthetic ranks."""
    events = []
    scale = 1.0 + rank / 4.0
    t = 1000.0
    for s in range(steps):
        wall = 1000.0 * scale
        for cat, tid in (("user_annotation", 1), ("gpu_user_annotation", 7)):
            events.append({"ph": "X", "cat": cat, "pid": 1, "tid": tid,
                           "name": "train_step", "ts": t, "dur": wall,
                           "args": {"step_num": str(s),
                                    "External id": s + 1}})
        events.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                       "name": f"sm90_gemm_kernel_{s}", "ts": t + 50,
                       "dur": 600 * scale})
        events.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 13,
                       "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                       "ts": t + 400, "dur": 400 * scale})
        t += wall
    return {"traceEvents": events}


def bench_gang_obs(n_ranks: int = 3) -> dict:
    """The JAX bench's gang-observability gate: N local rank exporters,
    the fleet collector over them; raises unless

    - the collector's merged scrape carries every per-rank series with
      ``rank``/``host`` labels and the merged values reconcile with the
      per-rank scrapes;
    - the merged gang trace budget reconciles with the per-rank analyses
      of the synthetic ``torch.profiler`` traces: per-family comm
      seconds sum, per-step walls max, cross-rank step skew > 0;
    - a seeded truncated capture (more steps annotated on the bus than
      ranges in the trace) trips ``xprof.capture_truncated`` exactly
      once, and a complete capture trips nothing.

    No device work: the observability plane's own gate."""
    import os
    import tempfile

    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.obs import (
        FleetCollector,
        Telemetry,
        analyze_trace,
        mint_run_id,
        parse_prometheus,
        scrape_json,
        scrape_text,
    )
    from sparktorch_tpu_torch.obs.heartbeat import HeartbeatEmitter
    from sparktorch_tpu_torch.obs.xprof import analyze_and_publish

    t0 = time.perf_counter()
    run_id = mint_run_id("bench-gang-obs")
    analyses = []
    exporters = []
    collector = None
    with tempfile.TemporaryDirectory() as hb_dir:
        try:
            for r in range(n_ranks):
                tele = Telemetry(run_id=run_id)
                # Distinct per-rank counter values, so the sum and
                # match gates cannot pass by accident.
                tele.counter("bench.gang_obs_ticks", r + 1)
                analysis = analyze_trace(_synthetic_rank_trace(r))
                analysis.publish(tele)
                analyses.append(analysis)
                HeartbeatEmitter(hb_dir, rank=r, telemetry=tele,
                                 run_id=run_id).notify_step(10 * (r + 1))
                exporters.append(GangMetricsExporter(
                    heartbeat_dir=hb_dir, telemetry=tele).start())

            collector = FleetCollector(
                {r: exp.url for r, exp in enumerate(exporters)},
                run_id=run_id, poll_interval_s=0,
            ).start(poll_loop=False)
            collector.poll()

            # Gate 1: the merged scrape against the per-rank scrapes.
            rank_scrapes = [parse_prometheus(scrape_text(e.url + "/metrics"))
                            for e in exporters]
            merged_scrape = parse_prometheus(
                scrape_text(collector.url + "/metrics"))
            host = "127.0.0.1"
            tick = "sparktorch_bench_gang_obs_ticks"
            merged_sum = 0.0
            for r, scrape in enumerate(rank_scrapes):
                own = scrape.get(tick)
                labeled = merged_scrape.get(
                    f'{tick}{{host="{host}",rank="{r}"}}')
                if own != float(r + 1) or labeled != own:
                    raise AssertionError(
                        f"rank {r}: merged series {labeled} != per-rank "
                        f"scrape {own}")
                merged_sum += labeled
            if merged_sum != sum(r + 1 for r in range(n_ranks)):
                raise AssertionError(
                    f"merged rank-labeled sum {merged_sum} != "
                    f"{sum(r + 1 for r in range(n_ranks))}")
            merged_snap = scrape_json(collector.url + "/telemetry")
            unlabeled = [
                k for section in ("counters", "gauges", "histograms")
                for k in merged_snap.get(section, {})
                if not k.startswith(("collector.", "xprof.gang_"))
                and "rank=" not in k]
            if unlabeled:
                raise AssertionError(
                    f"merged series missing rank labels: {unlabeled[:5]}")

            # Gate 2: the gang budget reconciles with the per-rank ones.
            gang = scrape_json(collector.url + "/gang")
            xp = gang.get("xprof")
            if not xp or xp.get("n_ranks") != n_ranks:
                raise AssertionError(f"gang xprof missing/short: {xp}")
            fam_sum: Dict[str, float] = {}
            for a in analyses:
                for fam, sec in a.family_s().items():
                    fam_sum[fam] = fam_sum.get(fam, 0.0) + sec
            for fam, sec in fam_sum.items():
                got = xp["collective_s"].get(fam, 0.0)
                if abs(got - sec) > 1e-9:
                    raise AssertionError(
                        f"family {fam}: gang {got} != sum {sec}")
            for i, step in enumerate(xp["steps"]):
                walls = [a.steps[i].wall_s for a in analyses]
                if abs(step["wall_s"] - max(walls)) > 1e-9:
                    raise AssertionError(
                        f"step {i}: gang wall {step['wall_s']} != max "
                        f"{max(walls)}")
                if step["skew_s"] < 0 or abs(
                        step["skew_s"] - (max(walls) - min(walls))) > 1e-9:
                    raise AssertionError(
                        f"step {i}: skew {step['skew_s']} != "
                        f"{max(walls) - min(walls)}")
            if not xp["step_skew_s"] > 0:
                raise AssertionError(
                    "synthetic ranks are skewed but gang skew is 0")
            hb = gang.get("heartbeats", {})
            if hb.get("n_ranks") != n_ranks or \
                    hb.get("step_skew") != 10 * (n_ranks - 1):
                raise AssertionError(f"merged heartbeat table wrong: {hb}")
            run_ids = set(gang.get("run_ids", {}).values())
            if run_ids != {run_id}:
                raise AssertionError(
                    f"run_id correlation broken: {run_ids} != {{{run_id}}}")

            # Gate 3: the truncation warning, exactly once.
            trunc_tele = Telemetry(run_id="gang_obs_trunc")
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "host0.pt.trace.json")
                with open(path, "w") as f:
                    json.dump(_synthetic_rank_trace(0, steps=2), f)  # lint-obs: ok (a synthetic profiler capture written as the analyzer's input, not telemetry)
                # Seeded truncation: 4 steps annotated on the bus, 2
                # ranges in the capture.
                analyze_and_publish(td, telemetry=trunc_tele,
                                    expected_steps=4)
                tripped = trunc_tele.counter_value(
                    "xprof.capture_truncated_total")
                if tripped != 1:
                    raise AssertionError(
                        f"truncation warning tripped {tripped}x, want 1")
                analyze_and_publish(td, telemetry=trunc_tele,
                                    expected_steps=2)
                if trunc_tele.counter_value(
                        "xprof.capture_truncated_total") != 1:
                    raise AssertionError(
                        "complete capture tripped the truncation warning")
        finally:
            if collector is not None:
                collector.stop()
            for exp in exporters:
                exp.stop()

    return {
        "config": "gang_obs", "unit": "ranks merged",
        "value": n_ranks,
        "n_ranks": n_ranks,
        "run_id": run_id,
        "gang_step_skew_s": round(float(xp["step_skew_s"]), 6),
        "gang_comm_s": round(float(xp["comm_s"]), 6),
        "gang_comm_fraction": round(float(xp["comm_fraction"]), 4),
        "gang_drift": _no_prior_drift(0.25, skew_tolerance=0.5),
        "merged_series": sum(len(merged_snap.get(s, {}))
                             for s in ("counters", "gauges", "histograms")),
        "truncation_trips": 1,
        "scrape_reconciled": True,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def _elastic_part_worker(ctx, parts, rank, generation, out, sleep_s):
    """One elastic rank's work (a ``ctl.worker`` child): rank 1 fails on
    every attempt; the others complete their partitions, each once
    (skip if done, atomic rename)."""
    import os as _os
    import time as _t

    if rank == 1:
        raise RuntimeError("rank1 permanently broken")
    for i, p in enumerate(parts):
        if ctx.should_stop():
            return
        ctx.notify_step(i)
        path = _os.path.join(out, p + ".done")
        if _os.path.exists(path):
            continue
        tmp = path + f".tmp{_os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"{rank}:{generation}")
        _os.replace(tmp, path)
        _t.sleep(sleep_s)


def bench_elastic_ctl(n_parts: int = 36, part_sleep_s: float = 0.4,
                      recovery_bound_s: float = 30.0) -> dict:
    """The JAX bench's elastic control-plane gate: one supervised
    multi-process run (``python -m sparktorch_tpu_torch.ctl.worker``
    children) through a seeded SIGKILL (``kill_process_at``, restart,
    bounded recovery latency), a restart-budget exhaustion (rank 1 fails
    every attempt: the world shrinks through the coordinator, its
    partitions redistributed) and a rejoin (a new rank: the world
    grows). Raises unless every partition completes exactly once, the
    kill fired once, shrink and grow each happened once with the
    coordinator's generation following, and every transition is a
    generation-tagged event in the fleet collector's ``/gang`` view
    scraped over HTTP. No device work."""
    import functools
    import os
    import tempfile
    import threading

    from sparktorch_tpu_torch.ctl import ElasticController, spawn_worker
    from sparktorch_tpu_torch.ft import (
        ChaosConfig,
        FtPolicy,
        RestartPolicy,
        inject,
    )
    from sparktorch_tpu_torch.native.gang import (
        GangCoordinator,
        GangMetricsExporter,
    )
    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.obs.collector import FleetCollector, scrape_json

    t_start = time.perf_counter()
    tele = Telemetry(run_id="bench_elastic")
    workdir = tempfile.mkdtemp(prefix="bench_elastic_")
    out = os.path.join(workdir, "parts")
    hb_dir = os.path.join(workdir, "hb")
    os.makedirs(out)
    work = [f"part{i:03d}" for i in range(n_parts)]

    def completed(p):
        return os.path.exists(os.path.join(out, p + ".done"))

    def start_fn(rank, attempt, generation, assignment):
        fn = functools.partial(_elastic_part_worker, parts=tuple(assignment),
                               rank=rank, generation=generation, out=out,
                               sleep_s=part_sleep_s)
        return spawn_worker(fn, rank=rank, heartbeat_dir=hb_dir,
                            name=f"rank{rank}", telemetry=tele)

    coord = GangCoordinator(world_size=3, port=0,
                            heartbeat_timeout_ms=30_000)
    exporter = GangMetricsExporter(heartbeat_dir=hb_dir, coordinator=coord,
                                   telemetry=tele, port=0).start()
    collector = FleetCollector({0: exporter.url}, telemetry=tele,
                               poll_interval_s=0.25)
    collector.start(poll_loop=True)
    policy = FtPolicy(restart=RestartPolicy(max_restarts=2,
                                            backoff_base_s=0.05,
                                            backoff_max_s=0.2), seed=0)
    ctl = ElasticController(work, completed, policy=policy, telemetry=tele,
                            coordinator=coord, collector=collector,
                            min_world=1, name="bench_elastic")
    for r in range(3):
        ctl.add_rank(r, start_fn)

    def grower():
        # The rejoin: a new rank joins right after the shrink lands.
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline and not ctl._stop.is_set():
            if ctl._resizes["shrink"] >= 1:
                ctl.grow(3, start_fn)
                return
            time.sleep(0.05)

    threading.Thread(target=grower, name="bench-elastic-grower",
                     daemon=True).start()
    try:
        with inject(ChaosConfig(seed=11, kill_process_at={0: 2}),
                    telemetry=tele) as inj:
            summary = ctl.run(poll_interval_s=0.05, deadline_s=240.0)
        gang_doc = scrape_json(f"http://127.0.0.1:{collector.port}/gang")
    finally:
        collector.stop()
        exporter.stop()
        coord.stop()
    coord_generation = coord.generation  # lint-obs: ok (snapshot property, frozen by stop())
    coord_world_size = coord.world_size  # lint-obs: ok (snapshot property, frozen by stop())

    missing = [p for p in work if not completed(p)]
    if missing or summary["work_pending"]:
        raise AssertionError(f"partitions incomplete: {missing}")
    torn = [f for f in os.listdir(out) if ".tmp" in f]
    if torn:
        raise AssertionError(f"torn partition outputs left behind: {torn}")
    if len(os.listdir(out)) != n_parts:
        raise AssertionError(
            f"{len(os.listdir(out))} outputs != {n_parts} partitions")
    kills_fired = [e for e in inj.events if e["site"] == "ctl.process"]
    if len(kills_fired) != 1 or kills_fired[0]["rank"] != 0:
        raise AssertionError(
            f"chaos kill_process_at fired {kills_fired} (want exactly one "
            "SIGKILL on rank 0)")
    if summary["resizes"] != {"shrink": 1, "grow": 1}:
        raise AssertionError(f"resizes {summary['resizes']} != "
                             "{'shrink': 1, 'grow': 1}")
    if summary["removed"] != [1]:
        raise AssertionError(f"removed {summary['removed']} != [1]")
    kinds = [h["kind"] for h in ctl.history]
    for needed in ("restart", "shrink", "grow"):
        if needed not in kinds:
            raise AssertionError(
                f"no {needed!r} event in the controller history {kinds}")
    untagged = [h for h in ctl.history if "generation" not in h]
    if untagged:
        raise AssertionError(f"events missing generation tags: {untagged}")
    if not (coord_generation == ctl.generation == summary["generation"]
            >= 2):
        raise AssertionError(
            f"generation disagreement: coordinator {coord_generation}, "
            f"controller {ctl.generation}, summary {summary['generation']}"
            " (want agreement, >= 2)")
    if coord_world_size != 3:  # ranks 0, 2 and the joined 3
        raise AssertionError(
            f"coordinator world_size {coord_world_size} != 3 after "
            "shrink+grow")
    elastic_doc = gang_doc.get("elastic") or {}
    doc_kinds = [h.get("kind") for h in elastic_doc.get("history", [])]
    for needed in ("restart", "shrink", "grow"):
        if needed not in doc_kinds:
            raise AssertionError(
                f"/gang elastic history lacks {needed!r}: {doc_kinds}")
    if elastic_doc.get("generation") != summary["generation"] or \
            elastic_doc.get("resizes") != summary["resizes"]:
        raise AssertionError(
            f"/gang elastic doc {elastic_doc.get('generation')}/"
            f"{elastic_doc.get('resizes')} disagrees with the run summary "
            f"{summary['generation']}/{summary['resizes']}")
    recovery = [v["max"] for k, v in tele.snapshot()["histograms"].items()
                if k.startswith("ft_recovery_latency_s") and v["count"]]
    if not recovery or max(recovery) > recovery_bound_s:
        raise AssertionError(
            f"recovery latency {recovery} empty or past the "
            f"{recovery_bound_s}s bound")
    by_gen: Dict[str, int] = {}
    for p in work:
        with open(os.path.join(out, p + ".done")) as f:
            _, gen = f.read().split(":")
        by_gen[gen] = by_gen.get(gen, 0) + 1
    if len(by_gen) < 2:
        raise AssertionError(
            f"all partitions completed in one generation ({by_gen}) — the "
            "resizes never redistributed work")
    recovery_max = max(recovery)
    return {
        "config": "elastic_ctl", "unit": "s (recovery latency)",
        "value": round(recovery_max, 3),
        "recovery_latency_s": round(recovery_max, 3),
        "n_parts": n_parts,
        "restarts": summary["restarts"],
        "resizes": summary["resizes"],
        "removed": summary["removed"],
        "generation": summary["generation"],
        "world_size": summary["world_size"],
        "parts_by_generation": dict(sorted(by_gen.items())),
        "chaos_kills": len(kills_fired),
        "records_exact": True,
        "elastic_drift": _no_prior_drift(2.0),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


def _per_iter_us(fn, iters: int, batches: int = 7) -> float:
    """The best of ``batches`` timed loops of ``iters`` calls, in
    microseconds a call."""
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e6


def _zeros_of(tree) -> dict:
    """Host zeros shaped like a flat tree of tensors."""
    return {k: np.zeros(tuple(v.shape), np.float32) for k, v in tree.items()}


def bench_rpc_trace(device=None) -> dict:
    """The JAX bench's request-tracing gate: the tracer must be cheap,
    honest and diagnostic; raises otherwise.

    - **overhead**: the per-op tracing cost at the default head sampling
      (the unsampled fast path plus 1% of a 7-commit sampled chain
      against a full ring, each timed by a tight microbenchmark, two
      roots an op) over the wall of a binary-wire push and fresh pull
      against a live server with the tracer off: < 2%;
    - **reconcile**: with every request sampled, each fresh pull of a
      4-shard fleet stitches to exactly one tree, each shard's ``serve``
      span p50 agrees with its ``param_server.wire_latency_s`` p50
      (the same handler window through two pipelines) within half of
      it or 2 ms, and every root's wall holds its slowest serve hop;
    - **critical path**: a seeded slow shard (``slow_shard_s``) is the
      critical path of every traced pull in the collector's stitched
      trees and in ``timeline --rpc`` rendered from its JSONL sink.

    MnistMLP under SGD at 1e-2, as in the JAX config; the shards' leaves
    live on ``device``."""
    import contextlib
    import io
    import os

    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.net.transport import BinaryTransport
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry, rpctrace
    from sparktorch_tpu_torch.obs import timeline as _timeline
    from sparktorch_tpu_torch.obs.telemetry import wall_ts
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.serve.param_server import (
        ParameterServer,
        ParamServerHttp,
    )

    dev = _resolve_device(device)
    n_shards, n_pulls, slow_pulls, op_iters = 4, 10, 3, 48
    with _Phase(dev, "init") as p_init:
        torch.manual_seed(0)
        spec = _spec(MnistMLP(), optimizer="sgd",
                     optimizer_params={"lr": 1e-2}, input_shape=(784,))

    # -- overhead at the default sampling --------------------------------
    # The mechanism timed directly and divided by the measured op wall:
    # the difference of two end-to-end timings does not converge on a
    # shared host (the JAX bench's finding), and this statistic charges
    # every op a whole root plus its share of a heavy sampled chain.
    with _Phase(dev, "measure_overhead") as p_overhead:
        mtr = rpctrace.tracer_for(Telemetry(run_id="rpc_overhead_micro"))
        mtr.sample_rate = 0.0

        def fast():
            with mtr.root_span("pull", kind="client", host="h", port=1):
                pass

        fast_us = _per_iter_us(fast, 2000)
        mtr.sample_rate = 1.0
        for _ in range(mtr._ring.maxlen + 8):
            with mtr.root_span("fill"):
                pass

        def sampled():
            with mtr.root_span("push", kind="client", host="h",
                               port=1) as sp:
                with mtr.child_span("encode", sp.ctx):
                    pass
                with mtr.child_span("socket", sp.ctx):
                    pass
                with mtr.child_span("serve", sp.ctx, kind="server",
                                    route="/update.bin"):
                    pass
                with mtr.child_span("decode", sp.ctx, kind="server"):
                    pass
                mtr.record("queue_wait", sp.ctx, wall_ts(), 0.001,
                           kind="server")
                with mtr.child_span("apply", sp.ctx, kind="server"):
                    pass

        sampled_us = _per_iter_us(sampled, 300)
        roots_per_op = 2  # the timed op is a push and a pull
        traced_cost_us = roots_per_op * (
            fast_us + rpctrace.DEFAULT_SAMPLE_RATE
            * max(sampled_us - fast_us, 0.0))

        op_tele = Telemetry(run_id="rpc_overhead_op")
        rpctrace.tracer_for(op_tele).sample_rate = -1.0
        server = ParameterServer(spec, telemetry=op_tele, device=dev)
        http = ParamServerHttp(server, port=0).start()
        try:
            transport = BinaryTransport(http.url, telemetry=op_tele)
            zeros = _zeros_of(server.slot.read()[1])
            transport.push(zeros)
            server.drain()
            transport.pull(-1)
            walls = []
            for _ in range(op_iters):
                t0 = time.perf_counter()
                transport.push(zeros)
                transport.pull(-1)
                walls.append(time.perf_counter() - t0)
            transport.close()
        finally:
            http.stop()
            server.stop()
        op_us = float(np.median(walls)) * 1e6
        overhead_pct = 100.0 * traced_cost_us / op_us

    # -- traced sharded pulls reconcile with wire_latency_s --------------
    with _Phase(dev, "measure_reconcile") as p_reconcile:
        rec_tele = Telemetry(run_id="rpc_reconcile")
        tracer = rpctrace.tracer_for(rec_tele)
        tracer.sample_rate = 1.0
        tracer.resize(8192)  # every span of the bounded run
        fleet = ParamServerFleet(spec, n_shards=n_shards, telemetry=rec_tele,
                                 device=dev).start()
        sink = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"rpc_trace_sink_{os.getpid()}.jsonl")
        collector = None
        try:
            transport = ShardedTransport(fleet, telemetry=rec_tele,
                                         run_id=rec_tele.run_id)
            zeros = _zeros_of(fleet.assemble())
            have, pulled = -1, 0
            for _ in range(n_pulls):
                transport.push(zeros)  # advances every leaf's version
                fleet.drain()
                snap = transport.pull(have)
                if snap is not None:
                    have = snap[0]
                    pulled += 1
            # A handler closes its serve span just after its reply.
            time.sleep(0.1)
            spans = tracer.spans
            pull_trees = [t for t in rpctrace.stitch_spans(spans)
                          if t["root"]["name"] == "pull"
                          and t["root"]["status"] == "ok"]
            if pulled != n_pulls:
                raise AssertionError(
                    f"only {pulled}/{n_pulls} pulls were fresh: the push "
                    "cadence failed to mint versions")
            if len(pull_trees) != n_pulls:
                raise AssertionError(
                    f"stitched pull trees != sampled pulls: "
                    f"{len(pull_trees)} vs {n_pulls}")
            serve_by_shard: Dict[str, List[float]] = {}
            for s in spans:
                if s["name"] == "serve" \
                        and s["ann"].get("route") == "/delta.bin":
                    serve_by_shard.setdefault(
                        str(s["ann"].get("shard")), []).append(s["dur_s"])
            if len(serve_by_shard) != n_shards:
                raise AssertionError(
                    f"serve spans seen for shards {sorted(serve_by_shard)} "
                    f"!= {n_shards} shards")
            recon = {}
            for sid, durs in serve_by_shard.items():
                span_p50 = float(np.percentile(durs, 50))
                hist = rec_tele.histogram(
                    "param_server.wire_latency_s",
                    labels={"route": "/delta.bin", "shard": sid})
                hist_p50 = hist["p50"]
                if hist_p50 is None:
                    raise AssertionError(
                        f"no wire_latency_s series for shard {sid}")
                tol = max(0.5 * hist_p50, 0.002)
                recon[sid] = {"span_p50_ms": round(span_p50 * 1e3, 3),
                              "hist_p50_ms": round(hist_p50 * 1e3, 3),
                              "spans": len(durs),
                              "hist_count": hist["count"]}
                if abs(span_p50 - hist_p50) > tol:
                    raise AssertionError(
                        f"shard {sid} serve-span p50 {span_p50 * 1e3:.2f}ms "
                        f"does not reconcile with wire_latency_s p50 "
                        f"{hist_p50 * 1e3:.2f}ms (tol {tol * 1e3:.2f}ms)")

            def serves(node, acc):
                if node["name"] == "serve":
                    acc.append(float(node["dur_s"] or 0.0))
                for c in node.get("children") or []:
                    serves(c, acc)
                return acc

            for t in pull_trees:
                hops = serves(t["root"], [])
                if hops and t["wall_s"] < max(hops) - 1e-4:
                    raise AssertionError(
                        f"trace {t['trace_id'][:8]}: root wall "
                        f"{t['wall_s'] * 1e3:.2f}ms < slowest serve hop "
                        f"{max(hops) * 1e3:.2f}ms")

            # -- a seeded slow shard is the critical path ----------------
            slow_shard, delay_s = "2", 0.12
            with inject(ChaosConfig(slow_shard_s={slow_shard: delay_s},
                                    seed=0)):
                for _ in range(slow_pulls):
                    transport.push(zeros)
                    fleet.drain()
                    snap = transport.pull(have)
                    if snap is not None:
                        have = snap[0]
            time.sleep(0.1)
            collector = FleetCollector.for_fleet(
                fleet, poll_interval_s=0, jsonl_path=sink)
            collector.poll()
            slow_trees = [t for t in collector.rpc_traces()
                          if t["root"]["name"] == "pull"
                          and t["wall_s"] >= delay_s * 0.8][:slow_pulls]
            if len(slow_trees) < slow_pulls:
                raise AssertionError(
                    f"collector stitched only {len(slow_trees)} slow-pull "
                    f"trees of {slow_pulls}")
            named = sum(1 for t in slow_trees
                        if str((t.get("critical") or {}).get("shard"))
                        == slow_shard)
            if named < slow_pulls:
                raise AssertionError(
                    f"slow shard {slow_shard} named as critical path in "
                    f"only {named}/{slow_pulls} traced pulls: "
                    f"{[t.get('critical') for t in slow_trees]}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = _timeline.main(["--rpc", sink])
            rendered = buf.getvalue()
            if rc != 0 or f"shard {slow_shard}" not in rendered \
                    or "bound by" not in rendered:
                raise AssertionError(
                    f"timeline --rpc did not name shard {slow_shard} "
                    f"(rc={rc})")
            transport.close()
        finally:
            if collector is not None:
                collector.stop()
            fleet.stop()
            try:
                os.remove(sink)
            except OSError:
                pass

    if overhead_pct >= 2.0:
        raise AssertionError(
            f"tracing overhead {overhead_pct:.3f}% >= 2% at default "
            f"sampling (fast path {fast_us:.2f}us + amortized sampled "
            f"chain {sampled_us:.1f}us x {rpctrace.DEFAULT_SAMPLE_RATE} "
            f"vs wire op p50 {op_us / 1e3:.2f}ms)")

    return {
        "config": "rpc_trace", "unit": "% (tracing overhead)",
        "value": round(overhead_pct, 4),
        "overhead_pct": round(overhead_pct, 4),
        "fast_path_us": round(fast_us, 2),
        "sampled_chain_us": round(sampled_us, 1),
        "traced_cost_per_op_us": round(traced_cost_us, 2),
        "wire_op_p50_ms": round(op_us / 1e3, 3),
        "sample_rate_default": rpctrace.DEFAULT_SAMPLE_RATE,
        "pull_trees": len(pull_trees),
        "reconcile": recon,
        "slow_shard": {"shard": slow_shard, "delay_s": delay_s,
                       "named": named, "pulls": slow_pulls},
        "phase_s": _phase_s(init=p_init, measure_overhead=p_overhead,
                            measure_reconcile=p_reconcile),
    }


def _aa_matmul_step(m: int):
    """The A/A legs' step: four chained ``m x m`` matmuls and the mean
    of the result (the JAX bench's), on the operand's device."""
    def step(a):
        b = a
        for _ in range(4):
            b = (b @ a) * (1.0 / m)
        return b, (b.sum() / b.numel()).float()

    return step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def health_aa(device=None, steps: int = 3, reps: int = 24,
              block_s: float = 0.05) -> dict:
    """The health lane's A/A leg on a 768 x 768 matmul step, the step
    synchronised and then noted, as a trainer that reads its loss each
    step would: ``reps`` interleaved triples of blocks (off, on and a
    second off arm, in rotating order) of ``block_s`` seconds and at
    least ``steps`` steps each. The on arm's one ledger notes every step
    and is settled after each block (untimed), so no read of one block
    lands in the next; the steps alternate between two operands (ones,
    and ones x 1.001) of one shape, so its losses are not a plateau the
    way one constant would be (the JAX leg's 20-step ledgers never reach
    the 32-step plateau window). Raises unless the on arm's goodput ``data_wait``
    is > 0 and the off arms' exactly 0.0, the clean run raises no
    anomaly, and the **mean** host cost of a note (every ``note_step``
    timed, their sum over the on arm's steps) is < 1% of the off arm's
    mean step wall. Beside it: the notes' median and min, the A/A wall
    delta (the mean over triples of the on block's mean step minus the
    same triple's off block's, over the off arm's mean) and the off/off
    delta measured the same way, the measurement's own floor."""
    import statistics

    from sparktorch_tpu_torch.obs import Telemetry
    from sparktorch_tpu_torch.obs import goodput as _goodput
    from sparktorch_tpu_torch.obs import health as _health

    dev = _resolve_device(device)
    m = 768
    aa_step = _aa_matmul_step(m)
    xms = [torch.ones((m, m), dtype=torch.float32, device=dev) * scale
           for scale in (1.0, 1.001)]
    aa_step(xms[0])
    _sync(dev)
    arms = ("off", "on", "off2")
    teles = {a: Telemetry(run_id=f"bench_health_aa_{a}") for a in arms}
    goodputs = {a: _goodput.GoodputLedger(telemetry=teles[a], rank="aa")
                for a in arms}
    hl = _health.TrainHealthLedger(rank="aa", telemetry=teles["on"])
    means: Dict[str, List[float]] = {a: [] for a in arms}
    notes: List[float] = []

    def block(arm: str) -> None:
        walls = []
        with goodputs[arm].activate():
            t_end = time.perf_counter() + block_s
            while True:
                t0 = time.perf_counter()
                _o, mean = aa_step(xms[len(walls) % 2])
                _sync(dev)
                if arm == "on":
                    t1 = time.perf_counter()
                    hl.note_step(device={"loss": mean})
                    notes.append(time.perf_counter() - t1)
                t2 = time.perf_counter()
                walls.append(t2 - t0)
                if len(walls) >= steps and t2 >= t_end:
                    break
            if arm == "on":
                hl.snapshot()
        means[arm].append(sum(walls) / len(walls))

    gc.collect()
    for r in range(reps):
        for arm in arms[r % 3:] + arms[:r % 3]:
            block(arm)
    with goodputs["on"].activate():
        hl.flush()
    dw = {a: float(teles[a].get_section(_goodput.SECTION)["buckets"]
                   ["data_wait"]) for a in arms}
    if dw["off"] != 0.0 or dw["off2"] != 0.0:
        raise AssertionError(
            f"health-OFF arms show data_wait {dw}: the A/A delta is "
            "meaningless")
    if dw["on"] <= 0.0:
        raise AssertionError(
            f"health-ON arm left data_wait empty ({dw}): the delayed fetch "
            "is not attributed")
    n_anom = len(hl.snapshot()["anomalies"])
    if n_anom:
        raise AssertionError(
            f"clean health-ON arm raised {n_anom} anomalies: false positives")
    w_off = statistics.fmean(means["off"])

    def delta(arm: str) -> float:
        return statistics.fmean(
            b - a for a, b in zip(means["off"], means[arm])) / max(w_off, 1e-9)

    note_mean = sum(notes) / len(notes)
    note_frac = note_mean / max(w_off, 1e-9)
    if note_frac >= 0.01:
        raise AssertionError(
            f"health lane's host cost is {100 * note_frac:.2f}% of the "
            f"{w_off * 1e3:.3f}ms step wall (bound: 1%): note_step's mean "
            f"{note_mean * 1e6:.2f}us over {len(notes)} steps (median "
            f"{statistics.median(notes) * 1e6:.2f}us); A/A wall delta "
            f"{100 * delta('on'):.2f}%, off/off {100 * delta('off2'):.2f}%")
    return {
        "note_frac": note_frac, "aa_frac": delta("on"),
        "floor_frac": delta("off2"),
        "note_min_frac": min(notes) / max(w_off, 1e-9),
        "step_wall_off_s": w_off,
        "step_wall_on_s": statistics.fmean(means["on"]),
        "note_mean_us": note_mean * 1e6,
        "note_median_us": statistics.median(notes) * 1e6,
        "note_min_us": min(notes) * 1e6, "notes": len(notes),
        "blocks": reps, "block_s": block_s,
        "data_wait_on_s": dw["on"], "data_wait_off_s": dw["off"],
        "clean_anomalies": n_anom, "telemetry": teles["on"]}


def bench_health(device=None, poison_step: int = 6, iters: int = 12,
                 aa_steps: int = 3, aa_reps: int = 24,
                 aa_block_s: float = 0.05) -> dict:
    """The JAX bench's model-health gate; raises unless the health
    lane's four claims hold end to end:

    - **detection is real and bounded**: a batch poisoned at
      ``poison_step`` (``ChaosConfig.poison_batch_at``) on a real
      ``train_distributed`` run trips the NaN sentinel at that step,
      within 2 steps of the delayed fetch, with dotted parameter names
      in the per-leaf grad-norm table; the latched ``health_nonfinite``
      alert fires one episode over 3 sweeps;
    - **replay is bitwise**: the bundle the sentinel wrote reproduces
      the recorded numerics in a fresh process
      (``python -m sparktorch_tpu_torch.obs.replay`` exits 0);
    - **the lane is attributed and nearly free**: in interleaved A/A
      runs the health-on arm's goodput ``data_wait`` is > 0 (the delayed
      fetch) and the off arm's exactly 0.0; the lane's mean host cost a
      step (every ``note_step`` timed) is < 1% of the mean step wall,
      the A/A wall delta and its off/off floor recorded beside it
      (:func:`health_aa`); a clean run raises no anomaly and no alert;
    - **the fleet path works**: the rank's section merges into
      ``GET /health`` rank-tagged, renders through ``timeline --health``
      from the collector's sink and from the saved document, shows in
      ``--follow`` as a ``health.run`` line, and the postmortem shows
      the health at death.

    The headline is ``note_step``'s host cost (2,000 notes); its drift
    gate reads ``no_prior_record``."""
    import contextlib
    import io
    import os
    import shutil
    import subprocess
    import sys
    import tempfile
    import threading

    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.models import Net
    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry
    from sparktorch_tpu_torch.obs import goodput as _goodput
    from sparktorch_tpu_torch.obs import health as _health
    from sparktorch_tpu_torch.obs import timeline as _timeline
    from sparktorch_tpu_torch.obs.alerts import AlertManager
    from sparktorch_tpu_torch.obs.blackbox import collect_postmortem
    from sparktorch_tpu_torch.obs.collector import scrape_json
    from sparktorch_tpu_torch.obs.history import MetricsHistory
    from sparktorch_tpu_torch.obs.telemetry import wall_ts
    from sparktorch_tpu_torch.train.sync import train_distributed
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    dev = _resolve_device(device)
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="bench_health_")
    replay_dir = os.path.join(workdir, "replay")

    # -- A/A overhead and attribution, on a clean step ------------------
    # First, in a quiet process: the ledger's per-step cost, quoted
    # against a training-sized step.
    aa = health_aa(dev, steps=aa_steps, reps=aa_reps, block_s=aa_block_s)
    tele_clean = aa.pop("telemetry")
    clean_hist = MetricsHistory(retention=4)
    clean_mgr = AlertManager(clean_hist, rules=_health.health_alert_rules(),
                             telemetry=tele_clean)
    clean_fired = []
    base_aa = wall_ts()
    for k in range(2):
        clean_hist.append(tele_clean.snapshot(), ts=base_aa + k)
        clean_fired += [e for e in clean_mgr.evaluate(ts=base_aa + k)
                        if e["event"] == "fired"]
    if clean_fired:
        raise AssertionError(
            f"clean leg fired alerts: {[e['alert'] for e in clean_fired]}")

    # -- a seeded poison drill on a real trainer ------------------------
    rng = np.random.default_rng(0)
    n_features, rows = 10, 256
    x = rng.normal(size=(rows, n_features)).astype(np.float32)
    y = rng.normal(size=(rows,)).astype(np.float32)
    torch.manual_seed(0)
    spec = ModelSpec(module=Net(in_features=n_features), loss="mse",
                     optimizer="adam", optimizer_params={"lr": 1e-2},
                     input_shape=(n_features,))
    tele = Telemetry(run_id="bench_health_drill")
    cfg = _health.HealthConfig(
        warmup_steps=3, replay_dir=replay_dir,
        replay_builder="sparktorch_tpu_torch.obs.replay:net_builder",
        replay_builder_kwargs={"n_features": n_features, "rows": rows,
                               "device": dev.type})
    prev_hl = _health.install(None)
    try:
        hl = _health.ensure(tele, rank=0, config=cfg)
        if hl is None:
            raise AssertionError(
                "health lane disabled (SPARKTORCH_TPU_HEALTH=0): the gate "
                "cannot run")
        ledger = _goodput.GoodputLedger(telemetry=tele, rank=0)
        with ledger.activate(), \
                inject(ChaosConfig(poison_batch_at={0: poison_step}),
                       telemetry=tele):
            train_distributed(spec, x, labels=y, iters=iters, seed=0,
                              steps_per_call=1, telemetry=tele, device=dev)
        doc = hl.snapshot()
    finally:
        _health.install(prev_hl)

    anomalies = doc["anomalies"]
    if not anomalies:
        raise AssertionError(
            f"poisoned step {poison_step} raised no anomaly: {doc}")
    first = anomalies[0]
    if first["akind"] != "nonfinite" or first["step"] != poison_step:
        raise AssertionError(
            f"first anomaly is {first['akind']} @ step {first['step']}, "
            f"want nonfinite @ {poison_step}: {anomalies[:3]}")
    lag_past_fetch = first["detect_lag"] - cfg.fetch_lag
    if not 0 <= lag_past_fetch <= 2:
        raise AssertionError(
            f"detection lag {first['detect_lag']} steps vs fetch_lag "
            f"{cfg.fetch_lag}: the sentinel must trip within 2 steps of "
            "the delayed fetch")
    leaves = doc.get("top_grad_leaves") or []
    if not leaves or not any("." in str(k) for k, _ in leaves):
        raise AssertionError(
            f"top grad leaves lack dotted param names: {leaves}")
    gdoc = tele.get_section(_goodput.SECTION)
    if float(gdoc["buckets"]["data_wait"]) <= 0.0:
        raise AssertionError(
            f"health fetches left data_wait empty: {gdoc['buckets']}")
    g_wall = float(gdoc["wall_s"])
    g_total = sum(float(v) for v in gdoc["buckets"].values())
    if abs(g_total - g_wall) > 0.02 * g_wall or \
            float(gdoc["overattributed_s"]) > 0.02 * g_wall:
        raise AssertionError(
            f"drill ledger not MECE: buckets sum {g_total:.3f}s vs wall "
            f"{g_wall:.3f}s, overattributed {gdoc['overattributed_s']}s")

    # -- the bundle replays bitwise in a fresh process ------------------
    bundles = (doc.get("replay") or {}).get("bundles") or []
    target = f"replay_step{poison_step:06d}_r0.json"
    meta_path = next((b for b in bundles
                      if os.path.basename(b) == target), None)
    if meta_path is None:
        raise AssertionError(
            f"no bundle for the poisoned step {poison_step}: {bundles}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta["anchor_step"] != poison_step:
        raise AssertionError(
            f"anchor did not re-arm on the poisoned batch: anchor "
            f"{meta['anchor_step']} vs step {poison_step}")
    proc = subprocess.run(
        [sys.executable, "-m", "sparktorch_tpu_torch.obs.replay",
         meta_path], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "bitwise reproduction" not in proc.stdout:
        raise AssertionError(
            f"replay did not reproduce bitwise (rc={proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")

    # -- the latched alert: one episode ---------------------------------
    history = MetricsHistory(retention=8)
    mgr = AlertManager(history, rules=_health.health_alert_rules(),
                       telemetry=tele)
    base = wall_ts()
    fired = []
    for k in range(3):
        history.append(tele.snapshot(), ts=base + k)
        fired += [e for e in mgr.evaluate(ts=base + k)
                  if e["event"] == "fired"]
    if [e["alert"] for e in fired] != ["health_nonfinite"]:
        raise AssertionError(
            f"want exactly one latched health_nonfinite episode over 3 "
            f"sweeps, got {[(e['alert'], e['episode']) for e in fired]}")

    # -- collector merge, GET /health, timeline renders -----------------
    exp = GangMetricsExporter(telemetry=tele, port=0).start()
    sink = os.path.join(workdir, "collector_sink.jsonl")
    collector = FleetCollector({0: exp.url}, poll_interval_s=0,
                               jsonl_path=sink)
    collector.start(poll_loop=False)
    try:
        collector.poll()
        run_doc = scrape_json(f"{collector.url}/health")
        pm_path = collect_postmortem(workdir, "bench-health drill",
                                     telemetry=tele, collector=collector)
    finally:
        collector.stop()
        exp.stop()
    if run_doc.get("kind") != "health_run" or \
            "0" not in (run_doc.get("per_rank") or {}):
        raise AssertionError(
            f"/health missing the drill rank: "
            f"{sorted(run_doc.get('per_rank') or {})}")
    worst = run_doc.get("worst") or {}
    if worst.get("akind") != "nonfinite" or worst.get("rank") != "0":
        raise AssertionError(
            f"/health worst anomaly is not the rank-tagged NaN: {worst}")
    saved = os.path.join(workdir, "health.json")
    with open(saved, "w") as f:
        f.write(json.dumps(run_doc))
    for args_, what in ((["--health", sink], "collector sink"),
                        (["--health", saved], "saved /health doc")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _timeline.main(args_)
        out_txt = buf.getvalue()
        if rc != 0 or "model health" not in out_txt \
                or "nonfinite" not in out_txt:
            raise AssertionError(
                f"timeline --health ({what}) failed (rc={rc}) or lost the "
                f"anomaly:\n{out_txt[:800]}")
    stop_ev = threading.Event()
    stop_ev.set()
    follow_lines = list(_timeline.follow(sink, poll_s=0.0, stop=stop_ev))
    if not any("health.run" in ln and "worst=nonfinite" in ln
               for ln in follow_lines):
        raise AssertionError(
            "--follow tail lacks the health.run one-liner:\n"
            + "\n".join(follow_lines[:10]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _timeline.main(["--postmortem", pm_path])
    out_txt = buf.getvalue()
    if rc != 0 or "model health at death" not in out_txt \
            or "nonfinite" not in out_txt:
        raise AssertionError(
            f"postmortem lost the health-at-death view (rc={rc}):\n"
            f"{out_txt[:800]}")

    # -- note_step's host cost (the drift-gated value) ------------------
    hl_ub = _health.TrainHealthLedger(
        rank="ub", telemetry=Telemetry(run_id="bench_health_ub"))
    n_ub = 2000
    t0 = time.perf_counter()
    for i in range(n_ub):
        hl_ub.note_step(host={"loss": 1.0 + 1e-4 * i, "grad_norm": 0.5})
    note_step_us = (time.perf_counter() - t0) / n_ub * 1e6
    shutil.rmtree(workdir, ignore_errors=True)

    return {
        "config": "health", "unit": "us (note_step cost)",
        "value": round(note_step_us, 3),
        "note_step_us": round(note_step_us, 3),
        "overhead_pct_of_step": round(100 * aa["note_frac"], 4),
        "overhead_pct_aa_wall": round(100 * aa["aa_frac"], 4),
        "overhead_pct_note_floor": round(100 * aa["note_min_frac"], 4),
        "step_wall_off_ms": round(aa["step_wall_off_s"] * 1e3, 3),
        "step_wall_on_ms": round(aa["step_wall_on_s"] * 1e3, 3),
        "detect": {
            "step": poison_step, "akind": first["akind"],
            "detect_lag": first["detect_lag"],
            "ingest_lag": first["ingest_lag"],
            "fetch_lag": cfg.fetch_lag,
            "anomalies_total": sum(doc["counts"].values()),
        },
        "replay": {
            "bundle": os.path.basename(meta_path),
            "anchor_step": meta["anchor_step"],
            "bitwise": True,
        },
        "aa": {
            "data_wait_on_s": round(aa["data_wait_on_s"], 6),
            "data_wait_off_s": aa["data_wait_off_s"],
            "clean_anomalies": aa["clean_anomalies"],
            "note_mean_us": round(aa["note_mean_us"], 3),
            "note_median_us": round(aa["note_median_us"], 3),
            "note_min_us": round(aa["note_min_us"], 3),
            "off_off_pct": round(100 * aa["floor_frac"], 4),
            "notes": aa["notes"], "blocks": aa["blocks"],
        },
        "alerts": {"episodes": 1, "clean_episodes": 0},
        "health_drift": _no_prior_drift(0.5),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


# The skew fence's wire: seconds both ranks spend in each step's
# exposed_comm after they meet, as both spend a collective's transfer.
SKEW_WIRE_S = 0.02


def bench_skew(device=None, steps: int = 8, delay_s: float = 0.3,
               from_step: int = 2, stamp_batches: int = 64,
               stamp_per_batch: int = 8) -> dict:
    """The JAX bench's cross-rank step-skew gate; raises unless

    - **the decomposition lands on the right rank**: a seeded
      ``delay_s`` a step straggler on rank 1 (``slow_rank_s``, fired
      before the step span, so the rank is late into the fence) puts
      >= 80% of the injected seconds in the merged ``GET /skew``
      document's ``straggler_wait_s``, charged to rank 1, straggler wait
      over wire, and the persistent-laggard verdict names rank 1 with a
      cause hypothesis;
    - **the alert reaches the controller**: ``skew_straggler_sustained``
      latches one episode over 4 collector sweeps and arrives at an
      ``ElasticController`` as a scale signal;
    - **the A/A leg stays quiet**: the same fence with no chaos shows
      ~0 straggler wait and no alert. Each step's fence carries
      SKEW_WIRE_S of transfer after the ranks meet (both spend it, as
      both spend a collective's wire time), so the A/A straggler
      fraction is host jitter over a fence with a wire, not jitter over
      a bare barrier's microseconds (which any load pushed over the
      alert's 0.5);
    - **stamping is nearly free**: the per-step stamp costs < 1% of a
      training-sized step (two 768 x 768 matmul pairs on ``device``),
      the stamp timed as a trainer pays it: ``stamp_batches`` batches of
      ``stamp_per_batch`` stamps, each batch right after a synchronised
      step, judged by the mean of all of them (``stamp_spread_us``: the
      least and the most batch mean);
    - **the render path works**: ``timeline --skew`` from the sink and
      from the saved document, and ``--follow``'s ``skew.run`` line.

    The headline is the stamp's host cost; its drift gate reads
    ``no_prior_record``."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    import threading

    from sparktorch_tpu_torch.ctl.elastic import ElasticController
    from sparktorch_tpu_torch.ft import ChaosConfig, inject
    from sparktorch_tpu_torch.ft import chaos as _chaos
    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry
    from sparktorch_tpu_torch.obs import goodput as _goodput
    from sparktorch_tpu_torch.obs import skew as _skew
    from sparktorch_tpu_torch.obs import timeline as _timeline
    from sparktorch_tpu_torch.obs.collector import scrape_json

    dev = _resolve_device(device)
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="bench_skew_")
    injected_total = delay_s * (steps - from_step)

    def fleet_leg(tag: str, chaos_cfg):
        """One 2-rank fence workload through a collector with the skew
        rules armed and a controller subscribed: ``(run_doc, latched
        episodes, scale signals, sink)``. The ranks stamp as the
        trainers do: chaos before the step span, the fence wait a
        nested exposed_comm span."""
        teles = [Telemetry(run_id=f"bench_skew_{tag}") for _ in range(2)]
        leds = [_goodput.GoodputLedger(telemetry=teles[r], rank=r)
                for r in range(2)]
        barrier = threading.Barrier(2)
        errs: list = []

        def rank_fn(r):
            try:
                led = leds[r]
                for i in range(steps):
                    _chaos.straggle(r, i)
                    with led.step_span(step=i):
                        with led.span("exposed_comm"):
                            barrier.wait()
                            time.sleep(SKEW_WIRE_S)
                led.close()
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=rank_fn, args=(r,))
                   for r in range(2)]
        cm = (inject(chaos_cfg, telemetry=teles[0]) if chaos_cfg
              else contextlib.nullcontext())
        with cm:
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        if errs:
            raise AssertionError(f"{tag} rank thread died: {errs[0]!r}")
        exps = [GangMetricsExporter(telemetry=teles[r], port=0).start()
                for r in range(2)]
        sink = os.path.join(workdir, f"sink_{tag}.jsonl")
        collector = FleetCollector(
            {r: exps[r].url for r in range(2)}, poll_interval_s=0,
            jsonl_path=sink, alert_rules=_skew.skew_alert_rules())
        ctl = ElasticController([], lambda w: True,
                                telemetry=collector.telemetry,
                                alerts=collector.alerts)
        collector.start(poll_loop=False)
        try:
            # The sustained rule wants consecutive breaches; one more
            # sweep shows the latch holds at one episode.
            for _ in range(4):
                collector.poll()
            run_doc = scrape_json(f"{collector.url}/skew")
        finally:
            collector.stop()
            for e in exps:
                e.stop()
            ctl.detach_alerts()
        state = collector.alerts.doc()["rules"]["skew_straggler_sustained"]
        return run_doc, int(state["episodes"]), list(ctl.scale_signals), sink

    # -- A/A: the same fence, no chaos, quiet ----------------------------
    aa_run, aa_eps, aa_signals, _aa_sink = fleet_leg("aa", None)
    aa_wait = float(aa_run.get("straggler_wait_s") or 0.0)
    if aa_wait > 0.1 * injected_total:
        raise AssertionError(
            f"A/A leg shows {aa_wait:.3f}s straggler wait (injected "
            f"nothing; bound {0.1 * injected_total:.3f}s): the "
            "decomposition charges healthy fence jitter as straggling")
    if aa_eps or aa_signals:
        raise AssertionError(
            f"A/A leg paged: {aa_eps} alert episode(s), "
            f"{len(aa_signals)} scale signal(s): false positives")

    # -- a seeded straggler on rank 1 ------------------------------------
    chaos_run, chaos_eps, chaos_signals, chaos_sink = fleet_leg(
        "chaos", ChaosConfig(slow_rank_s={1: (from_step, delay_s)}))
    wait = float(chaos_run.get("straggler_wait_s") or 0.0)
    if wait < 0.8 * injected_total:
        raise AssertionError(
            f"injected {injected_total:.2f}s of straggling but only "
            f"{wait:.3f}s landed in straggler_wait_s (<80%)")
    wire = chaos_run.get("wire_s")
    if wire is None or wait <= float(wire):
        raise AssertionError(
            f"straggler wait {wait:.3f}s does not dominate wire {wire}: "
            "exposed_comm was not split")
    to_r1 = float((chaos_run.get("wait_by_laggard") or {}).get("1") or 0.0)
    if to_r1 < 0.8 * injected_total:
        raise AssertionError(
            f"only {to_r1:.3f}s of the {injected_total:.2f}s injected wait "
            f"is charged to rank 1: {chaos_run.get('wait_by_laggard')}")
    lag = chaos_run.get("laggard") or {}
    if lag.get("rank") != "1" or not lag.get("persistent") \
            or not lag.get("cause"):
        raise AssertionError(
            "verdict did not name rank 1 as a persistent straggler with a "
            f"cause hypothesis: {lag}")
    if chaos_eps != 1:
        raise AssertionError(
            "want exactly one latched skew_straggler_sustained episode "
            f"over 4 sweeps, got {chaos_eps}")
    if not any(s.get("rule") == "skew_straggler_sustained"
               for s in chaos_signals):
        raise AssertionError(
            "the latched firing never reached the ElasticController as a "
            f"scale signal: {chaos_signals}")

    # -- the renders: sink, saved document, follow ------------------------
    saved = os.path.join(workdir, "skew.json")
    with open(saved, "w") as f:
        f.write(json.dumps(chaos_run))
    for args_, what in ((["--skew", chaos_sink], "collector sink"),
                        (["--skew", saved], "saved /skew doc")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _timeline.main(args_)
        out_txt = buf.getvalue()
        if rc != 0 or "step skew" not in out_txt \
                or "persistent straggler" not in out_txt:
            raise AssertionError(
                f"timeline --skew ({what}) failed (rc={rc}) or lost the "
                f"verdict:\n{out_txt[:800]}")
    stop_ev = threading.Event()
    stop_ev.set()
    follow_lines = list(_timeline.follow(chaos_sink, poll_s=0.0,
                                         stop=stop_ev))
    if not any("skew.run" in ln and "laggard=rank 1" in ln
               for ln in follow_lines):
        raise AssertionError(
            "--follow tail lacks the skew.run one-liner:\n"
            + "\n".join(follow_lines[:10]))
    shutil.rmtree(workdir, ignore_errors=True)

    # -- the stamp's cost against a training-sized step ------------------
    led_ub = _goodput.GoodputLedger(
        telemetry=Telemetry(run_id="bench_skew_ub"), rank="ub")
    m = 768
    xm = torch.ones((m, m), dtype=torch.float32, device=dev)

    def rep(a):
        return (a @ a) @ (a @ a) * (1.0 / m)

    rep(xm)
    _sync(dev)
    rep_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        rep(xm)
        _sync(dev)
        rep_walls.append(time.perf_counter() - t0)
    step_wall = min(rep_walls)
    batch_us = []
    for b in range(stamp_batches):
        rep(xm)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(stamp_per_batch):
            led_ub.skew.record(b * stamp_per_batch + i, 1, 0.0, 1.0)
        batch_us.append((time.perf_counter() - t0) / stamp_per_batch * 1e6)
    stamp_us = sum(batch_us) / len(batch_us)
    stamp_frac = (stamp_us * 1e-6) / max(step_wall, 1e-9)
    if stamp_frac >= 0.01:
        raise AssertionError(
            f"step stamp costs {stamp_us:.2f}us: {100 * stamp_frac:.3f}% of "
            f"the {step_wall * 1e3:.3f}ms representative step wall (>=1%)")

    return {
        "config": "skew", "unit": "us (step stamp cost)",
        "value": round(stamp_us, 3),
        "stamp_us": round(stamp_us, 3),
        "stamp_pct_of_step": round(100 * stamp_frac, 4),
        "stamp_spread_us": [round(min(batch_us), 3), round(max(batch_us), 3)],
        "step_wall_ms": round(step_wall * 1e3, 3),
        "decomposition": {
            "injected_s": round(injected_total, 3),
            "straggler_wait_s": round(wait, 3),
            "wire_s": round(float(wire), 3),
            "straggler_fraction": chaos_run.get("straggler_fraction"),
            "attributed_to_rank1_s": round(to_r1, 3),
            "laggard": {"rank": lag.get("rank"),
                        "persistent": bool(lag.get("persistent")),
                        "cause": lag.get("cause")},
        },
        "aa": {"straggler_wait_s": round(aa_wait, 6), "episodes": 0,
               "scale_signals": 0,
               "straggler_fraction": aa_run.get("straggler_fraction"),
               "wire_s": SKEW_WIRE_S},
        "alerts": {"episodes": 1, "scale_signals": len(chaos_signals)},
        "skew_drift": _no_prior_drift(0.5),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


def _profile_hot_planted(stop_t: float) -> float:
    """The hot function ``bench_profile`` plants inside a compute span:
    plain Python arithmetic with no callees, so every sample of it is
    self time of this frame."""
    acc = 0.0
    while time.perf_counter() < stop_t:
        for i in range(2000):
            acc += i * i
    return acc


def bench_profile(device=None, block_s: float = 0.01, reps: int = 96,
                  hot_s: float = 1.2) -> dict:
    """The JAX bench's stack-profiler gate; raises unless

    - **it is nearly free**: with the sampler at its default rate, a
      768 x 768 matmul step on ``device`` grows by < 1% against an A/A
      profiler-off arm. The arms run as ``reps`` interleaved triples of
      blocks of ``block_s`` seconds (at least 3 steps) — off, on, and a
      second off arm, in rotating order; the sampler starts and stops
      around each on block. A block's floor is its fastest step, and an
      arm's cost is the median over the triples of its floor minus the
      same triple's off floor, over the off arm's median floor. The
      off/off cost, measured the same way, is the measurement's own
      floor and is recorded beside the result;
    - **attribution is real**: a busy loop planted inside a ``compute``
      span is the compute bucket's top self-time frame with >= 80% of
      its samples;
    - **the fleet path works**: two ranks' sections merge into
      ``GET /profile`` over HTTP, and ``timeline --profile`` names the
      planted frame from the saved document and from the collector's
      sink.

    The headline is the sampler's cost a tick; its drift gate reads
    ``no_prior_record``."""
    import contextlib
    import io
    import os
    import shutil
    import statistics
    import tempfile
    import threading

    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry
    from sparktorch_tpu_torch.obs import goodput as _goodput
    from sparktorch_tpu_torch.obs import timeline as _timeline
    from sparktorch_tpu_torch.obs.collector import scrape_json
    from sparktorch_tpu_torch.obs.profile import StackProfiler, top_frames

    dev = _resolve_device(device)
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="bench_profile_")

    # -- A/A overhead: off, on and off again, interleaved ----------------
    m = 768
    xm = torch.ones((m, m), dtype=torch.float32, device=dev)
    xm @ xm
    _sync(dev)
    aa_prof = StackProfiler()

    def block(profiler_on: bool) -> float:
        if profiler_on:
            aa_prof.start()
        walls: List[float] = []
        try:
            t_end = time.perf_counter() + block_s
            while True:
                t0 = time.perf_counter()
                xm @ xm
                _sync(dev)
                t1 = time.perf_counter()
                walls.append(t1 - t0)
                if len(walls) >= 3 and t1 >= t_end:
                    break
        finally:
            if profiler_on:
                aa_prof.stop()
        return min(walls)

    arms = ("off", "on", "off2")
    floors: Dict[str, List[float]] = {a: [] for a in arms}
    for r in range(reps):
        for a in arms[r % 3:] + arms[:r % 3]:
            floors[a].append(block(a == "on"))
    aa_doc = aa_prof.stop()
    if aa_doc["ticks"] <= 0:
        raise AssertionError("profiler-on arm took no sample ticks")
    sample_tick_us = float(aa_doc["sample_tick_us"])
    w_off = statistics.median(floors["off"])
    w_on = statistics.median(floors["on"])

    def cost(arm_name: str) -> float:
        return statistics.median(
            b - a for a, b in zip(floors["off"], floors[arm_name])
        ) / max(w_off, 1e-9)

    overhead_frac = max(cost("on"), 0.0)
    aa_floor_frac = cost("off2")
    if overhead_frac >= 0.01:
        raise AssertionError(
            f"sampler overhead is {100 * overhead_frac:.2f}% of the "
            f"{w_off * 1e3:.3f}ms step wall (bound: 1%; on "
            f"{w_on * 1e3:.3f}ms vs off {w_off * 1e3:.3f}ms, median of "
            f"{reps} interleaved {1e3 * block_s:g}ms block floors; the "
            f"off/off floor read {100 * aa_floor_frac:.2f}%)")

    # -- a planted hot function owns its bucket --------------------------
    tele0 = Telemetry(run_id="bench_profile_r0")
    prof0 = StackProfiler(telemetry=tele0, rank=0, hz=250.0,
                          publish_interval_s=0.2)
    prof0.start()
    try:
        with _goodput.span("compute"):
            _profile_hot_planted(time.perf_counter() + hot_s)
    finally:
        doc0 = prof0.stop()
    buckets0 = doc0.get("buckets") or {}
    if "compute" not in buckets0:
        raise AssertionError(f"no compute bucket sampled: {sorted(buckets0)}")
    frames = top_frames(doc0, "compute", n=3)
    if not frames or not frames[0][0].startswith("_profile_hot_planted"):
        raise AssertionError(
            "planted hot function is not the compute bucket's top "
            f"self-time frame: {frames}")
    bucket_samples = int(buckets0["compute"].get("samples") or 0)
    hot_share = frames[0][1] / max(bucket_samples, 1)
    if hot_share < 0.8:
        raise AssertionError(
            f"planted function holds only {100 * hot_share:.1f}% of the "
            f"compute bucket's {bucket_samples} samples (want >= 80%)")

    # -- a 2-rank merge over HTTP and the renders ------------------------
    tele1 = Telemetry(run_id="bench_profile_r1")
    prof1 = StackProfiler(telemetry=tele1, rank=1, hz=250.0,
                          publish_interval_s=0.2)
    release = threading.Event()

    def rank1_waits():
        with _goodput.span("data_wait", {"site": "bench"}):
            release.wait(timeout=10.0)

    waiter = threading.Thread(target=rank1_waits, daemon=True)
    waiter.start()
    prof1.start()
    time.sleep(0.3)
    release.set()
    waiter.join(timeout=5.0)
    prof1.stop()

    exp0 = GangMetricsExporter(telemetry=tele0, port=0).start()
    exp1 = GangMetricsExporter(telemetry=tele1, port=0).start()
    sink = os.path.join(workdir, "collector_sink.jsonl")
    collector = FleetCollector({0: exp0.url, 1: exp1.url},
                               poll_interval_s=0, jsonl_path=sink)
    collector.start(poll_loop=False)
    try:
        collector.poll()
        run_doc = scrape_json(f"{collector.url}/profile")
    finally:
        collector.stop()
        exp0.stop()
        exp1.stop()
    ranks_seen = set(run_doc.get("per_rank") or {})
    if not {"0", "1"} <= ranks_seen:
        raise AssertionError(
            f"/profile per_rank missing ranks: {sorted(ranks_seen)}")
    if "data_wait" not in (run_doc.get("buckets") or {}):
        raise AssertionError(
            "rank1's data_wait bucket lost in the merge: "
            f"{sorted(run_doc.get('buckets') or {})}")
    merged_top = top_frames(run_doc, "compute", n=1)
    if not merged_top or \
            not merged_top[0][0].startswith("_profile_hot_planted"):
        raise AssertionError(
            f"merged /profile lost the planted frame: {merged_top}")
    saved = os.path.join(workdir, "profile.json")
    with open(saved, "w") as f:
        f.write(json.dumps(run_doc))
    for path, what in ((sink, "collector sink"),
                       (saved, "saved /profile doc")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _timeline.main([path, "--profile"])
        out_txt = buf.getvalue()
        if rc != 0 or "_profile_hot_planted" not in out_txt:
            raise AssertionError(
                f"timeline --profile ({what}) failed (rc={rc}) or did not "
                f"name the planted frame:\n{out_txt[:800]}")
    shutil.rmtree(workdir, ignore_errors=True)

    return {
        "config": "profile", "unit": "us (sample tick cost)",
        "value": round(sample_tick_us, 3),
        "sample_tick_us": round(sample_tick_us, 3),
        "overhead_pct_of_step": round(100 * overhead_frac, 4),
        "aa_floor_pct": round(100 * aa_floor_frac, 4),
        "step_wall_off_ms": round(w_off * 1e3, 3),
        "step_wall_on_ms": round(w_on * 1e3, 3),
        "hz": float(doc0["hz"]),
        "hot": {
            "ticks": doc0["ticks"],
            "bucket_samples": bucket_samples,
            "hot_share": round(hot_share, 4),
            "top_frame": frames[0][0],
        },
        "run_report": {
            "n_ranks": run_doc["n_ranks"],
            "samples_total": run_doc["samples_total"],
            "buckets": sorted(run_doc["buckets"]),
            "truncated": run_doc["truncated"],
        },
        "profile_drift": _no_prior_drift(1.0),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


def _obs_pm_worker(ctx, parts, rank, out, gate):
    """One rank of ``bench_obs_history``'s postmortem leg (a
    ``ctl.worker`` child): a span a partition on the worker's own bus
    (its flight recorder's evidence), parked before partition 2 until
    ``gate`` exists, so the kill at step 2 cannot outrun the
    collector's first scrape of this rank's ring."""
    import os as _os
    import time as _t

    for i, p in enumerate(parts):
        if ctx.should_stop():
            return
        if i == 2 and not _os.path.exists(gate):
            hold = _t.perf_counter() + 30.0
            while (not _os.path.exists(gate) and _t.perf_counter() < hold
                   and not ctx.should_stop()):
                _t.sleep(0.05)
        ctx.notify_step(i)
        with ctx.telemetry.span("work/partition", labels={"part": p}):
            path = _os.path.join(out, p + ".done")
            if not _os.path.exists(path):
                tmp = path + f".tmp{_os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(f"{rank}")
                _os.replace(tmp, path)
            _t.sleep(0.25)


def bench_obs_history(device=None, n_pulls: int = 6,
                      slow_delay_s: float = 0.5, for_sweeps: int = 3) -> dict:
    """The JAX bench's metrics-history, alerting and flight-recorder
    gate; raises unless

    - **alerting is causal, not noisy**: against a live 2-shard fleet a
      seeded slow shard fires the sustained p99 rule on the client's
      ``sharded.shard_pull_latency_s`` hop (where the injected delay
      lands) within ``for_sweeps`` + 1 sweeps of the first breach, one
      episode, shown in the collector's ``/gang`` over HTTP, while an
      A/A control run fires nothing; ``/history`` answers a rate query;
    - **postmortems hold the causal window**: a seeded SIGKILL of a
      process worker (``kill_process_at``) writes a postmortem whose
      event window holds the kill's ``ctl.*`` transition and the
      victim's last spans (from the collector's last-good scrape of the
      dead process's ring), rendered by ``timeline --postmortem``;
    - **the memory tier is nearly free**: a collector sweep with
      history and alerts stays within 10% + 0.2 ms of a history-off
      sweep (min of 60 interleaved sweeps).

    The fleet's shards keep their leaves on ``device``. The headline is
    the history-on sweep's median; its drift gate reads
    ``no_prior_record``."""
    import contextlib
    import functools
    import io
    import os
    import shutil
    import tempfile
    import threading

    from sparktorch_tpu_torch.ctl import ElasticController, spawn_worker
    from sparktorch_tpu_torch.ft import (
        ChaosConfig,
        FtPolicy,
        RestartPolicy,
        inject,
    )
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.obs import AlertRule, FleetCollector, Telemetry
    from sparktorch_tpu_torch.obs import timeline as _timeline
    from sparktorch_tpu_torch.obs.blackbox import (
        events_from_snapshot,
        read_postmortem,
    )
    from sparktorch_tpu_torch.obs.collector import scrape_json
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet

    dev = _resolve_device(device)
    t_start = time.perf_counter()
    torch.manual_seed(0)
    spec = _spec(MnistMLP(), optimizer="sgd", optimizer_params={"lr": 1e-2},
                 input_shape=(784,))
    slow_shard = "1"
    threshold_s = slow_delay_s * 0.4  # far above a clean hop, far below

    def alert_leg(chaos_cfg) -> dict:
        leg_tele = Telemetry(run_id="bench_obs_alert")
        fleet = ParamServerFleet(spec, n_shards=2, telemetry=leg_tele,
                                 device=dev).start()
        # The client's hop latency, not the server's wire_latency_s:
        # the delay lands before the handler's clock.
        rules = [AlertRule(
            name="hot_shard_p99", metric="sharded.shard_pull_latency_s",
            labels={"shard": slow_shard}, kind="sustained", field="p99",
            op=">", threshold=threshold_s, for_sweeps=for_sweeps)]
        collector = FleetCollector.for_fleet(fleet, poll_interval_s=0,
                                             alert_rules=rules)
        collector.start(poll_loop=False)
        first_breach_sweep = fired_sweep = None
        try:
            transport = ShardedTransport(fleet, telemetry=leg_tele)
            zeros = _zeros_of(fleet.assemble())
            have = -1
            ctx = (inject(chaos_cfg, telemetry=leg_tele) if chaos_cfg
                   else contextlib.nullcontext())
            with ctx:
                for sweep in range(n_pulls):
                    transport.push(zeros)
                    fleet.drain()
                    snap = transport.pull(have)
                    if snap is not None:
                        have = snap[0]
                    collector.poll()
                    state = collector.alerts.doc()["rules"]["hot_shard_p99"]
                    if first_breach_sweep is None and state["streak"] > 0:
                        first_breach_sweep = sweep
                    if fired_sweep is None and state["state"] == "firing":
                        fired_sweep = sweep
            gang = scrape_json(f"{collector.url}/gang")
            hist_rate = scrape_json(
                f"{collector.url}/history?name=collector.scrapes_total"
                "&query=rate")
            transport.close()
            return {"doc": collector.alerts.doc(),
                    "gang_alerts": gang.get("alerts") or {},
                    "first_breach_sweep": first_breach_sweep,
                    "fired_sweep": fired_sweep,
                    "history_rate_ok": hist_rate.get("value") is not None}
        finally:
            collector.stop()
            fleet.stop()

    with _Phase(dev, "alert_legs") as p_alerts:
        control = alert_leg(None)
        chaotic = alert_leg(ChaosConfig(
            seed=7, slow_shard_s={slow_shard: slow_delay_s}))
    ctl_rule = control["doc"]["rules"]["hot_shard_p99"]
    if ctl_rule["episodes"] != 0 or control["gang_alerts"].get("active"):
        raise AssertionError(
            f"A/A control run fired alerts: {ctl_rule} (active "
            f"{control['gang_alerts'].get('active')})")
    hot_rule = chaotic["doc"]["rules"]["hot_shard_p99"]
    if hot_rule["episodes"] != 1 or hot_rule["state"] != "firing":
        raise AssertionError(
            f"seeded degradation did not fire exactly one episode: "
            f"{hot_rule}")
    if chaotic["first_breach_sweep"] is None \
            or chaotic["fired_sweep"] is None \
            or (chaotic["fired_sweep"] - chaotic["first_breach_sweep"]
                > for_sweeps + 1):
        raise AssertionError(
            f"alert missed its rule window: first breach sweep "
            f"{chaotic['first_breach_sweep']}, fired sweep "
            f"{chaotic['fired_sweep']} (for_sweeps={for_sweeps})")
    if "hot_shard_p99" not in (chaotic["gang_alerts"].get("active") or []):
        raise AssertionError(
            "/gang alerts section does not show the firing rule: "
            f"{chaotic['gang_alerts']}")
    if not (control["history_rate_ok"] and chaotic["history_rate_ok"]):
        raise AssertionError(
            "/history rate query answered null on a live collector")

    # -- a seeded worker kill writes a postmortem ------------------------
    with _Phase(dev, "postmortem_leg") as p_pm:
        tele = Telemetry(run_id="bench_obs_pm")
        workdir = tempfile.mkdtemp(prefix="bench_obs_pm_")
        out = os.path.join(workdir, "parts")
        hb_dir = os.path.join(workdir, "hb")
        pm_dir = os.path.join(workdir, "postmortems")
        os.makedirs(out)
        work = [f"part{i:02d}" for i in range(8)]
        scrape_gate = os.path.join(workdir, "scrape.gate")

        def completed(p):
            return os.path.exists(os.path.join(out, p + ".done"))

        workers = {}

        def start_fn(rank, attempt, generation, assignment):
            fn = functools.partial(_obs_pm_worker, parts=tuple(assignment),
                                   rank=rank, out=out, gate=scrape_gate)
            w = spawn_worker(fn, rank=rank, heartbeat_dir=hb_dir,
                             name=f"rank{rank}", telemetry=tele, ctl_port=0)
            workers[rank] = w
            return w

        policy = FtPolicy(restart=RestartPolicy(max_restarts=2,
                                                backoff_base_s=0.05,
                                                backoff_max_s=0.2), seed=0)
        ctl = ElasticController(work, completed, policy=policy,
                                telemetry=tele, min_world=1,
                                postmortem_dir=pm_dir, name="bench_obs_pm")
        ctl.add_rank(0, start_fn)
        ctl.add_rank(1, start_fn)
        collector = None
        try:
            with inject(ChaosConfig(seed=13, kill_process_at={0: 2}),
                        telemetry=tele) as inj:
                run_err = []

                def run():
                    try:
                        ctl.run(poll_interval_s=0.05, deadline_s=120.0)
                    except BaseException as e:  # noqa: BLE001 - surfaced
                        run_err.append(e)

                runner = threading.Thread(target=run, daemon=True)
                runner.start()
                # The collector needs the workers' exporter URLs, which
                # exist only once run() launched them.
                deadline = time.perf_counter() + 30.0
                urls = {}
                while time.perf_counter() < deadline and len(urls) < 2:
                    for rank, w in list(workers.items()):
                        if rank not in urls:
                            url = w.ctl_url(timeout_s=0.1)
                            if url:
                                urls[rank] = url
                    time.sleep(0.05)
                if len(urls) < 2:
                    raise AssertionError(
                        f"worker exporters never published URLs: {urls}")
                collector = FleetCollector(urls, telemetry=tele,
                                           poll_interval_s=0.1)
                collector.start(poll_loop=True)
                ctl.collector = collector
                # Open the kill's gate once the victim's ring is in the
                # collector's last-good scrape.
                scraped = time.perf_counter() + 30.0
                while time.perf_counter() < scraped:
                    with collector._lock:
                        st = collector._ranks.get("0")
                        snap = st.snapshot if st is not None else None
                    if snap and any(e.get("kind") == "span"
                                    for e in events_from_snapshot(snap)):
                        break
                    time.sleep(0.05)
                else:
                    raise AssertionError(
                        "collector never scraped rank 0's blackbox ring")
                with open(scrape_gate + ".tmp", "w") as f:
                    f.write("ok")
                os.replace(scrape_gate + ".tmp", scrape_gate)
                runner.join(timeout=120.0)
                if runner.is_alive():
                    raise AssertionError("postmortem leg run() hung")
                if run_err:
                    raise AssertionError(
                        f"postmortem leg failed: {run_err[0]}")
        finally:
            if collector is not None:
                collector.stop()
        missing = [p for p in work if not completed(p)]
        if missing:
            raise AssertionError(f"partitions incomplete: {missing}")
        kills = [e for e in inj.events if e["site"] == "ctl.process"]
        if len(kills) != 1 or kills[0]["rank"] != 0:
            raise AssertionError(
                f"chaos kill fired {kills} (want one SIGKILL on rank 0)")
        bundles = sorted(os.listdir(pm_dir)) if os.path.isdir(pm_dir) else []
        if not bundles:
            raise AssertionError("no postmortem bundle written")
        # The kill's bundle is the first (written in detection order).
        bundle = read_postmortem(os.path.join(pm_dir, bundles[0]))
        kinds = {str(e.get("kind")) for e in bundle["events"]}
        if not kinds & {"ctl.restart_scheduled", "restart_scheduled"}:
            raise AssertionError(
                f"bundle window lacks the kill's ctl.* transition: "
                f"{sorted(kinds)}")
        victim_spans = [e for e in bundle["events"]
                        if e.get("kind") == "span"
                        and str(e.get("rank")) == "0"]
        if not victim_spans:
            raise AssertionError(
                f"bundle window lacks the victim's last spans (kinds "
                f"{sorted(kinds)})")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _timeline.main(["--postmortem",
                                 os.path.join(pm_dir, bundles[0])])
        if rc != 0 or "postmortem:" not in buf.getvalue():
            raise AssertionError(f"timeline --postmortem failed (rc={rc})")
        shutil.rmtree(workdir, ignore_errors=True)

    # -- the sweep with history and alerts against one without -----------
    gc.collect()  # the legs above leave garbage a sweep would collect
    with _Phase(dev, "overhead_leg") as p_ovr:
        ovr_tele = Telemetry(run_id="bench_obs_ovr")
        ovr_tele.counter("reqs_total", 10)
        for _ in range(64):
            ovr_tele.observe("lat_s", 0.01)
        exporters = [GangMetricsExporter(telemetry=ovr_tele, port=0).start()
                     for _ in range(2)]
        targets = {i: e.url for i, e in enumerate(exporters)}
        rules = [AlertRule(name="ovr", metric="lat_s", labels={"rank": "0"},
                           kind="sustained", field="p99", threshold=1e9,
                           for_sweeps=2)]
        col_on = FleetCollector(targets, poll_interval_s=0,
                                alert_rules=rules)
        col_off = FleetCollector(targets, poll_interval_s=0, history=False)
        on_walls, off_walls = [], []
        try:
            for _ in range(4):  # both paths warm
                col_on.poll()
                col_off.poll()
            for i in range(60):
                ovr_tele.counter("reqs_total")
                ovr_tele.observe("lat_s", 0.01)
                # Interleaved, the order alternating.
                pair = ((col_on, on_walls), (col_off, off_walls))
                for col, walls in (pair if i % 2 == 0 else reversed(pair)):
                    t0 = time.perf_counter()
                    col.poll()
                    walls.append(time.perf_counter() - t0)
        finally:
            col_on.stop()
            col_off.stop()
            for e in exporters:
                e.stop()
        on_ms = float(np.median(on_walls)) * 1e3
        off_ms = float(np.median(off_walls)) * 1e3
        on_min_ms = float(np.min(on_walls)) * 1e3
        off_min_ms = float(np.min(off_walls)) * 1e3
        tol = 0.10
        # The min of a deterministic sweep isolates its cost; the median
        # breathes with the host's scheduler. 0.2 ms for timer jitter.
        if on_min_ms > off_min_ms * (1.0 + tol) + 0.2:
            raise AssertionError(
                f"history+alerts sweep overhead past bound: min "
                f"{on_min_ms:.3f}ms vs {off_min_ms:.3f}ms history-off "
                f"(medians {on_ms:.3f}/{off_ms:.3f}ms; tol {tol:.0%} "
                "+ 0.2ms)")

    return {
        "config": "obs_history", "unit": "ms (history-on sweep p50)",
        "value": round(on_ms, 3),
        "sweep_on_ms": round(on_ms, 3),
        "sweep_off_ms": round(off_ms, 3),
        "sweep_on_min_ms": round(on_min_ms, 3),
        "sweep_off_min_ms": round(off_min_ms, 3),
        "sweep_overhead_pct": round(100.0 * (on_min_ms - off_min_ms)
                                    / max(off_min_ms, 1e-9), 2),
        "alert": {
            "threshold_s": threshold_s,
            "for_sweeps": for_sweeps,
            "control_episodes": ctl_rule["episodes"],
            "chaos_episodes": hot_rule["episodes"],
            "first_breach_sweep": chaotic["first_breach_sweep"],
            "fired_sweep": chaotic["fired_sweep"],
        },
        "postmortem": {
            "bundles": len(bundles),
            "victim_spans": len(victim_spans),
            "event_kinds": sorted(kinds)[:12],
        },
        "obs_drift": _no_prior_drift(1.0),
        "phase_s": _phase_s(alert_legs=p_alerts, postmortem_leg=p_pm,
                            overhead_leg=p_ovr),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


def bench_goodput(device=None, n_parts: int = 10, part_sleep_s: float = 0.25,
                  n_pulls: int = 4, slow_delay_s: float = 0.5) -> dict:
    """The JAX bench's run-level goodput gate; raises unless

    - **attribution is real**: a streaming training run with checkpoints
      shows ``compile``, ``checkpoint``, ``data_wait`` and ``compute``
      seconds, the ledger MECE (buckets and idle sum to the wall within
      2%, no over-attribution), and the run report served per rank and
      run-wide over ``GET /goodput`` and rendered by
      ``timeline --goodput`` with the biggest thief named;
    - **chaos lands in the right bucket**: a seeded ``slow_shard_s``
      delay on the wire moves ``exposed_comm`` by >= 80% of the injected
      seconds and ``compute`` by <= 25% of them against an A/A leg,
      whose downtime buckets are exactly zero;
    - **downtime reconciles**: a SIGKILL on a real multi-process elastic
      run lands at least its measured recovery gap in
      ``restart_downtime``, which reconciles with the
      ``ft_recovery_latency_s`` sum; the shrink and the grow land in
      ``resize_downtime``; the driver's ledger stays MECE;
    - **the ledger is nearly free**: a ``LedgerSpan`` costs < 1% of the
      training run's step wall.

    The port has no compiler: its ``compile`` bucket is the trainer's
    set-up (``site=train_init``, one compile) and a hand kernel's first
    build inside a step (none on this MLP), so the training leg asks for
    at least one compile of > 0 s where the JAX leg asks for two (the
    set-up and the first chunk's jit) and 10 ms. The rank-1 ledger steps
    a 256 x 256 matmul on ``device``. The headline is the span's host
    cost; its drift gate reads ``no_prior_record``."""
    import contextlib
    import functools
    import io
    import os
    import shutil
    import tempfile
    import threading

    from sparktorch_tpu_torch.ctl import ElasticController, spawn_worker
    from sparktorch_tpu_torch.ft import (
        ChaosConfig,
        FtPolicy,
        RestartPolicy,
        inject,
    )
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.native.gang import (
        GangCoordinator,
        GangMetricsExporter,
    )
    from sparktorch_tpu_torch.net.sharded import ShardedTransport
    from sparktorch_tpu_torch.obs import FleetCollector, Telemetry
    from sparktorch_tpu_torch.obs import goodput as _goodput
    from sparktorch_tpu_torch.obs import timeline as _timeline
    from sparktorch_tpu_torch.obs.collector import scrape_json
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.train.sync import train_distributed_streaming

    dev = _resolve_device(device)
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="bench_goodput_")

    def mece(doc: dict, leg: str, over_tol_frac: float = 0.02) -> None:
        wall = float(doc["wall_s"])
        total = sum(float(v) for v in doc["buckets"].values())
        if abs(total - wall) > 0.02 * wall:
            raise AssertionError(
                f"{leg}: ledger not MECE: buckets sum {total:.3f}s vs wall "
                f"{wall:.3f}s (> 2%)")
        if float(doc["overattributed_s"]) > over_tol_frac * wall:
            raise AssertionError(
                f"{leg}: {doc['overattributed_s']}s over-attributed "
                f"(double-counted regions) against {wall:.3f}s wall")

    def zero_downtime(doc: dict, leg: str) -> None:
        for b in ("restart_downtime", "resize_downtime"):
            if float(doc["buckets"][b]) != 0.0:
                raise AssertionError(
                    f"{leg}: A/A run shows nonzero {b} "
                    f"({doc['buckets'][b]}s)")

    # -- training attribution: compile, checkpoint, data_wait ------------
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2048, 784)).astype(np.float32)
    y = rng.integers(0, 10, (2048,)).astype(np.int32)
    torch.manual_seed(0)
    spec = _spec(MnistMLP(), optimizer="sgd", optimizer_params={"lr": 1e-2},
                 input_shape=(784,))
    tele0 = Telemetry(run_id="bench_goodput_r0")
    ledger0 = _goodput.GoodputLedger(telemetry=tele0, rank=0)
    with ledger0.activate():
        train_distributed_streaming(
            spec, (x, y), chunk_rows=512, epochs=2, mini_batch=64,
            checkpoint_dir=os.path.join(workdir, "ckpt"),
            checkpoint_every=8, telemetry=tele0, device=dev)
    doc0 = tele0.get_section(_goodput.SECTION)
    mece(doc0, "training leg")
    zero_downtime(doc0, "training leg")
    for bucket, floor in (("compile", 0.0), ("checkpoint", 0.001),
                          ("data_wait", 0.0005), ("compute", 0.001)):
        if float(doc0["buckets"][bucket]) <= floor:
            raise AssertionError(
                f"training leg: {bucket} bucket empty "
                f"({doc0['buckets'][bucket]}s <= {floor}s floor): "
                f"instrumentation lost: {doc0['buckets']}")
    if doc0["compiles"] < 1 or doc0["n_steps"] <= 0:
        raise AssertionError(
            f"training leg: compiles {doc0['compiles']} (want >= 1: the "
            f"set-up) / n_steps {doc0['n_steps']}")
    step_wall_s = ((float(doc0["buckets"]["compute"])
                    + float(doc0["buckets"]["exposed_comm"]))
                   / doc0["n_steps"])

    # Rank 1: a flops-declaring ledger over a matmul loop, so the merged
    # /goodput report is per rank and carries MFU.
    tele1 = Telemetry(run_id="bench_goodput_r1")
    m = 256
    xm = torch.ones((m, m), dtype=torch.float32, device=dev)
    ledger1 = _goodput.GoodputLedger(telemetry=tele1, rank=1,
                                     flops_per_step=2.0 * m ** 3)
    for _ in range(5):
        with ledger1.step_span():
            xm @ xm
            _sync(dev)
    ledger1.set_comm_model(0.1, "estimate")
    doc1 = ledger1.close()
    mece(doc1, "rank1 leg")

    # -- collector merge, GET /goodput, timeline renders -----------------
    exp0 = GangMetricsExporter(telemetry=tele0, port=0).start()
    exp1 = GangMetricsExporter(telemetry=tele1, port=0).start()
    sink = os.path.join(workdir, "collector_sink.jsonl")
    collector = FleetCollector({0: exp0.url, 1: exp1.url},
                               poll_interval_s=0, jsonl_path=sink)
    collector.start(poll_loop=False)
    try:
        collector.poll()
        run_doc = scrape_json(f"{collector.url}/goodput")
    finally:
        collector.stop()
        exp0.stop()
        exp1.stop()
    ranks_seen = set(run_doc.get("per_rank") or {})
    if not {"0", "1"} <= ranks_seen:
        raise AssertionError(
            f"/goodput per_rank missing ranks: {sorted(ranks_seen)}")
    if not 0.0 < float(run_doc["goodput"]) <= 1.0 or \
            any("goodput" not in r for r in run_doc["per_rank"].values()):
        raise AssertionError(
            f"/goodput fractions malformed: run {run_doc.get('goodput')}")
    thief = run_doc.get("biggest_thief")
    if not thief or thief["bucket"] == "compute":
        raise AssertionError(f"/goodput biggest_thief missing: {thief}")
    if run_doc.get("mfu") is None:
        raise AssertionError(
            "/goodput lacks mfu despite a flops-declaring rank")
    expected_thief = max(
        ((b, s) for b, s in run_doc["buckets"].items() if b != "compute"),
        key=lambda kv: kv[1])[0]
    saved = os.path.join(workdir, "goodput.json")
    with open(saved, "w") as f:
        f.write(json.dumps(run_doc))
    for args_, what in ((["--goodput", sink], "collector sink"),
                        (["--goodput", saved], "saved /goodput doc")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _timeline.main(args_)
        out_txt = buf.getvalue()
        if rc != 0 or f"biggest thief: {expected_thief}" not in out_txt:
            raise AssertionError(
                f"timeline --goodput ({what}) failed (rc={rc}) or did not "
                f"name the biggest thief {expected_thief!r}:\n"
                f"{out_txt[:800]}")

    # -- a seeded slow shard moves exposed_comm, not compute -------------
    wx = torch.ones((512, 512), dtype=torch.float32, device=dev)
    (wx @ wx).sum().item()

    def wire_leg(chaos_cfg) -> dict:
        leg_tele = Telemetry(run_id="bench_goodput_wire")
        fleet = ParamServerFleet(spec, n_shards=2, telemetry=leg_tele,
                                 device=dev).start()
        ledger = _goodput.GoodputLedger(telemetry=leg_tele, rank="wire")
        try:
            transport = ShardedTransport(fleet, telemetry=leg_tele)
            have = -1
            ctx = (inject(chaos_cfg, telemetry=leg_tele) if chaos_cfg
                   else contextlib.nullcontext())
            with ctx:
                for _ in range(n_pulls):
                    with ledger.span("exposed_comm", {"site": "pull"}):
                        snap = transport.pull(have)
                        if snap is not None:
                            have = snap[0]
                    with ledger.step_span():
                        (wx @ wx).sum().item()
            transport.close()
            return ledger.close()
        finally:
            fleet.stop()

    wire_ctrl = wire_leg(None)
    wire_chaos = wire_leg(ChaosConfig(seed=7,
                                      slow_shard_s={"1": slow_delay_s}))
    zero_downtime(wire_ctrl, "wire control leg")
    zero_downtime(wire_chaos, "wire chaos leg")
    injected = slow_delay_s * n_pulls
    comm_shift = (float(wire_chaos["buckets"]["exposed_comm"])
                  - float(wire_ctrl["buckets"]["exposed_comm"]))
    if comm_shift < 0.8 * injected:
        raise AssertionError(
            f"seeded slow shard did not land in exposed_comm: shift "
            f"{comm_shift:.3f}s vs {injected:.3f}s injected")
    compute_shift = (float(wire_chaos["buckets"]["compute"])
                     - float(wire_ctrl["buckets"]["compute"]))
    if compute_shift > 0.25 * injected:
        raise AssertionError(
            f"seeded slow shard leaked into compute: +{compute_shift:.3f}s "
            f"(vs {injected:.3f}s injected)")

    # -- elastic downtime: attribution and reconciliation ----------------
    out = os.path.join(workdir, "parts")
    hb_dir = os.path.join(workdir, "hb")
    os.makedirs(out)
    work = [f"part{i:03d}" for i in range(n_parts)]

    def completed(p):
        return os.path.exists(os.path.join(out, p + ".done"))

    etele = Telemetry(run_id="bench_goodput_elastic")

    def start_fn(rank, attempt, generation, assignment):
        fn = functools.partial(_elastic_part_worker, parts=tuple(assignment),
                               rank=rank, generation=generation, out=out,
                               sleep_s=part_sleep_s)
        return spawn_worker(fn, rank=rank, heartbeat_dir=hb_dir,
                            name=f"rank{rank}", telemetry=etele)

    coord = GangCoordinator(world_size=3, port=0,
                            heartbeat_timeout_ms=30_000)
    policy = FtPolicy(restart=RestartPolicy(max_restarts=2,
                                            backoff_base_s=0.05,
                                            backoff_max_s=0.2), seed=0)
    ctl = ElasticController(work, completed, policy=policy, telemetry=etele,
                            coordinator=coord, min_world=1,
                            name="bench_goodput")
    for r in range(3):
        ctl.add_rank(r, start_fn)

    def grower():
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline and not ctl._stop.is_set():
            if ctl._resizes["shrink"] >= 1:
                ctl.grow(3, start_fn)
                return
            time.sleep(0.05)

    threading.Thread(target=grower, daemon=True).start()
    eledger = _goodput.GoodputLedger(telemetry=etele, rank="driver")
    try:
        with eledger.activate():
            with inject(ChaosConfig(seed=11, kill_process_at={0: 2}),
                        telemetry=etele) as inj:
                summary = ctl.run(poll_interval_s=0.05, deadline_s=240.0)
    finally:
        coord.stop()
    edoc = etele.get_section(_goodput.SECTION)
    mece(edoc, "elastic leg")
    missing = [p for p in work if not completed(p)]
    if missing or summary["work_pending"]:
        raise AssertionError(f"elastic leg incomplete: {missing}")
    kills = [e for e in inj.events if e["site"] == "ctl.process"]
    if len(kills) != 1 or summary["resizes"] != {"shrink": 1, "grow": 1}:
        raise AssertionError(
            f"elastic leg chaos schedule wrong: kills {kills}, resizes "
            f"{summary['resizes']}")
    recovery = [(v["sum"], v["max"]) for k, v in
                etele.snapshot()["histograms"].items()
                if k.startswith("ft_recovery_latency_s") and v["count"]]
    if not recovery:
        raise AssertionError("no ft_recovery_latency_s samples")
    recovery_sum = sum(s for s, _ in recovery)
    recovery_max = max(mx for _, mx in recovery)
    restart_bucket = float(edoc["buckets"]["restart_downtime"])
    if restart_bucket < recovery_max:
        raise AssertionError(
            f"seeded kill's measured gap {recovery_max:.3f}s not covered "
            f"by restart_downtime {restart_bucket:.3f}s")
    if abs(restart_bucket - recovery_sum) > 0.05 * recovery_sum + 0.05:
        raise AssertionError(
            f"restart_downtime {restart_bucket:.3f}s does not reconcile "
            f"with ft_recovery_latency_s sum {recovery_sum:.3f}s")
    resize_bucket = float(edoc["buckets"]["resize_downtime"])
    if resize_bucket <= 0 or edoc["counts"].get("resize_downtime", 0) != 2:
        raise AssertionError(
            f"shrink+grow not attributed: resize_downtime {resize_bucket}s "
            f"x{edoc['counts'].get('resize_downtime')}")
    shutil.rmtree(workdir, ignore_errors=True)

    # -- the ledger's own cost against the step wall ---------------------
    bare = _goodput.GoodputLedger(telemetry=None)
    reps = 5000
    t0 = time.perf_counter()
    for _ in range(reps):
        with bare.step_span():
            pass
    span_cost_s = (time.perf_counter() - t0) / reps
    span_us = span_cost_s * 1e6
    overhead_frac = span_cost_s / max(step_wall_s, 1e-9)
    if overhead_frac >= 0.01:
        raise AssertionError(
            f"ledger span overhead {span_us:.2f}us is "
            f"{100 * overhead_frac:.2f}% of the measured "
            f"{step_wall_s * 1e3:.3f}ms step wall (bound: 1%)")

    return {
        "config": "goodput", "unit": "us (LedgerSpan overhead)",
        "value": round(span_us, 3),
        "ledger_span_us": round(span_us, 3),
        "overhead_pct_of_step": round(100 * overhead_frac, 4),
        "step_wall_ms": round(step_wall_s * 1e3, 3),
        "training": {
            "buckets": doc0["buckets"],
            "goodput": doc0["goodput"],
            "compiles": doc0["compiles"],
            "n_steps": doc0["n_steps"],
        },
        "run_report": {
            "goodput": run_doc["goodput"],
            "n_ranks": run_doc["n_ranks"],
            "biggest_thief": run_doc.get("biggest_thief"),
            "comm_source": run_doc.get("comm_source"),
            "mfu": run_doc.get("mfu"),
        },
        "wire": {
            "injected_s": injected,
            "exposed_comm_shift_s": round(comm_shift, 3),
            "compute_shift_s": round(compute_shift, 3),
        },
        "elastic": {
            "restart_downtime_s": round(restart_bucket, 3),
            "recovery_latency_sum_s": round(recovery_sum, 3),
            "resize_downtime_s": round(resize_bucket, 3),
            "goodput": edoc["goodput"],
            "resizes": summary["resizes"],
        },
        "goodput_drift": _no_prior_drift(1.0),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


def _mesh_label(shape: Dict[str, int]) -> str:
    """The JAX package's ``parallel.tune.mesh_label``: ``dp4xtp2``, axes
    of size 1 left out, the trivial mesh ``dp1``."""
    from sparktorch_tpu_torch.parallel.mesh import ALL_AXES

    parts = [f"{a}{shape[a]}" for a in ALL_AXES if shape.get(a, 1) > 1]
    return "x".join(parts) if parts else "dp1"


@contextlib.contextmanager
def _process_group(dev: torch.device):
    """The default process group, or a world of one made for the block
    (NCCL on the card, gloo on the CPU) and ended after it."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def bench_sharded_trace(device=None) -> dict:
    """The JAX bench's trace-attribution gate (``make bench-trace``):
    capture a ``torch.profiler`` trace of the sharded trainer, read it
    offline (:mod:`~sparktorch_tpu_torch.obs.xprof`), and raise unless

    - the analysis finds at least one collective event when the world
      has more than one process (the tp all-reduces inside the step,
      beside the batch group's gradient all-reduce);
    - the step slices' wall reconciles with the bus's
      ``train_sharded/step`` span wall (the step ranges sit inside those
      spans);
    - a real ``/metrics`` scrape equals the JSONL telemetry dump for
      every published ``xprof.*`` metric.

    ``SequenceClassifier(tiny_transformer())`` under Adam at 1e-3, a
    batch of 4 rows a process, 6 steps. The mesh is ``MeshConfig(tp=2)``
    on an even world and ``MeshConfig()`` otherwise, over the default
    process group (a world of one when there is none), and the record
    names the mesh built. ``SPARKTORCH_TPU_TRACE_MESH=auto`` (the mesh
    tuner) raises: ROADMAP, Queue 1, step 7."""
    import os
    import tempfile

    import torch.distributed as dist

    from sparktorch_tpu_torch.models import SequenceClassifier, tiny_transformer
    from sparktorch_tpu_torch.native.gang import GangMetricsExporter
    from sparktorch_tpu_torch.obs import (
        Telemetry,
        parse_prometheus,
        read_jsonl,
        scrape_text,
    )
    from sparktorch_tpu_torch.obs.prom import sanitize_name
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )
    from sparktorch_tpu_torch.utils.data import DataBatch

    dev = _resolve_device(device)
    mesh_knob = os.environ.get("SPARKTORCH_TPU_TRACE_MESH", "tp2")
    if mesh_knob not in ("tp2", "auto"):
        raise AssertionError(f"SPARKTORCH_TPU_TRACE_MESH={mesh_knob!r}: "
                             "use 'tp2' or 'auto'")
    if mesh_knob == "auto":
        raise NotImplementedError(
            "SPARKTORCH_TPU_TRACE_MESH=auto (the mesh tuner, "
            "parallel/tune.py) is not ported yet (ROADMAP, Queue 1, step 7)")
    tele = Telemetry(run_id="bench_sharded_trace")
    steps = 6
    with _process_group(dev):
        n_dev = dist.get_world_size()
        with tele.span("bench/data") as sp_data:
            rng = np.random.default_rng(0)
            bsz = 4 * n_dev
            batch = DataBatch(
                x=torch.from_numpy(rng.integers(0, 256, (bsz, 16)).astype(
                    np.int32)),
                y=torch.from_numpy(rng.integers(0, 2, (bsz,)).astype(
                    np.int32)),
                w=torch.ones(bsz, dtype=torch.float32))
        with tele.span("bench/init") as sp_init:
            torch.manual_seed(0)
            spec = _spec(SequenceClassifier(tiny_transformer()),
                         optimizer="adam", optimizer_params={"lr": 1e-3})
            mesh = build_mesh(MeshConfig(tp=2) if n_dev % 2 == 0
                              else MeshConfig())
            # Recorded from the mesh built, never the knob: on an odd
            # world the mesh is pure dp.
            mesh_ran = _mesh_label(mesh.shape)
            state, shardings = create_sharded_state(spec, mesh, rng=0,
                                                    device=dev)
        with tempfile.TemporaryDirectory() as profile_dir:
            step = make_sharded_train_step(spec.loss_fn(), mesh, shardings,
                                           profile_dir=profile_dir,
                                           telemetry=tele)
            sharded = shard_batch(batch, mesh).to(dev)
            with tele.span("bench/compile_warmup") as sp_warm:
                # The first step outside the capture (the bare step: no
                # span, range or profiler), so the trace holds steady
                # steps.
                state, m = step.jitted(state, sharded)
                float(m.loss)
            with tele.span("bench/measure") as sp_measure:
                for _ in range(steps):
                    state, m = step(state, sharded)
                    # Each step's device work drains inside its slice.
                    float(m.loss)
                sp_measure.synced = True
            analysis = step.finish()

    # -- gates --------------------------------------------------------------
    if analysis is None or analysis.n_device_events == 0:
        raise AssertionError("trace analysis found no device events: the "
                             "capture holds nothing usable")
    if n_dev > 1 and analysis.n_collective_events < 1:
        raise AssertionError(
            f"no collectives found in a {n_dev}-process sharded step "
            f"(families seen: {analysis.family_counts()})")
    span = tele.span_rollup("bench/measure/train_sharded/step")
    step_wall = analysis.wall_s
    span_wall = span["sum"]
    # The ranges sit inside the spans: their wall never exceeds the
    # span wall (beyond clock jitter) and accounts for most of it.
    tol = max(0.5 * span_wall, 0.02)
    if not (0 < step_wall <= span_wall + 0.005) or \
            abs(span_wall - step_wall) > tol:
        raise AssertionError(
            f"step-slice wall {step_wall:.4f}s does not reconcile with "
            f"bus span wall {span_wall:.4f}s (tol {tol:.4f}s)")
    if len(analysis.steps) != steps or span["count"] != steps:
        raise AssertionError(
            f"expected {steps} steps: trace has {len(analysis.steps)}, "
            f"bus has {span['count']}")

    # -- /metrics scrape == JSONL dump --------------------------------------
    with GangMetricsExporter(telemetry=tele) as exporter:
        scraped = parse_prometheus(scrape_text(exporter.url + "/metrics"))
    with tempfile.TemporaryDirectory() as d:
        dump_path = os.path.join(d, "telemetry.jsonl")
        snap = tele.dump(dump_path)
        (snap_read,) = read_jsonl(dump_path)

    def prom_key(flat: str) -> Tuple[str, str]:
        name, _, labels = flat.partition("{")
        lbl = ""
        if labels:
            k, _, v = labels[:-1].partition("=")
            lbl = f'{{{k}="{v}"}}'
        return "sparktorch_" + sanitize_name(name), lbl

    mismatches = []
    for flat, val in snap["counters"].items():
        if not flat.startswith("xprof."):
            continue
        key, lbl = prom_key(flat)
        got = scraped.get(key + lbl)
        if got != val or snap_read["counters"].get(flat) != val:
            mismatches.append((flat, val, got,
                               snap_read["counters"].get(flat)))
    n_hists = 0
    for flat, roll in snap["histograms"].items():
        if not flat.startswith("xprof."):
            continue
        n_hists += 1
        key, lbl = prom_key(flat)
        if scraped.get(f"{key}_count{lbl}") != float(roll["count"]) or \
                snap_read["histograms"][flat]["count"] != roll["count"]:
            mismatches.append((flat, roll["count"]))
    if mismatches or n_hists == 0:
        raise AssertionError(
            f"xprof /metrics scrape vs JSONL dump mismatch (histograms "
            f"seen: {n_hists}): {mismatches}")

    return {
        "config": "sharded_trace", "unit": "comm_fraction",
        "value": round(analysis.comm_fraction, 4),
        "comm_fraction": round(analysis.comm_fraction, 4),
        "overlap_fraction": round(analysis.overlap_fraction, 4),
        "comm_s": round(analysis.comm_s, 6),
        "compute_s": round(analysis.compute_s, 6),
        "collective_s": {k: round(v, 6)
                         for k, v in analysis.family_s().items()},
        "collective_counts": analysis.family_counts(),
        "n_collective_events": analysis.n_collective_events,
        "n_steps": len(analysis.steps),
        "n_chips": n_dev,
        "mesh": mesh_ran,
        "reconcile": {"steps_wall_s": round(step_wall, 6),
                      "span_wall_s": round(span_wall, 6)},
        "top_ops": analysis.top_ops[:5],
        "scrape_parity": "ok",
        "comm_drift": _no_prior_drift(0.25, mesh=mesh_ran),
        "phase_s": {
            "data": round(sp_data.duration_s, 3),
            "init": round(sp_init.duration_s, 3),
            "compile_warmup": round(sp_warm.duration_s, 3),
            "measure": round(sp_measure.duration_s, 3),
            "comm_s": round(analysis.comm_s, 6),
        },
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
    "hogwild_chaos": bench_hogwild_chaos,
    "hogwild_chaos_soak": bench_hogwild_chaos_soak,
    "gang_obs": bench_gang_obs,
    "elastic_ctl": bench_elastic_ctl,
    "rpc_trace": bench_rpc_trace,
    "health": bench_health,
    "goodput": bench_goodput,
    "skew": bench_skew,
    "profile": bench_profile,
    "obs_history": bench_obs_history,
    "sharded_trace": bench_sharded_trace,
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
