"""The port's bench harness on the CPU, against the JAX package's bench where they share code.

The configs themselves run on the card (``chip_smoke.py``'s bench phase);
here the harness runs a tiny MLP, and the accounting functions are held
to the JAX package's.
"""

import functools

import numpy as np
import pytest
import torch

from sparktorch_tpu_torch import bench
from sparktorch_tpu_torch.models import MnistMLP, bert_base
from sparktorch_tpu_torch.models.transformer import CausalLM, TransformerConfig
from sparktorch_tpu_torch.ops.roofline import attention_flops, ce_ops
from sparktorch_tpu_torch.utils.data import DataBatch
from sparktorch_tpu_torch.utils.serde import ModelSpec, resolve_optimizer


def _tiny_mlp_spec():
    torch.manual_seed(0)
    return ModelSpec(module=MnistMLP(hidden=(32,)), loss="cross_entropy",
                     optimizer="adam", optimizer_params={"lr": 1e-3},
                     input_shape=(784,))


def _mnist(n=64):
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (n, 784)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def test_sync_epoch_bench_measures_a_positive_slope():
    x, y = _mnist()
    rec = bench._sync_epoch_bench(_tiny_mlp_spec(), x, y, 64, iters=5,
                                  device="cpu")
    jax_keys, omitted, added = bench.RECORD_KEYS["mnist_mlp_sync"]
    assert set(rec) == (jax_keys - omitted - {"config", "unit"}) | added
    assert rec["step_time_p50_s"] > 0 and len(rec["rate_samples"]) >= 1
    # The rate is the batch over the median step, per chip (a world of 1).
    assert rec["n_chips"] == 1
    assert rec["examples_per_sec_per_chip"] == round(
        64 / rec["step_time_p50_s"], 1)
    assert rec["rate_best"] >= rec["examples_per_sec_per_chip"]
    assert rec["steps_run"] >= 5 * 3 + 5 * 2 * 8
    assert set(rec["phase_s"]) == {"data", "init", "compile_warmup",
                                   "measure"}
    assert np.isfinite(rec["final_loss"])


def test_sync_epoch_bench_trace_phase_gives_the_comm_budget():
    # moe_lm's trace keys: an analysed capture of two more calls; one
    # process, no group, so no collective.
    x, y = _mnist()
    rec = bench._sync_epoch_bench(_tiny_mlp_spec(), x, y, 64, iters=3,
                                  repeats=2, device="cpu", with_trace=True)
    budget = rec["comm_budget"]
    assert set(budget) == {"comm_s", "comm_fraction", "overlap_fraction",
                           "collective_s", "collective_counts",
                           "n_collective_events"}
    assert budget["comm_s"] == rec["comm_fraction"] == 0
    assert rec["overlap_fraction"] == 0
    assert rec["phase_s"]["comm_s"] == 0 and rec["phase_s"]["trace"] > 0
    moe_keys, omitted, added = bench.RECORD_KEYS["moe_lm"]
    assert not omitted and {"comm_budget", "comm_fraction",
                            "overlap_fraction", "comm_drift"} <= moe_keys


def test_gang_obs_gates_hold_on_the_cpu():
    # The JAX gate on torch.profiler-shaped synthetic ranks: merged
    # scrapes reconcile, the gang budget sums and maxes, the truncation
    # warning trips once.
    rec = bench.bench_gang_obs()
    assert set(rec) == bench.RECORD_KEYS["gang_obs"][0]
    assert rec["gang_step_skew_s"] > 0 and rec["truncation_trips"] == 1
    assert rec["gang_comm_fraction"] == pytest.approx(1 / 3, abs=1e-4)
    assert rec["gang_drift"]["status"] == "no_prior_record"


def test_steady_rate_drops_the_first_windows():
    # Two workers, windows of 4 iterations dispatched at t = 0, 1, 2, 3:
    # the 16 iterations dispatched after the second stamp (t = 1) over
    # the span from it to the last loss on the host (t = 5).
    metrics = [{"worker": w, "t": float(t), "t_done": t + 2.0}
               for w in range(2) for t in range(4) for _ in range(4)]
    assert bench.steady_examples_per_s(metrics, 8) == 16 * 8 / (5.0 - 1.0)
    assert bench.steady_examples_per_s(metrics[:8], 8) is None


@pytest.mark.parametrize("times", [
    [0.5], [0.3, 0.1, 0.2], list(np.linspace(1e-3, 2e-3, 17)),
])
def test_steps_summary_matches_jax(times):
    from sparktorch_tpu import bench as jax_bench

    assert bench._steps_summary(times) == jax_bench._steps_summary(times)


def test_bert_flops_accounting_matches_jax(monkeypatch):
    import flax.linen as nn
    import jax
    from sparktorch_tpu import bench as jax_bench
    from sparktorch_tpu.models.transformer import bert_base as jax_bert_base

    module = jax_bert_base()

    def shapes_only(self, *args, **kwargs):
        return jax.eval_shape(functools.partial(nn.Module.init, self),
                              *args, **kwargs)

    monkeypatch.setattr(type(module), "init", shapes_only)
    want = jax_bench._bert_flops_accounting(module, 128, 128)
    got = bench._bert_flops_accounting(bert_base(), 128, 128)
    for key in ("n_params", "n_params_embedding", "n_params_per_token",
                "n_params_per_example_head", "model_flops_per_step",
                "legacy_6n_total_flops_per_step"):
        assert got[key] == want[key], key


def test_counted_flops_add_each_kernel_launch():
    cfg = TransformerConfig(vocab_size=256, d_model=32, n_heads=2,
                            n_layers=1, d_ff=64, max_len=16, dtype="float32",
                            attn_impl="flash")
    torch.manual_seed(0)
    module = CausalLM(cfg)
    ids = torch.randint(0, 256, (2, 17))
    batch = DataBatch(ids[:, :-1].float(), ids[:, 1:], torch.ones(2))
    per = bench._flops_per_launch(module, batch.x)
    assert per["flash_fwd"] == attention_flops(2, 16, 2, 16, True)
    assert per["ce_fwd"] == per["ce_bwd"] == ce_ops(32, 256)
    assert bench._flops_per_launch(MnistMLP(), batch.x) == {}

    # On the CPU the wrappers run their plain versions, which the
    # counter sees (0 launches): the count is FlopCounterMode's.
    from torch.utils.flop_counter import FlopCounterMode

    from sparktorch_tpu_torch.utils.losses import resolve_loss

    loss_fn = resolve_loss("cross_entropy")
    opt = resolve_optimizer("sgd", {"lr": 0.0})(module.parameters())
    before = bench._launches()
    counted = bench.counted_flops_per_step(module, loss_fn, opt, batch)
    assert bench._launches() == before
    with FlopCounterMode(display=False) as counter:
        from sparktorch_tpu_torch.train.step import train_step

        train_step(module, loss_fn, opt, batch)
    assert counted == counter.get_total_flops() > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card path")
@pytest.mark.parametrize("argv", [["--config", "headline"],
                                  ["--config", "mnist_mlp_sync"],
                                  ["--config", "bert_dp"]])
def test_main_raises_without_a_card(argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(argv)


def test_config_choices_and_unported_options():
    assert set(bench.CONFIGS) == set(bench.RECORD_KEYS) == {
        "mnist_mlp_sync", "mnist_cnn_sync", "lazy_cnn_sync",
        "resnet18_hogwild", "hogwild_wire", "bert_dp",
        "resnet50_inference", "long_context_lm", "moe_lm", "serve_online",
        "hogwild_ps_fleet", "hogwild_chaos", "hogwild_chaos_soak",
        "gang_obs", "elastic_ctl", "rpc_trace", "health", "goodput", "skew",
        "profile", "obs_history", "sharded_trace"}
    with pytest.raises(SystemExit):
        bench.main(["--config", "moe_a2a"])  # needs an ep mesh axis
    # --telemetry-dump is ported: without a card the run raises first.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--config", "mnist_mlp_sync", "--telemetry-dump",
                    "x.jsonl"])
    assert bench.mfu_honest(98.9) == pytest.approx(0.1)
    # One division and one peak for a bench record and the ledger's MFU.
    from sparktorch_tpu_torch.obs import goodput
    from sparktorch_tpu_torch.ops.roofline import PEAK_FLOPS

    assert bench.mfu_honest is goodput.mfu_honest
    assert bench.H100_BF16_PEAK_TFLOPS == goodput.H100_BF16_PEAK_TFLOPS \
        == PEAK_FLOPS["bfloat16"] / 1e12


@pytest.mark.parametrize("config", ["hogwild_chaos", "hogwild_chaos_soak"])
def test_hogwild_chaos_gates_hold_on_the_cpu(config):
    # The JAX configs' sizes, seeds and gates at full size on one CPU
    # worker; a gate that fails raises inside the run.
    rec = bench.CONFIGS[config](device="cpu")
    jax_keys, omitted, added = bench.RECORD_KEYS[config]
    assert set(rec) == (jax_keys - omitted) | added
    assert rec["config"] == config and rec["n_chips"] == 1
    if config == "hogwild_chaos":
        assert rec["restarts"] == 1 and rec["victim_worker"] == 0
        assert 0 < rec["recovery_latency_s"] <= 10.0
    else:
        assert rec["restarts"] == rec["kills"] + rec["freezes"]
        assert rec["stall_preemptions"] == rec["freezes"] == 2
        assert rec["records_exact"] is True


def test_hogwild_ps_fleet_byte_and_kill_gates_hold_on_the_cpu():
    # The JAX config's legs, gates and record keys at a small size
    # (width 256, quota 3, one interleaved pair): the call raises if a
    # byte gate or a shard-kill gate fails. The timing gates are the
    # card's (bench.check_fleet_gates(rec) there).
    rec = bench.bench_hogwild_ps_fleet(device="cpu", width=256, quota=3,
                                       pairs=1, timing_gates=False)
    jax_keys, omitted, added = bench.RECORD_KEYS["hogwild_ps_fleet"]
    assert set(rec) == (jax_keys - omitted) | added
    assert (rec["n_shards"], rec["workers"], rec["quota"]) == (4, 6, 3)
    assert (rec["hot_leaves"], rec["total_leaves"]) == (8, 34)
    assert rec["fleet"]["wire_mb_per_pull"] < rec["single"][
        "wire_mb_per_pull"]
    assert rec["fleet_int8"]["wire_mb_per_pull"] < rec["fleet"][
        "wire_mb_per_pull"]
    kill = rec["shard_kill"]
    assert kill["fired"] >= 1 and kill["records"] == 24
    assert kill["restarts"] >= 1
    assert set(rec["phase_s"]) == {"init", "compile_warmup", "measure",
                                   "shard_kill"}
    broken = dict(rec, fleet_int8=dict(rec["fleet_int8"],
                                       wire_mb_per_pull=1e9))
    with pytest.raises(AssertionError, match="int8 delta pulls"):
        bench.check_fleet_gates(dict(broken, shard_kill=dict(
            kill, expected_records=24)), timing=False)


def test_serve_online_gates_hold_on_the_cpu():
    # The JAX config's sizes, seeds, legs and gates, at 40 requests a
    # leg: the call raises if a gate fails. One intra-op thread, so a
    # row's compute sets the serial service time (the regime the gate's
    # model is sized for), not the thread pool's contention with the
    # other processes on the host.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = bench.bench_serve_online(device="cpu", n_requests=40)
    finally:
        torch.set_num_threads(threads)
    jax_keys, omitted, added = bench.RECORD_KEYS["serve_online"]
    assert set(rec) == (jax_keys - omitted) | added
    assert rec["n_requests"] == 40
    assert rec["throughput_ratio"] > 1.0 and rec["p99_ratio"] <= 1.0
    for leg in ("baseline", "continuous", "replica_kill"):
        assert rec[leg]["completed"] == 40 and rec[leg]["errors"] == 0
    kill = rec["replica_kill"]
    assert kill["kills"] == 1 and min(
        kill["evictions"], kill["restarts"], kill["readmissions"]) >= 1
    push = rec["weight_push"]
    assert push["exact"] and set(push["staleness_s"]) == {"0", "1"}
    assert max(push["staleness_s"].values()) <= push["staleness_bound_s"]
    assert rec["serve_drift"] == {"status": "no_prior_record",
                                  "tolerance": 0.5}
    assert set(rec["phase_s"]) == {"init", "compile_warmup", "measure",
                                   "replica_kill", "weight_push"}


def test_serve_online_record_keys_are_the_jax_records():
    # The JAX bench's retained serve_online records carry exactly these
    # keys (plus the ``ts`` its CLI adds).
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "benchmarks" / \
        "bench_r07_serve.jsonl"
    jax_keys, omitted, added = bench.RECORD_KEYS["serve_online"]
    recs = [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]
    assert recs and all(set(r) - {"ts"} == jax_keys for r in recs)
    assert omitted == added == set()


# The obs configs at a cut CPU depth, where the JAX config has a
# parameter for it (rpc_trace and profile run whole): each call raises
# if a gate fails.
OBS_CONFIGS = {
    "rpc_trace": {},
    "health": dict(aa_reps=2),
    "goodput": dict(part_sleep_s=0.1, n_pulls=2,
                    slow_delay_s=0.25),
    "skew": dict(steps=6, delay_s=0.15),
    "profile": {},
    "obs_history": dict(slow_delay_s=0.25),
}


@pytest.mark.parametrize("config", sorted(OBS_CONFIGS))
def test_obs_configs_hold_their_gates_on_the_cpu(config):
    threads = torch.get_num_threads()
    if config == "profile":
        # The A/A's 768² CPU matmul on every core of a loaded host times
        # the cores' contention (its off/off floor read up to 10% under
        # six concurrent runs), not the sampler: one intra-op thread, as
        # serve_online's test pins (its floor then within 0.4%).
        torch.set_num_threads(1)
    try:
        rec = bench.CONFIGS[config](device="cpu", **OBS_CONFIGS[config])
    finally:
        torch.set_num_threads(threads)
    jax_keys, omitted, added = bench.RECORD_KEYS[config]
    assert set(rec) == (jax_keys - omitted) | added
    assert rec["config"] == config
    drift = [v for k, v in rec.items() if k.endswith("_drift")]
    assert all(d["status"] == "no_prior_record" for d in drift)
    if config == "rpc_trace":
        assert rec["overhead_pct"] < 2.0 and rec["pull_trees"] == 10
        assert rec["slow_shard"]["named"] == rec["slow_shard"]["pulls"] == 3
        assert len(rec["reconcile"]) == 4
    elif config == "health":
        assert rec["detect"]["step"] == 6 and rec["replay"]["bitwise"]
    elif config == "goodput":
        assert rec["elastic"]["resizes"] == {"shrink": 1, "grow": 1}
        assert rec["wire"]["exposed_comm_shift_s"] >= 0.8 * rec["wire"][
            "injected_s"]
    elif config == "skew":
        assert rec["decomposition"]["laggard"]["rank"] == "1"
    elif config == "profile":
        assert rec["hot"]["top_frame"].startswith("_profile_hot_planted")
    else:
        assert rec["alert"]["chaos_episodes"] == 1
        assert rec["postmortem"]["victim_spans"] >= 1


@pytest.mark.parametrize("config,path", [
    ("health", "bench_r15_health.jsonl"), ("goodput", "bench_r11_goodput.jsonl"),
    ("skew", "bench_r16_skew.jsonl"), ("profile", "bench_r14_profile.jsonl"),
    ("obs_history", "bench_r09_obs.jsonl")])
def test_obs_record_keys_are_the_jax_records(config, path):
    # The JAX bench's newest retained record of each config carries
    # exactly these keys (plus the ``ts`` its CLI adds).
    import json
    from pathlib import Path

    lines = (Path(__file__).resolve().parent.parent / "benchmarks" / path
             ).read_text().splitlines()
    recs = [json.loads(ln) for ln in lines if ln.strip()]
    newest = [r for r in recs if r.get("config") == config][-1]
    jax_keys, omitted, added = bench.RECORD_KEYS[config]
    assert set(newest) - {"ts"} == jax_keys
    # The port's additions: profile's A/A records its off/off floor,
    # skew the spread of its stamp's batch means.
    assert omitted == set()
    assert added == {"profile": {"aa_floor_pct"},
                     "skew": {"stamp_spread_us"}}.get(config, set())
