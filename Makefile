# Developer entry points (reference parity: Makefile:1-15 exposes
# docker build/run-test; here the runtime is local JAX + the native
# C++ components, built on demand by tests).

PYTHON ?= python

.PHONY: install test test-fast test-pyspark native bench bench-all \
	bench-wire bench-chaos bench-chaos-soak bench-trace bench-gang-obs \
	bench-ps-fleet bench-tune bench-pp-tune bench-rpc-trace \
	bench-serve bench-elastic bench-obs-history bench-moe \
	bench-goodput bench-profile bench-health bench-skew bench-lint \
	cluster-up clean lint lint-obs lint-torch bench-wire-torch

install:
	$(PYTHON) -m pip install -e .

# sparklint: the AST-based static-analysis pass (sparktorch_tpu/lint/).
# It replaced this Makefile's six grep stanzas — the rules are now
# scope-aware (with-blocks, call structure, import aliases) and each
# encodes a bug class this repo actually shipped: lock-held percentile
# roll-ups (PR 9/11), raw clocks outside wall_ts/LedgerSpans (PR 13),
# the Telemetry.event(kind=...) envelope collision, jit retrace
# hazards (PR 14), collectives outside shard_map scope (PR 12), and
# stopped-handle use-after-free (PR 10). Rule table + suppression
# syntax (`# lint-obs: ok (<why>)`): README "Static analysis";
# `python -m sparktorch_tpu.lint --list-rules` for the live list.
lint:
	@$(PYTHON) -m sparktorch_tpu.lint sparktorch_tpu/

# Back-compat alias: `make lint-obs` keeps working (the historical
# target name the grep stanzas lived under).
lint-obs: lint

# Lint wall-time gate: the analyzer must stay under 5s on the full
# tree (CPU rig) so the tier-1 prerequisite never becomes the suite's
# slowest step; each run retains one JSONL record so the trend is
# visible beside the other bench records.
bench-lint:
	@$(PYTHON) -m sparktorch_tpu.lint sparktorch_tpu/ --gate-wall 5 \
		--log benchmarks/bench_r13_lint.jsonl

# The PyTorch/CUDA port's sparklint (sparktorch_tpu_torch/lint/): the
# same engine and suppression syntax, scoped to the port, with SPK108,
# SPK401 and SPK402 re-aimed at torch; and the port's wire benchmark.
lint-torch:
	@$(PYTHON) -m sparktorch_tpu_torch.lint sparktorch_tpu_torch/

bench-wire-torch:
	$(PYTHON) -m sparktorch_tpu_torch.net.bench_wire

test: lint
	$(PYTHON) -m pytest tests/ -q

test-fast: lint
	$(PYTHON) -m pytest tests/ -q -m "not slow"

# Real pyspark + JVM persistence harness (skips without pyspark/java;
# `pip install -e .[spark]` + a JRE make it run for real). Own process
# so the localspark shim never shadows genuine pyspark.
test-pyspark:
	$(PYTHON) -m pytest tests/test_real_pyspark.py -v

# Genuine Spark standalone cluster (master+worker+driver) running the
# adapter example and the JVM persistence tests. Reference parity:
# docker-compose.yml:3-25.
cluster-up:
	docker compose -f deploy/docker/docker-compose.yml up --build \
		--abort-on-container-exit --exit-code-from driver

# Build the native C++ runtime (gang coordinator, rowpack parser)
# explicitly; tests otherwise build it on first use.
native:
	$(PYTHON) -c "from sparktorch_tpu.native.build import load_library; \
	load_library('gang'); load_library('rowpack'); print('native OK')"

bench:
	$(PYTHON) bench.py

bench-all:
	$(PYTHON) -m sparktorch_tpu.bench --config all --log benchmarks/bench_local.jsonl

# Dill-vs-binary wire microbenchmark (transformer-sized state dict):
# FAILS unless the framed binary wire beats dill on both bytes on the
# wire and encode+decode wall time — the zero-copy claim, gated.
# Non-default CI-style smoke target (no TPU or JAX device needed).
bench-wire:
	$(PYTHON) -m sparktorch_tpu.net.bench_wire

# Fault-tolerance gate: a supervised hogwild run with ONE seeded
# worker kill must complete with exactly one restart, a learned model,
# and recovery overhead under budget — FAILS otherwise (the recovery
# path is load-bearing, so its regressions should break CI, not
# production). Runs on any backend (JAX_PLATFORMS=cpu works).
bench-chaos:
	$(PYTHON) -m sparktorch_tpu.bench --config hogwild_chaos

# Chaos SOAK gate: a seeded multi-round random kill/freeze/drop
# schedule through the supervisor — FAILS unless every round completes
# with restart count == injected kills, stall preemptions == injected
# freezes, and exact record counts (no double-counting). Catches
# recovery races the single-fault bench-chaos gate cannot.
bench-chaos-soak:
	$(PYTHON) -m sparktorch_tpu.bench --config hogwild_chaos_soak

# Trace-attribution gate: capture a sharded-step XLA profile, analyze
# it offline (obs.xprof), and FAIL unless >=1 collective is found, the
# step-slice wall reconciles with the bus span wall, and a real
# /metrics scrape equals the JSONL telemetry dump for the xprof
# metrics. The gang_obs config runs second so bench-trace is ALSO
# gated on xprof.gang_* drift (cross-rank step skew growth, gang comm
# fraction rise vs the newest prior gang record; no_prior_record skip
# until a multi-host round has recorded one). Defaults to the
# 8-virtual-device CPU backend so it runs anywhere (override
# JAX_PLATFORMS/XLA_FLAGS for a real accelerator);
# SPARKTORCH_TPU_TRACE_MESH=auto lets the mesh auto-tuner pick the
# layout under the capture instead of the fixed tp2.
bench-trace:
	JAX_PLATFORMS=$${JAX_PLATFORMS:-cpu} \
	XLA_FLAGS="$${XLA_FLAGS:---xla_force_host_platform_device_count=8}" \
	$(PYTHON) -m sparktorch_tpu.bench --config sharded_trace
	$(PYTHON) -m sparktorch_tpu.bench --config gang_obs
	$(MAKE) bench-moe

# MoE expert-parallel dispatch gate: on the same ep=2 mesh and matched
# init, the explicit shard_map all-to-all dispatch must move STRICTLY
# fewer per-device HLO collective bytes than the legacy token-
# replication lowering (with all-to-alls present and zero all-gathers
# in its program), at equal-or-better median step wall
# (SPARKTORCH_TPU_MOE_WALL_TOL, default 0.05) and identical losses
# (rtol 1e-5) — FAILS otherwise. The tuner's ep a2a byte term is
# cross-checked against the measured HLO bytes (factor band), and the
# record is retained so the byte-reduction drift gate arms against the
# windowed median of prior rounds (SPARKTORCH_TPU_MOE_DRIFT_TOL,
# relative, default 0.25). Also chained into bench-trace. Defaults to
# the 8-virtual-device CPU backend so it runs anywhere.
bench-moe:
	JAX_PLATFORMS=$${JAX_PLATFORMS:-cpu} \
	XLA_FLAGS="$${XLA_FLAGS:---xla_force_host_platform_device_count=8}" \
	$(PYTHON) -m sparktorch_tpu.bench --config moe_a2a \
		--log benchmarks/bench_r10_moe.jsonl

# Mesh auto-tuner gate: the trace-guided tuner (enumerate -> analytic
# comm-volume prune -> profiled measurement with early stop) must pick
# a mesh within tolerance (default 10% step wall) of the exhaustively
# measured winner on this rig, with >=1 candidate pruned without
# execution, the measured winner never pruned, the profiled-step
# budget respected, and the full ranking emitted in tune_result.json —
# FAILS otherwise. Defaults to the 8-virtual-device CPU backend.
bench-tune:
	JAX_PLATFORMS=$${JAX_PLATFORMS:-cpu} \
	XLA_FLAGS="$${XLA_FLAGS:---xla_force_host_platform_device_count=8}" \
	$(PYTHON) -m sparktorch_tpu.bench --config mesh_tune

# Pipeline-schedule tuning + recompile-tax gate (ROADMAP item 4):
# (a) the tuner searches dp x pp x {gpipe,1f1b,interleaved} x
# virtual_stages, measured through the PIPELINE trainer, and must
# choose within tolerance (default 15%) of the exhaustively-measured
# winner; (b) a cache-warm mesh="auto" build must compile LESS than
# the cold path (TuneResult.compile_count drops, the goodput ledger's
# `compile` bucket shows the seconds saved, the warm tune wall
# collapses to a cache hit) — FAILS otherwise. The record is retained
# (--log) so the tuner-wall drift gate arms against the windowed
# median of prior rounds (SPARKTORCH_TPU_PP_TUNE_DRIFT_TOL, relative,
# default 1.0 + 5s floor). Defaults to the 8-virtual-device CPU rig.
bench-pp-tune:
	JAX_PLATFORMS=$${JAX_PLATFORMS:-cpu} \
	XLA_FLAGS="$${XLA_FLAGS:---xla_force_host_platform_device_count=8 --xla_cpu_enable_concurrency_optimized_scheduler=false}" \
	$(PYTHON) -m sparktorch_tpu.bench --config pp_tune \
		--log benchmarks/bench_r12_pptune.jsonl

# Gang-observability gate: spin local rank exporters, run the fleet
# collector, and FAIL unless the merged scrape reconciles with the
# per-rank scrapes (every series rank/host-labeled, values and sums
# equal), the merged xprof gang budget reconciles with the per-rank
# analyses (families sum, step walls max, skew >= 0), and a seeded
# truncated capture trips the xprof.capture_truncated warning exactly
# once. Backend-free — no devices needed.
bench-gang-obs:
	$(PYTHON) -m sparktorch_tpu.bench --config gang_obs

# Per-request RPC tracing gate: tracing overhead must stay < 2% at
# default head sampling on the binary-wire push/pull loop; a traced
# 4-shard pull must yield one stitched span tree per sampled request
# whose serve spans reconcile with the wire_latency_s histograms
# (same population, p50 within tolerance); and a seeded slow shard
# (ft.chaos slow_shard_s) must be named as the critical path in the
# collector's stitched output and in `timeline --rpc` — FAILS
# otherwise. Runs on any backend (JAX_PLATFORMS=cpu works).
bench-rpc-trace:
	$(PYTHON) -m sparktorch_tpu.bench --config rpc_trace

# Online-serving gate: under seeded Poisson open-loop load, the
# continuous-batching inference tier must beat a serially-dispatched
# fixed-window BatchPredictor on throughput at equal-or-better p99
# (zero failed requests both sides); a seeded replica kill mid-load
# must drop ZERO requests with the eviction -> restart -> re-admission
# pipeline observed in counters; and a mid-load weight push must land
# on every replica within the staleness bound with exact served
# parameters — FAILS otherwise. The serve modules are covered by
# lint-obs like everything else under sparktorch_tpu/ (no raw prints,
# tracer-helper-only span minting, sanctioned scrape readers). Runs on
# any backend (JAX_PLATFORMS=cpu works).
bench-serve:
	$(PYTHON) -m sparktorch_tpu.bench --config serve_online

# Parameter-server fleet gate: under a sparse-update worker swarm, a
# 4-shard fleet must beat the single server on aggregate pull
# bandwidth AND p99 pull latency (medians over interleaved repeats),
# per-tensor delta pulls must ship strictly fewer bytes than full
# pulls (and int8 deltas fewer than f32 deltas), and a seeded shard
# kill during a real train_async(shards=4) run must complete with
# exact record counts and a monitored shard restart — FAILS otherwise.
# Runs on any backend (JAX_PLATFORMS=cpu works).
bench-ps-fleet:
	$(PYTHON) -m sparktorch_tpu.bench --config hogwild_ps_fleet

# Elastic control-plane gate: one supervised MULTI-PROCESS run (real
# `python -m sparktorch_tpu.ctl.worker` children) must survive a
# seeded NON-COOPERATIVE kill (chaos kill_process_at: raw SIGKILL, no
# cancel event — restart, recovery latency bounded), a restart-budget
# exhaustion (world SHRINK through the native coordinator, the dead
# rank's partitions redistributed, training continues), and a rejoin
# (world GROW) — with every partition completed EXACTLY once and every
# transition visible as a generation-tagged event in the collector's
# /gang view — FAILS otherwise. The record is retained (--log) so the
# recovery-latency drift gate arms against prior rounds
# (SPARKTORCH_TPU_ELASTIC_DRIFT_TOL, relative, default 2.0). The ctl
# modules are covered by lint-obs like everything else under
# sparktorch_tpu/. Runs on any backend (JAX_PLATFORMS=cpu works).
bench-elastic:
	$(PYTHON) -m sparktorch_tpu.bench --config elastic_ctl \
		--log benchmarks/bench_r08_elastic.jsonl

# Metrics-history / SLO-alerting / flight-recorder gate: a seeded
# slow-shard degradation must fire the sustained client-hop
# (shard_pull_latency_s) p99 breach rule within its rule window
# while an A/A control run fires
# NOTHING; a seeded non-cooperative process-worker kill must produce a
# postmortem bundle whose causal event window contains the kill's
# ctl.* transition and the victim's last spans (recovered from the
# collector's last-good scrape of the dead process's flight-recorder
# ring); and the collector sweep with history+alerts enabled must stay
# within 10% of a history-off sweep (SPARKTORCH_TPU_OBS_SWEEP_TOL) —
# FAILS otherwise. The record is retained (--log) so the sweep-cost
# drift gate arms against the WINDOWED median of prior rounds
# (SPARKTORCH_TPU_OBS_DRIFT_TOL, relative, default 1.0). Runs on any
# backend (JAX_PLATFORMS=cpu works).
bench-obs-history:
	$(PYTHON) -m sparktorch_tpu.bench --config obs_history \
		--log benchmarks/bench_r09_obs.jsonl

# Goodput-ledger gate: the run-level time ledger must be MECE on a
# real multi-process elastic run — buckets (compute/exposed_comm/
# compile/checkpoint/data_wait/restart_downtime/resize_downtime/idle)
# sum to total run wall within 2% with ZERO over-attribution; a seeded
# non-cooperative kill must land at least its measured recovery gap in
# restart_downtime (the ledger reconciles with ft_recovery_latency_s
# by construction) and the shrink must land in resize_downtime; a
# seeded 0.5s slow-shard must shift exposed_comm, NOT compute, on the
# hogwild wire leg; a training leg must show compile, checkpoint and
# data_wait as nonzero numbers with `GET /goodput` serving the run
# report over HTTP and `timeline --goodput` naming the biggest thief;
# and ledger overhead must stay under 1% of step wall — FAILS
# otherwise. The record is retained (--log) so the overhead drift gate
# arms against the windowed median of prior rounds
# (SPARKTORCH_TPU_GOODPUT_DRIFT_TOL, relative, default 1.0). An A/A
# leg (no chaos) must report exactly zero downtime seconds. Runs on
# any backend (JAX_PLATFORMS=cpu works).
bench-goodput:
	$(PYTHON) -m sparktorch_tpu.bench --config goodput \
		--log benchmarks/bench_r11_goodput.jsonl

# Continuous stack-profiler gate: the sampler must cost < 1% of the
# measured step wall vs an A/A profiler-off leg (min of interleaved
# runs), a planted busy-loop inside a compute LedgerSpan must surface
# as the top self-time frame of its bucket (>= 80% of the bucket's
# samples), and two ranks' sections must merge into `GET /profile`
# with `timeline --profile` rendering the planted frame from both a
# saved document and the collector sink — FAILS otherwise. The record
# is retained (--log) so the per-tick sample-cost drift gate arms
# against the windowed median of prior rounds
# (SPARKTORCH_TPU_PROFILE_DRIFT_TOL, relative, default 1.0). Runs on
# any backend (JAX_PLATFORMS=cpu works).
bench-profile:
	$(PYTHON) -m sparktorch_tpu.bench --config profile \
		--log benchmarks/bench_r14_profile.jsonl

# Model-health observability gate: a seeded poison batch on a real
# train_distributed run must trip the NaN sentinel AT the poisoned
# step within 2 steps of the health ledger's delayed fetch, and the
# replay bundle it writes must reproduce the bad step BITWISE in a
# fresh process (`python -m sparktorch_tpu.obs.replay` exits 0); the
# latched health_nonfinite alert fires exactly one episode; an
# interleaved A/A pair must show the health fetch attributed in
# data_wait{site=health} (off arm exactly 0.0) with < 1% step-wall
# overhead and ZERO anomalies/alerts on the clean leg; the drill
# rank's section must merge rank-tagged into `GET /health` and render
# via `timeline --health`, `--follow`, and `--postmortem` — FAILS
# otherwise. The record is retained (--log) so the note_step-cost
# drift gate arms against the windowed median of prior rounds
# (SPARKTORCH_TPU_HEALTH_DRIFT_TOL, relative, default 0.5). Runs on
# any backend (JAX_PLATFORMS=cpu works).
bench-health:
	$(PYTHON) -m sparktorch_tpu.bench --config health \
		--log benchmarks/bench_r15_health.jsonl

# Cross-rank step-skew gate: a seeded 0.3s/step straggler on rank 1
# (ChaosConfig.slow_rank_s, fired before the collective fence) must
# land >= 80% of the injected seconds in the merged `GET /skew`
# document's straggler_wait_s, charged to rank 1, with the
# persistent-laggard verdict naming rank 1 and a cause hypothesis; the
# sustained skew_straggler_sustained alert latches exactly one episode
# and reaches an ElasticController as a ctl.scale_signal; an identical
# A/A fence leg (no chaos) must decompose to ~0 straggler wait with
# ZERO alert episodes; the per-step boundary stamp must cost < 1% of a
# training-representative step wall; `timeline --skew` must render the
# verdict from both the collector sink and a saved document — FAILS
# otherwise. The record is retained (--log) so the stamp-cost drift
# gate arms against the windowed median of prior rounds
# (SPARKTORCH_TPU_SKEW_DRIFT_TOL, relative, default 0.5). Runs on any
# backend (JAX_PLATFORMS=cpu works).
bench-skew:
	$(PYTHON) -m sparktorch_tpu.bench --config skew \
		--log benchmarks/bench_r16_skew.jsonl

clean:
	rm -rf build dist *.egg-info sparktorch_tpu/native/_build
