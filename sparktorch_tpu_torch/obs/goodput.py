"""Run-level goodput ledger: every second of a run, attributed — a copy of ``sparktorch_tpu/obs/goodput.py``.

:class:`GoodputLedger` is a per-rank time ledger that attributes the
full wall-clock of a run into mutually-exclusive,
collectively-exhaustive (MECE) buckets:

- ``compute``     — train-step time net of exposed comm, plus
                    directly attributed compute regions;
- ``exposed_comm``— collective and wire time not hidden under compute:
                    the step split by a comm model
                    (``comm_source``), plus direct wire waits;
- ``compile``     — compile walls: the trainers' set-up
                    (``site=train_init``) and a step during which a
                    hand-written kernel was first built and loaded,
                    plus :func:`note_compile`;
- ``checkpoint``  — snapshot save and restore walls;
- ``data_wait``   — batch placement and next-chunk waits;
- ``restart_downtime`` — death detection -> relaunch gaps (the ft
                    supervisor's and the elastic controller's recovery
                    latency window);
- ``resize_downtime``  — world shrink and grow walls;
- ``idle``        — everything unattributed (derived:
                    ``wall - sum(attributed)``, floored at 0).

Attribution happens through :class:`LedgerSpan` context managers on a
per-thread nesting stack: a child span's gross duration is subtracted
from its parent's attribution, so a checkpoint inside a step counts
once. Over-attribution (attributed > wall: spans on several threads) is
computed explicitly as ``overattributed_s``.

The ledger publishes as the ``goodput`` telemetry section plus
``goodput.*`` gauges; :func:`merge_sections` folds per-rank sections
into a run-level report. Instrumentation is ambient, like
:mod:`sparktorch_tpu_torch.ft.chaos`: a process installs its ledger
(:func:`install`, or ``with ledger.activate():``) and the instrumented
sites call the module-level :func:`span` / :func:`add`, a global read
and a None check when no ledger is active. The port's instrumented
sites: the trainers' step spans and their data, compile and eval
spans, the hogwild workers' pulls, pushes and drains, the router's
hops and retries, the health lane's read-backs, checkpoints, and the
ft supervisor's and the elastic controller's restart and resize
windows. :meth:`GoodputLedger.site_s` reads one site's seconds.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from sparktorch_tpu_torch.obs.skew import SECTION as _SKEW_SECTION
from sparktorch_tpu_torch.obs.skew import StepSkewRing
from sparktorch_tpu_torch.obs.telemetry import Telemetry, wall_ts
from sparktorch_tpu_torch.ops.roofline import PEAK_FLOPS

SECTION = "goodput"
RUN_SECTION = "goodput_run"

# The MECE bucket set. "idle" is DERIVED (wall - attributed), never
# attributed directly; "exposed_comm" is part-derived (the step-split
# share) and part-direct (wire waits).
BUCKETS = ("compute", "exposed_comm", "compile", "checkpoint",
           "data_wait", "restart_downtime", "resize_downtime", "idle")

# Buckets a LedgerSpan / add() may attribute directly. "step" is the
# pseudo-bucket train-step bodies use: its gross seconds are split
# into compute + exposed_comm at read time by the comm model.
_DIRECT_BUCKETS = ("compute", "exposed_comm", "compile", "checkpoint",
                   "data_wait", "restart_downtime", "resize_downtime",
                   "step")

PRODUCTIVE_BUCKETS = ("compute",)

# The dense bf16 peak of one H100 SXM at 700 W: the default denominator
# of mfu_honest, of the ledger's MFU and of the bench's records, which
# import both from here. The JAX package divides by its TPU's peak; pass
# peak_tflops= to compare the two formulas.
H100_BF16_PEAK_TFLOPS = PEAK_FLOPS["bfloat16"] / 1e12


def mfu_honest(achieved_tflops_per_chip: float,
               peak_tflops: float = H100_BF16_PEAK_TFLOPS) -> float:
    """Model-FLOPs utilization from honest achieved TFLOPs per chip:
    one division, shared by the ledger's MFU and its run-level merge."""
    return achieved_tflops_per_chip / peak_tflops


def achieved_tflops_per_chip(flops_total: float, wall_s: float,
                             n_chips: int = 1) -> float:
    """Honest achieved TFLOPs per chip over a wall-clock window."""
    if wall_s <= 0 or n_chips <= 0:
        return 0.0
    return flops_total / wall_s / n_chips / 1e12


def jit_cache_size(jitted: Any) -> Optional[int]:
    """The JAX package's compile probe, kept for its signature: the
    entry count of a jitted function's dispatch cache, or None for
    anything that has none. An eager PyTorch callable has no such
    cache, so in the port this returns None, as the JAX one does for a
    plain callable; the trainers probe
    :func:`~sparktorch_tpu_torch.ops._build.loads` instead."""
    probe = getattr(jitted, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:  # noqa: BLE001 - degrade, never break dispatch
        return None


# Per-thread nesting stack of open LedgerSpans (module-level: ambient
# spans from different layers must see each other's nesting).
_TLS = threading.local()

# Cross-thread view of the SAME stacks, keyed by thread ident — what
# the stack profiler (obs/profile.py) samples: sys._current_frames()
# hands it {ident: frame} and this registry answers "which ledger
# bucket is open on that thread right now". Entries live only while a
# thread has at least one open span (registered on the outermost
# __enter__, dropped on the outermost __exit__), so a dead thread's
# reused ident can never alias a stale stack. Mutated only under the
# GIL by the owning thread; readers tolerate the pop race.
_STACKS_BY_IDENT: Dict[int, List["LedgerSpan"]] = {}


def open_span_buckets() -> Dict[int, str]:
    """Snapshot {thread_ident: bucket of the innermost open span} for
    every thread currently inside a LedgerSpan. The ``step``
    pseudo-bucket reads as ``compute``: a sampler cannot split one
    stack sample by the comm model, and compute is where step samples
    overwhelmingly land. Safe to call from any thread."""
    out: Dict[int, str] = {}
    for ident, stack in list(_STACKS_BY_IDENT.items()):
        try:
            bucket = stack[-1].bucket
        except IndexError:  # lost the race with the outermost __exit__
            continue
        out[ident] = "compute" if bucket == "step" else bucket
    return out


class LedgerSpan:
    """One timed attribution region. ALWAYS times (two perf_counter
    reads, ``duration_s`` after close) so call sites can use it as
    their step clock; attributes to a ledger bucket only when a ledger
    is bound. Nesting-aware: a child's gross duration is subtracted
    from the parent's attribution (the MECE mechanism).

    ``count`` (default 1, settable before close — e.g. the number of
    fused steps a chunk dispatched) feeds the ledger's step counter
    for ``step`` spans and the per-bucket event counts otherwise.
    ``rebucket()`` may re-aim an open span (a step call discovered to
    be a compile).

    ``step`` (optional, step spans only) is the explicit step index
    the span trains — the skew ring's alignment key across ranks;
    when None the ledger's own step counter supplies it."""

    __slots__ = ("ledger", "bucket", "labels", "count", "step", "t0",
                 "duration_s", "_child_s", "_closed")

    def __init__(self, ledger: Optional["GoodputLedger"], bucket: str,
                 labels: Optional[Dict[str, Any]] = None,
                 step: Optional[int] = None):
        if bucket not in _DIRECT_BUCKETS:
            raise ValueError(
                f"bucket {bucket!r} not attributable (want one of "
                f"{_DIRECT_BUCKETS}; 'idle' is derived)")
        self.ledger = ledger
        self.bucket = bucket
        self.labels = dict(labels or {})
        self.count = 1
        self.step = step if step is None else int(step)
        self.t0 = 0.0
        self.duration_s: Optional[float] = None
        self._child_s = 0.0
        self._closed = False

    def rebucket(self, bucket: str) -> None:
        if bucket not in _DIRECT_BUCKETS:
            raise ValueError(f"bucket {bucket!r} not attributable")
        if bucket != self.bucket:
            # count semantics change with the bucket (steps for a step
            # span, events otherwise): a fused chunk re-aimed at
            # ``compile`` is ONE compile, not steps_per_call of them.
            self.count = 1
        self.bucket = bucket

    def __enter__(self) -> "LedgerSpan":
        stack: List[LedgerSpan] = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        if not stack:
            # Outermost span on this thread: expose the stack to the
            # cross-thread sampler registry.
            _STACKS_BY_IDENT[threading.get_ident()] = stack
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        dur = end - self.t0
        self.duration_s = dur
        self._closed = True
        stack: List[LedgerSpan] = getattr(_TLS, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()
        if not stack:
            _STACKS_BY_IDENT.pop(threading.get_ident(), None)
        if stack:
            # Gross duration rolls up to the parent so the parent
            # attributes only its OWN (self) time — one second of
            # wall lands in exactly one bucket.
            stack[-1]._child_s += dur
        if self.ledger is not None:
            if self.bucket == "step":
                # Step-boundary stamp for the cross-rank skew ring:
                # the span's OWN clock pair (no new clock sites),
                # recorded before _attribute so an implicit step
                # index reads the pre-increment counter.
                self.ledger._stamp_step(self.step, self.count,
                                        self.t0, end)
            self.ledger._attribute(self.bucket,
                                   max(dur - self._child_s, 0.0),
                                   self.count, self.labels.get("site"))


class GoodputLedger:
    """The per-rank run ledger. Construct at run start (the clock
    starts in the ctor), attribute through :class:`LedgerSpan` /
    :meth:`add`, read via :meth:`snapshot`, publish onto the bus via
    :meth:`publish` (throttled automatically from span closes when a
    bus is bound). Thread-safe."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 rank: Optional[Any] = None,
                 publish_interval_s: float = 0.25,
                 flops_per_step: Optional[float] = None,
                 n_chips: int = 1,
                 peak_tflops: float = H100_BF16_PEAK_TFLOPS,
                 skew_capacity: int = 512):
        self.telemetry = telemetry
        self.rank = rank
        self.publish_interval_s = float(publish_interval_s)
        self.flops_per_step = flops_per_step
        self.n_chips = int(n_chips)
        self.peak_tflops = float(peak_tflops)
        # Concurrent execution LANES attributing into this ledger
        # (e.g. train_async's N local worker threads — each thread is
        # a lane of real work, so the MECE budget is lanes x clock
        # wall, the same rank-seconds unit the run-level merge uses).
        # A single-threaded trainer leaves this at 1. Without it, N
        # threads would attribute ~N x wall and read as massive
        # over-attribution with goodput > 1.
        self.lanes = 1
        # Per-step boundary stamps for the cross-rank straggler
        # referee (obs/skew.py): step spans stamp their enter/exit
        # here, converted to wall time through the ctor anchor pair
        # below so stamps from different processes are comparable.
        self.skew = StepSkewRing(skew_capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.started_ts = wall_ts()
        self._buckets: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._site_s: Dict[Tuple[str, str], float] = {}
        self._step_s = 0.0
        self._n_steps = 0
        self._compiles = 0
        # Step-seconds comm split: fraction of step gross that is
        # exposed collective time. "measured" (an analyzed
        # device trace), "estimate" (the alpha-beta model), or "none"
        # (no model: all step time counts as compute, labeled so).
        self._comm_fraction = 0.0
        self._comm_source = "none"
        self._last_publish = 0.0
        self._closed_ts: Optional[float] = None
        self._auto_stop: Optional[threading.Event] = None

    # -- attribution ---------------------------------------------------------

    def span(self, bucket: str,
             labels: Optional[Dict[str, Any]] = None) -> LedgerSpan:
        return LedgerSpan(self, bucket, labels)

    def step_span(self, step: Optional[int] = None) -> LedgerSpan:
        """A train-step body: gross seconds split compute vs
        exposed_comm by the comm model at read time; ``count`` is the
        number of (fused) steps the call trained. ``step`` pins the
        skew ring's alignment key (trainers pass their loop index so
        ranks agree on which step is which); None falls back to this
        ledger's own step counter."""
        return LedgerSpan(self, "step", step=step)

    def add(self, bucket: str, seconds: float, count: int = 1) -> None:
        """Direct attribution (no timing) — the downtime buckets'
        entry point: the controller/supervisor already measured the
        detection->relaunch gap."""
        if bucket not in _DIRECT_BUCKETS:
            raise ValueError(f"bucket {bucket!r} not attributable")
        self._attribute(bucket, max(float(seconds), 0.0), count)

    def _stamp_step(self, step: Optional[int], count: int,
                    t0: float, t1: float) -> None:
        """Record one step span's boundary pair into the skew ring.
        ``t0``/``t1`` are the span's perf_counter reads; the ctor
        anchor pair (``started_ts``/``_t0``) converts them to wall
        time — pure arithmetic, zero new clock sites."""
        if step is None:
            with self._lock:
                step = self._n_steps  # pre-increment: _attribute runs after
        base = self.started_ts - self._t0
        self.skew.record(int(step), count, base + t0, base + t1)

    def _attribute(self, bucket: str, seconds: float, count: int,
                   site: Optional[str] = None) -> None:
        with self._lock:
            if site is not None:
                key = (bucket, str(site))
                self._site_s[key] = self._site_s.get(key, 0.0) + seconds
            if bucket == "step":
                self._step_s += seconds
                self._n_steps += int(count)
            else:
                self._buckets[bucket] = (self._buckets.get(bucket, 0.0)
                                         + seconds)
                self._counts[bucket] = (self._counts.get(bucket, 0)
                                        + int(count))
                if bucket == "compile":
                    self._compiles += int(count)
            due = (self.telemetry is not None
                   and time.perf_counter() - self._last_publish
                   >= self.publish_interval_s)
        if due:
            self.publish()

    def note_compile(self, seconds: float, site: str = "?") -> None:
        """A detected compile wall —
        sugar over ``add('compile', ...)`` that also counts the site."""
        self.add("compile", seconds)
        if self.telemetry is not None:
            self.telemetry.counter("goodput.compiles_total",
                                   labels={"site": site})

    def set_comm_model(self, fraction: float, source: str) -> None:
        """Install the step-seconds comm split: ``fraction`` of step
        gross is exposed collective time. ``source`` is ``measured``
        (an analyzed capture — always wins) or ``estimate`` (the
        alpha-beta model — never overwrites a measured split)."""
        if source not in ("measured", "estimate"):
            raise ValueError(f"comm source {source!r} "
                             "(want measured|estimate)")
        with self._lock:
            if source == "estimate" and self._comm_source == "measured":
                return
            self._comm_fraction = min(max(float(fraction), 0.0), 1.0)
            self._comm_source = source

    def apply_analysis(self, analysis: Any) -> None:
        """Adopt an analysis's measured exposed-comm fraction (an object
        or a mapping with ``exposed_comm_fraction``), retroactively: the
        split is applied to ALL step seconds at read time, so the
        estimate a run started under is replaced, not blended."""
        frac = getattr(analysis, "exposed_comm_fraction", None)
        if frac is None and isinstance(analysis, Mapping):
            frac = analysis.get("exposed_comm_fraction")
        if frac is not None:
            self.set_comm_model(float(frac), "measured")

    # -- reading -------------------------------------------------------------

    def site_s(self, bucket: str, site: str) -> float:
        """Seconds attributed to ``bucket`` by spans labelled
        ``site=<site>`` (e.g. ``data_wait{site=health}``, the health
        lane's read-backs). A port addition: the JAX ledger keeps only
        the bucket totals, which :meth:`snapshot` reports alike."""
        with self._lock:
            return self._site_s.get((bucket, str(site)), 0.0)

    def wall_s(self) -> float:
        with self._lock:
            return self._wall_locked()

    def _wall_locked(self) -> float:
        if self._closed_ts is not None:
            return self._closed_ts - self._t0
        return time.perf_counter() - self._t0

    def snapshot(self) -> Dict[str, Any]:
        """The MECE accounting NOW: bucket seconds + fractions, idle
        derived, goodput = productive / wall, comm-source label, and
        MFU when the workload declared FLOPs. ``wall_s`` is the MECE
        budget — clock wall x lanes (lane-seconds, the same
        rank-seconds unit the run merge sums); ``clock_s`` is the raw
        single-clock wall."""
        with self._lock:
            clock = self._wall_locked()
            lanes = max(1, int(self.lanes))
            wall = clock * lanes
            buckets = dict(self._buckets)
            counts = dict(self._counts)
            step_s = self._step_s
            n_steps = self._n_steps
            frac = self._comm_fraction
            source = self._comm_source
        exposed_from_steps = step_s * frac
        buckets["compute"] = (buckets.get("compute", 0.0)
                              + step_s - exposed_from_steps)
        buckets["exposed_comm"] = (buckets.get("exposed_comm", 0.0)
                                   + exposed_from_steps)
        attributed = sum(buckets.values())
        idle = max(wall - attributed, 0.0)
        over = max(attributed - wall, 0.0)
        buckets["idle"] = idle
        full = {b: round(buckets.get(b, 0.0), 6) for b in BUCKETS}
        denom = max(wall, 1e-9)
        productive = sum(full[b] for b in PRODUCTIVE_BUCKETS)
        doc: Dict[str, Any] = {
            "rank": self.rank,
            "started_ts": self.started_ts,
            "wall_s": round(wall, 6),
            "clock_s": round(clock, 6),
            "lanes": lanes,
            "buckets": full,
            "fractions": {b: round(full[b] / denom, 6) for b in BUCKETS},
            "counts": counts,
            "n_steps": n_steps,
            "compiles": self._compiles,
            "goodput": round(productive / denom, 6),
            "comm_source": source,
            "overattributed_s": round(over, 6),
        }
        if self.flops_per_step:
            flops_total = float(self.flops_per_step) * n_steps
            achieved = achieved_tflops_per_chip(flops_total, wall,
                                                self.n_chips)
            doc["flops_per_step"] = float(self.flops_per_step)
            # n_chips/peak ride the doc so the run-level merge divides
            # by this rank's REAL capacity, not an assumed 1 chip at
            # the default peak — /goodput must agree with the per-rank
            # docs it embeds.
            doc["n_chips"] = self.n_chips
            doc["peak_tflops"] = self.peak_tflops
            doc["achieved_tflops_per_chip"] = round(achieved, 4)
            doc["mfu"] = round(mfu_honest(achieved, self.peak_tflops), 6)
        return doc

    # -- publication ---------------------------------------------------------

    def publish(self, event: bool = False) -> Dict[str, Any]:
        """Refresh the bus's ``goodput`` section + ``goodput.*``
        gauges (the series the history tier retains and alert rules
        judge). ``event=True`` additionally emits one ``goodput.ledger``
        event to the sinks, a condensed record of the run."""
        doc = self.snapshot()
        with self._lock:
            self._last_publish = time.perf_counter()
        tele = self.telemetry
        if tele is None:
            return doc
        tele.set_section(SECTION, doc)
        if len(self.skew):
            # The skew section rides beside goodput only once a step
            # has stamped — a server/ctl ledger with no step spans
            # must not publish an empty ring (the collector's /skew
            # stays 404 until a real stamp exists).
            sdoc = self.skew.snapshot()
            sdoc["rank"] = self.rank
            sdoc["started_ts"] = self.started_ts
            tele.set_section(_SKEW_SECTION, sdoc)
        labels = ({"rank": str(self.rank)}
                  if self.rank is not None else None)
        for b in BUCKETS:
            tele.gauge(f"goodput.{b}_s", doc["buckets"][b], labels=labels)
        tele.gauge("goodput.fraction", doc["goodput"], labels=labels)
        tele.gauge("goodput.wall_s", doc["wall_s"], labels=labels)
        tele.gauge("goodput.overattributed_s", doc["overattributed_s"],
                   labels=labels)
        if "mfu" in doc:
            tele.gauge("goodput.mfu", doc["mfu"], labels=labels)
        if event:
            thief = biggest_thief(doc)
            tele.event("goodput.ledger", rank=self.rank,  # lint-obs: ok (rank IS this record's identity: per-rank ledger event on the local bus, no collector tag to collide with)
                       wall_s=doc["wall_s"], goodput=doc["goodput"],
                       comm_source=doc["comm_source"],
                       thief=(thief[0] if thief else None),
                       thief_s=(round(thief[1], 6) if thief else None))
        return doc

    def start_auto_publish(self, interval_s: float = 0.5
                           ) -> "GoodputLedger":
        """Background refresh of the published section on a cadence —
        for long-lived processes (ctl workers, servers) whose ledger
        would otherwise only publish when something is attributed,
        leaving the scraped ``wall_s`` stale between events. Daemon
        thread; close() stops it."""
        if self._auto_stop is not None or self.telemetry is None:
            return self
        stop = self._auto_stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                self.publish()

        threading.Thread(target=loop, daemon=True,
                         name="goodput-publish").start()
        return self

    def close(self) -> Dict[str, Any]:
        """Freeze the clock and publish the final accounting (with the
        ``goodput.ledger`` sink record): a finished run's last ledger
        survives in the section for whoever scrapes it."""
        with self._lock:
            if self._closed_ts is None:
                self._closed_ts = time.perf_counter()
        if self._auto_stop is not None:
            self._auto_stop.set()
        return self.publish(event=True)

    # -- ambient installation ------------------------------------------------

    @contextlib.contextmanager
    def activate(self):
        """Install this ledger as the process-global ambient ledger
        for a with-block (the chaos-injector shape: instrumentation
        points deep inside worker/writer threads reach it without a
        handle threaded through every layer). Always restores the
        previous ledger; closes this one on exit."""
        prev = install(self)
        try:
            yield self
        finally:
            install(prev)
            self.close()


# ---------------------------------------------------------------------------
# Ambient (process-global) ledger + no-op-cheap helpers
# ---------------------------------------------------------------------------

_ACTIVE: Optional[GoodputLedger] = None
_ACTIVE_LOCK = threading.Lock()


def install(ledger: Optional[GoodputLedger]) -> Optional[GoodputLedger]:
    """Swap the ambient ledger; returns the previous one."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, ledger
    return prev


def active() -> Optional[GoodputLedger]:
    return _ACTIVE


def span(bucket: str, labels: Optional[Dict[str, Any]] = None
         ) -> LedgerSpan:
    """A :class:`LedgerSpan` bound to the ambient ledger (or unbound —
    it still times, so call sites can use ``duration_s`` as their
    step clock whether or not a ledger is active)."""
    return LedgerSpan(_ACTIVE, bucket, labels)


def step_span(step: Optional[int] = None) -> LedgerSpan:
    return LedgerSpan(_ACTIVE, "step", step=step)


def add(bucket: str, seconds: float, count: int = 1) -> None:
    """Direct attribution to the ambient ledger; no-op without one."""
    ledger = _ACTIVE
    if ledger is not None:
        ledger.add(bucket, seconds, count)


def note_compile(seconds: float, site: str = "?") -> None:
    ledger = _ACTIVE
    if ledger is not None:
        ledger.note_compile(seconds, site=site)


def set_comm_model(fraction: float, source: str) -> None:
    ledger = _ACTIVE
    if ledger is not None:
        ledger.set_comm_model(fraction, source)


# ---------------------------------------------------------------------------
# Run-level merge (the collector's /goodput)
# ---------------------------------------------------------------------------


def biggest_thief(doc: Mapping[str, Any],
                  exclude: Tuple[str, ...] = ("compute",)
                  ) -> Optional[Tuple[str, float]]:
    """The largest non-compute bucket of a ledger/run doc — the one
    number an operator acts on. None when nothing is attributed."""
    buckets = doc.get("buckets") or {}
    ranked = sorted(((b, float(s)) for b, s in buckets.items()
                     if b not in exclude and s > 0),
                    key=lambda kv: -kv[1])
    return ranked[0] if ranked else None


def merge_sections(rank_docs: Mapping[Any, Mapping[str, Any]],
                   skew: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Fold per-rank ``goodput`` sections into ONE run-level report —
    the run-level report. Bucket seconds SUM across ranks (a
    rank-second is the unit: 2 ranks idle for 1s is 2 rank-seconds of
    idle), wall sums likewise, and the run goodput fraction is
    productive rank-seconds over total rank-seconds. MFU aggregates
    flops-weighted over the ranks that declared FLOPs. The per-rank
    docs ride along.

    ``skew`` (a merged ``skew_run`` doc from
    :func:`sparktorch_tpu_torch.obs.skew.merge_sections`, when the caller —
    the collector — has one) refines ``biggest_thief``: when the
    thief is ``exposed_comm`` and straggler wait dominates wire, the
    thief is renamed ``straggler_wait`` with the laggard rank, so the
    one number an operator acts on points at the slow rank instead of
    the collective."""
    per_rank: Dict[str, Dict[str, Any]] = {}
    buckets = {b: 0.0 for b in BUCKETS}
    counts: Dict[str, int] = {}
    wall = 0.0
    n_steps = 0
    compiles = 0
    over = 0.0
    sources = set()
    flops_total = 0.0
    chip_seconds = 0.0
    peak_flop_seconds = 0.0  # aggregate capacity of the flops ranks
    for rank, doc in sorted(rank_docs.items(), key=lambda kv: str(kv[0])):
        if not isinstance(doc, Mapping) or "buckets" not in doc:
            continue
        per_rank[str(rank)] = dict(doc)
        for b in BUCKETS:
            buckets[b] += float((doc["buckets"] or {}).get(b, 0.0))
        for b, n in (doc.get("counts") or {}).items():
            counts[b] = counts.get(b, 0) + int(n)
        wall += float(doc.get("wall_s") or 0.0)
        n_steps += int(doc.get("n_steps") or 0)
        compiles += int(doc.get("compiles") or 0)
        over += float(doc.get("overattributed_s") or 0.0)
        sources.add(str(doc.get("comm_source") or "none"))
        if doc.get("flops_per_step"):
            rank_chips = int(doc.get("n_chips") or 1)
            rank_peak = float(doc.get("peak_tflops")
                              or H100_BF16_PEAK_TFLOPS)
            rank_wall = float(doc.get("wall_s") or 0.0)
            flops_total += (float(doc["flops_per_step"])
                            * int(doc.get("n_steps") or 0))
            chip_seconds += rank_wall * rank_chips
            peak_flop_seconds += rank_wall * rank_chips * rank_peak * 1e12
    denom = max(wall, 1e-9)
    productive = sum(buckets[b] for b in PRODUCTIVE_BUCKETS)
    run: Dict[str, Any] = {
        "kind": "goodput_run",
        "ts": wall_ts(),
        "n_ranks": len(per_rank),
        "wall_s": round(wall, 6),
        "buckets": {b: round(s, 6) for b, s in buckets.items()},
        "fractions": {b: round(s / denom, 6) for b, s in buckets.items()},
        "counts": counts,
        "n_steps": n_steps,
        "compiles": compiles,
        "goodput": round(productive / denom, 6),
        "overattributed_s": round(over, 6),
        # One label for the whole run: measured wins only when EVERY
        # contributing rank measured; a mixed run is labeled mixed so
        # nobody mistakes a half-estimated number for ground truth.
        "comm_source": (sources.pop() if len(sources) == 1 else "mixed"),
        "per_rank": per_rank,
    }
    thief = biggest_thief(run)
    if thief:
        run["biggest_thief"] = {"bucket": thief[0],
                                "seconds": round(thief[1], 6),
                                "fraction": round(thief[1] / denom, 6)}
        if thief[0] == "exposed_comm" and isinstance(skew, Mapping):
            straggler = float(skew.get("straggler_wait_s") or 0.0)
            wire = float(skew.get("wire_s") or 0.0)
            if straggler > wire and straggler > 0:
                bt = run["biggest_thief"]
                bt["bucket"] = "straggler_wait"
                bt["of"] = "exposed_comm"
                bt["seconds"] = round(straggler, 6)
                bt["fraction"] = round(straggler / denom, 6)
                lag = (skew.get("laggard") or {}).get("rank")
                if lag is not None:
                    bt["laggard"] = lag
    if flops_total > 0 and chip_seconds > 0:
        # Per-chip rate over the flops-declaring ranks' chip-seconds;
        # MFU against their AGGREGATE capacity (each rank's own chip
        # count and peak) — so the run report can never disagree with
        # the per-rank docs it embeds.
        achieved = achieved_tflops_per_chip(flops_total, chip_seconds)
        run["achieved_tflops_per_chip"] = round(achieved, 4)
        run["mfu"] = round(flops_total / peak_flop_seconds, 6)
    return run


def sections_from_snapshots(snapshots: Mapping[Any, Optional[Mapping]]
                            ) -> Dict[Any, Mapping[str, Any]]:
    """Pull each rank's ``goodput`` section out of its (last-good)
    telemetry snapshot; ranks without one are skipped."""
    out: Dict[Any, Mapping[str, Any]] = {}
    for rank, snap in snapshots.items():
        section = ((snap or {}).get("sections") or {}).get(SECTION)
        if isinstance(section, Mapping):
            out[rank] = section
    return out
