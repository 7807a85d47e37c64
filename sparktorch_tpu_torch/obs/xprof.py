"""Offline trace analysis: per-collective time attribution — the port of ``sparktorch_tpu/obs/xprof.py`` for ``torch.profiler``'s Chrome traces.

The tracing hooks (:mod:`sparktorch_tpu_torch.utils.tracing`) capture
``torch.profiler`` traces and mark each dispatched step as a
``train_step`` range. This module machine-reads the Chrome-trace JSON,
slices it by those ranges, and attributes the time within a step to
collective families (all-reduce, all-gather, all-to-all,
reduce-scatter, permute, send/recv) versus compute — then publishes the
result onto the :class:`~sparktorch_tpu_torch.obs.Telemetry` bus under
the JAX package's ``xprof.*`` names, so a ``/metrics`` scrape, a
``/telemetry`` read and a ``--telemetry-dump`` JSONL all show the same
budget. It is backend-free: JSON only, no torch import.

Trace shape (``torch.profiler.export_chrome_trace``): ``traceEvents``
holds ``ph == "X"`` complete events with ``ts``/``dur`` in
microseconds and a ``cat``:

- ``kernel``, ``gpu_memcpy``, ``gpu_memset`` — work on the card (its
  streams are the trace's device lanes);
- ``cpu_op`` (ATen and c10d operators), ``python_function``,
  ``cuda_runtime``/``cuda_driver`` (launch calls) — host work;
- ``user_annotation`` — a ``record_function`` range on the host, such
  as ``train_step`` (a range's args, the step number among them, are
  not exported: steps carry ``step = None`` unless an event has
  ``args.step_num``), and the ``gloo:*`` ranges on gloo's own threads;
- ``gpu_user_annotation`` — a range's projection onto the card: from
  the first to the end of the last kernel launched inside it.

Which events belong to a step: a step's kernels run after its host
range closes, so on a trace with device work the steps are sliced by
the ``gpu_user_annotation`` projections of ``train_step`` (the host
ranges where no projection exists); a CPU-only trace is sliced by the
host ranges. Device ops are the device-lane events on a CUDA trace;
on a CPU-only trace, where the host is the device, they are the
``cpu_op`` events and the ``gloo:``/``nccl:`` ranges, an operator
nested inside a collective counted as the collective's. Collectives
(:func:`classify_op`): on the card the NCCL kernels
(``ncclDevKernel_AllReduce_*``, ``ncclKernel_AllGather_*``,
``ncclDevKernel_ReduceScatter_*``, ``ncclDevKernel_SendRecv``, ...);
on the host the c10d operators (``c10d::allreduce_``,
``c10d::_allgather_base_``, ...) and the gloo and NCCL ranges
(``gloo:all_reduce``, ``nccl:all_reduce``, ...). The host's calls also
count on a CUDA trace where no collective ran on the card (gloo with
CUDA tensors; an NCCL world of one, where NCCL launches no kernel):
there the communication happened on the host, one call each. A broadcast (``ncclDevKernel_Broadcast``,
``c10d::broadcast_``, ``gloo:broadcast``) goes to ``send_recv``, where
the JAX package puts ``collective-broadcast``. Every other device op is
compute.

Time accounting per step (seconds, union of intervals, so N device
lanes running the same collective count its wall once):

- ``collective_time_s{op=<family>}``: wall with >=1 event of that
  family in flight;
- ``comm_s``: wall with >=1 collective of any family in flight;
- ``compute_s``: wall with >=1 non-collective device op in flight;
- ``overlap_s``: wall where both hold — collective time hidden under
  compute; ``overlap_fraction = overlap_s / comm_s``;
- ``comm_fraction = comm_s / window_s`` where ``window_s`` is the
  step's attribution slice (its range's start to the next range's
  start) and ``wall_s`` is the range's own duration.

The HLO text parser of the JAX module (``hlo_collective_bytes``) has no
counterpart yet (ROADMAP, Queue 1, step 6, with ``moe_a2a``).
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from sparktorch_tpu_torch.obs.log import get_logger

_LOG = get_logger("sparktorch_tpu_torch.obs.xprof")

US = 1e-6  # chrome-trace ts/dur unit -> seconds


class TraceParseError(ValueError):
    """The file is not a readable Chrome-trace capture."""


# ---------------------------------------------------------------------------
# Op classification
# ---------------------------------------------------------------------------

# Ordered: first match wins. Patterns are substring matches against
# the lowercased op name: the JAX package's HLO spellings, plus the
# NCCL kernels' camel case ("ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
# and c10d's and gloo's snake case ("c10d::reduce_scatter_",
# "gloo:all_reduce").
COLLECTIVE_FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("all_reduce", ("all-reduce", "allreduce", "all_reduce",
                    "cross-replica-sum")),
    ("reduce_scatter", ("reduce-scatter", "reducescatter",
                        "reduce_scatter")),
    ("all_gather", ("all-gather", "allgather", "all_gather")),
    ("all_to_all", ("all-to-all", "alltoall", "all_to_all")),
    ("ppermute", ("collective-permute", "collectivepermute", "ppermute")),
    # Point-to-point + broadcast: the short patterns go LAST so the
    # structured families above win on names containing both.
    ("send_recv", ("collective-broadcast", "broadcast", "send", "recv")),
)

FAMILY_NAMES: Tuple[str, ...] = tuple(f for f, _ in COLLECTIVE_FAMILIES)

#: Event categories of work on the card.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: Prefixes of the names that may be collectives: NCCL kernels on the
#: card; c10d operators and gloo/NCCL ranges on the host.
_COLLECTIVE_PREFIXES = ("nccl", "c10d::", "gloo:")


def classify_op(name: str) -> Optional[str]:
    """Collective family for an op name, or None (compute/other)."""
    low = name.lower()
    for family, patterns in COLLECTIVE_FAMILIES:
        for pat in patterns:
            if pat in low:
                return family
    return None


def _family(name: str) -> Optional[str]:
    """:func:`classify_op` for names of communication libraries only: a
    compute kernel whose templated name happens to hold ``send`` or
    ``broadcast`` stays compute."""
    low = name.lower()
    return classify_op(name) if low.startswith(_COLLECTIVE_PREFIXES) \
        else None


# ---------------------------------------------------------------------------
# Interval math (all inputs/outputs in seconds)
# ---------------------------------------------------------------------------


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge into disjoint sorted intervals."""
    if not intervals:
        return []
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _measure(merged: List[Tuple[float, float]]) -> float:
    return sum(t1 - t0 for t0, t1 in merged)


def _intersection_measure(a: List[Tuple[float, float]],
                          b: List[Tuple[float, float]]) -> float:
    """Measure of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def find_trace_file(path: str) -> str:
    """Resolve a capture location to one trace file: the path itself
    if it is a file, else the newest ``*.trace.json(.gz)`` under it
    (``profile_run`` writes ``<log_dir>/<host>_<pid>.<ns>.pt.trace.json``;
    a ``.pt.trace.json`` name ends in ``.trace.json``)."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        raise TraceParseError(f"no trace at {path!r}")
    hits: List[str] = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json"):
        hits.extend(glob.glob(os.path.join(glob.escape(path), pat),
                              recursive=True))
    if not hits:
        raise TraceParseError(f"no *.trace.json(.gz) under {path!r}")
    return max(hits, key=os.path.getmtime)


def load_trace(path: str) -> Dict[str, Any]:
    """Parse one Chrome-trace JSON file (gzipped or plain). Raises
    :class:`TraceParseError` on anything that is not a trace capture
    (truncated gzip, invalid JSON, missing/ill-typed ``traceEvents``)
    — a torn capture from a killed run must fail loudly, not
    half-analyze."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:  # type: ignore[operator]
            data = json.load(f)
    except (OSError, EOFError, ValueError) as e:
        raise TraceParseError(f"unreadable trace {path!r}: {e}") from e
    if not isinstance(data, dict) or not isinstance(
            data.get("traceEvents"), list):
        raise TraceParseError(
            f"{path!r} is not a Chrome trace (no traceEvents list)"
        )
    return data


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepAttribution:
    """Where one step's time went."""

    step: Optional[int]          # step_num (None: whole-trace pseudo-step)
    wall_s: float                # the step annotation's own duration
    window_s: float              # attribution slice span (start->next start)
    compute_s: float             # union wall of non-collective device ops
    comm_s: float                # union wall of all collectives
    overlap_s: float             # comm wall hidden under compute
    families: Dict[str, float]   # union wall per collective family
    counts: Dict[str, int]       # collective event counts per family

    @property
    def comm_fraction(self) -> float:
        return self.comm_s / self.window_s if self.window_s > 0 else 0.0

    @property
    def overlap_fraction(self) -> float:
        return self.overlap_s / self.comm_s if self.comm_s > 0 else 0.0

    @property
    def exposed_comm_s(self) -> float:
        """Collective wall NOT hidden under compute — the part of the
        step a better layout/schedule could still reclaim."""
        return max(self.comm_s - self.overlap_s, 0.0)

    @property
    def exposed_comm_fraction(self) -> float:
        return (self.exposed_comm_s / self.window_s
                if self.window_s > 0 else 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "wall_s": self.wall_s,
            "window_s": self.window_s,
            "compute_s": self.compute_s,
            "comm_s": self.comm_s,
            "overlap_s": self.overlap_s,
            "exposed_comm_s": self.exposed_comm_s,
            "comm_fraction": self.comm_fraction,
            "overlap_fraction": self.overlap_fraction,
            "families": dict(self.families),
            "counts": dict(self.counts),
        }


@dataclasses.dataclass
class TraceAnalysis:
    """The whole capture, attributed."""

    source: str
    steps: List[StepAttribution]
    top_ops: List[Dict[str, Any]]
    n_events: int                # X events seen
    n_device_events: int         # classified as device op executions
    n_collective_events: int
    n_unattributed: int          # device ops outside every step window
    n_markers: int = 0           # step annotations found in the trace
    markers_overlap: bool = False  # concurrent markers -> not sliceable

    # -- aggregates --------------------------------------------------------

    @property
    def wall_s(self) -> float:
        return sum(s.wall_s for s in self.steps)

    @property
    def comm_s(self) -> float:
        return sum(s.comm_s for s in self.steps)

    @property
    def compute_s(self) -> float:
        return sum(s.compute_s for s in self.steps)

    @property
    def overlap_s(self) -> float:
        return sum(s.overlap_s for s in self.steps)

    @property
    def comm_fraction(self) -> float:
        window = sum(s.window_s for s in self.steps)
        return self.comm_s / window if window > 0 else 0.0

    @property
    def overlap_fraction(self) -> float:
        return self.overlap_s / self.comm_s if self.comm_s > 0 else 0.0

    @property
    def exposed_comm_s(self) -> float:
        return sum(s.exposed_comm_s for s in self.steps)

    @property
    def exposed_comm_fraction(self) -> float:
        """Exposed (non-overlapped) collective wall over the total
        attribution window — the auto-tuner's secondary objective
        (:mod:`sparktorch_tpu.parallel.tune`): of two configs with
        equal step wall, prefer the one whose comm is hidden."""
        window = sum(s.window_s for s in self.steps)
        return self.exposed_comm_s / window if window > 0 else 0.0

    def step_wall_stats(self) -> Dict[str, float]:
        """Per-step wall roll-up for scoring: the MEDIAN is the
        decision variable (one GC pause or scheduler hiccup must not
        crown a config), the p75-p25 ``spread_s`` is the measurement
        noise floor an auto-tuner's early stop compares leads
        against. Zeros when the capture had no steps."""
        return wall_stats([s.wall_s for s in self.steps])

    def family_s(self) -> Dict[str, float]:
        out = {f: 0.0 for f in FAMILY_NAMES}
        for s in self.steps:
            for fam, sec in s.families.items():
                out[fam] += sec
        return {f: v for f, v in out.items() if v > 0}

    def family_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.steps:
            for fam, n in s.counts.items():
                out[fam] = out.get(fam, 0) + n
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "source": self.source,
            "n_steps": len(self.steps),
            "n_markers": self.n_markers,
            "markers_overlap": self.markers_overlap,
            "n_events": self.n_events,
            "n_device_events": self.n_device_events,
            "n_collective_events": self.n_collective_events,
            "n_unattributed": self.n_unattributed,
            "wall_s": self.wall_s,
            "comm_s": self.comm_s,
            "compute_s": self.compute_s,
            "overlap_s": self.overlap_s,
            "exposed_comm_s": self.exposed_comm_s,
            "comm_fraction": self.comm_fraction,
            "overlap_fraction": self.overlap_fraction,
            "exposed_comm_fraction": self.exposed_comm_fraction,
            "collective_s": self.family_s(),
            "collective_counts": self.family_counts(),
            "steps": [s.to_dict() for s in self.steps],
            "top_ops": list(self.top_ops),
        }

    # -- bus publication ---------------------------------------------------

    def publish(self, telemetry=None) -> None:
        """Put the attribution on the telemetry bus. One histogram
        sample PER STEP (so p50/p99 across steps are meaningful), the
        event-count counters, whole-run fractions as gauges, and one
        ``xprof_analysis`` event with the condensed summary — the same
        state a ``/metrics`` scrape and a ``--telemetry-dump`` JSONL
        then both render."""
        from sparktorch_tpu_torch.obs.telemetry import get_telemetry

        tele = telemetry or get_telemetry()
        for s in self.steps:
            tele.observe("xprof.step_wall_s", s.wall_s)
            tele.observe("xprof.compute_s", s.compute_s)
            tele.observe("xprof.comm_s", s.comm_s)
            tele.observe("xprof.comm_fraction", s.comm_fraction)
            tele.observe("xprof.overlap_fraction", s.overlap_fraction)
            for fam, sec in s.families.items():
                tele.observe("xprof.collective_time_s", sec,
                             labels={"op": fam})
        for fam, n in self.family_counts().items():
            tele.counter("xprof.collectives_total", n, labels={"op": fam})
        tele.counter("xprof.steps_total", len(self.steps))
        tele.counter("xprof.analyses_total")
        tele.gauge("xprof.comm_fraction_run", self.comm_fraction)
        tele.gauge("xprof.overlap_fraction_run", self.overlap_fraction)
        tele.event(
            "xprof_analysis",
            source=self.source,
            n_steps=len(self.steps),
            n_collective_events=self.n_collective_events,
            comm_s=self.comm_s,
            compute_s=self.compute_s,
            overlap_s=self.overlap_s,
            comm_fraction=self.comm_fraction,
            overlap_fraction=self.overlap_fraction,
            collective_s=self.family_s(),
            top_ops=self.top_ops[:5],
        )
        # The full analysis also rides the snapshot as a SECTION: a
        # /telemetry scrape then carries the per-step attribution a
        # fleet collector needs to fold N ranks into one gang budget
        # (merge_analyses) — rolled-up metrics alone cannot be merged
        # (max'd step walls and cross-rank skew need per-step data).
        tele.set_section("xprof", self.to_dict())


def wall_stats(walls) -> Dict[str, float]:
    """Median / mean / min / max / p75-p25 spread over a wall list —
    THE wall roll-up shared by :meth:`TraceAnalysis.step_wall_stats`
    and the auto-tuner's cross-round aggregation
    (:mod:`sparktorch_tpu.parallel.tune`), so the noise floor a lead
    is judged against is computed with the same math as the
    per-candidate stats it compares. Zeros when empty."""
    ws = sorted(float(w) for w in walls)
    if not ws:
        return {"n": 0, "median_s": 0.0, "mean_s": 0.0,
                "min_s": 0.0, "max_s": 0.0, "spread_s": 0.0}
    n = len(ws)
    mid = n // 2
    median = ws[mid] if n % 2 else 0.5 * (ws[mid - 1] + ws[mid])

    def _pct(q: float) -> float:
        # Linear interpolation, numpy 'linear' convention.
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return ws[lo] + (ws[hi] - ws[lo]) * (pos - lo)

    return {
        "n": n,
        "median_s": median,
        "mean_s": sum(ws) / n,
        "min_s": ws[0],
        "max_s": ws[-1],
        "spread_s": max(_pct(0.75) - _pct(0.25), 0.0),
    }


# ---------------------------------------------------------------------------
# Cross-host (gang) merge
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GangStepAttribution:
    """One training step across the whole gang.

    Walls are MAX'd across ranks (the gang proceeds at the slowest
    rank's pace); device-seconds (compute/comm/overlap, per-family)
    are SUMMED (total chip-time the gang spent); ``skew_s`` is the
    spread between the slowest and fastest rank's step wall — the
    straggler signal at trace resolution, always >= 0."""

    step: Optional[int]
    wall_s: float                # max over ranks
    window_s: float              # max over ranks
    compute_s: float             # sum over ranks
    comm_s: float                # sum over ranks
    overlap_s: float             # sum over ranks
    skew_s: float                # max(wall) - min(wall) over ranks
    n_ranks: int                 # ranks contributing to this step
    families: Dict[str, float]   # summed per collective family
    counts: Dict[str, int]       # summed event counts per family
    ranks: Dict[str, Dict[str, float]]  # per-rank lane detail

    @property
    def comm_fraction(self) -> float:
        # Fraction of the gang's total device-time budget for this
        # step (n_ranks concurrent windows) spent with a collective in
        # flight somewhere.
        denom = self.n_ranks * self.window_s
        return self.comm_s / denom if denom > 0 else 0.0

    @property
    def overlap_fraction(self) -> float:
        return self.overlap_s / self.comm_s if self.comm_s > 0 else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "wall_s": self.wall_s,
            "window_s": self.window_s,
            "compute_s": self.compute_s,
            "comm_s": self.comm_s,
            "overlap_s": self.overlap_s,
            "skew_s": self.skew_s,
            "n_ranks": self.n_ranks,
            "comm_fraction": self.comm_fraction,
            "overlap_fraction": self.overlap_fraction,
            "families": dict(self.families),
            "counts": dict(self.counts),
            "ranks": {r: dict(v) for r, v in self.ranks.items()},
        }


@dataclasses.dataclass
class GangAnalysis:
    """N per-host :class:`TraceAnalysis` folded into one gang budget
    (the multi-host half of the Dapper gap: per-rank traces exist, this
    is the whole-gang view). Same ``publish()`` contract as the
    per-rank analysis, so gang numbers ride the existing
    bus/scrape/dump plumbing under ``xprof.gang_*`` names."""

    sources: List[str]
    n_ranks: int
    steps: List[GangStepAttribution]
    run_id: Optional[str] = None

    # -- aggregates (gang semantics: walls max'd, seconds summed) ----------

    @property
    def wall_s(self) -> float:
        return sum(s.wall_s for s in self.steps)

    @property
    def comm_s(self) -> float:
        return sum(s.comm_s for s in self.steps)

    @property
    def compute_s(self) -> float:
        return sum(s.compute_s for s in self.steps)

    @property
    def overlap_s(self) -> float:
        return sum(s.overlap_s for s in self.steps)

    @property
    def step_skew_s(self) -> float:
        """Worst cross-rank step-wall spread in the capture (>= 0)."""
        return max((s.skew_s for s in self.steps), default=0.0)

    @property
    def comm_fraction(self) -> float:
        # Recomputed over the union of every rank's attribution
        # windows: total collective device-seconds over total
        # device-seconds of window across the gang.
        denom = sum(s.n_ranks * s.window_s for s in self.steps)
        return self.comm_s / denom if denom > 0 else 0.0

    @property
    def overlap_fraction(self) -> float:
        return self.overlap_s / self.comm_s if self.comm_s > 0 else 0.0

    def family_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.steps:
            for fam, sec in s.families.items():
                out[fam] = out.get(fam, 0.0) + sec
        return {f: v for f, v in out.items() if v > 0}

    def family_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.steps:
            for fam, n in s.counts.items():
                out[fam] = out.get(fam, 0) + n
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "gang",
            "run_id": self.run_id,
            "sources": list(self.sources),
            "n_ranks": self.n_ranks,
            "n_steps": len(self.steps),
            "wall_s": self.wall_s,
            "comm_s": self.comm_s,
            "compute_s": self.compute_s,
            "overlap_s": self.overlap_s,
            "step_skew_s": self.step_skew_s,
            "comm_fraction": self.comm_fraction,
            "overlap_fraction": self.overlap_fraction,
            "collective_s": self.family_s(),
            "collective_counts": self.family_counts(),
            "steps": [s.to_dict() for s in self.steps],
        }

    def publish(self, telemetry=None) -> None:
        """Same contract as :meth:`TraceAnalysis.publish`, under
        ``xprof.gang_*`` names so gang and per-rank budgets coexist on
        one bus: per-gang-step histogram samples, summed counters,
        run-level gauges, one event, and the full document as the
        ``xprof_gang`` snapshot section."""
        from sparktorch_tpu_torch.obs.telemetry import get_telemetry

        tele = telemetry or get_telemetry()
        for s in self.steps:
            tele.observe("xprof.gang_step_wall_s", s.wall_s)
            tele.observe("xprof.gang_comm_s", s.comm_s)
            tele.observe("xprof.gang_step_skew_s", s.skew_s)
            tele.observe("xprof.gang_comm_fraction", s.comm_fraction)
            for fam, sec in s.families.items():
                tele.observe("xprof.gang_collective_time_s", sec,
                             labels={"op": fam})
        for fam, n in self.family_counts().items():
            tele.counter("xprof.gang_collectives_total", n,
                         labels={"op": fam})
        tele.counter("xprof.gang_steps_total", len(self.steps))
        tele.counter("xprof.gang_merges_total")
        tele.gauge("xprof.gang_ranks", self.n_ranks)
        tele.gauge("xprof.gang_comm_fraction_run", self.comm_fraction)
        tele.gauge("xprof.gang_overlap_fraction_run", self.overlap_fraction)
        tele.gauge("xprof.gang_step_skew_s_max", self.step_skew_s)
        tele.event(
            "xprof_gang_analysis",
            n_ranks=self.n_ranks,
            n_steps=len(self.steps),
            comm_s=self.comm_s,
            compute_s=self.compute_s,
            overlap_s=self.overlap_s,
            step_skew_s=self.step_skew_s,
            comm_fraction=self.comm_fraction,
            overlap_fraction=self.overlap_fraction,
            collective_s=self.family_s(),
            gang_run_id=self.run_id,
        )
        tele.set_section("xprof_gang", self.to_dict())


_RANK_LANE_KEYS = ("wall_s", "window_s", "compute_s", "comm_s", "overlap_s")


def _analysis_dict(a: Any) -> Dict[str, Any]:
    if isinstance(a, TraceAnalysis):
        return a.to_dict()
    if isinstance(a, dict):
        return a
    raise TypeError(f"cannot merge {type(a).__name__}: expected a "
                    f"TraceAnalysis or its to_dict() form")


def merge_analyses(analyses, ranks: Optional[Iterable[Any]] = None,
                   run_id: Optional[str] = None) -> GangAnalysis:
    """Fold N per-host analyses (objects or their ``to_dict()`` forms,
    e.g. scraped ``xprof`` snapshot sections) into one
    :class:`GangAnalysis`.

    Steps are aligned by step number when every rank has one (the
    normal annotated capture), by position otherwise; a rank missing a
    step simply doesn't contribute to it (its ``n_ranks`` shrinks) —
    truncated captures must not invent zeros that drag the max'd walls
    down. Per-family comm seconds SUM, per-step walls MAX, skew is the
    cross-rank wall spread (>= 0 by construction), and the gang
    comm/overlap fractions are recomputed over the union of every
    rank's windows."""
    dicts = [_analysis_dict(a) for a in analyses]
    if not dicts:
        raise ValueError("merge_analyses: no analyses given")
    rank_ids = [str(r) for r in ranks] if ranks is not None else [
        str(i) for i in range(len(dicts))
    ]
    if len(rank_ids) != len(dicts):
        raise ValueError(
            f"merge_analyses: {len(rank_ids)} ranks for {len(dicts)} "
            f"analyses"
        )

    # Alignment key: step number when every contributing step has one,
    # else list position (whole-trace pseudo-steps merge positionally).
    use_num = all(s.get("step") is not None
                  for d in dicts for s in d.get("steps", []))
    buckets: Dict[Any, List[Tuple[str, Dict[str, Any]]]] = {}
    order: List[Any] = []
    for rank, d in zip(rank_ids, dicts):
        for i, s in enumerate(d.get("steps", [])):
            key = s.get("step") if use_num else i
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append((rank, s))
    if use_num:
        order.sort()

    steps: List[GangStepAttribution] = []
    for key in order:
        contrib = buckets[key]
        walls = [s["wall_s"] for _, s in contrib]
        families: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        lanes: Dict[str, Dict[str, float]] = {}
        for rank, s in contrib:
            for fam, sec in (s.get("families") or {}).items():
                families[fam] = families.get(fam, 0.0) + sec
            for fam, n in (s.get("counts") or {}).items():
                counts[fam] = counts.get(fam, 0) + int(n)
            lanes[rank] = {k: float(s.get(k, 0.0) or 0.0)
                           for k in _RANK_LANE_KEYS}
        steps.append(GangStepAttribution(
            step=contrib[0][1].get("step") if use_num else None,
            wall_s=max(walls),
            window_s=max(s["window_s"] for _, s in contrib),
            compute_s=sum(s["compute_s"] for _, s in contrib),
            comm_s=sum(s["comm_s"] for _, s in contrib),
            overlap_s=sum(s["overlap_s"] for _, s in contrib),
            skew_s=max(walls) - min(walls),
            n_ranks=len(contrib),
            families=families,
            counts=counts,
            ranks=lanes,
        ))
    return GangAnalysis(
        sources=[d.get("source", "<?>") for d in dicts],
        n_ranks=len(dicts),
        steps=steps,
        run_id=run_id,
    )


def _iter_x_events(events: Iterable[Any]):
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        ts, dur = e.get("ts"), e.get("dur", 0)
        if not isinstance(ts, (int, float)) or not isinstance(
                dur, (int, float)) or dur < 0:
            continue
        yield e, float(ts) * US, (float(ts) + float(dur)) * US


def _outermost_calls(ops):
    """Host collective calls less those nested in another of the same
    thread (``c10d::allreduce_`` around ``nccl:all_reduce``): one event
    per call, so the counts are calls."""
    out = []
    for op in sorted(ops, key=lambda o: (o[4], o[0], -o[1])):
        last = out[-1] if out else None
        if last is not None and last[4] == op[4] and op[1] <= last[1]:
            continue
        out.append(op)
    return out


def _drop_nested_in_collectives(ops):
    """Host ops less those nested inside a collective op on the same
    thread (a c10d operator's own ATen calls are part of the
    collective, not compute alongside it)."""
    by_lane: Dict[Any, List[Tuple[float, float]]] = {}
    for t0, t1, family, _name, lane in ops:
        if family is not None:
            by_lane.setdefault(lane, []).append((t0, t1))
    if not by_lane:
        return ops
    merged = {lane: _union(iv) for lane, iv in by_lane.items()}
    starts = {lane: [a for a, _ in iv] for lane, iv in merged.items()}
    out = []
    for op in ops:
        t0, t1, family, _name, lane = op
        iv = merged.get(lane)
        if family is None and iv:
            i = bisect.bisect_right(starts[lane], t0) - 1
            if i >= 0 and iv[i][0] <= t0 and t1 <= iv[i][1]:
                continue
        out.append(op)
    return out


def analyze_trace(path_or_data, step_name: str = "train_step",
                  top_k: int = 15) -> TraceAnalysis:
    """Analyze one capture: a trace file path, a profile log dir, or
    an already-parsed Chrome-trace dict."""
    if isinstance(path_or_data, dict):
        source, data = "<dict>", path_or_data
        if not isinstance(data.get("traceEvents"), list):
            raise TraceParseError("not a Chrome trace (no traceEvents list)")
    else:
        source = find_trace_file(path_or_data)
        data = load_trace(source)
    events = data["traceEvents"]

    xs = list(_iter_x_events(events))
    on_card = any(e.get("cat") in DEVICE_CATS for e, _, _ in xs)

    # Pass 1: step markers. On a trace with device work, the ranges'
    # projections onto the card (one per range and stream, joined by
    # the range's "External id"); the host ranges where none exists.
    markers: List[Tuple[float, float, Optional[int]]] = []
    projected: Dict[Any, List[float]] = {}
    host_markers: List[Tuple[float, float, Optional[int]]] = []
    for e, t0, t1 in xs:
        if e.get("name") != step_name:
            continue
        args = e.get("args") or {}
        raw = args.get("step_num")
        try:
            num: Optional[int] = int(raw)
        except (TypeError, ValueError):
            num = None
        if e.get("cat") == "gpu_user_annotation":
            key = args.get("External id", ("event", len(projected)))
            lo_hi = projected.setdefault(key, [t0, t1, num])
            lo_hi[0], lo_hi[1] = min(lo_hi[0], t0), max(lo_hi[1], t1)
        else:
            host_markers.append((t0, t1, num))
    if on_card and projected:
        markers = [(t0, t1, num) for t0, t1, num in projected.values()]
    else:
        markers = host_markers
    # Key on times only: step_num can be None (unparseable) and must
    # never be compared as a tie-breaker.
    markers.sort(key=lambda m: (m[0], m[1]))
    n_markers = len(markers)

    # Concurrent markers (hogwild: N worker threads each annotating
    # its own local step) make start->next-start slicing meaningless —
    # device ops would attribute to whichever thread's marker opened
    # last. Detect the overlap and fall back to ONE whole-trace
    # pseudo-step: the aggregate comm/compute budget stays honest,
    # and no garbage per-step walls reach the bus.
    markers_overlap = any(
        markers[i + 1][0] < markers[i][1] - 1e-9
        for i in range(len(markers) - 1)
    )
    if markers_overlap:
        _LOG.warning(
            f"[sparktorch_tpu_torch:xprof] {n_markers} step markers overlap "
            f"(concurrent workers?) — attributing the capture as one "
            f"aggregate slice instead of per-step"
        )
        markers = []

    # Pass 2: device ops (module docstring).
    n_events = n_device = n_coll = 0
    candidates: List[Tuple[float, float, Optional[str], str, Any]] = []
    host_colls: List[Tuple[float, float, Optional[str], str, Any]] = []
    t_end = 0.0
    for e, t0, t1 in xs:
        n_events += 1
        t_end = max(t_end, t1)
        name = str(e.get("name", ""))
        cat = e.get("cat")
        if name == step_name:
            continue
        host_op = cat == "cpu_op" or (
            cat == "user_annotation"
            and name.lower().startswith(("gloo:", "nccl:")))
        if on_card:
            if cat in DEVICE_CATS:
                candidates.append((t0, t1, _family(name), name,
                                   (e.get("pid"), e.get("tid"))))
            elif host_op and _family(name) is not None:
                host_colls.append((t0, t1, _family(name), name,
                                   (e.get("pid"), e.get("tid"))))
        elif host_op:
            candidates.append((t0, t1, _family(name), name,
                               (e.get("pid"), e.get("tid"))))
    if on_card and not any(c[2] is not None for c in candidates):
        # No collective ran on the card (gloo, or an NCCL world of one,
        # where NCCL launches no kernel): the host's collective calls
        # are where the communication happened.
        candidates.extend(_outermost_calls(host_colls))
    if not on_card:
        candidates = _drop_nested_in_collectives(candidates)
    device_ops: List[Tuple[float, float, Optional[str], str]] = []
    for t0, t1, family, name, _lane in candidates:
        n_device += 1
        n_coll += family is not None
        device_ops.append((t0, t1, family, name))

    # Step slices: annotation start -> next annotation start (the last
    # one runs to the end of the trace), so async device work that
    # drains after the annotation closes still attributes to its step.
    slices: List[Tuple[float, float, float, Optional[int]]] = []
    if markers:
        for i, (t0, t1, num) in enumerate(markers):
            nxt = markers[i + 1][0] if i + 1 < len(markers) \
                else max(t1, t_end)
            slices.append((t0, max(nxt, t1), t1 - t0, num))
    elif device_ops:
        lo = min(t0 for t0, _, _, _ in device_ops)
        hi = max(t1 for _, t1, _, _ in device_ops)
        slices.append((lo, hi, hi - lo, None))

    starts = [s[0] for s in slices]
    per_step: List[Dict[str, List[Tuple[float, float]]]] = [
        {"compute": [], "comm": []} for _ in slices
    ]
    per_family: List[Dict[str, List[Tuple[float, float]]]] = [
        {} for _ in slices
    ]
    per_counts: List[Dict[str, int]] = [{} for _ in slices]
    n_unattributed = 0
    op_totals: Dict[Tuple[str, Optional[str]], List[float]] = {}
    for t0, t1, family, name in device_ops:
        tot = op_totals.setdefault((name, family), [0.0, 0])
        tot[0] += t1 - t0
        tot[1] += 1
        mid = (t0 + t1) / 2.0
        idx = bisect.bisect_right(starts, mid) - 1
        if idx < 0 or mid > slices[idx][1]:
            n_unattributed += 1
            continue
        if family is None:
            per_step[idx]["compute"].append((t0, t1))
        else:
            per_step[idx]["comm"].append((t0, t1))
            per_family[idx].setdefault(family, []).append((t0, t1))
            per_counts[idx][family] = per_counts[idx].get(family, 0) + 1

    steps: List[StepAttribution] = []
    for i, (s0, s1, wall, num) in enumerate(slices):
        compute_u = _union(per_step[i]["compute"])
        comm_u = _union(per_step[i]["comm"])
        steps.append(StepAttribution(
            step=num,
            wall_s=wall,
            window_s=s1 - s0,
            compute_s=_measure(compute_u),
            comm_s=_measure(comm_u),
            overlap_s=_intersection_measure(comm_u, compute_u),
            families={f: _measure(_union(iv))
                      for f, iv in per_family[i].items()},
            counts=per_counts[i],
        ))

    top = sorted(
        ({"name": name, "family": family or "compute",
          "total_s": tot, "count": int(cnt)}
         for (name, family), (tot, cnt) in op_totals.items()),
        key=lambda r: -r["total_s"],
    )[:top_k]

    return TraceAnalysis(
        source=source,
        steps=steps,
        top_ops=top,
        n_events=n_events,
        n_device_events=n_device,
        n_collective_events=n_coll,
        n_unattributed=n_unattributed,
        n_markers=n_markers,
        markers_overlap=markers_overlap,
    )


def check_capture_truncation(analysis: TraceAnalysis,
                             expected_steps: Optional[int],
                             telemetry=None) -> bool:
    """The capture-truncation detector (ROADMAP follow-up): the
    profiler's event buffer can overflow (a capture containing the
    multi-second XLA compile) and later step markers silently vanish —
    the analysis then under-reports without any signal. Compare the
    steps ANNOTATED on the bus during the capture (``expected_steps``,
    the ``tracing.annotated_steps`` delta the profiling hook measured)
    against the markers actually FOUND in the trace; on a shortfall
    emit one ``xprof.capture_truncated`` warning event + counter
    instead of staying silent. Returns True when truncation was
    detected."""
    if expected_steps is None or expected_steps <= analysis.n_markers:
        return False
    from sparktorch_tpu_torch.obs.telemetry import get_telemetry

    tele = telemetry or get_telemetry()
    _LOG.warning(
        f"[sparktorch_tpu_torch:xprof] capture truncated? {expected_steps} "
        f"steps annotated on the bus but only {analysis.n_markers} "
        f"train_step markers in the trace ({analysis.source}) — the "
        f"profiler event buffer likely overflowed (keep compilation "
        f"out of the capture); attribution below covers only the "
        f"surviving markers"
    )
    tele.counter("xprof.capture_truncated_total")
    tele.event("xprof.capture_truncated",
               expected_steps=int(expected_steps),
               found_markers=int(analysis.n_markers),
               source=analysis.source)
    return True


def analyze_and_publish(log_dir: str, telemetry=None,
                        step_name: str = "train_step",
                        expected_steps: Optional[int] = None
                        ) -> Optional[TraceAnalysis]:
    """The stop-profiler hook: find the capture under ``log_dir``,
    analyze it, publish onto the bus. ``expected_steps`` (the number
    of step annotations the capture should contain — measured by
    ``profile_run`` from the bus counter) arms the truncation
    detector. Analysis failures must never fail the run that was
    being profiled — ANY exception (a torn capture, an event shape
    this parser has not seen, a sink whose disk filled during publish)
    logs, bumps ``xprof.analyze_failures``, and returns None."""
    from sparktorch_tpu_torch.obs.telemetry import get_telemetry

    tele = telemetry or get_telemetry()
    try:
        analysis = analyze_trace(log_dir, step_name=step_name)
        check_capture_truncation(analysis, expected_steps, tele)
        analysis.publish(tele)
        return analysis
    except Exception as e:
        try:
            tele.counter("xprof.analyze_failures")
        except Exception:
            pass
        _LOG.warning(f"[sparktorch_tpu_torch:xprof] trace analysis of "
                     f"{log_dir!r} failed: {type(e).__name__}: {e}")
        return None
