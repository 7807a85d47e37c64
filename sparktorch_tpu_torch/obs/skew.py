"""Cross-rank step-skew ledger: wire time vs straggler wait — a copy of ``sparktorch_tpu/obs/skew.py``.

A rank blocked in a collective may be paying real wire time or waiting
for the slowest peer; the two call for opposite fixes. This module
splits them:

- Each rank's :class:`~sparktorch_tpu_torch.obs.goodput.GoodputLedger`
  stamps a bounded :class:`StepSkewRing` of per-step boundary
  timestamps (step index, enter and exit of the step's fence) from its
  ``step_span()`` close path. The stamps are the span's own clock
  pair, converted to wall time through the ledger's anchor, so stamps
  from different processes are comparable. This module never reads a
  clock itself.
- The ring publishes as the ``skew`` telemetry section beside
  ``goodput``. :func:`merge_sections` aligns step indices across ranks,
  computes per-step arrival skew (last arrival minus median), charges
  each step's victims' fence waits to that step's laggard, and splits
  the merged ``exposed_comm`` rank-seconds into ``wire_s`` and
  ``straggler_wait_s``.
- A persistent laggard is named by rank, with a cause hypothesis read
  from that rank's own goodput section (a data_wait spike, compiles,
  idle, preemption), and exported as ``skew.*`` gauges, so
  :func:`skew_alert_rules`' sustained straggler-fraction rule can feed
  latched firings to the elastic controller.

With a per-step fence every rank exits together when the last arrival
lands, so a victim's wait at step ``i`` is ``last_enter -
enter_victim``, clipped to the victim's own span. The per-step waits
sum to the fleet's straggler seconds, clipped to the merged
``exposed_comm``; the rest of it is wire.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

from sparktorch_tpu_torch.obs.alerts import AlertRule
from sparktorch_tpu_torch.obs.telemetry import Telemetry

SECTION = "skew"
RUN_SECTION = "skew_run"

# Per-step detail entries retained in the merged doc (the timeline's
# arrival-bar table); the full decomposition always covers EVERY
# aligned step regardless of this window.
DEFAULT_WINDOW = 32

# A laggard must have topped this many aligned steps AND own this
# share of the fleet's total straggler wait before the verdict calls
# it persistent — one noisy step must not name a rank.
MIN_LAGGARD_STEPS = 3
LAGGARD_DOMINANCE = 0.5


class StepSkewRing:
    """Bounded ring of per-step boundary stamps for ONE rank.

    Each entry is ``(step, count, enter_ts, exit_ts)``: the step index
    the stamp starts at, how many fused steps the span trained, and
    the wall-clock enter/exit of the step span (the collective fence's
    boundary — arrival at the fence is the enter stamp). Stamps are
    recorded by the goodput ledger's ``step_span()`` close path; this
    class never reads a clock. Thread-safe; overflow evicts oldest and
    counts ``dropped`` so the merge can say how much history it lost.
    """

    __slots__ = ("capacity", "_ring", "_dropped", "_lock")

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._ring: Deque[Tuple[int, int, float, float]] = deque(
            maxlen=self.capacity)
        self._dropped = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def record(self, step: int, count: int,
               enter_ts: float, exit_ts: float) -> None:
        # Once a step: the values go in as given; the snapshot converts.
        with self._lock:
            ring = self._ring
            if len(ring) == self.capacity:
                self._dropped += 1
            ring.append((step, count, enter_ts, exit_ts))

    def snapshot(self) -> Dict[str, Any]:
        """The publishable ``skew`` section body: newest-last stamp
        list plus ring accounting. Stamps serialize as 4-lists so the
        section survives a JSON round-trip unchanged."""
        with self._lock:
            ring = list(self._ring)
            dropped = self._dropped
        stamps = [[int(s), max(1, int(c)), round(float(t0), 6),
                   round(float(t1), 6)] for (s, c, t0, t1) in ring]
        return {"n_stamps": len(stamps), "capacity": self.capacity,
                "dropped": dropped, "stamps": stamps}


# ---------------------------------------------------------------------------
# Run-level merge (the collector's /skew)
# ---------------------------------------------------------------------------


def _median(values: List[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


def _stamps_by_step(doc: Mapping[str, Any]
                    ) -> Dict[int, Tuple[float, float]]:
    """{step: (enter, exit)} from one rank's section, tolerant of
    malformed entries (a torn scrape must not kill the merge)."""
    out: Dict[int, Tuple[float, float]] = {}
    for entry in (doc.get("stamps") or []):
        try:
            step, _count, enter, exit_ = entry[0], entry[1], entry[2], entry[3]
            out[int(step)] = (float(enter), float(exit_))
        except (TypeError, ValueError, IndexError):
            continue
    return out


def _hypothesize_cause(lag: str,
                       goodput_docs: Mapping[str, Mapping[str, Any]],
                       health_docs: Mapping[str, Mapping[str, Any]]
                       ) -> Tuple[str, List[str]]:
    """Name WHY the laggard is slow from its own ledger, judged
    against its peers' medians: a data_wait spike, compile storms,
    preemption downtime, or unattributed time (the GC / host-stall
    shape — seconds the laggard's own ledger could not explain are
    exactly where a straggling host hides). Health anomalies ride as
    corroborating evidence whatever the bucket verdict."""
    evidence: List[str] = []
    gdoc = goodput_docs.get(lag)
    cause = "unknown"
    if isinstance(gdoc, Mapping) and isinstance(gdoc.get("fractions"),
                                                Mapping):
        fr = gdoc["fractions"]
        peers = [d for r, d in goodput_docs.items()
                 if r != lag and isinstance(d, Mapping)
                 and isinstance(d.get("fractions"), Mapping)]

        def peer_med(key: str) -> float:
            return _median([float(p["fractions"].get(key) or 0.0)
                            for p in peers]) if peers else 0.0

        data_wait = float(fr.get("data_wait") or 0.0)
        compile_f = float(fr.get("compile") or 0.0)
        idle = float(fr.get("idle") or 0.0)
        downtime = (float(fr.get("restart_downtime") or 0.0)
                    + float(fr.get("resize_downtime") or 0.0))
        compiles = int(gdoc.get("compiles") or 0)
        peer_compiles = _median([float(p.get("compiles") or 0)
                                 for p in peers]) if peers else 0.0
        if data_wait > max(2.0 * peer_med("data_wait"), 0.02):
            cause = "data_wait"
            evidence.append(
                f"data_wait {data_wait:.1%} vs peer median "
                f"{peer_med('data_wait'):.1%}")
        elif (compile_f > max(2.0 * peer_med("compile"), 0.02)
              or compiles > peer_compiles + 1):
            cause = "compile"
            evidence.append(
                f"{compiles} compiles ({compile_f:.1%} of wall) vs "
                f"peer median {peer_compiles:.0f}")
        elif downtime > max(2.0 * (peer_med("restart_downtime")
                                   + peer_med("resize_downtime")), 0.02):
            cause = "preempt"
            evidence.append(
                f"restart/resize downtime {downtime:.1%} of wall")
        elif idle > 2.0 * peer_med("idle") + 0.05:
            # Time the laggard's OWN ledger could not attribute: the
            # GC-pause / host-stall / noisy-neighbor shape.
            cause = "gc_or_unattributed"
            evidence.append(
                f"unattributed (idle) {idle:.1%} vs peer median "
                f"{peer_med('idle'):.1%}")
    hdoc = health_docs.get(lag)
    if isinstance(hdoc, Mapping):
        anoms = hdoc.get("anomalies") or []
        kinds = sorted({str((a or {}).get("kind"))
                        for a in anoms if isinstance(a, Mapping)})
        if kinds:
            evidence.append("health anomalies: " + ", ".join(kinds))
    return cause, evidence


def merge_sections(rank_docs: Mapping[Any, Mapping[str, Any]],
                   goodput_docs: Optional[Mapping[Any, Mapping]] = None,
                   health_docs: Optional[Mapping[Any, Mapping]] = None,
                   window: int = DEFAULT_WINDOW) -> Dict[str, Any]:
    """Fold per-rank ``skew`` sections into ONE run-level verdict —
    what ``GET /skew`` serves. Steps present on >= 2 ranks align; per
    step, arrival skew is last-enter minus the median enter, each
    victim's wait is charged to that step's laggard, and the summed
    waits decompose the merged goodput ``exposed_comm`` into
    ``wire_s`` + ``straggler_wait_s``. ``goodput_docs`` /
    ``health_docs`` (the same per-rank sections the collector already
    scraped, keyed by the same ranks) supply the exposed_comm budget
    and the laggard's cause evidence; without them the doc still
    reports raw arrival waits but leaves the decomposition null.

    Stamps are wall-clock, so cross-PROCESS comparability is bounded
    by host clock sync (NTP-class skew is µs–ms, far under the
    step-level stalls this referee exists to name)."""
    per_rank_stamps: Dict[str, Dict[int, Tuple[float, float]]] = {}
    docs: Dict[str, Mapping[str, Any]] = {}
    for rank in sorted(rank_docs, key=str):
        doc = rank_docs[rank]
        if not isinstance(doc, Mapping):
            continue
        r = str(rank)
        docs[r] = doc
        per_rank_stamps[r] = _stamps_by_step(doc)
    gdocs = {str(r): d for r, d in (goodput_docs or {}).items()
             if isinstance(d, Mapping)}
    hdocs = {str(r): d for r, d in (health_docs or {}).items()
             if isinstance(d, Mapping)}

    # Align: step -> {rank: (enter, exit)} on every step >=2 ranks saw.
    by_step: Dict[int, Dict[str, Tuple[float, float]]] = {}
    for r, stamps in per_rank_stamps.items():
        for step, pair in stamps.items():
            by_step.setdefault(step, {})[r] = pair
    aligned = sorted(s for s, ranks in by_step.items() if len(ranks) >= 2)

    wait_by_laggard: Dict[str, float] = {}
    wait_by_victim: Dict[str, float] = {}
    laggard_steps: Dict[str, int] = {}
    lag_samples: Dict[str, List[float]] = {r: [] for r in docs}
    per_step: List[Dict[str, Any]] = []
    worst: Optional[Dict[str, Any]] = None
    newest_ts = 0.0
    for step in aligned:
        arrivals = by_step[step]
        enters = {r: pair[0] for r, pair in arrivals.items()}
        lag_r = max(enters, key=lambda r: enters[r])
        last = enters[lag_r]
        med = _median(list(enters.values()))
        first = min(enters.values())
        skew_s = max(last - med, 0.0)
        step_wait = 0.0
        for r, (enter, exit_) in arrivals.items():
            newest_ts = max(newest_ts, exit_)
            lag_samples.setdefault(r, []).append(max(enter - med, 0.0))
            if r == lag_r:
                continue
            # The victim exits the fence with the last arrival; it
            # cannot have waited longer than it was inside the span.
            wait = max(min(last - enter, max(exit_ - enter, 0.0)), 0.0)
            wait_by_victim[r] = wait_by_victim.get(r, 0.0) + wait
            step_wait += wait
        wait_by_laggard[lag_r] = wait_by_laggard.get(lag_r, 0.0) + step_wait
        laggard_steps[lag_r] = laggard_steps.get(lag_r, 0) + 1
        entry = {"step": step, "skew_s": round(skew_s, 6),
                 "laggard": lag_r, "wait_s": round(step_wait, 6),
                 "arrivals": {r: round(e - first, 6)
                              for r, e in enters.items()}}
        per_step.append(entry)
        if worst is None or skew_s > worst["skew_s"]:
            worst = {"step": step, "skew_s": round(skew_s, 6),
                     "laggard": lag_r}

    total_wait = sum(wait_by_victim.values())
    exposed: Optional[float] = None
    if gdocs:
        exposed = sum(float(((d.get("buckets") or {})
                             .get("exposed_comm")) or 0.0)
                      for d in gdocs.values())
    if exposed is not None:
        straggler_wait = min(total_wait, exposed)
        wire = max(exposed - straggler_wait, 0.0)
        fraction = (straggler_wait / exposed) if exposed > 0 else 0.0
    else:
        # No goodput budget scraped: report raw waits, decomposition
        # null, fraction 0 (never a false alert on missing data).
        straggler_wait, wire, fraction = total_wait, None, 0.0

    run: Dict[str, Any] = {
        "kind": "skew_run",
        "ts": round(newest_ts, 6),
        "n_ranks": len(docs),
        "steps_aligned": len(aligned),
        "arrival_wait_s": round(total_wait, 6),
        "exposed_comm_s": (round(exposed, 6)
                           if exposed is not None else None),
        "straggler_wait_s": round(straggler_wait, 6),
        "wire_s": (round(wire, 6) if wire is not None else None),
        "straggler_fraction": round(fraction, 6),
        "wait_by_laggard": {r: round(s, 6)
                            for r, s in sorted(wait_by_laggard.items())},
        "wait_by_victim": {r: round(s, 6)
                           for r, s in sorted(wait_by_victim.items())},
        "per_rank": {
            r: {"steps": len(per_rank_stamps.get(r) or {}),
                "laggard_steps": laggard_steps.get(r, 0),
                "wait_caused_s": round(wait_by_laggard.get(r, 0.0), 6),
                "wait_suffered_s": round(wait_by_victim.get(r, 0.0), 6),
                "arrival_lag_p50_s": round(
                    _median(lag_samples.get(r) or []), 6),
                "arrival_lag_max_s": round(
                    max(lag_samples.get(r) or [0.0]), 6),
                "dropped": int(docs[r].get("dropped") or 0)}
            for r in sorted(docs)},
        "worst_step": worst,
        "per_step": per_step[-max(1, int(window)):],
        "laggard": None,
    }
    if total_wait > 0 and wait_by_laggard:
        lag = max(wait_by_laggard, key=lambda r: wait_by_laggard[r])
        share = wait_by_laggard[lag] / total_wait
        persistent = (laggard_steps.get(lag, 0) >= MIN_LAGGARD_STEPS
                      and share >= LAGGARD_DOMINANCE)
        verdict: Dict[str, Any] = {
            "rank": lag,
            "steps": laggard_steps.get(lag, 0),
            "share": round(share, 6),
            "persistent": persistent,
        }
        if persistent:
            cause, evidence = _hypothesize_cause(lag, gdocs, hdocs)
            verdict["cause"] = cause
            verdict["evidence"] = evidence
        run["laggard"] = verdict
    return run


def sections_from_snapshots(snapshots: Mapping[Any, Optional[Mapping]]
                            ) -> Dict[Any, Mapping[str, Any]]:
    """Pull each rank's ``skew`` section out of its (last-good)
    telemetry snapshot; ranks without one are skipped."""
    out: Dict[Any, Mapping[str, Any]] = {}
    for rank, snap in snapshots.items():
        section = ((snap or {}).get("sections") or {}).get(SECTION)
        if isinstance(section, Mapping):
            out[rank] = section
    return out


def publish_run_gauges(telemetry: Telemetry,
                       run: Mapping[str, Any]) -> None:
    """Export the merged verdict as ``skew.*`` gauges on the
    collector's bus — the series :class:`MetricsHistory` retains and
    :func:`skew_alert_rules` judges."""
    for key in ("straggler_fraction", "straggler_wait_s", "wire_s",
                "arrival_wait_s", "steps_aligned", "n_ranks"):
        val = run.get(key)
        if val is not None:
            telemetry.gauge(f"skew.{key}", float(val))
    worst = run.get("worst_step") or {}
    if worst:
        telemetry.gauge("skew.worst_step_skew_s",
                        float(worst.get("skew_s") or 0.0))
    for r, caused in (run.get("wait_by_laggard") or {}).items():
        telemetry.gauge("skew.wait_caused_s", float(caused),
                        labels={"rank": str(r)})


def skew_alert_rules(threshold: float = 0.5, for_sweeps: int = 3,
                     severity: str = "warning") -> List[AlertRule]:
    """The sustained straggler rule: fire (latched, episode-counted)
    when straggler wait has dominated the run's exposed_comm for
    ``for_sweeps`` consecutive collector sweeps — the signal the
    ElasticController consumes as a ``ctl.scale_signal`` (evict or
    replace the named rank beats compressing the collective). One
    noisy sweep never flaps the signal; that is what ``sustained``
    means in :mod:`sparktorch_tpu_torch.obs.alerts`."""
    return [AlertRule(
        name="skew_straggler_sustained",
        metric="skew.straggler_fraction",
        kind="sustained",
        op=">",
        threshold=float(threshold),
        for_sweeps=int(for_sweeps),
        severity=severity,
    )]
