"""Retained metrics history — a copy of ``sparktorch_tpu/obs/history.py``.

:class:`MetricsHistory` is a bounded time-series tier over telemetry
snapshots: :meth:`~MetricsHistory.append` adds one point per metric
series (``(ts, value)`` for counters and gauges, ``(ts, rollup)`` for
histogram and span digests) into a per-series ring of fixed retention,
so memory is O(series x retention), never O(run length).

- Derived queries: :meth:`~MetricsHistory.rate` (reset-aware
  per-second counter increase over a window),
  :meth:`~MetricsHistory.percentile_over` (a windowed
  percentile-of-percentiles over the retained digests),
  :meth:`~MetricsHistory.delta_since`, and the raw
  :meth:`~MetricsHistory.series`.
- Timestamps come from the snapshot (``snapshot["ts"]``), never from
  the clock at append time, so a scripted sequence replays exactly.
- An optional JSONL spill appends one compact record per append;
  :meth:`~MetricsHistory.from_jsonl` rebuilds a history from it.

Series are matched by name and a label SUBSET, like
:func:`~sparktorch_tpu_torch.obs.collector.snapshot_histogram`; when
several series match, the one with the most retained points wins. The
fleet collector (:class:`~sparktorch_tpu_torch.obs.collector.FleetCollector`)
appends its merged snapshot every poll; a caller may append its own
bus's snapshots as well.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from sparktorch_tpu_torch.obs.prom import _parse_flat_key  # shared key grammar

DEFAULT_RETENTION = 512

# Sweep-record kinds from_jsonl understands: this module's own spill
# records, the collector sink's merged snapshots, and plain telemetry
# dumps — all carry ts + counters/gauges/histograms.
_RECORD_KINDS = ("history_sweep", "gang_snapshot", "snapshot")

# Snapshot sections retained per sweep, with the point shape each one
# appends (scalar vs digest).
_SCALAR_SECTIONS = ("counters", "gauges")
_DIGEST_SECTIONS = ("histograms", "spans")

_DIGEST_FIELDS = ("count", "sum", "mean", "min", "max", "p50", "p95",
                  "p99")


class _Series:
    __slots__ = ("kind", "name", "labels", "points")

    def __init__(self, flat: str, kind: str, retention: int):
        self.kind = kind  # counter | gauge | histogram | span
        # Parsed once at creation: the flat key is immutable, and the
        # per-sweep rule evaluations would otherwise re-parse every
        # series' key grammar on every query (measured in the
        # collector-sweep overhead budget).
        self.name, self.labels = _parse_flat_key(flat)
        self.points: "deque[Tuple[float, Any]]" = deque(maxlen=retention)


def _increase(points: List[Tuple[float, float]]) -> float:
    """Reset-aware monotonic increase over consecutive points: a value
    DROP is a counter reset (process restart), and the post-reset value
    is itself increase — never a negative delta."""
    total = 0.0
    for (_, v0), (_, v1) in zip(points, points[1:]):
        total += (v1 - v0) if v1 >= v0 else v1
    return total


class MetricsHistory:
    """Bounded per-series time-series rings with derived queries.

    Thread-safe: the collector's poll loop appends while ``/history``
    handler threads query. All query windows are measured back from
    the NEWEST retained point's timestamp (not the wall clock), so a
    replayed scripted sequence answers identically every time.
    """

    def __init__(self, retention: int = DEFAULT_RETENTION,
                 spill_jsonl: Optional[str] = None):
        if retention < 2:
            raise ValueError(f"retention must be >= 2, got {retention}")
        self.retention = int(retention)
        self.spill_jsonl = spill_jsonl
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._last_ts: Optional[float] = None
        self.sweeps = 0

    # -- append --------------------------------------------------------------

    def append(self, snapshot: Mapping[str, Any],
               ts: Optional[float] = None) -> None:
        """Retain one sweep. ``snapshot`` is a telemetry/merged
        snapshot dict; its own ``ts`` stamps every point unless an
        explicit ``ts`` overrides it (scripted sequences)."""
        when = float(ts if ts is not None
                     else snapshot.get("ts") or 0.0)
        spill: Dict[str, Any] = {}
        with self._lock:
            for section, kind in (("counters", "counter"),
                                  ("gauges", "gauge"),
                                  ("histograms", "histogram"),
                                  ("spans", "span")):
                table = snapshot.get(section)
                if not isinstance(table, Mapping):
                    continue
                digest = section in _DIGEST_SECTIONS
                for flat, value in table.items():
                    series = self._series.get(flat)
                    if series is None:
                        series = self._series[flat] = _Series(
                            flat, kind, self.retention)
                    if digest:
                        if not isinstance(value, Mapping):
                            continue
                        point = {k: value.get(k) for k in _DIGEST_FIELDS}
                    else:
                        point = float(value)
                    series.points.append((when, point))
                    if self.spill_jsonl:
                        spill.setdefault(section, {})[flat] = point
            self._last_ts = when
            self.sweeps += 1
        if self.spill_jsonl and spill:
            from sparktorch_tpu_torch.obs.sinks import write_jsonl

            write_jsonl(self.spill_jsonl,
                        [{"kind": "history_sweep", "ts": when, **spill}],
                        append=True)

    @classmethod
    def from_jsonl(cls, path: str,
                   retention: int = DEFAULT_RETENTION) -> "MetricsHistory":
        """Rebuild a history from a spill file or a collector sink —
        the HA fallback's read path: a secondary that never scraped
        can still answer windowed queries from the primary's records."""
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        history = cls(retention=retention)
        for rec in read_jsonl(path):
            if rec.get("kind") in _RECORD_KINDS and rec.get("ts") is not None:
                history.append(rec)
        return history

    # -- series lookup -------------------------------------------------------

    def _match_locked(self, name: str,
                      labels: Optional[Mapping[str, Any]]) -> Optional[str]:
        """Best-matching retained series key: name + label subset,
        most points wins (caller holds the lock)."""
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        best_key, best_n = None, -1
        for flat, series in self._series.items():
            if series.name != name:
                continue
            have = series.labels
            if any(have.get(k) != v for k, v in want.items()):
                continue
            if len(series.points) > best_n:
                best_key, best_n = flat, len(series.points)
        return best_key

    def _points(self, name: str, labels: Optional[Mapping[str, Any]],
                window_s: Optional[float]) -> Tuple[Optional[str],
                                                    List[Tuple[float, Any]]]:
        with self._lock:
            key = self._match_locked(name, labels)
            if key is None:
                return None, []
            pts = list(self._series[key].points)
        if window_s is not None and pts:
            cutoff = pts[-1][0] - float(window_s)
            pts = [p for p in pts if p[0] >= cutoff]
        return key, pts

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)

    # -- derived queries -----------------------------------------------------

    def series(self, name: str,
               labels: Optional[Mapping[str, Any]] = None,
               window_s: Optional[float] = None,
               field: Optional[str] = None) -> List[Tuple[float, Any]]:
        """Raw retained points ``[(ts, value), ...]`` (oldest first).
        ``field`` projects one digest field (``p99``, ``count``, …) out
        of histogram/span points; None points are dropped under a
        projection (an empty sweep's digest has null quantiles)."""
        _, pts = self._points(name, labels, window_s)
        if field is None:
            return pts
        return [(ts, v.get(field)) for ts, v in pts
                if isinstance(v, Mapping) and v.get(field) is not None]

    def latest(self, name: str,
               labels: Optional[Mapping[str, Any]] = None,
               field: Optional[str] = None) -> Optional[Any]:
        """Newest retained value (field-projected for digests). Peeks
        the ring tail directly — the per-sweep rule evaluations must
        not copy a full retention window to read one point."""
        with self._lock:
            key = self._match_locked(name, labels)
            if key is None:
                return None
            points = self._series[key].points
            if not points:
                return None
            value = points[-1][1]
        if field is None:
            return value
        if isinstance(value, Mapping):
            return value.get(field)
        return None

    def rate(self, name: str,
             labels: Optional[Mapping[str, Any]] = None,
             window_s: Optional[float] = None) -> Optional[float]:
        """Per-second increase of a counter over the window (the whole
        retention when None): reset-aware total increase divided by the
        covered time span. None with fewer than two points or a zero
        span — "no signal", which callers must not read as zero."""
        _, pts = self._points(name, labels, window_s)
        pts = [(ts, float(v)) for ts, v in pts
               if not isinstance(v, Mapping)]
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        return _increase(pts) / span

    def delta_since(self, name: str, since_ts: float,
                    labels: Optional[Mapping[str, Any]] = None
                    ) -> Optional[float]:
        """Reset-aware increase from the newest point at-or-before
        ``since_ts`` (or the oldest retained point when the window
        predates retention) to the newest point. None when nothing is
        retained."""
        _, pts = self._points(name, labels, None)
        pts = [(ts, float(v)) for ts, v in pts
               if not isinstance(v, Mapping)]
        if not pts:
            return None
        start = 0
        for i, (ts, _) in enumerate(pts):
            if ts <= float(since_ts):
                start = i
        return _increase(pts[start:]) if len(pts) > start + 1 else 0.0

    def percentile_over(self, name: str, q: float,
                        labels: Optional[Mapping[str, Any]] = None,
                        window_s: Optional[float] = None,
                        field: str = "p99") -> Optional[float]:
        """Windowed percentile-of-percentiles: the ``q``-th percentile
        (0-100) of the per-sweep ``field`` digests retained in the
        window — e.g. ``percentile_over("wire_latency_s", 90,
        field="p99", window_s=30)`` is "the p99 level the worst decile
        of recent sweeps saw". None when no digest in the window
        carries the field."""
        values = [v for _, v in self.series(name, labels,
                                            window_s=window_s,
                                            field=field)]
        if not values:
            return None
        return float(np.percentile(np.asarray(values, dtype=np.float64),
                                   float(q)))

    # -- sweep-level deltas (postmortem input) -------------------------------

    def deltas_since(self, since_ts: float,
                     max_series: int = 64) -> Dict[str, float]:
        """Nonzero counter increases since ``since_ts`` across every
        retained counter series, largest first, capped — the
        "last-good metrics delta" block a postmortem bundle carries."""
        # Each ring is read directly by its exact flat key — routing
        # through delta_since would re-run the subset MATCH per counter
        # (O(counters x series) on the supervisor's death path, and a
        # bare key could resolve to a superset-labeled sibling).
        with self._lock:
            rings = [(flat, list(s.points))
                     for flat, s in self._series.items()
                     if s.kind == "counter"]
        out: Dict[str, float] = {}
        for flat, raw in rings:
            pts = [(ts, float(v)) for ts, v in raw
                   if not isinstance(v, Mapping)]
            if not pts:
                continue
            start = 0
            for i, (ts, _) in enumerate(pts):
                if ts <= float(since_ts):
                    start = i
            delta = (_increase(pts[start:])
                     if len(pts) > start + 1 else 0.0)
            if delta:
                out[flat] = round(delta, 6)
        ranked = sorted(out.items(), key=lambda kv: -abs(kv[1]))
        return dict(ranked[:max_series])

    # -- the /history dispatch ----------------------------------------------

    def query(self, query: str, name: str,
              labels: Optional[Mapping[str, Any]] = None,
              window_s: Optional[float] = None,
              q: Optional[float] = None,
              field: Optional[str] = None,
              since_ts: Optional[float] = None) -> Dict[str, Any]:
        """One ``GET /history`` answer: ``query`` in ``series`` /
        ``rate`` / ``pctile`` / ``delta`` / ``latest``. Raises
        ``ValueError`` on an unknown query or missing required
        argument (the route's 400)."""
        doc: Dict[str, Any] = {"query": query, "name": name,
                               "labels": dict(labels or {}),
                               "window_s": window_s}
        if query == "series":
            doc["points"] = [[ts, v] for ts, v in
                             self.series(name, labels, window_s=window_s,
                                         field=field)]
            doc["field"] = field
        elif query == "rate":
            doc["value"] = self.rate(name, labels, window_s=window_s)
        elif query == "pctile":
            if q is None:
                raise ValueError("pctile query needs q= (0-100)")
            doc["q"] = float(q)
            doc["field"] = field or "p99"
            doc["value"] = self.percentile_over(
                name, float(q), labels, window_s=window_s,
                field=field or "p99")
        elif query == "delta":
            if since_ts is None:
                raise ValueError("delta query needs since_ts=")
            doc["since_ts"] = float(since_ts)
            doc["value"] = self.delta_since(name, float(since_ts), labels)
        elif query == "latest":
            doc["field"] = field
            doc["value"] = self.latest(name, labels, field=field)
        else:
            raise ValueError(f"unknown history query {query!r} (want "
                             f"series/rate/pctile/delta/latest)")
        return doc

    def describe(self) -> Dict[str, Any]:
        """The summary block ``/gang`` and ``/history`` (no args)
        serve: retention shape, sweep count, newest timestamp."""
        with self._lock:
            return {
                "retention": self.retention,
                "sweeps": self.sweeps,
                "n_series": len(self._series),
                "last_ts": self._last_ts,
            }


def parse_labels(spec: Optional[str]) -> Dict[str, str]:
    """``k:v,k2:v2`` (the /history query-string spelling — '=' is
    taken by the query string itself) -> a labels dict."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"bad label {part!r} (want k:v)")
        k, v = part.split(":", 1)
        out[k.strip()] = v.strip()
    return out
