"""The fleet collector: the gang-level aggregation layer over per-rank exporters — the port of ``sparktorch_tpu/obs/collector.py``.

Every rank serves its own observability surface (the parameter server
and :class:`~sparktorch_tpu_torch.native.gang.GangMetricsExporter`:
``/metrics``, ``/telemetry`` with its named sections, ``/heartbeats``).
The :class:`FleetCollector` assembles the whole-gang view:

- **scrape**: each poll pulls every rank's ``/telemetry`` and
  ``/heartbeats`` in parallel under one sweep deadline; a failing rank
  degrades to a warning and ``collector.scrape_errors_total{rank}``,
  its last good snapshot keeps serving, aging visibly;
- **tag**: every scraped series is re-keyed with ``rank`` and ``host``
  labels (labels the series already carries win);
- **merge**: the ranks' ``xprof`` sections fold into one gang budget
  (:func:`~sparktorch_tpu_torch.obs.xprof.merge_analyses`, published
  under ``xprof.gang_*``); the ``goodput``, ``skew``, ``health`` and
  ``profile`` sections into their run-level documents; heartbeat
  tables union into one gang table; history rings and alert rules
  judge every sweep;
- **re-serve**: ``GET /gang``, ``/metrics``, ``/telemetry``,
  ``/history``, ``/goodput``, ``/skew``, ``/health``, ``/profile`` and
  ``POST /ctl``, plus an optional JSONL sink with one merged snapshot
  (and the condensed ``goodput.run``, ``profile.run``, ``health.run``,
  ``skew.run`` and alert records) per poll.

Every sweep also stitches the ranks' ``rpc_spans`` rings into
whole-request trees (:mod:`~sparktorch_tpu_torch.obs.rpctrace`), each
with its critical path, published as the ``rpc_traces`` section and
condensed on ``/gang`` (:meth:`FleetCollector.rpc_traces`).

The module-level helpers: run ids (:func:`mint_run_id`) and their
16-bit wire tag (:func:`run_tag`); the one sanctioned way to read an
exporter's routes (:func:`scrape_text`, :func:`scrape_json`) and to
post a control verb (:func:`post_json`), all failing as
:class:`ScrapeError`; and :func:`snapshot_histogram`, a histogram's
roll-up in a snapshot matched by name and a label subset.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple
from urllib.parse import urlsplit

from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.prom import _parse_flat_key  # shared key grammar
from sparktorch_tpu_torch.obs.telemetry import Telemetry, format_key

_LOG = get_logger("sparktorch_tpu_torch.obs.collector")

_SCRAPE_TIMEOUT = 2.0


def mint_run_id(prefix: str = "gang") -> str:
    """A gang-unique run id: sortable timestamp + random suffix, no
    protocol-reserved characters (spaces, commas, '=' — it travels on
    the gang REG line and as a metric-adjacent token)."""
    return f"{prefix}-{time.strftime('%Y%m%dT%H%M%S')}-{os.urandom(3).hex()}"


def run_tag(run_id: Optional[str]) -> int:
    """16-bit correlation tag for the binary wire header's reserved
    bytes (frames predate string payloads there; two bytes is room for
    a join key, not a name). 0 is reserved for "untagged" — the value
    every pre-tag encoder wrote — so a real run id always maps to a
    nonzero tag."""
    if not run_id:
        return 0
    tag = zlib.crc32(str(run_id).encode()) & 0xFFFF
    return tag or 1


# ---------------------------------------------------------------------------
# Sanctioned scrape helpers
# ---------------------------------------------------------------------------


class ScrapeError(OSError):
    """The exporter was unreachable or answered garbage."""


def scrape_text(url: str, timeout: float = _SCRAPE_TIMEOUT) -> str:
    """GET a text route (e.g. ``/metrics``). Raises ScrapeError on any
    network failure or non-200 status."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                raise ScrapeError(f"{url}: HTTP {resp.status}")
            return resp.read().decode("utf-8", errors="replace")
    except ScrapeError:
        raise
    except (OSError, ValueError) as e:
        raise ScrapeError(f"{url}: {type(e).__name__}: {e}") from e


def scrape_json(url: str, timeout: float = _SCRAPE_TIMEOUT) -> Any:
    """GET + parse a JSON route (``/telemetry``, ``/heartbeats``,
    ``/gang``). Raises ScrapeError on network failure, non-200, or a
    body that is not valid JSON (the torn-response case readers must
    survive)."""
    body = scrape_text(url, timeout=timeout)
    try:
        return json.loads(body)
    except ValueError as e:
        raise ScrapeError(f"{url}: torn/invalid JSON: {e}") from e


def post_json(url: str, payload: Mapping[str, Any],
              timeout: float = _SCRAPE_TIMEOUT,
              headers: Optional[Mapping[str, str]] = None) -> Any:
    """POST a JSON document to a control route (``/ctl``) and parse
    the JSON reply — the write-side twin of :func:`scrape_json`, kept
    in obs/ so control traffic shares the same timeout/error taxonomy
    the lint-obs scrape discipline enforces on readers. Raises
    :class:`ScrapeError` on network failure or a non-JSON reply;
    non-2xx statuses raise with the server's body in the message (a
    403 bad-token or 400 unknown-verb reply is the diagnostic)."""
    req = urllib.request.Request(
        url, data=json.dumps(dict(payload)).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 **(dict(headers) if headers else {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode("utf-8", errors="replace")
            if resp.status < 200 or resp.status >= 300:
                raise ScrapeError(f"{url}: HTTP {resp.status}: {body}")
    except ScrapeError:
        raise
    except urllib.error.HTTPError as e:
        detail = e.read().decode("utf-8", errors="replace")
        raise ScrapeError(f"{url}: HTTP {e.code}: {detail}") from e
    except (OSError, ValueError) as e:
        raise ScrapeError(f"{url}: {type(e).__name__}: {e}") from e
    try:
        return json.loads(body)
    except ValueError as e:
        raise ScrapeError(f"{url}: torn/invalid JSON reply: {e}") from e


def snapshot_histogram(snapshot: Mapping[str, Any], name: str,
                       labels: Optional[Mapping[str, Any]] = None
                       ) -> Optional[Dict[str, Any]]:
    """The roll-up of histogram ``name`` in a telemetry snapshot dict
    (a ``/telemetry`` scrape, a collector's merged snapshot, or a
    JSONL dump record), matched by name + a label SUBSET: every given
    label must match, EXTRA labels on the series are ignored — a
    collector re-keys scraped series with rank/host labels, and a
    consumer asking for ``serve.request_latency_s{replica=2}`` must
    find it regardless of which target it was scraped from. When
    several series match (the same replica scraped under two targets)
    the one with the largest sample count wins. None when nothing
    matches — readers must treat that as "no signal", never as zero.

    This is the sanctioned read path for routing/consuming decisions
    off scraped snapshots (the lint-obs scrape discipline's read-side
    twin): the ``name{k=v}`` key grammar stays parsed in obs/."""
    hists = snapshot.get("histograms")
    if not isinstance(hists, Mapping):
        return None
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    best: Optional[Dict[str, Any]] = None
    for flat, rollup in hists.items():
        series_name, series_labels = _parse_flat_key(str(flat))
        if series_name != name or not isinstance(rollup, Mapping):
            continue
        have = dict(series_labels)
        if any(have.get(k) != v for k, v in want.items()):
            continue
        if best is None or (rollup.get("count") or 0) > \
                (best.get("count") or 0):
            best = dict(rollup)
    return best


# ---------------------------------------------------------------------------
# The collector
# ---------------------------------------------------------------------------


class _RankState:
    __slots__ = ("url", "host", "snapshot", "heartbeats", "last_ok_ts",
                 "last_error", "scrapes", "errors", "committed_seq")

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.host = urlsplit(self.url).hostname or "?"
        self.snapshot: Optional[Dict[str, Any]] = None
        self.heartbeats: Optional[Dict[str, Any]] = None
        self.last_ok_ts: Optional[float] = None
        self.last_error: Optional[str] = None
        self.scrapes = 0
        self.errors = 0
        # Sweep generation of the last committed scrape: a straggler
        # from an OLDER sweep must never overwrite a newer snapshot
        # (and re-stamp it fresh) after a later sweep already landed.
        self.committed_seq = -1


def _tag_series(flat: str, rank: str, host: str) -> str:
    """Re-key ``name{labels}`` with rank/host labels. Labels the
    series already carries WIN (a heartbeat gauge's own ``rank`` names
    the heartbeat's rank, not the scrape target's)."""
    name, labels = _parse_flat_key(flat)
    merged = {"rank": rank, "host": host}
    merged.update(labels)
    return format_key((name, tuple(sorted(merged.items()))))


class FleetCollector:
    """Scrape N rank exporters, merge, re-serve the unified view.

    ``targets`` maps rank -> exporter base URL (the
    ``GangMetricsExporter`` / ``ParamServerHttp`` address). ``poll()``
    is one synchronous sweep — callable directly (tests, one-shot CLI
    use) or driven by the background loop ``start()`` launches when
    ``poll_interval_s`` > 0. ``jsonl_path`` appends one merged
    snapshot per poll (the ``timeline --gang`` input).
    """

    def __init__(self, targets: Mapping[Any, str],
                 telemetry: Optional[Telemetry] = None,
                 run_id: Optional[str] = None,
                 poll_interval_s: float = 2.0,
                 jsonl_path: Optional[str] = None,
                 fallback_jsonl: Optional[str] = None,
                 scrape_timeout_s: float = _SCRAPE_TIMEOUT,
                 poll_parallelism: int = 8,
                 poll_deadline_s: Optional[float] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ctl=None, ctl_token: Optional[str] = None,
                 history=True,
                 history_retention: Optional[int] = None,
                 history_spill_jsonl: Optional[str] = None,
                 alert_rules=None):
        if not targets:
            raise ValueError("FleetCollector needs at least one target")
        self.run_id = run_id or mint_run_id("collector")
        self.telemetry = telemetry or Telemetry(run_id=self.run_id)
        # Retained history: every poll sweep appends the merged series
        # into bounded per-series rings (obs.history.MetricsHistory),
        # served back as derived queries on ``GET /history`` and as
        # the substrate the alert rules judge. ``history=False`` turns
        # the tier off (the bench's overhead control leg); a
        # MetricsHistory instance is adopted as-is.
        from sparktorch_tpu_torch.obs.history import DEFAULT_RETENTION, MetricsHistory

        if history is True:
            self.history: Optional[MetricsHistory] = MetricsHistory(
                retention=history_retention or DEFAULT_RETENTION,
                spill_jsonl=history_spill_jsonl)
        elif history:
            self.history = history
        else:
            self.history = None
        # Declarative SLO/threshold alerting over the history
        # (obs.alerts): rules evaluate once per sweep; latched,
        # episode-counted transitions land on the bus, in the JSONL
        # sink, and in /gang's ``alerts`` section.
        self.alerts = None
        if alert_rules:
            if self.history is None:
                raise ValueError("alert_rules need history enabled")
            from sparktorch_tpu_torch.obs.alerts import AlertManager

            self.alerts = (alert_rules
                           if isinstance(alert_rules, AlertManager)
                           else AlertManager(self.history, alert_rules,
                                             telemetry=self.telemetry))
        # One atomic (sig, history) pair like _fallback_cache — two
        # separately-assigned attributes can tear under the threading
        # HTTP server and re-serve a reconstruction staler than the file.
        self._fallback_history_cache: Optional[
            Tuple[Tuple[int, int], MetricsHistory]] = None
        self._ranks: Dict[str, _RankState] = {
            str(r): _RankState(url) for r, url in targets.items()
        }
        self.poll_interval_s = poll_interval_s
        self.jsonl_path = jsonl_path
        # HA tail mode: a PEER collector's JSONL sink. When this
        # collector has never scraped a single rank successfully (and
        # none of its last-good snapshots exist), ``/gang`` falls back
        # to the newest merged snapshot in the peer's file — a
        # secondary collector keeps answering operators from the
        # primary's sink while the primary (or the whole scrape plane)
        # is down. Served with ``source: fallback_jsonl`` so a reader
        # can tell live data from tailed data.
        self.fallback_jsonl = fallback_jsonl
        self.scrape_timeout_s = scrape_timeout_s
        # Fan-in at scale: scrape targets in PARALLEL (a param-server
        # fleet multiplies targets — N shards + gateway per host; a
        # serial sweep would take N x timeout when several die at
        # once) under one sweep-wide deadline budget. poll_parallelism
        # <= 1 restores the serial sweep.
        self.poll_parallelism = max(1, int(poll_parallelism))
        self.poll_deadline_s = (
            poll_deadline_s if poll_deadline_s is not None
            else scrape_timeout_s * 2 + 1.0
        )
        self._scrape_pool = None
        self._poll_seq = -1  # sweep generation (stale-commit guard)
        # Control plane: ``POST /ctl`` with a ``rank`` is FORWARDED to
        # that rank's exporter (same route, token header passed
        # through) — the controller talks to one address and the
        # collector fans out, exactly like the read side. Without a
        # rank, the verb dispatches to this collector's own registry
        # (``ctl`` — e.g. the elastic controller's resize verb);
        # ``ctl_token`` guards BOTH paths (None = unguarded, for
        # loopback dev rigs).
        self.ctl = ctl
        self.ctl_token = ctl_token
        self.host = host
        self.port = port
        self._lock = threading.Lock()
        self._gang_xprof: Optional[Dict[str, Any]] = None
        self._rpc_doc: Optional[Dict[str, Any]] = None
        self._xprof_fingerprint: Optional[Tuple] = None
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None

    @classmethod
    def for_fleet(cls, fleet, per_shard: bool = False,
                  **kwargs) -> "FleetCollector":
        """Collector over a param-server FLEET's scrape surface.
        Default is the fleet's single deduplicated target (the
        in-process fleet shares ONE bus across shards — scraping
        every frontend would multiply every series by the target
        count; per-shard attribution rides the ``shard`` labels).
        ``per_shard=True`` targets every shard frontend + gateway —
        for fleets whose shards own separate buses. ``fleet`` is a
        :class:`~sparktorch_tpu_torch.serve.fleet.ParamServerFleet` (or
        anything with ``collector_targets()``)."""
        kwargs.setdefault("run_id", getattr(
            getattr(fleet, "telemetry", None), "run_id", None))
        return cls(fleet.collector_targets(per_shard=per_shard), **kwargs)

    # -- scraping ----------------------------------------------------------

    def _scrape_rank(self, rank: str, st: _RankState,
                     seq: int = -1) -> None:
        """One target's scrape (telemetry + heartbeats), with the
        degrade-to-last-good contract. Thread-safe: state lands under
        the collector lock, so parallel sweeps never tear a rank —
        and ``seq`` (the sweep generation) gates the commit, so a
        STRAGGLING scrape from an older sweep that finally answers
        after a newer sweep landed is dropped, never allowed to roll
        the rank's snapshot (and its freshness stamp) backwards."""
        tele = self.telemetry
        labels = {"rank": rank}
        try:
            snap = scrape_json(st.url + "/telemetry",
                               timeout=self.scrape_timeout_s)
            if not isinstance(snap, dict):
                raise ScrapeError(f"{st.url}/telemetry: not an object")
            hb: Optional[Dict[str, Any]] = None
            try:
                got = scrape_json(st.url + "/heartbeats",
                                  timeout=self.scrape_timeout_s)
                hb = got if isinstance(got, dict) else None
            except ScrapeError:
                hb = None  # optional route; /telemetry carries gauges
            with self._lock:
                if seq < st.committed_seq:
                    tele.counter("collector.stale_scrapes_dropped_total",
                                 labels=labels)
                    return
                st.committed_seq = seq
                st.snapshot = snap
                if hb is not None:
                    # Same degrade-to-last-good contract as the
                    # snapshot: a transient /heartbeats failure
                    # must not make this target's ranks VANISH
                    # from /gang — the stale table keeps serving
                    # (its ages grow, which is the visible signal).
                    st.heartbeats = hb
                st.last_ok_ts = time.time()
                st.last_error = None
                st.scrapes += 1
            tele.counter("collector.scrapes_total", labels=labels)
        except ScrapeError as e:
            with self._lock:
                st.errors += 1
                st.last_error = str(e)
            tele.counter("collector.scrape_errors_total", labels=labels)
            _LOG.warning(
                f"[sparktorch_tpu_torch:collector] rank {rank} scrape "
                f"failed (serving last good snapshot): {e}"
            )

    def poll(self) -> Dict[str, Any]:
        """One sweep over every rank: scrape (in parallel), tag,
        merge, sink. Returns the merged snapshot. Per-rank failures
        degrade to warnings + counters; the sweep itself never raises.

        Parallel fan-in: targets scrape concurrently (bounded by
        ``poll_parallelism``) under the ``poll_deadline_s`` sweep
        budget, so sweep wall is ~one timeout even when several
        targets hang — a serial sweep over a fleet's N shard
        frontends would take N timeouts exactly when things are on
        fire. A target that misses the sweep deadline is counted
        (``collector.scrape_deadline_misses_total{rank}``) and its
        last good snapshot keeps serving; its straggling scrape still
        lands when it finishes — unless a NEWER sweep already
        committed for that rank, in which case the stale result is
        dropped (``collector.stale_scrapes_dropped_total{rank}``)
        instead of rolling the snapshot backwards."""
        tele = self.telemetry
        items = list(self._ranks.items())
        self._poll_seq += 1
        seq = self._poll_seq
        if self.poll_parallelism <= 1 or len(items) == 1:
            for rank, st in items:
                self._scrape_rank(rank, st, seq)
        else:
            from concurrent.futures import ThreadPoolExecutor, wait

            if self._scrape_pool is None:
                self._scrape_pool = ThreadPoolExecutor(
                    max_workers=min(len(items), self.poll_parallelism),
                    thread_name_prefix="collector-scrape",
                )
            futures = {
                self._scrape_pool.submit(self._scrape_rank, rank, st,
                                         seq): rank
                for rank, st in items
            }
            _done, not_done = wait(futures, timeout=self.poll_deadline_s)
            for future in not_done:
                rank = futures[future]
                tele.counter("collector.scrape_deadline_misses_total",
                             labels={"rank": rank})
                _LOG.warning(
                    f"[sparktorch_tpu_torch:collector] rank {rank} scrape "
                    f"missed the {self.poll_deadline_s}s sweep deadline "
                    f"(serving last good snapshot)"
                )
        self._merge_xprof()
        self._stitch_rpc()
        self._merge_goodput()
        self._merge_profile()
        self._merge_health()
        merged = self.merged_snapshot()
        alert_events: List[Dict[str, Any]] = []
        if self.history is not None:
            self.history.append(merged)
            if self.alerts is not None:
                alert_events = self.alerts.evaluate(ts=merged.get("ts"))
        if self.jsonl_path:
            from sparktorch_tpu_torch.obs.sinks import write_jsonl

            try:
                # The sink record also carries the unioned heartbeat
                # table (merged_snapshot alone does not — heartbeats
                # are a /gang-level join): a secondary collector
                # tailing this file must be able to serve the
                # straggler/step-skew view, which is exactly what an
                # operator wants DURING the outage HA mode covers.
                # Alert transitions land in the sink as their own
                # records BEFORE the snapshot: a `timeline --follow`
                # tail renders the firing the moment it happens, and
                # the HA fallback secondary replays the same episodes.
                # The run-level goodput accounting rides the same way
                # — one condensed `goodput.run` record per sweep (the
                # shape `--follow` renders as a one-liner), with the
                # full document still on the snapshot's sections.
                goodput_records: List[Dict[str, Any]] = []
                run_doc = (merged.get("sections") or {}).get("goodput_run")
                if isinstance(run_doc, Mapping):
                    goodput_records.append({
                        "kind": "goodput.run", "ts": merged.get("ts"),
                        "goodput": run_doc.get("goodput"),
                        "wall_s": run_doc.get("wall_s"),
                        "n_ranks": run_doc.get("n_ranks"),
                        "comm_source": run_doc.get("comm_source"),
                        "biggest_thief": run_doc.get("biggest_thief"),
                    })
                # Same shape for the merged stack profile: one
                # condensed `profile.run` line per sweep, full tries
                # on the snapshot's sections (timeline --profile
                # reads those back out of this very file).
                profile_records: List[Dict[str, Any]] = []
                prof_doc = (merged.get("sections") or {}).get("profile_run")
                if isinstance(prof_doc, Mapping):
                    profile_records.append({
                        "kind": "profile.run", "ts": merged.get("ts"),
                        "samples_total": prof_doc.get("samples_total"),
                        "n_ranks": prof_doc.get("n_ranks"),
                        "bursts": prof_doc.get("bursts"),
                    })
                # And the model-health merge: one condensed
                # `health.run` line per sweep (anomaly counts stay
                # rank-tagged — a single poisoned rank must surface
                # by name, never averaged into the fleet).
                health_records: List[Dict[str, Any]] = []
                health_doc = (merged.get("sections") or {}).get("health_run")
                if isinstance(health_doc, Mapping):
                    health_records.append({
                        "kind": "health.run", "ts": merged.get("ts"),
                        "n_ranks": health_doc.get("n_ranks"),
                        "last_step": health_doc.get("last_step"),
                        "anomalies_total": health_doc.get(
                            "anomalies_total"),
                        "counts": health_doc.get("counts"),
                        "worst": health_doc.get("worst"),
                    })
                # The cross-rank straggler verdict: one condensed
                # `skew.run` line per sweep (the wire/straggler split
                # plus the named laggard — the `--follow` one-liner),
                # full doc on the snapshot's sections.
                skew_records: List[Dict[str, Any]] = []
                skew_doc = (merged.get("sections") or {}).get("skew_run")
                if isinstance(skew_doc, Mapping):
                    skew_records.append({
                        "kind": "skew.run", "ts": merged.get("ts"),
                        "n_ranks": skew_doc.get("n_ranks"),
                        "steps_aligned": skew_doc.get("steps_aligned"),
                        "wire_s": skew_doc.get("wire_s"),
                        "straggler_wait_s": skew_doc.get(
                            "straggler_wait_s"),
                        "straggler_fraction": skew_doc.get(
                            "straggler_fraction"),
                        "laggard": skew_doc.get("laggard"),
                    })
                write_jsonl(self.jsonl_path,
                            [{"kind": f"alert.{e['event']}", **e}
                             for e in alert_events]
                            + goodput_records + profile_records
                            + health_records + skew_records
                            + [{"kind": "gang_snapshot", **merged,
                                "heartbeats": self._merged_heartbeats()}],
                            append=True)
            except OSError as e:
                _LOG.warning(
                    f"[sparktorch_tpu_torch:collector] JSONL sink "
                    f"{self.jsonl_path!r} failed: {e}"
                )
        return merged

    def _merge_xprof(self) -> None:
        """Fold every rank's ``xprof`` snapshot section into one gang
        budget. Re-published only when some rank's analysis actually
        changed — republishing identical analyses each poll would
        duplicate histogram samples and inflate the merge counters."""
        with self._lock:
            found: List[Tuple[str, Dict[str, Any]]] = []
            for rank, st in self._ranks.items():
                section = ((st.snapshot or {}).get("sections") or {}).get(
                    "xprof")
                if isinstance(section, dict) and section.get("steps"):
                    found.append((rank, section))
        if not found:
            return
        fingerprint = tuple(
            (rank, d.get("source"), d.get("n_events"), d.get("wall_s"))
            for rank, d in found
        )
        if fingerprint == self._xprof_fingerprint:
            return
        from sparktorch_tpu_torch.obs.xprof import merge_analyses

        try:
            gang = merge_analyses([d for _, d in found],
                                  ranks=[r for r, _ in found],
                                  run_id=self.run_id)
        except (KeyError, TypeError, ValueError) as e:
            _LOG.warning(
                f"[sparktorch_tpu_torch:collector] xprof merge failed: {e}"
            )
            return
        self._xprof_fingerprint = fingerprint
        gang.publish(self.telemetry)
        with self._lock:
            self._gang_xprof = gang.to_dict()

    def _stitch_rpc(self) -> None:
        """Join every scraped rank's ``rpc_spans`` ring (and this bus's
        own) into whole-request trees by trace id: a worker's root and
        the serving rank's queue-wait and apply spans live on different
        buses until here. The document (each tree with its critical
        path) is this bus's ``rpc_traces`` section, so the JSONL sink,
        ``/telemetry``, ``/gang`` and ``timeline --rpc`` agree."""
        from sparktorch_tpu_torch.obs import rpctrace

        spans: List[Dict[str, Any]] = []
        with self._lock:
            for st in self._ranks.values():
                spans.extend(rpctrace.spans_from_snapshot(
                    st.snapshot or {}))
        own = self.telemetry.get_section(rpctrace.SECTION)
        if isinstance(own, dict):
            spans.extend(own.get("spans") or [])
        if not spans:
            return
        traces = rpctrace.stitch_spans(spans, max_traces=32)
        doc = {
            "n_spans": len(spans),
            "n_traces": len(traces),
            "traces": traces,
        }
        with self._lock:
            self._rpc_doc = doc
        self.telemetry.set_section(rpctrace.TRACES_SECTION, doc)

    def rpc_traces(self) -> List[Dict[str, Any]]:
        """The last stitched whole-request trees (newest first)."""
        with self._lock:
            return list((self._rpc_doc or {}).get("traces") or [])

    def _merge_goodput(self) -> None:
        """Fold every scraped rank's ``goodput`` ledger section (plus
        this collector's own bus's, when a driver-side ledger shares
        it) into ONE run-level report, published as the
        ``goodput_run`` section — so the JSONL sink, ``/telemetry``,
        ``/gang``, postmortem bundles, and ``timeline --goodput`` all
        carry the same run accounting. The last-good contract applies:
        a dead rank's final ledger keeps contributing."""
        from sparktorch_tpu_torch.obs import goodput as _goodput

        from sparktorch_tpu_torch.obs import skew as _skew

        # The skew merge runs FIRST: it decomposes exposed_comm from
        # the same per-rank sections, and the fresh skew_run verdict
        # refines this merge's biggest_thief (straggler_wait vs wire).
        self._merge_skew()
        with self._lock:
            snaps = {r: st.snapshot for r, st in self._ranks.items()}
        docs = _goodput.sections_from_snapshots(snaps)
        own = self.telemetry.get_section(_goodput.SECTION)
        if isinstance(own, Mapping):
            docs.setdefault("collector", own)
        if not docs:
            return
        skew_run = self.telemetry.get_section(_skew.RUN_SECTION)
        run = _goodput.merge_sections(
            docs, skew=skew_run if isinstance(skew_run, Mapping) else None)
        run["run_id"] = self.run_id
        self.telemetry.set_section(_goodput.RUN_SECTION, run)

    def goodput_view(self) -> Optional[Dict[str, Any]]:
        """The run-level goodput report ``GET /goodput`` serves —
        recomputed from the freshest last-good snapshots at read time
        (a rank's ledger advances between poll sweeps only via
        scrapes, so this is one merge over already-held state, never
        a network hop). None when no rank has published a ledger."""
        self._merge_goodput()
        from sparktorch_tpu_torch.obs import goodput as _goodput

        doc = self.telemetry.get_section(_goodput.RUN_SECTION)
        return dict(doc) if isinstance(doc, Mapping) else None

    def _merge_skew(self) -> None:
        """Align every scraped rank's ``skew`` step-stamp ring (plus
        this collector's own bus's, when a driver-side ledger shares
        it) into the run-level straggler verdict, published as the
        ``skew_run`` section and exported as ``skew.*`` gauges (the
        series the sustained straggler-fraction alert rule judges).
        The per-rank goodput/health sections from the SAME snapshots
        supply the exposed_comm budget and the laggard's cause
        evidence. Last-good contract: a dead rank's final stamps keep
        contributing."""
        from sparktorch_tpu_torch.obs import goodput as _goodput
        from sparktorch_tpu_torch.obs import health as _health
        from sparktorch_tpu_torch.obs import skew as _skew

        with self._lock:
            snaps = {r: st.snapshot for r, st in self._ranks.items()}
        docs = _skew.sections_from_snapshots(snaps)
        own = self.telemetry.get_section(_skew.SECTION)
        if isinstance(own, Mapping):
            docs.setdefault("collector", own)
        if not docs:
            return
        gdocs = _goodput.sections_from_snapshots(snaps)
        gown = self.telemetry.get_section(_goodput.SECTION)
        if isinstance(gown, Mapping):
            gdocs.setdefault("collector", gown)
        hdocs = _health.sections_from_snapshots(snaps)
        run = _skew.merge_sections(docs, goodput_docs=gdocs,
                                   health_docs=hdocs)
        run["run_id"] = self.run_id
        self.telemetry.set_section(_skew.RUN_SECTION, run)
        _skew.publish_run_gauges(self.telemetry, run)

    def skew_view(self) -> Optional[Dict[str, Any]]:
        """The run-level straggler verdict ``GET /skew`` serves —
        recomputed from the freshest last-good snapshots at read
        time, like :meth:`goodput_view`. None when no rank has
        published step stamps."""
        self._merge_skew()
        from sparktorch_tpu_torch.obs import skew as _skew

        doc = self.telemetry.get_section(_skew.RUN_SECTION)
        return dict(doc) if isinstance(doc, Mapping) else None

    def _merge_profile(self) -> None:
        """Fold every scraped rank's ``profile`` section (plus this
        collector's own bus's, when a driver-side sampler shares it)
        into one run-level stack profile, published as the
        ``profile_run`` section — the same path the goodput merge
        takes, with the same last-good contract: a SIGKILLed rank's
        final throttled publish keeps contributing its tries."""
        from sparktorch_tpu_torch.obs import profile as _profile

        with self._lock:
            snaps = {r: st.snapshot for r, st in self._ranks.items()}
        docs = _profile.sections_from_snapshots(snaps)
        own = self.telemetry.get_section(_profile.SECTION)
        if isinstance(own, Mapping):
            docs.setdefault("collector", own)
        if not docs:
            return
        run = _profile.merge_sections(docs)
        run["run_id"] = self.run_id
        self.telemetry.set_section(_profile.RUN_SECTION, run)

    def profile_view(self) -> Optional[Dict[str, Any]]:
        """The merged stack profile ``GET /profile`` serves —
        recomputed from the freshest last-good snapshots at read
        time, like :meth:`goodput_view`. None when no rank has
        published a profile section."""
        self._merge_profile()
        from sparktorch_tpu_torch.obs import profile as _profile

        doc = self.telemetry.get_section(_profile.RUN_SECTION)
        return dict(doc) if isinstance(doc, Mapping) else None

    def _merge_health(self) -> None:
        """Fold every scraped rank's ``health`` ledger section (plus
        this collector's own bus's, when a driver-side ledger shares
        it) into one run-level model-health report, published as the
        ``health_run`` section. The merge is strictly rank-tagged —
        anomalies carry their source rank and are never averaged, so
        a single poisoned rank surfaces by name. Last-good contract:
        a dead rank's final ledger keeps contributing its anomalies."""
        from sparktorch_tpu_torch.obs import health as _health

        with self._lock:
            snaps = {r: st.snapshot for r, st in self._ranks.items()}
        docs = _health.sections_from_snapshots(snaps)
        own = self.telemetry.get_section(_health.SECTION)
        if isinstance(own, Mapping):
            docs.setdefault("collector", own)
        if not docs:
            return
        run = _health.merge_sections(docs)
        run["run_id"] = self.run_id
        self.telemetry.set_section(_health.RUN_SECTION, run)

    def health_view(self) -> Optional[Dict[str, Any]]:
        """The run-level model-health report ``GET /health`` serves —
        recomputed from the freshest last-good snapshots at read
        time, like :meth:`goodput_view`. None when no rank has
        published a health section."""
        self._merge_health()
        from sparktorch_tpu_torch.obs import health as _health

        doc = self.telemetry.get_section(_health.RUN_SECTION)
        return dict(doc) if isinstance(doc, Mapping) else None

    # -- merged views ------------------------------------------------------

    def _rank_status_locked(self, now: float) -> Dict[str, Any]:
        """Per-rank scrape status; caller holds ``self._lock``."""
        return {
            r: {
                "url": st.url,
                "host": st.host,
                "ok": st.last_error is None and st.snapshot is not None,
                "scrapes": st.scrapes,
                "errors": st.errors,
                "last_error": st.last_error,
                "last_scrape_age_s": (
                    now - st.last_ok_ts
                    if st.last_ok_ts is not None else None
                ),
                "run_id": (st.snapshot or {}).get("run_id"),
            }
            for r, st in self._ranks.items()
        }

    def merged_snapshot(self) -> Dict[str, Any]:
        """The unified metric view: every rank's series re-keyed with
        rank/host labels, the collector's own metrics (scrape counters,
        gang xprof budget) alongside, plus per-rank scrape status."""
        own = self.telemetry.snapshot()
        now = time.time()
        with self._lock:
            rank_snaps = {r: (st.snapshot, st.host)
                          for r, st in self._ranks.items()}
            status = self._rank_status_locked(now)
        merged: Dict[str, Any] = {
            "run_id": self.run_id,
            "ts": now,
            "counters": dict(own.get("counters", {})),
            "gauges": dict(own.get("gauges", {})),
            "histograms": dict(own.get("histograms", {})),
            "spans": dict(own.get("spans", {})),
            "info": dict(own.get("info", {})),
            "ranks": status,
        }
        if "sections" in own:
            merged["sections"] = own["sections"]
        for r, (snap, host) in rank_snaps.items():
            if not snap:
                continue
            for section in ("counters", "gauges", "histograms", "spans",
                            "info"):
                for flat, value in (snap.get(section) or {}).items():
                    merged[section][_tag_series(flat, r, host)] = value
        merged["gauges"]["collector.ranks"] = float(len(self._ranks))
        merged["gauges"]["collector.ranks_ok"] = float(
            sum(1 for s in status.values() if s["ok"])
        )
        return merged

    def _merged_heartbeats(self) -> Dict[str, Any]:
        """The unioned gang heartbeat table (freshest record per rank
        across targets sharing a directory) + derived step skew —
        shared by ``gang_view`` and the JSONL sink record, so a
        fallback secondary tails the same table ``/gang`` serves."""
        hb_ranks: Dict[str, Any] = {}
        steps: List[int] = []
        with self._lock:
            for r, st in self._ranks.items():
                for hb_rank, rec in ((st.heartbeats or {}).get("ranks")
                                     or {}).items():
                    prev = hb_ranks.get(str(hb_rank))
                    # Two targets may report the same heartbeat rank
                    # (shared directory): freshest record wins.
                    if prev is not None and (
                            prev.get("last_seen_age_s", 1e18)
                            <= rec.get("last_seen_age_s", 1e18)):
                        continue
                    hb_ranks[str(hb_rank)] = dict(rec)
        for rec in hb_ranks.values():
            if rec.get("step") is not None:
                steps.append(int(rec["step"]))
        heartbeats: Dict[str, Any] = {
            "n_ranks": len(hb_ranks),
            "ranks": hb_ranks,
            "alive": sorted((r for r, v in hb_ranks.items()
                             if v.get("alive")), key=str),
        }
        if steps:
            heartbeats["step_min"] = min(steps)
            heartbeats["step_max"] = max(steps)
            heartbeats["step_skew"] = max(steps) - min(steps)
        return heartbeats

    def gang_view(self) -> Dict[str, Any]:
        """The joined gang document ``GET /gang`` serves: scrape
        status per rank, the unioned heartbeat table (re-aged at read
        time), the merged xprof budget, and every run_id seen — the
        cross-rank correlation surface. Reads only the per-rank status
        and heartbeat/xprof state — it does NOT pay the full series
        tag-and-merge that ``merged_snapshot`` does (O(ranks), not
        O(total series), per ``/gang`` poll)."""
        now = time.time()
        with self._lock:
            status = self._rank_status_locked(now)
            gang_xprof = self._gang_xprof
            rpc_doc = self._rpc_doc
        if self.fallback_jsonl and not any(
                s["ok"] or s["scrapes"] for s in status.values()):
            # HA tail mode: this collector has NEVER landed a scrape
            # (secondary spun up while the scrape plane is dark) — keep
            # answering from the peer collector's sink rather than
            # serving an empty gang.
            fallback = self._fallback_gang_view(now)
            if fallback is not None:
                return fallback
        heartbeats = self._merged_heartbeats()
        doc = {
            "run_id": self.run_id,
            "ts": now,
            "source": "live",
            "ranks": status,
            "run_ids": {r: s.get("run_id") for r, s in status.items()},
            "heartbeats": heartbeats,
            "xprof": gang_xprof,
        }
        # Elastic control-plane state: when an ElasticController shares
        # this collector's bus (bringup wires them together), its
        # generation-tagged world document — current world size,
        # members, and the shrink/grow/restart event history — rides
        # /gang beside liveness, so one scrape answers both "who is
        # alive" and "what did the controller do about it".
        elastic = self.telemetry.get_section("elastic")
        if isinstance(elastic, dict):
            doc["elastic"] = elastic
        # The judgment layer rides the same scrape: what the collector
        # is worried about (alerts) and how much it remembers
        # (history shape) — one /gang answers liveness, control-plane
        # state, AND the SLO verdicts.
        if self.alerts is not None:
            doc["alerts"] = self.alerts.doc()
        if self.history is not None:
            doc["history"] = self.history.describe()
        if rpc_doc:
            # The condensed per-request view (which requests, how slow,
            # bounded by what); the full trees ride the section.
            doc["rpc"] = {
                "n_traces": rpc_doc.get("n_traces", 0),
                "n_spans": rpc_doc.get("n_spans", 0),
                "traces": [
                    {
                        "trace_id": t.get("trace_id"),
                        "name": (t.get("root") or {}).get("name"),
                        "wall_s": t.get("wall_s"),
                        "n_spans": t.get("n_spans"),
                        "status": (t.get("root") or {}).get("status"),
                        "critical": {
                            k: (t.get("critical") or {}).get(k)
                            for k in ("name", "shard", "self_s",
                                      "fraction")
                        },
                    }
                    for t in (rpc_doc.get("traces") or [])[:8]
                ],
            }
        return doc

    def _fallback_gang_view(self, now: float) -> Optional[Dict[str, Any]]:
        """Reconstruct a ``/gang`` document from the newest merged
        snapshot in the peer collector's JSONL sink (``gang_snapshot``
        records carry rank status + the xprof_gang / rpc_traces
        sections). None when the file is unreadable or empty — the
        caller then serves its own (empty) live view. The parsed
        record is CACHED on the file's (size, mtime) signature: the
        primary appends one snapshot per poll for hours, and
        re-parsing a tens-of-MB sink per operator ``/gang`` request
        would make fallback latency grow with primary uptime."""
        import os as _os

        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            st = _os.stat(self.fallback_jsonl)
            sig = (st.st_size, st.st_mtime_ns)
            cached = getattr(self, "_fallback_cache", None)
            if cached is not None and cached[0] == sig:
                rec = cached[1]
            else:
                records = read_jsonl(self.fallback_jsonl)
                rec = next((r for r in reversed(records)
                            if r.get("kind") == "gang_snapshot"), None)
                self._fallback_cache = (sig, rec)
        except OSError as e:
            _LOG.warning(
                f"[sparktorch_tpu_torch:collector] fallback sink "
                f"{self.fallback_jsonl!r} unreadable: {e}"
            )
            return None
        if rec is None:
            return None
        self.telemetry.counter("collector.fallback_serves_total")
        sections = rec.get("sections") or {}
        return {
            "run_id": rec.get("run_id"),
            "ts": rec.get("ts"),
            "source": "fallback_jsonl",
            "fallback_path": self.fallback_jsonl,
            "fallback_age_s": (now - float(rec["ts"])
                               if rec.get("ts") is not None else None),
            "serving_run_id": self.run_id,
            "ranks": rec.get("ranks") or {},
            "run_ids": {r: s.get("run_id")
                        for r, s in (rec.get("ranks") or {}).items()},
            "heartbeats": rec.get("heartbeats") or {},
            "xprof": sections.get("xprof_gang"),
            "rpc": {
                "n_traces": (sections.get("rpc_traces")
                             or {}).get("n_traces", 0),
                "traces": [
                    {
                        "trace_id": t.get("trace_id"),
                        "name": (t.get("root") or {}).get("name"),
                        "wall_s": t.get("wall_s"),
                        "critical": t.get("critical"),
                    }
                    for t in ((sections.get("rpc_traces")
                               or {}).get("traces") or [])[:8]
                ],
            },
        }

    # -- history serving ---------------------------------------------------

    def _history_for_serving(self):
        """The history ``GET /history`` answers from: this collector's
        own rings normally; in HA tail mode (never scraped, peer sink
        configured) a history RECONSTRUCTED from the peer's JSONL —
        the fallback secondary answers windowed queries, not just the
        newest snapshot. The reconstruction is cached on the file's
        (size, mtime) signature like the fallback gang view."""
        live = self.history
        if live is not None and live.sweeps > 0:
            return live
        if not self.fallback_jsonl:
            return live
        with self._lock:
            never_scraped = not any(st.scrapes for st in
                                    self._ranks.values())
        if not never_scraped:
            return live
        import os as _os

        from sparktorch_tpu_torch.obs.history import (DEFAULT_RETENTION,
                                                MetricsHistory)

        try:
            st = _os.stat(self.fallback_jsonl)
            sig = (st.st_size, st.st_mtime_ns)
        except OSError:
            return live
        cached = self._fallback_history_cache
        if cached is None or cached[0] != sig:
            try:
                rebuilt = MetricsHistory.from_jsonl(
                    self.fallback_jsonl,
                    retention=(live.retention if live is not None
                               else DEFAULT_RETENTION))
            except OSError as e:
                _LOG.warning(
                    f"[sparktorch_tpu_torch:collector] fallback history "
                    f"{self.fallback_jsonl!r} unreadable: {e}")
                return live
            cached = (sig, rebuilt)
            self._fallback_history_cache = cached
            self.telemetry.counter("collector.fallback_history_builds_total")
        return cached[1]

    def _handle_history(self, params: Mapping[str, Any]
                        ) -> Tuple[int, Dict[str, Any]]:
        """One ``GET /history`` request (params = parsed query string,
        one value per key). No ``name`` -> the describe block + series
        list; with one -> the named derived query."""
        from sparktorch_tpu_torch.obs.history import parse_labels

        history = self._history_for_serving()
        if history is None:
            return 404, {"ok": False, "error": "history tier disabled"}
        cached = self._fallback_history_cache
        source = ("fallback_jsonl"
                  if cached is not None and history is cached[1]
                  else "live")
        name = params.get("name")
        if not name:
            doc = history.describe()
            doc["series"] = history.series_names()
            doc["source"] = source
            return 200, doc
        try:
            doc = history.query(
                params.get("query") or "series",
                str(name),
                labels=parse_labels(params.get("labels")),
                window_s=(float(params["window_s"])
                          if params.get("window_s") else None),
                q=float(params["q"]) if params.get("q") else None,
                field=params.get("field") or None,
                since_ts=(float(params["since_ts"])
                          if params.get("since_ts") else None),
            )
        except ValueError as e:
            return 400, {"ok": False, "error": str(e)}
        doc["source"] = source
        return 200, doc

    # -- control plane -----------------------------------------------------

    def _check_ctl_token(self, token: Optional[str]) -> bool:
        if self.ctl is not None:
            return bool(self.ctl.check_token(token))
        if self.ctl_token:
            return token == self.ctl_token
        return True  # unguarded (loopback dev rigs)

    def _handle_ctl(self, body: Mapping[str, Any],
                    token: Optional[str]) -> Tuple[int, Dict[str, Any]]:
        """One ``POST /ctl`` request: with a ``rank``, forward the
        verb to that rank's exporter (the collector is the control
        fan-out exactly as it is the scrape fan-in — the controller
        needs one address); without one, dispatch to this collector's
        own registry (e.g. an elastic controller's ``resize``)."""
        if not self._check_ctl_token(token):
            return 403, {"ok": False, "error": "bad ctl token"}
        verb = body.get("verb")
        rank = body.get("rank")
        args = body.get("args") or {}
        labels = {"verb": str(verb)}
        if rank is not None:
            st = self._ranks.get(str(rank))
            if st is None:
                return 404, {"ok": False,
                             "error": f"unknown rank {rank!r}"}
            headers = {"X-Ctl-Token": token} if token else None
            try:
                reply = post_json(st.url + "/ctl",
                                  {"verb": verb, "args": args},
                                  timeout=self.scrape_timeout_s,
                                  headers=headers)
            except ScrapeError as e:
                self.telemetry.counter("collector.ctl_forward_errors_total",
                                       labels=labels)
                return 502, {"ok": False, "rank": str(rank),
                             "error": str(e)}
            self.telemetry.counter("collector.ctl_forwards_total",
                                   labels=labels)
            return 200, {"ok": True, "rank": str(rank), "reply": reply}
        if self.ctl is None:
            return 404, {"ok": False,
                         "error": "no collector-side ctl registry"}
        try:
            result = self.ctl.handle(verb, args)
        except KeyError:
            return 400, {"ok": False, "error": f"unknown verb {verb!r}"}
        except Exception as e:  # verb handlers are user code
            return 500, {"ok": False,
                         "error": f"{type(e).__name__}: {e}"}
        self.telemetry.counter("collector.ctl_requests_total",
                               labels=labels)
        return 200, {"ok": True, "verb": verb, "result": result}

    # -- HTTP surface ------------------------------------------------------

    def start(self, serve: bool = True,
              poll_loop: bool = True) -> "FleetCollector":
        """Start the HTTP surface (``/gang``, ``/metrics``,
        ``/telemetry``, ``/history``, ``/goodput``, ``/profile``,
        ``/health``, ``/skew``, ``POST /ctl``) and — when
        ``poll_interval_s`` > 0 and ``poll_loop`` — the background
        scrape loop."""
        if serve and self._httpd is None:
            from http.server import (
                BaseHTTPRequestHandler,
                ThreadingHTTPServer,
            )

            from sparktorch_tpu_torch.obs.prom import (
                CONTENT_TYPE as PROM_CONTENT_TYPE,
                render_prometheus,
            )

            collector = self

            class Handler(BaseHTTPRequestHandler):
                def log_message(self, *a):
                    pass

                def _send(self, code: int, body: bytes = b"",
                          content_type: Optional[str] = None):
                    self.send_response(code)
                    if content_type:
                        self.send_header("Content-Type", content_type)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    if body:
                        self.wfile.write(body)

                def do_GET(self):
                    route = self.path.split("?", 1)[0]
                    if route == "/":
                        self._send(200, b"sparktorch-tpu-torch fleet collector")
                    elif route == "/history":
                        from urllib.parse import parse_qs

                        qs = parse_qs(self.path.partition("?")[2])
                        params = {k: v[0] for k, v in qs.items() if v}
                        code, doc = collector._handle_history(params)
                        self._send(code, json.dumps(doc).encode(),
                                   content_type="application/json")
                    elif route == "/goodput":
                        doc = collector.goodput_view()
                        if doc is None:
                            self._send(404, json.dumps(
                                {"ok": False,
                                 "error": "no goodput ledger published "
                                          "by any scraped rank"}).encode(),
                                content_type="application/json")
                        else:
                            self._send(200, json.dumps(doc).encode(),
                                       content_type="application/json")
                    elif route == "/profile":
                        doc = collector.profile_view()
                        if doc is None:
                            self._send(404, json.dumps(
                                {"ok": False,
                                 "error": "no stack profile published "
                                          "by any scraped rank"}).encode(),
                                content_type="application/json")
                        else:
                            self._send(200, json.dumps(doc).encode(),
                                       content_type="application/json")
                    elif route == "/health":
                        doc = collector.health_view()
                        if doc is None:
                            self._send(404, json.dumps(
                                {"ok": False,
                                 "error": "no health ledger published "
                                          "by any scraped rank"}).encode(),
                                content_type="application/json")
                        else:
                            self._send(200, json.dumps(doc).encode(),
                                       content_type="application/json")
                    elif route == "/skew":
                        doc = collector.skew_view()
                        if doc is None:
                            self._send(404, json.dumps(
                                {"ok": False,
                                 "error": "no skew stamps published "
                                          "by any scraped rank"}).encode(),
                                content_type="application/json")
                        else:
                            self._send(200, json.dumps(doc).encode(),
                                       content_type="application/json")
                    elif route == "/gang":
                        self._send(200,
                                   json.dumps(collector.gang_view()).encode(),
                                   content_type="application/json")
                    elif route == "/metrics":
                        text = render_prometheus(collector.merged_snapshot())
                        self._send(200, text.encode(),
                                   content_type=PROM_CONTENT_TYPE)
                    elif route == "/telemetry":
                        self._send(
                            200,
                            json.dumps(collector.merged_snapshot()).encode(),
                            content_type="application/json")
                    else:
                        self._send(404)

                def do_POST(self):
                    route = self.path.split("?", 1)[0]
                    if route != "/ctl":
                        self._send(404)
                        return
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(length) or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError("ctl body must be an object")
                    except (ValueError, TypeError) as e:
                        self._send(400, str(e).encode())
                        return
                    token = self.headers.get("X-Ctl-Token")
                    code, reply = collector._handle_ctl(body, token)
                    self._send(code, json.dumps(reply).encode(),
                               content_type="application/json")

            self._httpd = ThreadingHTTPServer((self.host, self.port),
                                              Handler)
            self.port = self._httpd.server_address[1]
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
            self._http_thread.start()
        if poll_loop and self.poll_interval_s > 0 \
                and self._poll_thread is None:
            self._poll_stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="fleet-collector-poll",
            )
            self._poll_thread.start()
        return self

    def _poll_loop(self) -> None:
        while not self._poll_stop.is_set():
            try:
                self.poll()
            except Exception as e:  # the loop must outlive any sweep
                _LOG.warning(
                    f"[sparktorch_tpu_torch:collector] poll sweep failed: "
                    f"{type(e).__name__}: {e}"
                )
            self._poll_stop.wait(self.poll_interval_s)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
        if self._scrape_pool is not None:
            # wait=False: a target hung past its socket timeout must
            # not hold collector shutdown hostage.
            self._scrape_pool.shutdown(wait=False)
            self._scrape_pool = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
