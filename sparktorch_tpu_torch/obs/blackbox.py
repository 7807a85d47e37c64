"""Flight recorder and postmortem bundles — a copy of ``sparktorch_tpu/obs/blackbox.py``.

- :class:`FlightRecorder`: a process-local bounded ring of recent
  telemetry EVENTS (spans, ``ctl.*`` transitions, ``ft_*`` recovery
  events, ``alert.*`` firings, gang and chaos markers), attached to a
  bus as a sink and published, throttled, as the bus's ``blackbox``
  snapshot section, so it rides every ``/telemetry`` scrape.
- :func:`collect_postmortem`: on a worker's death, a preemption or an
  alert, the supervisor or the controller folds every available ring
  (its own bus's, plus a collector's last-good rank snapshots when one
  is given) into one ``postmortem_<ts>.json``: the time-ordered event
  window, the metric deltas from a history, the heartbeat table, the
  goodput, profile and skew sections, and the elastic world document.
  :func:`read_postmortem` reads one back. A bundle's ``health`` is the
  model-health ledger's run document (:mod:`~sparktorch_tpu_torch.obs.health`):
  the collector's merge, else the bus's run section, else its bare
  per-rank section merged.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional

from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.telemetry import Telemetry, wall_ts

_LOG = get_logger("sparktorch_tpu_torch.obs.blackbox")

SECTION = "blackbox"

DEFAULT_CAPACITY = 256
DEFAULT_PUBLISH_INTERVAL_S = 0.25

# Event kinds worth keeping for a postmortem: run structure and
# failure narrative, not per-sample metric noise. A "span" event is a
# closed Telemetry.span (the worker's own timed regions).
DEFAULT_KIND_PREFIXES = ("span", "ctl.", "ft_", "alert.", "gang",
                         "chaos", "profile_trace", "health")


class FlightRecorder:
    """Bounded ring of recent bus events, published as the
    ``blackbox`` snapshot section.

    Attach with :func:`attach_recorder` (idempotent per bus) or
    construct directly and :meth:`attach`. ``kind_prefixes`` filters
    which event kinds are retained; everything else costs a tuple
    scan and is dropped."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 kind_prefixes: Iterable[str] = DEFAULT_KIND_PREFIXES,
                 publish_interval_s: float = DEFAULT_PUBLISH_INTERVAL_S):
        from sparktorch_tpu_torch.obs.telemetry import get_telemetry

        self.telemetry = telemetry or get_telemetry()
        self.kind_prefixes = tuple(kind_prefixes)
        self.publish_interval_s = float(publish_interval_s)
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(8, int(capacity)))
        self.dropped = 0
        self._last_publish = 0.0
        self._attached = False

    # -- the sink ------------------------------------------------------------

    def __call__(self, event: Mapping[str, Any]) -> None:
        kind = str(event.get("kind") or "")
        if not kind.startswith(self.kind_prefixes):
            return
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(dict(event))
            # perf_counter, not wall_ts: the throttle is DURATION math
            # and a backward clock step must not stall publication.
            due = (time.perf_counter() - self._last_publish
                   >= self.publish_interval_s)
        if due:
            self.publish()

    def attach(self) -> "FlightRecorder":
        if not self._attached:
            self.telemetry.add_sink(self)
            self._attached = True
        return self

    def close(self) -> None:
        """Final publish + detach — the ring's last state stays on the
        snapshot for whoever scrapes the corpse."""
        if self._attached:
            self.telemetry.remove_sink(self)
            self._attached = False
        self.publish()

    # -- publication ---------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def publish(self) -> None:
        """Refresh the bus's ``blackbox`` section from the ring
        (throttled from the sink path; forced here)."""
        with self._lock:
            section = {
                "n": len(self._ring),
                "dropped": self.dropped,
                "capacity": self._ring.maxlen,
                "events": list(self._ring),
            }
            self._last_publish = time.perf_counter()
        self.telemetry.set_section(SECTION, section)


# Weak values: the bus's sink list is what keeps a recorder alive, so
# a dropped Telemetry (and its ring) is collectable — a strong module
# registry would pin every bus ever attached for the process lifetime.
_RECORDERS: "weakref.WeakValueDictionary[int, FlightRecorder]" = \
    weakref.WeakValueDictionary()
_RECORDERS_LOCK = threading.Lock()


def attach_recorder(telemetry: Optional[Telemetry] = None,
                    **kwargs: Any) -> FlightRecorder:
    """The one flight recorder of a bus, attached on first use —
    idempotent, so every layer that wants a ring (worker entry,
    controller, supervisor) can call this without stacking sinks."""
    from sparktorch_tpu_torch.obs.telemetry import get_telemetry

    tele = telemetry or get_telemetry()
    with _RECORDERS_LOCK:
        recorder = _RECORDERS.get(id(tele))
        if recorder is None or recorder.telemetry is not tele:
            recorder = FlightRecorder(tele, **kwargs).attach()
            _RECORDERS[id(tele)] = recorder
        return recorder


# ---------------------------------------------------------------------------
# Postmortem bundles
# ---------------------------------------------------------------------------


def events_from_snapshot(snapshot: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """The ``blackbox`` ring out of one telemetry snapshot dict (a
    ``/telemetry`` scrape, a collector's last-good rank snapshot, or a
    JSONL record); [] when absent."""
    section = (snapshot.get("sections") or {}).get(SECTION)
    if not isinstance(section, Mapping):
        return []
    events = section.get("events")
    return [dict(e) for e in events] if isinstance(events, list) else []


def collect_postmortem(out_dir: str, reason: str,
                       telemetry: Optional[Telemetry] = None,
                       collector=None,
                       history=None,
                       extra_events: Optional[
                           Iterable[Mapping[str, Any]]] = None,
                       window_s: float = 30.0,
                       rank: Optional[Any] = None,
                       trigger_ts: Optional[float] = None) -> str:
    """Assemble one postmortem bundle and write it atomically as
    ``postmortem_<ts>.json`` under ``out_dir``; returns the path.

    Sources, all optional and all best-effort:

    - the local bus's own ``blackbox`` ring (``telemetry``);
    - every scraped rank's ``blackbox`` ring held in the
      ``collector``'s last-good snapshots (the dead rank's final ring
      included — that is the point), each event tagged with its rank;
    - ``extra_events`` (e.g. the elastic controller's generation-
      tagged transition history);
    - the ``history`` tier's counter deltas over the window (what
      moved in the last good interval);
    - the collector's stitched RPC traces, heartbeat table, and the
      ``elastic`` world document.

    The event WINDOW is everything stamped within ``window_s`` before
    the trigger (and anything after it — the transition itself lands
    at/after the trigger), time-ordered.
    """
    trigger = float(trigger_ts) if trigger_ts is not None else wall_ts()
    cutoff = trigger - float(window_s)
    events: List[Dict[str, Any]] = []

    def _take(source: Iterable[Mapping[str, Any]],
              tag: Optional[Any] = None) -> None:
        for e in source:
            ts = e.get("ts")
            if ts is None or float(ts) < cutoff:
                continue
            rec = dict(e)
            if tag is not None and "rank" not in rec:
                rec["rank"] = tag
            events.append(rec)

    if telemetry is not None:
        _take(events_from_snapshot(telemetry.snapshot()))
    if extra_events:
        _take(extra_events)
    world = None
    heartbeats = None
    rpc_traces: List[Dict[str, Any]] = []
    if collector is not None:
        try:
            with collector._lock:
                rank_snaps = {r: st.snapshot
                              for r, st in collector._ranks.items()}
            for r, snap in rank_snaps.items():
                if snap:
                    _take(events_from_snapshot(snap), tag=r)
            gang = collector.gang_view()
            world = gang.get("elastic")
            heartbeats = gang.get("heartbeats")
            rpc_traces = collector.rpc_traces()[:8]
        except Exception as e:  # noqa: BLE001 - evidence is best-effort
            _LOG.warning(f"[sparktorch_tpu_torch:blackbox] collector evidence "
                         f"failed: {type(e).__name__}: {e}")
    if world is None and telemetry is not None:
        section = telemetry.get_section("elastic")
        if isinstance(section, Mapping):
            world = dict(section)
    # The run's last goodput accounting rides the bundle: a dead run's
    # time ledger (how much of the run was productive, who stole the
    # rest) must survive exactly like its event ring does. The
    # collector's merged run doc wins (it folds every scraped rank's
    # last-good ledger); a driver-local ledger section is the fallback.
    goodput = None
    if collector is not None:
        try:
            goodput = collector.goodput_view()
        except Exception:  # noqa: BLE001 - evidence is best-effort
            goodput = None
    if goodput is None and telemetry is not None:
        from sparktorch_tpu_torch.obs import goodput as _goodput_mod

        section = (telemetry.get_section(_goodput_mod.RUN_SECTION)
                   or telemetry.get_section(_goodput_mod.SECTION))
        if isinstance(section, Mapping):
            goodput = dict(section)
    # The victim's last-good stack profile rides beside the ledger:
    # the bucket doc says WHERE the time went, the profile says WHICH
    # FUNCTION was holding it when the run died. Same source order —
    # the collector's merge (it still holds a SIGKILLed rank's final
    # throttled publish) wins, a driver-local section is the fallback.
    profile = None
    if collector is not None:
        try:
            profile = collector.profile_view()
        except Exception:  # noqa: BLE001 - evidence is best-effort
            profile = None
    if profile is None and telemetry is not None:
        from sparktorch_tpu_torch.obs import profile as _profile_mod

        section = (telemetry.get_section(_profile_mod.RUN_SECTION)
                   or telemetry.get_section(_profile_mod.SECTION))
        if isinstance(section, Mapping):
            profile = dict(section)
    # And the model-health ledger's run document: did the numbers go
    # bad before the process did, and on which rank. Same source order;
    # a bare per-rank section (a trainer's bus) is merged to the run
    # shape, so the renderer sees one document kind.
    health = None
    if collector is not None:
        try:
            health = collector.health_view()
        except Exception:  # noqa: BLE001 - evidence is best-effort
            health = None
    if health is None and telemetry is not None:
        from sparktorch_tpu_torch.obs import health as _health_mod

        section = telemetry.get_section(_health_mod.RUN_SECTION)
        if isinstance(section, Mapping):
            health = dict(section)
        else:
            section = telemetry.get_section(_health_mod.SECTION)
            if isinstance(section, Mapping):
                health = _health_mod.merge_sections({"local": section})
    # "Skew at death": the run's final cross-rank straggler verdict —
    # whether the dying run's exposed_comm was wire or one slow rank,
    # and which. Same source order; a bare single-rank section still
    # merges (no alignment, but the stamp accounting survives).
    skew = None
    if collector is not None:
        try:
            skew = collector.skew_view()
        except Exception:  # noqa: BLE001 - evidence is best-effort
            skew = None
    if skew is None and telemetry is not None:
        from sparktorch_tpu_torch.obs import skew as _skew_mod

        section = telemetry.get_section(_skew_mod.RUN_SECTION)
        if isinstance(section, Mapping):
            skew = dict(section)
        else:
            section = telemetry.get_section(_skew_mod.SECTION)
            if isinstance(section, Mapping):
                skew = _skew_mod.merge_sections({"local": section})
    # Dedup (the controller's history events also flow through its
    # bus recorder) and order: identical (ts, kind, rank) triples
    # collapse, the narrative reads in time order. The controller's
    # history stores bare kinds ("restart_scheduled") while the same
    # transition reaches the ring as a "ctl."-prefixed bus event at
    # the same ts — strip the prefix in the key so the pair collapses.
    seen = set()
    unique: List[Dict[str, Any]] = []
    for e in sorted(events, key=lambda e: float(e.get("ts", 0.0))):
        kind = str(e.get("kind") or "")
        if kind.startswith("ctl."):
            kind = kind[4:]
        key = (e.get("ts"), kind, e.get("rank"),
               e.get("name"), e.get("worker"))
        if key in seen:
            continue
        seen.add(key)
        unique.append(e)
    deltas: Dict[str, float] = {}
    if history is not None:
        try:
            deltas = history.deltas_since(cutoff)
        except Exception as e:  # noqa: BLE001
            _LOG.warning(f"[sparktorch_tpu_torch:blackbox] history deltas "
                         f"failed: {type(e).__name__}: {e}")
    bundle = {
        "kind": "postmortem",
        "reason": reason,
        "rank": rank,
        "ts": trigger,
        "window_s": float(window_s),
        "n_events": len(unique),
        "events": unique,
        "metric_deltas": deltas,
        "goodput": goodput,
        "profile": profile,
        "health": health,
        "skew": skew,
        "rpc_traces": rpc_traces,
        "heartbeats": heartbeats,
        "world": world,
        "run_id": getattr(telemetry, "run_id", None),
    }
    os.makedirs(out_dir, exist_ok=True)
    stamp = f"{trigger:.3f}".replace(".", "_")
    base = os.path.join(out_dir, f"postmortem_{stamp}")
    tmp = f"{base}.json.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(bundle, f)
    # Exclusive link, never replace: two triggers in the same
    # millisecond (two rules in one evaluate pass, two deaths in one
    # supervisor poll) must yield two bundles, not one overwriting the
    # other.
    path = f"{base}.json"
    n = 0
    while True:
        try:
            os.link(tmp, path)
            break
        except FileExistsError:
            n += 1
            path = f"{base}_{n}.json"
    os.unlink(tmp)
    _LOG.warning(f"[sparktorch_tpu_torch:blackbox] postmortem written: {path} "
                 f"({len(unique)} events, reason: {reason})")
    return path


def read_postmortem(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != "postmortem":
        raise ValueError(f"{path} is not a postmortem bundle")
    return doc
