"""Declarative alert rules over the retained metrics history — a copy of ``sparktorch_tpu/obs/alerts.py``.

A fixed set of :class:`AlertRule` declarations is evaluated once per
sweep against a :class:`~sparktorch_tpu_torch.obs.history.MetricsHistory`
by an :class:`AlertManager`, producing latched, episode-counted alert
events. Three rule forms:

- **threshold**: fire the sweep the observed value crosses
  (``value OP threshold``; OP is ``>`` or ``<``).
- **sustained**: fire only after the condition holds for
  ``for_sweeps`` consecutive sweeps, so one noisy sweep cannot flap.
- **burn_rate**: the windowed rate of a bad-event counter over the
  windowed rate of its total counter, divided by the allowed fraction
  (``slo``); fires when the burn exceeds ``burn_factor``.

Per rule: ``ok`` -> ``firing`` (latched while the condition holds) ->
the first clean sweep resolves it back to ``ok``. Each ok->firing
transition is one EPISODE: ``alerts.fired_total{rule=}`` counts
episodes, the ``alert.fired`` / ``alert.resolved`` bus events carry the
episode number, and subscribers (the elastic controller's scale
signals, the stack profiler's bursts) get one callback per transition.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

from sparktorch_tpu_torch.obs.history import MetricsHistory
from sparktorch_tpu_torch.obs.log import get_logger

_LOG = get_logger("sparktorch_tpu_torch.obs.alerts")

_KINDS = ("threshold", "sustained", "burn_rate")
_OPS = (">", "<")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule. ``metric`` + ``labels`` select the series
    (label-SUBSET match, like every sanctioned snapshot reader);
    ``field`` picks the observation — a digest field (``p99``, ``mean``
    …) for histogram/span series, ``"rate"`` for a counter's windowed
    per-second rate, None for a gauge/counter's latest value. The
    ``window_s`` horizon backs rate and windowed-percentile reads;
    a ``sustained`` rule's digest read ignores it and always judges
    the newest sweep (consecutive fresh evidence, never a self-
    sustaining window peak).

    ``burn_rate`` rules read ``metric`` as the BAD-event counter and
    ``total_metric`` as the traffic counter; the observed value is
    ``(rate_bad / rate_total) / slo`` — the burn multiple."""

    name: str
    metric: str
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    kind: str = "threshold"
    field: Optional[str] = None
    op: str = ">"
    threshold: float = 0.0
    for_sweeps: int = 1
    window_s: Optional[float] = None
    # burn_rate only:
    slo: Optional[float] = None
    burn_factor: float = 1.0
    total_metric: Optional[str] = None
    total_labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    severity: str = "warning"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"rule {self.name!r}: kind {self.kind!r} "
                             f"not in {_KINDS}")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: op {self.op!r} "
                             f"not in {_OPS}")
        if self.kind == "sustained" and self.for_sweeps < 1:
            raise ValueError(f"rule {self.name!r}: for_sweeps must be "
                             f">= 1")
        if self.kind == "burn_rate":
            if not self.slo or self.slo <= 0:
                raise ValueError(f"rule {self.name!r}: burn_rate needs "
                                 f"slo > 0 (the allowed bad fraction)")
            if not self.total_metric:
                raise ValueError(f"rule {self.name!r}: burn_rate needs "
                                 f"total_metric (the traffic counter)")

    def required_streak(self) -> int:
        return self.for_sweeps if self.kind == "sustained" else 1


class _RuleState:
    __slots__ = ("streak", "firing", "episodes", "value", "fired_ts",
                 "resolved_ts", "last_eval_ts")

    def __init__(self):
        self.streak = 0
        self.firing = False
        self.episodes = 0
        self.value: Optional[float] = None
        self.fired_ts: Optional[float] = None
        self.resolved_ts: Optional[float] = None
        self.last_eval_ts: Optional[float] = None


class AlertManager:
    """Evaluate rules per sweep; latch, count, publish, notify.

    ``evaluate(ts)`` is called by the collector after each history
    append (``ts`` = the sweep's snapshot timestamp — deterministic on
    replays). Subscribers registered with :meth:`subscribe` receive
    the fire/resolve event dicts; a subscriber that raises is counted
    and logged, never allowed to kill the poll loop."""

    def __init__(self, history: MetricsHistory,
                 rules: Optional[Iterable[AlertRule]] = None,
                 telemetry=None):
        from sparktorch_tpu_torch.obs.telemetry import get_telemetry

        self.history = history
        self.telemetry = telemetry or get_telemetry()
        self.rules: List[AlertRule] = list(rules or [])
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self._lock = threading.Lock()
        self._state: Dict[str, _RuleState] = {r.name: _RuleState()
                                              for r in self.rules}
        self._subscribers: List[Callable[[Dict[str, Any]], None]] = []

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Idempotent removal — a retired consumer (a finished elastic
        controller) must stop receiving firings."""
        with self._lock:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

    # -- observation ---------------------------------------------------------

    def _observe(self, rule: AlertRule) -> Optional[float]:
        """The rule's current observed value; None = no signal (the
        series hasn't appeared / not enough points for a rate), which
        NEVER breaches — absence of evidence must not page."""
        h = self.history
        if rule.kind == "burn_rate":
            bad = h.rate(rule.metric, rule.labels, window_s=rule.window_s)
            total = h.rate(rule.total_metric, rule.total_labels,
                           window_s=rule.window_s)
            if bad is None or total is None or total <= 0:
                return None
            return (bad / total) / float(rule.slo)
        if rule.field == "rate":
            return h.rate(rule.metric, rule.labels, window_s=rule.window_s)
        if rule.field:
            if rule.window_s is not None and rule.kind != "sustained":
                # Windowed percentile-of-percentiles: the worst sweep
                # in the window decides — the window MAX for ">" rules,
                # the window MIN for "<" rules (a single good sweep
                # must not mask a sustained low). Sustained rules
                # always read the NEWEST sweep instead: for_sweeps
                # demands fresh evidence every sweep, and a window
                # extreme would let one spike self-sustain the streak
                # for the whole window.
                worst_q = 100.0 if rule.op == ">" else 0.0
                return h.percentile_over(rule.metric, worst_q, rule.labels,
                                         window_s=rule.window_s,
                                         field=rule.field)
            return h.latest(rule.metric, rule.labels, field=rule.field)
        return h.latest(rule.metric, rule.labels)

    @staticmethod
    def _breaches(rule: AlertRule, value: Optional[float]) -> bool:
        if value is None:
            return False
        limit = (rule.burn_factor if rule.kind == "burn_rate"
                 else rule.threshold)
        return value > limit if rule.op == ">" else value < limit

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, ts: Optional[float] = None) -> List[Dict[str, Any]]:
        """One sweep's pass over every rule. Returns the transition
        events emitted this pass (fired + resolved)."""
        from sparktorch_tpu_torch.obs.telemetry import wall_ts

        when = float(ts) if ts is not None else wall_ts()
        events: List[Dict[str, Any]] = []
        for rule in self.rules:
            value = self._observe(rule)
            st = self._state[rule.name]
            breach = self._breaches(rule, value)
            with self._lock:
                st.value = value
                st.last_eval_ts = when
                st.streak = st.streak + 1 if breach else 0
                should_fire = (not st.firing
                               and st.streak >= rule.required_streak())
                should_resolve = st.firing and not breach
                if should_fire:
                    st.firing = True
                    st.episodes += 1
                    st.fired_ts = when
                elif should_resolve:
                    st.firing = False
                    st.resolved_ts = when
            if should_fire:
                events.append(self._transition("fired", rule, st, when))
            elif should_resolve:
                events.append(self._transition("resolved", rule, st, when))
        self.telemetry.gauge("alerts.active", float(
            sum(1 for s in self._state.values() if s.firing)))
        return events

    def _transition(self, what: str, rule: AlertRule, st: _RuleState,
                    when: float) -> Dict[str, Any]:
        # "rule_kind", not "kind": these dicts travel as bus events and
        # JSONL sink records, where "kind" is the record type.
        event = {
            "alert": rule.name,
            "event": what,
            "rule_kind": rule.kind,
            "severity": rule.severity,
            "metric": rule.metric,
            "labels": dict(rule.labels),
            "value": st.value,
            "threshold": (rule.burn_factor if rule.kind == "burn_rate"
                          else rule.threshold),
            "episode": st.episodes,
            "ts": when,
        }
        self.telemetry.counter(f"alerts.{what}_total",
                               labels={"rule": rule.name})
        self.telemetry.event(f"alert.{what}", **event)
        log = _LOG.warning if what == "fired" else _LOG.info
        log(f"[sparktorch_tpu_torch:alerts] {rule.name} {what} "
            f"(value={st.value}, episode={st.episodes})")
        with self._lock:
            subscribers = list(self._subscribers)
        for fn in subscribers:
            try:
                fn(dict(event))
            except Exception as e:  # noqa: BLE001 - user callback
                self.telemetry.counter("alerts.subscriber_errors_total",
                                       labels={"rule": rule.name})
                _LOG.warning(f"[sparktorch_tpu_torch:alerts] subscriber for "
                             f"{rule.name} raised: "
                             f"{type(e).__name__}: {e}")
        return event

    # -- read side -----------------------------------------------------------

    def active(self) -> List[str]:
        with self._lock:
            return sorted(name for name, st in self._state.items()
                          if st.firing)

    def doc(self) -> Dict[str, Any]:
        """The ``alerts`` section ``/gang`` serves: every rule's state,
        value, streak and episode count — one scrape answers "what is
        the collector worried about, and for how long"."""
        with self._lock:
            return {
                "n_rules": len(self.rules),
                "active": sorted(name for name, st in self._state.items()
                                 if st.firing),
                "rules": {
                    rule.name: {
                        "state": ("firing" if self._state[rule.name].firing
                                  else "ok"),
                        "kind": rule.kind,
                        "metric": rule.metric,
                        "labels": dict(rule.labels),
                        "field": rule.field,
                        "op": rule.op,
                        "threshold": (rule.burn_factor
                                      if rule.kind == "burn_rate"
                                      else rule.threshold),
                        "for_sweeps": rule.required_streak(),
                        "window_s": rule.window_s,
                        "value": self._state[rule.name].value,
                        "streak": self._state[rule.name].streak,
                        "episodes": self._state[rule.name].episodes,
                        "fired_ts": self._state[rule.name].fired_ts,
                        "resolved_ts": self._state[rule.name].resolved_ts,
                        "severity": rule.severity,
                    }
                    for rule in self.rules
                },
            }
