"""The elastic gang controller: live world resize under supervision — a copy of ``sparktorch_tpu/ctl/elastic.py``.

When a worker spends its restart budget, the ft supervisor fails the
run. For a gang with redistributable work this controller shrinks the
world instead, and grows it when a rank joins:

- **membership = generation**: every world change bumps the generation,
  through :meth:`~sparktorch_tpu_torch.native.gang.GangCoordinator.resize`
  when a coordinator is attached (its barrier waiters are released and
  every rank registers again), and relaunches the surviving members
  with the new generation's work assignment.
- **work = partitions with idempotent completion**: the unit of
  redistribution is an opaque partition id, and ``completed_fn`` says
  what "complete" means (typically: the partition's atomically renamed
  output file exists). A restarted or reassigned worker skips completed
  partitions, so records stay exact across any schedule of kills,
  shrinks and grows.
- **gang-view supervision**: with ``gang_url`` (any ``/gang``
  endpoint) or ``collector`` (a
  :class:`~sparktorch_tpu_torch.obs.collector.FleetCollector`, read in
  process) the controller tells an exporter that vanished (scrape
  failing, heartbeat fresh: count it, keep supervising by handle) from
  a rank that died (heartbeat age past the barrier deadline: preempt,
  restart, and on budget exhaustion shrink).
- **remote ranks**: a member registered with a ``ctl_url`` and no
  local handle is managed over ``POST /ctl``.

Every transition is a generation-tagged ``ctl.*`` event and counter on
the bus, and the world document is the ``elastic`` telemetry section.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from sparktorch_tpu_torch.ft.policy import FtPolicy
from sparktorch_tpu_torch.ft.supervisor import WorkerFailed
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.telemetry import get_telemetry, wall_ts

_LOG = get_logger("sparktorch_tpu_torch.ctl.elastic")

ELASTIC_SECTION = "elastic"
_HISTORY_CAP = 64


def round_robin_assign(ranks: Sequence[int],
                       partitions: Sequence[Any]) -> Dict[int, List[Any]]:
    """The default work assignment: deterministic round-robin of the
    pending partitions over the rank list (sorted, so every generation
    computes the same layout from the same inputs)."""
    ranks = sorted(ranks)
    out: Dict[int, List[Any]] = {r: [] for r in ranks}
    for i, part in enumerate(partitions):
        out[ranks[i % len(ranks)]].append(part)
    return out


class _Member:
    __slots__ = ("rank", "start_fn", "ctl_url", "handle", "restarts",
                 "done", "removed", "restart_at", "detected_at",
                 "exporter_gone", "draining", "assignment")

    def __init__(self, rank: int, start_fn, ctl_url: Optional[str]):
        self.rank = rank
        self.start_fn = start_fn      # None for purely remote ranks
        self.ctl_url = ctl_url
        self.handle = None
        self.restarts = 0
        self.done = False
        self.removed = False          # shrunk out of the world
        self.restart_at: Optional[float] = None
        self.detected_at: Optional[float] = None
        self.exporter_gone = False    # degradation episode latch
        self.draining = False         # resize drain in flight
        self.assignment: List[Any] = []  # partitions of the last launch


class ElasticController:
    """Supervise a gang of (process) workers with live world resize.

    ``start_fn(rank, attempt, generation, assignment)`` must (re)start
    rank's worker over the given partition list and return a handle
    satisfying the supervisor contract (``ProcessWorker`` is the
    intended one; ``ThreadWorker`` works for tests). ``completed_fn``
    decides partition completion (idempotency lives there).

    ``gang_url`` (any ``/gang`` endpoint) or ``collector`` (a
    :class:`~sparktorch_tpu_torch.obs.collector.FleetCollector`, whose
    ``gang_view`` it reads) arms gang-view supervision;
    ``coordinator`` (a GangCoordinator) makes resizes real gang
    membership events.
    """

    def __init__(self, work: Sequence[Any],
                 completed_fn: Callable[[Any], bool],
                 policy: Optional[FtPolicy] = None,
                 telemetry=None,
                 assign_fn: Callable[..., Dict[int, List[Any]]] = (
                     round_robin_assign),
                 coordinator=None,
                 collector=None,
                 gang_url: Optional[str] = None,
                 ctl_token: Optional[str] = None,
                 min_world: int = 1,
                 drain_grace_s: float = 5.0,
                 name: str = "elastic",
                 alerts=None,
                 on_scale_signal: Optional[Callable[[Dict[str, Any]],
                                                    Any]] = None,
                 postmortem_dir: Optional[str] = None,
                 postmortem_window_s: float = 30.0,
                 postmortem_min_interval_s: float = 0.0):
        self.work = list(work)
        self.completed_fn = completed_fn
        self.policy = policy or FtPolicy()
        self.telemetry = telemetry or get_telemetry()
        self.assign_fn = assign_fn
        self.coordinator = coordinator
        self.collector = collector
        self.gang_url = gang_url
        self.ctl_token = ctl_token
        self.min_world = int(min_world)
        self.drain_grace_s = float(drain_grace_s)
        self.name = name
        self._rng = self.policy.rng()
        self._members: Dict[int, _Member] = {}
        self._lock = threading.Lock()
        self._pending_grow: List[_Member] = []
        self._stop = threading.Event()
        self.generation = (int(coordinator.generation)
                           if coordinator is not None else 0)
        self.history: List[Dict[str, Any]] = []
        self._resizes = {"shrink": 0, "grow": 0}
        self._gang_check_ts = 0.0
        # SLO alerting consumer: subscribing to an AlertManager turns
        # every latched firing — a sustained hot-shard p99 breach, a
        # 429-rate burn — into a generation-tagged ``ctl.scale_signal``
        # this controller logs (and hands to the ``on_scale_signal``
        # policy hook, where a deployment attaches its split/drain/scale
        # decision).
        self.scale_signals: List[Dict[str, Any]] = []
        self.on_scale_signal = on_scale_signal
        self.alerts = alerts
        # Flight-recorder postmortems: when a rank dies, is preempted,
        # or an alert fires, fold every available blackbox ring (this
        # bus's + each scraped rank's last-good) into one bundle under
        # ``postmortem_dir``.
        self.postmortem_dir = postmortem_dir
        self.postmortem_window_s = float(postmortem_window_s)
        self._postmortem_min_interval_s = float(postmortem_min_interval_s)
        self._last_postmortem_ts = 0.0
        self.postmortems: List[str] = []
        if postmortem_dir:
            from sparktorch_tpu_torch.obs.blackbox import attach_recorder

            attach_recorder(self.telemetry)
        # Subscribe LAST: _on_alert runs on the collector's poll
        # thread and reads the postmortem attributes above — a firing
        # delivered mid-__init__ must not hit a half-built controller.
        if alerts is not None:
            alerts.subscribe(self._on_alert)

    # -- alert consumption -------------------------------------------------

    def _on_alert(self, event: Dict[str, Any]) -> None:
        """AlertManager subscriber: a FIRED alert becomes a scale
        signal (event + counter + the policy hook); a RESOLVED one
        clears it. Runs on the collector's poll thread — must never
        raise into the alert fan-out."""
        what = event.get("event")
        if what == "fired":
            signal = {
                "rule": event.get("alert"),
                "rule_kind": event.get("rule_kind"),
                "metric": event.get("metric"),
                "labels": event.get("labels"),
                "value": event.get("value"),
                "episode": event.get("episode"),
                "ts": event.get("ts"),
            }
            self.scale_signals.append(signal)
            self.telemetry.counter("ctl.scale_signals_total",
                                   labels={"rule": str(event.get("alert"))})
            self._event("scale_signal", **signal)
            _LOG.warning(
                f"[sparktorch_tpu_torch:ctl] scale signal from alert "
                f"{event.get('alert')} (value={event.get('value')})")
            if self.on_scale_signal is not None:
                try:
                    self.on_scale_signal(dict(event))
                except Exception as e:  # noqa: BLE001 - policy hook
                    _LOG.warning(f"[sparktorch_tpu_torch:ctl] on_scale_signal "
                                 f"raised: {type(e).__name__}: {e}")
            self._write_postmortem(
                f"alert {event.get('alert')} fired", rank=None)
        elif what == "resolved":
            self._event("scale_signal_cleared",
                        rule=event.get("alert"),
                        episode=event.get("episode"))

    # -- postmortems -------------------------------------------------------

    def _write_postmortem(self, reason: str,
                          rank: Optional[int] = None) -> Optional[str]:
        """Best-effort bundle write (death/preempt/alert triggers):
        evidence collection must never take down supervision."""
        if not self.postmortem_dir:
            return None
        now = time.perf_counter()  # lint-obs: ok (throttle clock, not a measured region)
        if self._postmortem_min_interval_s and \
                now - self._last_postmortem_ts < \
                self._postmortem_min_interval_s:
            return None
        self._last_postmortem_ts = now
        from sparktorch_tpu_torch.obs.blackbox import collect_postmortem

        history = getattr(self.collector, "history", None)
        try:
            path = collect_postmortem(
                self.postmortem_dir, reason,
                telemetry=self.telemetry,
                collector=self.collector,
                history=history,
                extra_events=self.history,
                window_s=self.postmortem_window_s,
                rank=rank,
            )
        except Exception as e:  # noqa: BLE001 - evidence is best-effort
            self.telemetry.counter("ctl.postmortem_failures_total")
            _LOG.warning("[sparktorch_tpu_torch:ctl] postmortem write "
                         f"failed: {type(e).__name__}: {e}")
            return None
        self.postmortems.append(path)
        self.telemetry.counter("ctl.postmortems_total")
        return path

    # -- membership --------------------------------------------------------

    def add_rank(self, rank: int, start_fn=None,
                 ctl_url: Optional[str] = None) -> None:
        """Register a member BEFORE run(). ``start_fn`` None = a
        remote rank this controller can watch and kill (via
        ``ctl_url``) but not relaunch — its death shrinks the world."""
        if start_fn is None and not ctl_url:
            raise ValueError(f"rank {rank}: need a start_fn or a ctl_url")
        self._members[int(rank)] = _Member(int(rank), start_fn, ctl_url)

    def grow(self, rank: int, start_fn=None,
             ctl_url: Optional[str] = None) -> None:
        """Request a world GROW: the new rank joins at the next poll
        tick as a resize event (generation bump, pending work
        redistributed over the enlarged world). Thread-safe — callable
        from an operator thread or a ctl verb while run() spins."""
        if start_fn is None and not ctl_url:
            raise ValueError(f"rank {rank}: need a start_fn or a ctl_url")
        with self._lock:
            self._pending_grow.append(_Member(int(rank), start_fn, ctl_url))

    def stop(self) -> None:
        """Request shutdown; also the teardown for a controller that
        never reached ``run()`` (whose finally is the other detach
        path) — a retired controller must not stay subscribed as an
        alert consumer."""
        self._stop.set()
        self.detach_alerts()

    # -- views -------------------------------------------------------------

    def active_ranks(self) -> List[int]:
        return sorted(r for r, m in self._members.items()
                      if not m.removed)

    def world_size(self) -> int:
        return len(self.active_ranks())

    def pending_work(self) -> List[Any]:
        return [p for p in self.work if not self.completed_fn(p)]

    def _publish(self) -> None:
        """The elastic world document, as a telemetry section — the
        collector folds it into ``/gang`` when buses are shared."""
        doc = {
            "generation": self.generation,
            "world_size": self.world_size(),
            "min_world": self.min_world,
            "members": {
                str(m.rank): {
                    "state": ("removed" if m.removed else
                              "done" if m.done else
                              "backoff" if m.restart_at is not None else
                              "running"),
                    "restarts": m.restarts,
                    "remote": m.start_fn is None,
                    "exporter_gone": m.exporter_gone,
                }
                # list() snapshot: _on_alert publishes from the
                # collector's poll thread while a resize mutates the
                # member table on the run thread.
                for m in list(self._members.values())
            },
            "work": {"total": len(self.work),
                     "pending": len(self.pending_work())},
            "resizes": dict(self._resizes),
            "history": self.history[-_HISTORY_CAP:],
        }
        self.telemetry.set_section(ELASTIC_SECTION, doc)

    def _event(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "generation": self.generation,
               "world_size": self.world_size(), "ts": wall_ts(),
               **fields}
        self.history.append(rec)
        self.telemetry.event(f"ctl.{kind}", **{k: v for k, v in rec.items()
                                               if k != "kind"})
        self.telemetry.counter(f"ctl.{kind}_total")
        self._publish()

    # -- launching ---------------------------------------------------------

    def _assignment_for(self, rank: int) -> List[Any]:
        ranks = [r for r in self.active_ranks()
                 if self._members[r].start_fn is not None]
        pending = self.pending_work()
        if not ranks or rank not in ranks:
            return []
        return self.assign_fn(ranks, pending).get(rank, [])

    def _launch(self, m: _Member, attempt: int,
                assignment: Optional[List[Any]] = None) -> None:
        if m.start_fn is None:
            return  # remote: supervised, never (re)launched from here
        old = m.handle
        if old is not None:
            # A replaced handle is retired: let process handles remove
            # their payload/url files instead of leaking one tmp file
            # per relaunch for the controller's lifetime.
            getattr(old, "cleanup", lambda: None)()
        m.assignment = (list(assignment) if assignment is not None
                        else self._assignment_for(m.rank))
        m.handle = m.start_fn(m.rank, attempt, self.generation,
                              m.assignment)
        m.restart_at = None
        m.draining = False
        m.done = False

    # -- death / restart / shrink -----------------------------------------

    def _schedule_restart(self, m: _Member, reason: str) -> bool:
        """Spend a restart slot (True) or report budget exhaustion
        (False — the caller shrinks)."""
        if m.restarts >= self.policy.restart.max_restarts:
            return False
        delay = self.policy.restart.delay_s(m.restarts, self._rng)
        m.detected_at = time.perf_counter()  # lint-obs: ok (recovery clock origin, ledger-fed in _do_restart)
        m.restart_at = m.detected_at + delay
        _LOG.warning(
            f"[sparktorch_tpu_torch:ctl] rank {m.rank} {reason}; restart "
            f"{m.restarts + 1}/{self.policy.restart.max_restarts} "
            f"in {delay:.3f}s"
        )
        self._event("restart_scheduled", rank=m.rank, reason=reason,
                    delay_s=delay)
        # The death is the postmortem trigger: the bundle's window
        # closes AFTER this transition landed, so the restart_scheduled
        # event (and the victim's last scraped ring) are inside it.
        self._write_postmortem(f"rank {m.rank} {reason}", rank=m.rank)
        return True

    def _do_restart(self, m: _Member) -> None:
        attempt = m.restarts + 1
        # A restart (same generation, same world) resumes the member's
        # OWN assignment minus what already completed. Recomputing the
        # round-robin here would re-deal the current pending set over
        # ranks whose survivors still hold their original lists —
        # overlapping them and duplicating (idempotent, but wasted)
        # partition work. Full redistribution belongs to _resize,
        # where everyone relaunches together.
        self._launch(m, attempt,
                     assignment=[p for p in m.assignment
                                 if not self.completed_fn(p)])
        m.restarts = attempt
        labels = {"worker": f"rank{m.rank}"}
        self.telemetry.counter("ft_restarts_total", labels=labels)
        latency = (time.perf_counter()  # lint-obs: ok (recovery clock pair, ledger-fed below)
                   - (m.detected_at or time.perf_counter()))  # lint-obs: ok (fallback read of the same clock)
        self.telemetry.observe("ft_recovery_latency_s", latency,
                               labels=labels)
        # The detection->relaunch gap (backoff included) is RUN
        # DOWNTIME: the goodput ledger's restart_downtime bucket
        # closes on exactly the window ft_recovery_latency_s measures,
        # so the two reconcile by construction.
        _goodput.add("restart_downtime", latency)
        self._event("restart", rank=m.rank, attempt=attempt)

    def _resize(self, kind: str, rank: Optional[int],
                joiners: Sequence[_Member] = ()) -> None:
        """One world-membership change: drain survivors, bump the
        generation (through the coordinator when attached — its
        members re-register fresh), recompute the assignment over the
        INCOMPLETE work, relaunch everyone. Completed partitions are
        never re-run (``completed_fn`` is the idempotency line), so a
        resize costs the survivors their in-flight partitions at
        worst, never the records already landed."""
        # The whole resize wall — drain, generation bump, relaunch —
        # is world downtime: nobody computes while the membership
        # changes. The ledger span closes when the survivors (and
        # joiners) are relaunched.
        with _goodput.span("resize_downtime", {"kind": kind}):
            self._resize_body(kind, rank, joiners)

    def _resize_body(self, kind: str, rank: Optional[int],
                     joiners: Sequence[_Member] = ()) -> None:
        # Survivors are the PRE-JOIN launchable members: joiners enter
        # the member table after this snapshot, or the relaunch loop
        # below would see each joiner twice (once as a "survivor",
        # once as a joiner) and double-launch it — the first handle
        # orphaned into an unsupervised worker racing the same
        # partitions.
        survivors = [self._members[r] for r in self.active_ranks()
                     if self._members[r].start_fn is not None
                     and not self._members[r].done]
        for m in joiners:
            self._members[m.rank] = m
        # Drain: cooperative stop, escalation handled by the handle's
        # own grace logic; join so two attempts never overlap on one
        # partition file (atomic renames make even that benign, but
        # the join keeps the schedule readable).
        for m in survivors:
            if m.handle is not None and m.handle.is_alive():
                m.draining = True
                m.handle.kill()
        for m in survivors:
            if m.handle is not None:
                m.handle.join(self.drain_grace_s + 2.0)
        if self.coordinator is not None:
            self.generation = self.coordinator.resize(
                max(1, self.world_size()))
        else:
            self.generation += 1
        self._resizes[kind] += 1
        self.telemetry.counter("ctl.resizes_total",
                               labels={"kind": kind})
        self._event(kind, rank=rank,
                    ranks=self.active_ranks())
        for m in survivors + [j for j in joiners if j.start_fn is not None]:
            if not m.removed:
                self._launch(m, m.restarts)

    def _shrink(self, m: _Member, reason: str) -> None:
        if self.world_size() - 1 < self.min_world:
            m.done = True
            raise WorkerFailed(
                f"{self.name}: rank {m.rank} exhausted its restart "
                f"budget ({reason}) and the world cannot shrink below "
                f"min_world={self.min_world}"
            )
        m.removed = True
        if m.ctl_url:
            # Best-effort remote kill: the rank may be a zombie whose
            # exporter still answers — it must not keep computing
            # against a generation that no longer includes it.
            from sparktorch_tpu_torch.ctl.route import CtlRefused, ctl_request

            try:
                ctl_request(m.ctl_url, "kill", token=self.ctl_token,
                            timeout=2.0)
            except CtlRefused:
                pass
        _LOG.warning(
            f"[sparktorch_tpu_torch:ctl] rank {m.rank} {reason}; SHRINKING "
            f"world {self.world_size() + 1} -> {self.world_size()}"
        )
        self._resize("shrink", m.rank)
        self._write_postmortem(f"world shrunk around rank {m.rank} "
                               f"({reason})", rank=m.rank)

    # -- collector-driven supervision --------------------------------------

    def _gang_view(self) -> Optional[Dict[str, Any]]:
        if self.collector is not None:
            try:
                return self.collector.gang_view()
            except Exception as e:  # a torn merge must not kill the loop
                _LOG.warning(
                    f"[sparktorch_tpu_torch:ctl] gang view failed: {e}")
                return None
        if self.gang_url:
            from sparktorch_tpu_torch.obs.collector import (
                ScrapeError,
                scrape_json,
            )

            try:
                view = scrape_json(self.gang_url.rstrip("/") + "/gang",
                                   timeout=2.0)
                return view if isinstance(view, dict) else None
            except ScrapeError as e:
                self.telemetry.counter("ctl.gang_scrape_errors_total")
                _LOG.warning(
                    f"[sparktorch_tpu_torch:ctl] /gang scrape failed "
                    f"(handle supervision continues): {e}")
                return None
        return None

    def _apply_gang_view(self) -> None:
        """Whole-pod liveness from the collector: the two failure
        classes the /gang join makes distinguishable —

        - **exporter vanished**: the rank's scrape is failing but its
          heartbeat is fresh (or its local handle is alive). The rank
          is WORKING; only its observability died. Degrade: count it,
          latch one event per episode, keep handle supervision.
        - **rank died**: heartbeat age past the barrier deadline. With
          a live local handle that is a WEDGED process (preempt: the
          handle kill's grace/SIGKILL escalation applies); with no
          handle (remote rank) it is a death this controller cannot
          relaunch — shrink.
        """
        view = self._gang_view()
        if not view:
            return
        deadline = self.policy.barrier.deadline_s
        scrape_status = view.get("ranks") or {}
        hb_ranks = (view.get("heartbeats") or {}).get("ranks") or {}
        for m in self._members.values():
            if m.removed or m.done:
                continue
            st = scrape_status.get(str(m.rank))
            hb = hb_ranks.get(str(m.rank))
            hb_age = (hb or {}).get("last_seen_age_s")
            handle_alive = m.handle is not None and m.handle.is_alive()
            scrape_ok = bool(st.get("ok")) if st else None
            if scrape_ok is False:
                hb_fresh = (hb_age is not None and deadline
                            and hb_age <= deadline)
                if hb_fresh or handle_alive:
                    if not m.exporter_gone:
                        m.exporter_gone = True
                        self.telemetry.counter(
                            "ctl.exporter_vanished_total",
                            labels={"rank": str(m.rank)})
                        self._event("exporter_vanished", rank=m.rank)
                    continue  # degraded, not dead
            elif scrape_ok and m.exporter_gone:
                m.exporter_gone = False  # episode over
                self._event("exporter_recovered", rank=m.rank)
            if (deadline and hb_age is not None and hb_age > deadline
                    and m.restart_at is None and not m.draining):
                if handle_alive:
                    # Alive-but-wedged: preempt through the handle
                    # (grace -> SIGKILL); the death lands in the next
                    # poll's restart path.
                    self.telemetry.counter(
                        "ft_stall_preemptions_total",
                        labels={"worker": f"rank{m.rank}"})
                    self._event("stall_preempt", rank=m.rank,
                                hb_age_s=hb_age)
                    m.handle.kill()
                    self._write_postmortem(
                        f"rank {m.rank} stall-preempted "
                        f"(hb age {hb_age:.1f}s)", rank=m.rank)
                elif m.start_fn is None:
                    # Remote rank, silent past the deadline, nothing
                    # to relaunch: the world must shrink around it.
                    self._shrink(m, f"remote heartbeat silent "
                                    f"{hb_age:.1f}s > {deadline}s")

    # -- main loop ---------------------------------------------------------

    def detach_alerts(self) -> None:
        """Stop consuming alert firings (idempotent). A finished or
        retired controller must not keep turning alerts into scale
        signals and postmortem bundles — the AlertManager would
        otherwise hold it (and its buses) alive forever."""
        alerts, self.alerts = self.alerts, None
        if alerts is not None:
            alerts.unsubscribe(self._on_alert)

    def run(self, poll_interval_s: float = 0.05,
            deadline_s: Optional[float] = None,
            gang_check_interval_s: float = 0.5) -> Dict[str, Any]:
        """Launch every member and supervise until the WORK is done
        (every partition complete) and no member is mid-restart.
        Returns the run summary; raises :class:`WorkerFailed` only
        when the world can no longer shrink (below ``min_world``).
        Either way the controller retires as an alert consumer."""
        try:
            return self._run_supervise(poll_interval_s, deadline_s,
                                       gang_check_interval_s)
        finally:
            self.detach_alerts()

    def _run_supervise(self, poll_interval_s: float,
                       deadline_s: Optional[float],
                       gang_check_interval_s: float) -> Dict[str, Any]:
        t0 = time.perf_counter()  # lint-obs: ok (run-wall clock for the summary)
        if not self._members:
            raise ValueError(f"{self.name}: no members added")
        self._event("start", ranks=self.active_ranks())
        for m in self._members.values():
            if not m.removed:
                self._launch(m, 0)
        while not self._stop.is_set():
            with self._lock:
                joiners, self._pending_grow = self._pending_grow, []
            if joiners:
                for j in joiners:
                    _LOG.info(f"[sparktorch_tpu_torch:ctl] rank {j.rank} "
                              f"joining; GROWING world")
                self._resize("grow", joiners[0].rank, joiners=joiners)
            pending_members = False
            for m in list(self._members.values()):
                if m.removed or m.done:
                    continue
                if m.restart_at is not None:
                    if time.perf_counter() >= m.restart_at:  # lint-obs: ok (backoff deadline check)
                        self._do_restart(m)
                    pending_members = True
                    continue
                if m.start_fn is None:
                    continue  # remote: watched via the gang view only
                if m.handle.is_alive():
                    pending_members = True
                    continue
                err = m.handle.error
                drained = m.draining or getattr(m.handle, "preempted",
                                                False)
                if err is None and not drained:
                    m.done = True
                    self._event("member_done", rank=m.rank)
                    continue
                reason = (f"failed: {type(err).__name__}: {err}"
                          if err is not None else "preempted")
                if not self._schedule_restart(m, reason):
                    self._shrink(m, f"restart budget exhausted ({reason})")
                    continue
                pending_members = True
            now = time.perf_counter()  # lint-obs: ok (poll-interval clock)
            if now - self._gang_check_ts >= gang_check_interval_s:
                self._gang_check_ts = now
                self._apply_gang_view()
            if not self.pending_work():
                # Work is complete: drain any member still running its
                # (now-empty or in-flight-duplicate) tail and finish.
                still = [m for m in self._members.values()
                         if not m.removed and not m.done
                         and m.start_fn is not None]
                live = [m for m in still
                        if m.handle is not None and m.handle.is_alive()]
                if not live and not any(m.restart_at is not None
                                        for m in still):
                    break
            elif not pending_members and not self._pending_grow:
                # Work remains but nobody is running or scheduled —
                # every launchable member finished an earlier (pre-
                # resize) assignment. Relaunch over the remainder.
                runnable = [m for m in self._members.values()
                            if not m.removed and m.start_fn is not None]
                if not runnable:
                    raise WorkerFailed(
                        f"{self.name}: work pending but no launchable "
                        f"members remain")
                for m in runnable:
                    m.done = False
                    self._launch(m, m.restarts)
                self._event("relaunch", ranks=[m.rank for m in runnable])
            if (deadline_s is not None
                    and time.perf_counter() - t0 > deadline_s):  # lint-obs: ok (deadline check)
                raise WorkerFailed(
                    f"{self.name}: deadline {deadline_s}s exceeded with "
                    f"work pending")
            time.sleep(poll_interval_s)
        for m in self._members.values():
            if m.handle is not None:
                getattr(m.handle, "cleanup", lambda: None)()
        summary = {
            "generation": self.generation,
            "world_size": self.world_size(),
            "restarts": {str(m.rank): m.restarts
                         for m in self._members.values() if m.restarts},
            "resizes": dict(self._resizes),
            "removed": sorted(m.rank for m in self._members.values()
                              if m.removed),
            "work_total": len(self.work),
            "work_pending": len(self.pending_work()),
            "events": len(self.history),
            "wall_s": time.perf_counter() - t0,  # lint-obs: ok (summary wall)
        }
        self._event("finish", **{k: v for k, v in summary.items()
                                 if k in ("restarts", "resizes",
                                          "wall_s")})
        return summary
