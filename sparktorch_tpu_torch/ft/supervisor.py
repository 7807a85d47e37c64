"""The gang supervisor: owns workers, watches liveness, applies policy — a copy of ``sparktorch_tpu/ft/supervisor.py``.

The :class:`Supervisor` acts on the liveness signals the port already
has (per-rank heartbeat files, a
:class:`~sparktorch_tpu_torch.native.gang.GangMetricsExporter`'s
``/heartbeats`` route, thread and process liveness):

- **restart-on-death** with exponential backoff and deterministic
  jitter under a per-worker budget (``RestartPolicy``);
- **straggler detection** from cross-rank step skew (warn at N steps,
  optionally preempt at M; ``StragglerPolicy``);
- **stall deadlines**: a worker whose heartbeat age exceeds the barrier
  deadline while its handle still looks alive is preempted
  (``BarrierPolicy``).

Every restart bumps ``ft_restarts_total{worker=}``, straggler episodes
bump ``ft_straggler_warnings_total`` / ``ft_straggler_preemptions_total``,
and the death -> running-again latency lands in the
``ft_recovery_latency_s`` histogram and the goodput ledger's
``restart_downtime``, all on the bus the trainers and the parameter
server share.

The handle contract is ``name``, ``error`` (None until a failure is
known), ``is_alive()``, ``join(timeout)`` and ``kill()``, with three
implementations: :class:`ThreadWorker` (a cooperative kill through a
cancel Event), :class:`ProcessWorker` here (a ``multiprocessing.Process``
terminate), and :class:`sparktorch_tpu_torch.ctl.proc.ProcessWorker`
(spawned ``python -m sparktorch_tpu_torch.ctl.worker`` children with
heartbeat-file liveness and SIGTERM -> grace -> SIGKILL). Restarted
sync ranks resume from the latest finalized checkpoint (found by
``utils.checkpoint.latest_step``); restarted hogwild workers rejoin by
pulling the current server version.

A worker that spends its restart budget fails the run
(:class:`WorkerFailed`) unless ``on_exhausted=`` absorbs it, as the
elastic controller's shrink does (:mod:`sparktorch_tpu_torch.ctl.elastic`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from sparktorch_tpu_torch.ft.policy import FtPolicy
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.telemetry import get_telemetry


class WorkerFailed(RuntimeError):
    """A supervised worker failed and its restart budget is spent."""


class WorkerPreempted(RuntimeError):
    """A cooperative worker observed its cancel event and stopped.

    Raised by worker loops that poll the :class:`ThreadWorker` cancel
    event (the hogwild ``_worker_loop`` polls between windows), so a
    supervisor ``kill()`` — straggler preemption, stall deadline —
    actually stops a thread-based worker instead of merely flagging
    it. The supervisor treats the death of a ``preempting`` worker as
    a restart under budget, whatever it raised."""


class ThreadWorker:
    """Thread-backed worker handle. The target either returns (clean
    exit) or raises (failure — captured, surfaced via ``error``).
    ``kill()`` is cooperative: it sets ``cancel`` (an Event the target
    may poll); threads cannot be preempted — process workers can."""

    def __init__(self, name: str, target: Callable[..., Any],
                 pass_cancel: bool = False):
        self.name = name
        self.error: Optional[BaseException] = None
        self.cancel = threading.Event()

        def run():
            try:
                target(self.cancel) if pass_cancel else target()
            except BaseException as e:  # surfaced to the supervisor
                self.error = e

        self._thread = threading.Thread(
            target=run, name=f"ft-worker-{name}", daemon=True
        )
        self._thread.start()

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def kill(self) -> None:
        self.cancel.set()


class ProcessWorker:
    """``multiprocessing.Process`` handle: non-zero exitcode = failure,
    ``kill()`` is a real terminate. The process must already be
    started (or ``start()``ed by the factory that returns it)."""

    def __init__(self, process: Any):
        self.process = process
        if not process.is_alive() and process.exitcode is None:
            process.start()

    @property
    def name(self) -> str:
        return getattr(self.process, "name", "process")

    @property
    def error(self) -> Optional[BaseException]:
        code = self.process.exitcode
        if code is None or code == 0:
            return None
        return WorkerFailed(f"{self.name}: exit code {code}")

    def is_alive(self) -> bool:
        return self.process.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self.process.join(timeout)

    def kill(self) -> None:
        self.process.terminate()


class _Supervised:
    """One worker's supervision state."""

    __slots__ = ("name", "rank", "start_fn", "handle", "restarts",
                 "done", "failed", "warned", "preempting",
                 "restart_at", "detected_at")

    def __init__(self, name: str, start_fn, rank: Optional[int]):
        self.name = name
        self.rank = rank
        self.start_fn = start_fn
        self.handle = None
        self.restarts = 0
        self.done = False
        self.failed: Optional[BaseException] = None
        self.warned = False      # straggler episode latch
        self.preempting = False  # kill() issued, waiting for death
        # Scheduled restart: backoff waits here (checked by the poll
        # loop), never as an inline sleep — a 5s backoff for one
        # worker must not freeze death detection for the others.
        self.restart_at: Optional[float] = None
        self.detected_at: Optional[float] = None


class Supervisor:
    """Owns a set of workers and runs them to completion under policy.

    ``heartbeat_dir`` and/or ``exporter_url`` wire the liveness/skew
    source (heartbeat files, or a ``GangMetricsExporter``'s
    ``/heartbeats`` route); without either, supervision still covers
    death-and-restart from handle liveness alone.
    """

    def __init__(self, policy: Optional[FtPolicy] = None,
                 telemetry=None, heartbeat_dir: Optional[str] = None,
                 exporter_url: Optional[str] = None,
                 on_exhausted=None,
                 name: str = "supervisor",
                 postmortem_dir: Optional[str] = None,
                 postmortem_window_s: float = 30.0,
                 collector=None):
        self.policy = policy or FtPolicy()
        self.telemetry = telemetry or get_telemetry()
        self.heartbeat_dir = heartbeat_dir
        self.exporter_url = exporter_url
        # Flight-recorder postmortems: with a ``postmortem_dir``, every
        # detected death/preemption folds the available blackbox rings
        # (this bus's, plus each scraped rank's last-good when a
        # ``collector`` is attached) into one bundle — the evidence of
        # WHY a worker died no longer dies with its process.
        self.postmortem_dir = postmortem_dir
        self.postmortem_window_s = float(postmortem_window_s)
        self.collector = collector
        if postmortem_dir:
            from sparktorch_tpu_torch.obs.blackbox import attach_recorder

            attach_recorder(self.telemetry)
        # ``on_exhausted(name, rank, error) -> bool``: called when a
        # worker dies past its restart budget. True = the failure was
        # ABSORBED (an elastic controller shrank the world and
        # redistributed the work) — the worker is marked done and the
        # run continues; False/None keeps the original fail-the-run
        # behavior.
        self.on_exhausted = on_exhausted
        self.name = name
        self._rng = self.policy.rng()
        self._workers: List[_Supervised] = []
        self._log = get_logger("sparktorch_tpu_torch.ft.supervisor")

    # -- registration ------------------------------------------------------

    def add(self, name: str, start_fn: Callable[[int], Any],
            rank: Optional[int] = None) -> None:
        """Register a worker. ``start_fn(attempt)`` must (re)start the
        worker and return its handle; attempt 0 is the first launch.
        ``rank`` links the worker to its heartbeat record for
        straggler/stall policies."""
        self._workers.append(_Supervised(name, start_fn, rank))

    # -- heartbeat / skew source -------------------------------------------

    def _report(self) -> Optional[Dict[str, Any]]:
        if self.heartbeat_dir:
            from sparktorch_tpu_torch.obs.heartbeat import gang_report

            return gang_report(self.heartbeat_dir)
        if self.exporter_url:
            # The scrape must DEGRADE, never crash the poll loop: an
            # exporter answering 500, a torn JSON body, a server that
            # vanished mid-poll, or a well-formed reply with a shape
            # this reader doesn't expect (non-dict, junk rank keys)
            # all reduce to "no report this tick" — a warning plus the
            # ft_scrape_errors_total counter, while death-and-restart
            # supervision from handle liveness continues untouched.
            from sparktorch_tpu_torch.obs.collector import (
                ScrapeError,
                scrape_json,
            )

            url = self.exporter_url.rstrip("/") + "/heartbeats"
            try:
                report = scrape_json(url, timeout=2.0)
                if not isinstance(report, dict):
                    raise ScrapeError(f"{url}: not a JSON object")
                # The exporter serialized rank keys as strings; re-key
                # (junk keys are a malformed reply, same degradation).
                report["ranks"] = {
                    int(k): v for k, v in (report.get("ranks") or {}).items()
                }
                return report
            except (ScrapeError, ValueError, TypeError, AttributeError) as e:
                self.telemetry.counter("ft_scrape_errors_total",
                                       labels={"source": "exporter"})
                self._log.warning(
                    f"[sparktorch_tpu_torch:ft] exporter scrape failed "
                    f"(skew/stall policies skip this tick): {e}"
                )
                return None
        return None

    # -- policy application ------------------------------------------------

    def _postmortem(self, reason: str, worker: Optional[str] = None,
                    rank: Optional[int] = None) -> None:
        """Best-effort bundle write on a detected death/preemption:
        evidence must never take supervision down with it."""
        if not self.postmortem_dir:
            return
        from sparktorch_tpu_torch.obs.blackbox import collect_postmortem

        try:
            collect_postmortem(
                self.postmortem_dir,
                f"{worker or self.name}: {reason}",
                telemetry=self.telemetry,
                collector=self.collector,
                history=getattr(self.collector, "history", None),
                window_s=self.postmortem_window_s,
                rank=rank,
            )
            self.telemetry.counter("ft_postmortems_total")
        except Exception as e:  # noqa: BLE001 - best-effort evidence
            self.telemetry.counter("ft_postmortem_failures_total")
            self._log.warning(
                f"[sparktorch_tpu_torch:ft] postmortem write failed: "
                f"{type(e).__name__}: {e}")

    def _schedule_restart(self, w: _Supervised, reason: str) -> None:
        """Death detected: either spend a restart slot (schedule the
        relaunch for after the backoff) or fail the worker for good.
        The backoff is a TIMESTAMP the poll loop checks, not a sleep —
        supervision of the other workers never pauses."""
        self._postmortem(reason, worker=w.name, rank=w.rank)
        policy = self.policy.restart
        if w.restarts >= policy.max_restarts:
            err = WorkerFailed(
                f"{w.name}: restart budget ({policy.max_restarts}) "
                f"exhausted ({reason})"
            )
            if self.on_exhausted is not None and self.on_exhausted(
                    w.name, w.rank, err):
                # Absorbed (elastic shrink): this worker's share moved
                # elsewhere; it is done, not failed.
                w.done = True
                self.telemetry.counter("ft_budget_absorbed_total",
                                       labels={"worker": w.name})
                self.telemetry.event("ft_budget_absorbed", worker=w.name,
                                     reason=reason)
                return
            w.failed = w.failed or err
            return
        delay = policy.delay_s(w.restarts, self._rng)
        w.detected_at = time.perf_counter()
        w.restart_at = w.detected_at + delay
        self._log.warning(
            f"[sparktorch_tpu_torch:ft] worker {w.name} {reason}; restart "
            f"{w.restarts + 1}/{policy.max_restarts} in {delay:.3f}s"
        )
        self.telemetry.event("ft_restart_scheduled", worker=w.name,
                             reason=reason, delay_s=delay)

    def _do_restart(self, w: _Supervised) -> None:
        attempt = w.restarts + 1
        old = w.handle
        if old is not None:
            # Retire the replaced handle's on-disk residue (a ctl
            # ProcessWorker's payload/url files); thread handles have
            # no cleanup and are skipped.
            getattr(old, "cleanup", lambda: None)()
        w.handle = w.start_fn(attempt)
        w.restarts = attempt
        w.preempting = False
        w.warned = False
        w.restart_at = None
        labels = {"worker": w.name}
        self.telemetry.counter("ft_restarts_total", labels=labels)
        # Death-detection -> running-again, INCLUDING the backoff wait
        # (that is real downtime the policy chose to spend).
        latency = (time.perf_counter()
                   - (w.detected_at or time.perf_counter()))
        self.telemetry.observe("ft_recovery_latency_s", latency,
                               labels=labels)
        # Same window, same number, into the goodput ledger's
        # restart_downtime bucket — the reconciliation the bench gate
        # checks.
        _goodput.add("restart_downtime", latency)
        self.telemetry.event("ft_restart", worker=w.name, attempt=attempt)

    def _apply_skew_policies(self) -> None:
        report = self._report()
        if not report:
            return
        strag = self.policy.straggler
        ranks = report.get("ranks", {})
        by_rank = {w.rank: w for w in self._workers if w.rank is not None}
        # Stall deadline: heartbeat age beyond the barrier deadline on
        # a handle that still looks alive = wedged -> preempt.
        deadline = self.policy.barrier.deadline_s
        if deadline and deadline > 0:
            for rank, rec in ranks.items():
                w = by_rank.get(rank)
                if (w is None or w.done or w.failed or w.preempting
                        or w.handle is None or not w.handle.is_alive()):
                    continue
                if rec.get("alive") and rec["last_seen_age_s"] > deadline:
                    self._log.warning(
                        f"[sparktorch_tpu_torch:ft] rank {rank} heartbeat "
                        f"age {rec['last_seen_age_s']:.1f}s > deadline "
                        f"{deadline}s; preempting"
                    )
                    self.telemetry.counter(
                        "ft_stall_preemptions_total",
                        labels={"worker": w.name},
                    )
                    w.preempting = True
                    w.handle.kill()
        if strag is None:
            return
        skew = report.get("step_skew")
        steps = {r: rec.get("step") for r, rec in ranks.items()
                 if rec.get("step") is not None}
        if skew is None or len(steps) < max(2, strag.min_ranks):
            return
        if skew < strag.warn_skew_steps:
            # Episode over (the laggard caught up): re-arm the warn
            # latches so the NEXT lagging episode warns again.
            for w in self._workers:
                w.warned = False
            return
        laggard_rank = min(steps, key=steps.get)
        w = by_rank.get(laggard_rank)
        if w is None or w.done or w.failed:
            return
        if skew >= strag.warn_skew_steps and not w.warned:
            w.warned = True
            self.telemetry.counter("ft_straggler_warnings_total",
                                   labels={"worker": w.name})
            self._log.warning(
                f"[sparktorch_tpu_torch:ft] rank {laggard_rank} lags by "
                f"{skew} steps (warn threshold "
                f"{strag.warn_skew_steps})"
            )
        if (strag.preempt_skew_steps and strag.preempt_skew_steps > 0
                and skew >= strag.preempt_skew_steps
                and not w.preempting and w.handle is not None
                and w.handle.is_alive()):
            self.telemetry.counter("ft_straggler_preemptions_total",
                                   labels={"worker": w.name})
            self._log.warning(
                f"[sparktorch_tpu_torch:ft] rank {laggard_rank} lags by "
                f"{skew} steps >= preempt threshold "
                f"{strag.preempt_skew_steps}; preempting"
            )
            w.preempting = True
            w.handle.kill()

    # -- main loop ---------------------------------------------------------

    def run(self, poll_interval_s: float = 0.05,
            deadline_s: Optional[float] = None) -> Dict[str, Any]:
        """Start every worker and supervise until all are done (or one
        fails past its budget). Returns a summary dict; raises
        :class:`WorkerFailed` on unrecovered failure."""
        t0 = time.perf_counter()
        for w in self._workers:
            w.handle = w.start_fn(0)
        while True:
            pending = False
            for w in self._workers:
                if w.done or w.failed:
                    continue
                if w.restart_at is not None:
                    # Waiting out the backoff; relaunch when due.
                    if time.perf_counter() >= w.restart_at:
                        self._do_restart(w)
                    pending = True
                    continue
                if w.handle.is_alive():
                    pending = True
                    continue
                err = w.handle.error
                if err is None and not w.preempting:
                    w.done = True
                    continue
                # Death (or a preempt landing): restart under budget.
                reason = (f"failed: {type(err).__name__}: {err}"
                          if err is not None else "preempted")
                self._schedule_restart(w, reason)
                if w.failed is None:
                    pending = True
            self._apply_skew_policies()
            if not pending:
                break
            if (deadline_s is not None
                    and time.perf_counter() - t0 > deadline_s):
                raise WorkerFailed(
                    f"{self.name}: supervision deadline {deadline_s}s "
                    "exceeded with workers still running"
                )
            time.sleep(poll_interval_s)
        failures = [w for w in self._workers if w.failed]
        summary = {
            "workers": len(self._workers),
            "restarts": {w.name: w.restarts for w in self._workers
                         if w.restarts},
            "failed": [w.name for w in failures],
            "wall_s": time.perf_counter() - t0,
        }
        if failures:
            raise WorkerFailed(
                f"{self.name}: {len(failures)} worker(s) failed past "
                f"their restart budget: {summary['failed']}"
            ) from failures[0].failed
        return summary


def supervise_run(fn: Callable[..., Any],
                  policy: Optional[FtPolicy] = None,
                  telemetry=None,
                  retry_on: tuple = (Exception,),
                  checkpoint_dir: Optional[str] = None,
                  name: str = "gang") -> Any:
    """Gang-LEVEL recovery for synchronous training: run
    ``fn(attempt=k, resume=bool)`` and, when it dies with a retriable
    error (a ``GangFailure``, a chaos kill, a failed Spark stage),
    restart the WHOLE attempt under the restart policy.

    ``resume`` is True only when a finalized checkpoint actually
    exists (auto-discovered via ``utils.checkpoint.latest_step`` when
    ``checkpoint_dir`` is given), so a first-attempt crash before any
    save restarts from scratch instead of erroring on an empty
    directory. Restart metrics land on the same bus as the worker-
    level supervisor's (``ft_restarts_total{worker=<name>}``).
    """
    policy = policy or FtPolicy()
    tele = telemetry or get_telemetry()
    log = get_logger("sparktorch_tpu_torch.ft.supervisor")
    rng = policy.rng()
    attempt = 0
    while True:
        resume = False
        if checkpoint_dir:
            from sparktorch_tpu_torch.utils.checkpoint import latest_step

            resume = attempt > 0 and latest_step(checkpoint_dir) is not None
        try:
            return fn(attempt=attempt, resume=resume)
        except retry_on as e:
            if attempt >= policy.restart.max_restarts:
                raise
            t_detect = time.perf_counter()
            delay = policy.restart.delay_s(attempt, rng)
            log.warning(
                f"[sparktorch_tpu_torch:ft] {name} attempt {attempt} failed "
                f"({type(e).__name__}: {e}); restarting in {delay:.3f}s"
            )
            time.sleep(delay)
            attempt += 1
            tele.counter("ft_restarts_total", labels={"worker": name})
            latency = time.perf_counter() - t_detect
            tele.observe("ft_recovery_latency_s", latency,
                         labels={"worker": name})
            _goodput.add("restart_downtime", latency)
            tele.event("ft_restart", worker=name, attempt=attempt,
                       reason=f"{type(e).__name__}: {e}")
