"""Process-backed worker handles for the gang supervisor — a copy of ``sparktorch_tpu/ctl/proc.py``.

A worker wedged on the GIL or inside a native call is out of reach of
any cooperative cancel. This module's handle reaches it:

- :class:`ProcessWorker` runs ``python -m sparktorch_tpu_torch.ctl.worker``
  as a child with a dill payload file (a callable, a fleet shard
  server, an inference replica or a hogwild worker: see
  :mod:`sparktorch_tpu_torch.ctl.worker`);
- liveness is the PID (``is_alive``) plus the child's heartbeat FILE
  (rank-attributed, the directory protocol every supervisor reads);
- ``kill()`` sends SIGTERM (the child's entry turns it into the cancel
  event, so a healthy worker drains at its next window boundary), then
  SIGKILL after ``grace_s``.

The ``ctl.process`` chaos site lives in :meth:`ProcessWorker.is_alive`:
when a :class:`~sparktorch_tpu_torch.ft.ChaosConfig` maps this rank to a
kill step, the poll that sees the child's heartbeat reach that step
delivers a raw SIGKILL, the non-cooperative death the restart path must
survive. Chaos off costs one global None check per poll.

The child imports torch and the port, never JAX. Where it runs is the
payload's business: the subsystem entries take ``device=`` in their
kwargs (CUDA unless ``"cpu"`` is asked for), and a callable places its
own tensors.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

import dill

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.telemetry import wall_ts

_LOG = get_logger("sparktorch_tpu_torch.ctl.proc")

# Exit codes the worker entry uses (see ctl/worker.py): distinguish a
# drain (SIGTERM honored, work intentionally incomplete) from a crash
# so the controller can tell "I stopped it" from "it died".
EXIT_OK = 0
EXIT_FAILED = 1
EXIT_PREEMPTED = 75  # EX_TEMPFAIL: SIGTERM received before completion

_DEFAULT_GRACE_S = 5.0


class ProcessWorker:
    """One spawned worker process, presented through the supervisor
    handle contract. Construct via :func:`spawn_worker` (which writes
    the payload) or adapt an existing ``subprocess.Popen``."""

    def __init__(self, name: str, process: subprocess.Popen,
                 rank: Optional[int] = None,
                 heartbeat_dir: Optional[str] = None,
                 grace_s: float = _DEFAULT_GRACE_S,
                 payload_path: Optional[str] = None,
                 telemetry=None):
        self.name = name
        self.process = process
        self.rank = rank
        self.heartbeat_dir = heartbeat_dir
        self.grace_s = float(grace_s)
        self.payload_path = payload_path
        self.telemetry = telemetry
        self.preempted = False  # kill() was issued by a supervisor
        self.sigkilled = False  # the grace escalation (or chaos) fired
        self._kill_thread: Optional[threading.Thread] = None

    # -- liveness ----------------------------------------------------------

    @property
    def pid(self) -> int:
        return self.process.pid

    def is_alive(self) -> bool:
        alive = self.process.poll() is None
        inj = _chaos.active()
        if (alive and inj is not None and self.rank is not None
                and self.rank in getattr(inj.config, "kill_process_at",
                                         {})):
            # Seeded non-cooperative kill: the supervisor's own poll
            # delivers it the moment the child's heartbeat reports the
            # configured step — SIGKILL straight away, no cancel
            # event, no grace. One-shot per rank (the injector owns
            # the latch), so the restarted child survives its rerun.
            act = _chaos.fire("ctl.process", rank=self.rank,
                              step=self.heartbeat_step())
            if act and act.get("sigkill"):
                self.sigkilled = True
                try:
                    os.kill(self.process.pid, signal.SIGKILL)
                except OSError:
                    pass
        return alive

    @property
    def error(self) -> Optional[BaseException]:
        code = self.process.poll()
        if code is None or code == EXIT_OK:
            return None
        from sparktorch_tpu_torch.ft.supervisor import WorkerFailed

        if code == EXIT_PREEMPTED:
            return WorkerFailed(f"{self.name}: preempted (drained by "
                                f"SIGTERM before completion)")
        if code < 0:
            return WorkerFailed(
                f"{self.name}: killed by signal {-code}"
            )
        return WorkerFailed(f"{self.name}: exit code {code}")

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self.process.wait(timeout)
        except subprocess.TimeoutExpired:
            pass

    # -- heartbeat-file liveness ------------------------------------------

    def heartbeat_record(self) -> Optional[Dict[str, Any]]:
        """This rank's current heartbeat record (None without a
        heartbeat dir, before the first beat, or on a torn file)."""
        if self.heartbeat_dir is None or self.rank is None:
            return None
        path = os.path.join(self.heartbeat_dir,
                            f"gang_hb_rank{int(self.rank)}.json")
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        return rec if isinstance(rec, dict) else None

    def heartbeat_step(self) -> Optional[int]:
        rec = self.heartbeat_record()
        step = (rec or {}).get("step")
        return int(step) if step is not None else None

    def heartbeat_age_s(self, now: Optional[float] = None) -> Optional[float]:
        rec = self.heartbeat_record()
        if not rec or rec.get("ts") is None:
            return None
        return max(0.0, (now if now is not None else wall_ts())
                   - float(rec["ts"]))

    # -- preemption --------------------------------------------------------

    def kill(self, grace_s: Optional[float] = None) -> None:
        """Non-cooperative preemption: SIGTERM now (the worker entry
        translates it into the cancel event, so a HEALTHY worker
        drains and exits ``EXIT_PREEMPTED``), SIGKILL after the grace
        window for a worker too wedged to react. Idempotent; the
        escalation runs on a daemon thread so the supervisor's poll
        loop never blocks on a dying child."""
        self.preempted = True
        if self.process.poll() is not None:
            return
        try:
            self.process.terminate()
        except OSError:
            return
        grace = self.grace_s if grace_s is None else float(grace_s)
        if self._kill_thread is not None:
            return

        def escalate():
            try:
                self.process.wait(grace)
            except subprocess.TimeoutExpired:
                self.sigkilled = True
                if self.telemetry is not None:
                    self.telemetry.counter(
                        "ctl.sigkill_escalations_total",
                        labels={"worker": self.name})
                _LOG.warning(
                    f"[sparktorch_tpu_torch:ctl] worker {self.name} ignored "
                    f"SIGTERM for {grace}s; escalating to SIGKILL"
                )
                try:
                    self.process.kill()
                except OSError:
                    pass

        self._kill_thread = threading.Thread(
            target=escalate, name=f"ctl-kill-{self.name}", daemon=True)
        self._kill_thread.start()

    def ctl_url(self, timeout_s: float = 10.0) -> Optional[str]:
        """The child's exporter/control URL (see
        :func:`worker_ctl_url`); None without a ``ctl_port``."""
        return worker_ctl_url(self, timeout_s=timeout_s)

    def cleanup(self) -> None:
        """Remove the payload file (the worker read it at startup)."""
        if self.payload_path:
            for path in (self.payload_path, self.payload_path + ".url"):
                try:
                    os.unlink(path)
                except OSError:
                    pass


def spawn_worker(fn: Optional[Callable[..., Any]] = None, *,
                 kind: str = "callable",
                 kwargs: Optional[Mapping[str, Any]] = None,
                 name: Optional[str] = None,
                 rank: Optional[int] = None,
                 heartbeat_dir: Optional[str] = None,
                 ctl_port: Optional[int] = None,
                 grace_s: float = _DEFAULT_GRACE_S,
                 env: Optional[Mapping[str, str]] = None,
                 cwd: Optional[str] = None,
                 payload_dir: Optional[str] = None,
                 telemetry=None) -> ProcessWorker:
    """Spawn one worker process running the ctl entry.

    ``kind`` selects the entry (see :mod:`sparktorch_tpu_torch.ctl.worker`):
    ``"callable"`` runs ``fn(ctx)`` (dill-shipped — closures work);
    ``"shard_server"`` / ``"replica_server"`` / ``"hogwild_worker"``
    run the corresponding subsystem entry point with ``kwargs``. Every
    kind gets a :class:`~sparktorch_tpu_torch.ctl.worker.WorkerContext`:
    rank, the SIGTERM-wired cancel event, a heartbeat emitter when
    ``heartbeat_dir`` is given, and (with ``ctl_port`` — 0 for
    ephemeral) a :class:`~sparktorch_tpu_torch.native.gang.
    GangMetricsExporter` serving ``/metrics`` + ``POST /ctl`` with
    kill/drain verbs; the bound URL is published next to the payload
    (``<payload>.url``) for :attr:`ProcessWorker.ctl_url`.
    """
    name = name or (f"rank{rank}" if rank is not None else "worker")
    payload: Dict[str, Any] = {
        "kind": kind,
        "fn": fn,
        "kwargs": dict(kwargs or {}),
        "name": name,
        "rank": rank,
        "heartbeat_dir": heartbeat_dir,
        "ctl_port": ctl_port,
    }
    fd, payload_path = tempfile.mkstemp(
        prefix=f"ctl_worker_{name}_", suffix=".dill", dir=payload_dir)
    with os.fdopen(fd, "wb") as f:
        dill.dump(payload, f)
    child_env = dict(os.environ)
    # The child must resolve this package no matter what ``cwd`` the
    # controller runs under (an uninstalled checkout imports via the
    # parent's sys.path, which the child does not inherit). Same for
    # the module DEFINING a shipped callable: dill pickles a function
    # from an importable module by reference, so the child must be
    # able to import it (a fn defined in __main__ ships by value and
    # needs nothing).
    extra = [os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))]
    mod = sys.modules.get(getattr(fn, "__module__", None) or "")
    mod_file = getattr(mod, "__file__", None)
    if mod_file and getattr(mod, "__name__", "") != "__main__":
        extra.append(os.path.dirname(os.path.abspath(mod_file)))
    parts = [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
             if p]
    child_env["PYTHONPATH"] = os.pathsep.join(
        [p for p in extra if p not in parts] + parts)
    if env:
        child_env.update({str(k): str(v) for k, v in env.items()})
    process = subprocess.Popen(
        [sys.executable, "-m", "sparktorch_tpu_torch.ctl.worker",
         payload_path],
        env=child_env, cwd=cwd,
        # The child's stdout/stderr flow to the parent's (an operator
        # tailing the controller sees worker tracebacks); no pipes to
        # fill up and wedge a silent child.
    )
    return ProcessWorker(name, process, rank=rank,
                         heartbeat_dir=heartbeat_dir, grace_s=grace_s,
                         payload_path=payload_path, telemetry=telemetry)


def worker_ctl_url(worker: ProcessWorker,
                   timeout_s: float = 10.0) -> Optional[str]:
    """The child's control/observability URL (``<payload>.url``,
    written by the entry once its exporter binds). None when the
    worker was spawned without ``ctl_port`` or hasn't bound within
    the timeout."""
    if not worker.payload_path:
        return None
    path = worker.payload_path + ".url"
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                url = f.read().strip()
            if url:
                return url
        except OSError:
            pass
        if worker.process.poll() is not None:
            return None
        time.sleep(0.05)
    return None
