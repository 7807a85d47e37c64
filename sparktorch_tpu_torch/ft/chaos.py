"""Seeded, deterministic fault injection for the recovery paths — a copy of ``sparktorch_tpu/ft/chaos.py``.

Named INJECTION POINTS sit behind the hot paths, and a
:class:`ChaosInjector` decides, deterministically from an explicit
config, when each point fires. :meth:`ChaosInjector.fire` gives the
JAX package's verdicts for the same config and the same site calls.

The port's injection points: ``serve.replica`` (kill and slow, in
:meth:`~sparktorch_tpu_torch.serve.infer.InferenceReplica.submit`),
``heartbeat.beat`` (the freeze, in
:meth:`~sparktorch_tpu_torch.obs.heartbeat.HeartbeatEmitter.beat`),
``transport.request`` (a dropped connection, in the binary wire
client), ``param_server.pull`` and ``param_server.update`` (a torn pull
body, a forced 500, in the parameter server's HTTP routes), and
``worker.step``, ``data.batch`` and ``train.rank`` (kill, poison,
straggle, in the sync, streaming and hogwild trainers' step loops), and
``fleet.shard`` (a shard frontend's death at its Nth request, a
straggler's delay, in the fleet shards' HTTP routes), and
``ctl.process`` (a raw SIGKILL of a ``ctl.worker`` child, in
:meth:`~sparktorch_tpu_torch.ctl.proc.ProcessWorker.is_alive`).

Install is process-global (``with inject(config): ...``) because the
faults must reach code deep inside worker threads without threading a
handle through every layer; ``fire()`` is a single global read + None
check when no injector is installed, so production paths pay nothing.

This module imports nothing from the rest of the package, so every
injection point can import it without cycles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional


class ChaosKill(RuntimeError):
    """Raised at an injection point to kill the enclosing worker."""


class ChaosServerError(RuntimeError):
    """Raised server-side to force an HTTP 500 on a wire route."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """What to break, and when. All fields are explicit (worker/rank ->
    step, or a countdown budget), so a config replays identically;
    ``seed`` exists for future probabilistic modes and to label runs."""

    seed: int = 0
    # worker/rank -> step: raise ChaosKill at the 'worker.step' site
    # once the worker reaches that step. One-shot per worker by
    # default (kill_times) so the restarted worker's rerun survives.
    kill_worker_at: Mapping[int, int] = dataclasses.field(
        default_factory=dict)
    kill_times: int = 1
    # rank -> step: stop publishing heartbeat files from that step on
    # (the process stays alive — a freeze, not a death).
    freeze_heartbeat_at: Mapping[int, int] = dataclasses.field(
        default_factory=dict)
    # Drop the client's keep-alive connection under the next K
    # transport requests (simulates the server closing the socket /
    # a network blip mid-run).
    drop_connections: int = 0
    # Force a 500 on the next K gradient pushes, server-side.
    server_error_pushes: int = 0
    # Truncate the next K binary pull bodies server-side (client must
    # fail with WireError, never hang or half-decode).
    truncate_pull_frames: int = 0
    # shard id -> Nth request (1-based) at which that param-server
    # fleet shard's HTTP frontend dies mid-conversation (one-shot, so
    # the monitor-restarted frontend survives). Clients must degrade
    # to the remaining ring inside their grace window; the fleet
    # monitor must bring the shard back.
    kill_shard_at: Mapping[Any, int] = dataclasses.field(
        default_factory=dict)
    # shard id -> seconds of injected latency on EVERY request that
    # shard's HTTP frontend serves while the config is installed — the
    # straggler-shard fault: the shard stays correct, just slow, which
    # is exactly what per-request tracing must attribute (the slow
    # hop named as the critical path, not inferred from aggregates).
    slow_shard_s: Mapping[Any, float] = dataclasses.field(
        default_factory=dict)
    # replica id -> Nth admitted request (1-based) at which that
    # SERVING replica dies mid-admission (one-shot, so a monitor-
    # restarted replica survives its rerun) — the router-eviction
    # fault, mirroring kill_shard_at: the router must fail the hop,
    # evict, and re-route the request with zero drops.
    kill_replica_at: Mapping[Any, int] = dataclasses.field(
        default_factory=dict)
    # replica id -> seconds of injected latency on every request that
    # replica admits while the config is installed — the straggler-
    # replica fault (correct, just slow): load-aware routing must
    # shift traffic away, and a traced request's replica hop must
    # name it.
    slow_replica_s: Mapping[Any, float] = dataclasses.field(
        default_factory=dict)
    # worker/rank -> step: at the 'data.batch' site, tell the trainer
    # to poison its resident batch (NaN in the feature rows — see
    # poison_batch) before dispatching that step. One-shot per worker:
    # the drill needs exactly one bad step, then clean recovery
    # steps for the detectors/alerts to resolve against.
    poison_batch_at: Mapping[int, int] = dataclasses.field(
        default_factory=dict)
    # rank -> (from_step, delay_s): make that TRAIN rank a straggler —
    # the 'train.rank' site (fired inside the step loop, before the
    # step's collective fence) returns {"delay": delay_s} on EVERY
    # step >= from_step, so the rank arrives late at the fence and its
    # peers' exposed waits are attributable to it. Persistent, not
    # one-shot: the skew referee's sustained straggler-fraction rule
    # exists precisely for a rank that stays slow.
    slow_rank_s: Mapping[int, Any] = dataclasses.field(
        default_factory=dict)
    # rank -> step: deliver a raw SIGKILL to that rank's PROCESS
    # worker once its heartbeat reports reaching the step — the
    # NON-COOPERATIVE death the thread deployment can never exercise
    # (no cancel event, no grace, a worker wedged on the GIL dies
    # anyway). Fired at the 'ctl.process' site by the supervising
    # handle's own liveness poll; one-shot per rank so the restarted
    # worker's rerun survives.
    kill_process_at: Mapping[int, int] = dataclasses.field(
        default_factory=dict)


class ChaosInjector:
    """Evaluates a :class:`ChaosConfig` at each named site.

    Thread-safe: worker threads, HTTP handler threads, and heartbeat
    threads all consult the same injector. ``events`` records every
    fault actually fired (site + context) for tests and post-mortems.
    """

    def __init__(self, config: ChaosConfig,
                 telemetry: Optional[Any] = None):
        self.config = config
        self.telemetry = telemetry
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._kills_fired: Dict[int, int] = {}
        self._drops_left = int(config.drop_connections)
        self._errors_left = int(config.server_error_pushes)
        self._truncs_left = int(config.truncate_pull_frames)
        self._shard_requests: Dict[str, int] = {}
        self._shard_kills_fired: set = set()
        self._replica_requests: Dict[str, int] = {}
        self._replica_kills_fired: set = set()
        self._process_kills_fired: set = set()
        self._poisons_fired: set = set()

    def _record(self, site: str, **ctx: Any) -> None:
        self.events.append({"site": site, **ctx})
        if self.telemetry is not None:
            self.telemetry.counter("chaos_injections_total",
                                   labels={"site": site})

    def fire(self, site: str, **ctx: Any) -> Optional[Dict[str, Any]]:
        """Evaluate one injection point. Returns an action dict for
        sites the caller must act on (drop/truncate/skip), raises for
        kill/error sites, or returns None (the overwhelmingly common
        case: nothing to inject here)."""
        cfg = self.config
        if site == "worker.step":
            worker = ctx.get("worker")
            at = cfg.kill_worker_at.get(worker)
            if at is not None and ctx.get("step", -1) >= at:
                with self._lock:
                    fired = self._kills_fired.get(worker, 0)
                    if fired >= cfg.kill_times:
                        return None
                    self._kills_fired[worker] = fired + 1
                    self._record(site, **ctx)
                raise ChaosKill(
                    f"chaos: killed worker {worker} at step {ctx.get('step')}"
                )
        elif site == "heartbeat.beat":
            rank = ctx.get("rank")
            at = cfg.freeze_heartbeat_at.get(rank)
            if at is not None:
                step = ctx.get("step")
                # at <= 0 freezes from the first beat; otherwise only
                # once the rank has reported reaching that step.
                if at <= 0 or (step is not None and step >= at):
                    with self._lock:
                        self._record(site, rank=rank, step=step)
                    return {"skip": True}
        elif site == "transport.request":
            with self._lock:
                if self._drops_left > 0:
                    self._drops_left -= 1
                    self._record(site, **ctx)
                    return {"drop": True}
        elif site == "param_server.update":
            forced = False
            with self._lock:
                if self._errors_left > 0:
                    self._errors_left -= 1
                    self._record(site, **ctx)
                    forced = True
            if forced:
                raise ChaosServerError("chaos: forced server error")
        elif site == "param_server.pull":
            with self._lock:
                if self._truncs_left > 0:
                    self._truncs_left -= 1
                    self._record(site, **ctx)
                    return {"truncate": True}
        elif site == "fleet.shard":
            shard = str(ctx.get("shard"))
            action: Dict[str, Any] = {}
            delay = next((float(v) for k, v in cfg.slow_shard_s.items()
                          if str(k) == shard), None)
            if delay:
                with self._lock:
                    self._record(site, shard=shard,
                                 route=ctx.get("route"), delay_s=delay)
                action["delay"] = delay
            at = next((int(v) for k, v in cfg.kill_shard_at.items()
                       if str(k) == shard), None)
            if at is not None:
                with self._lock:
                    count = self._shard_requests.get(shard, 0) + 1
                    self._shard_requests[shard] = count
                    if count >= at and shard not in self._shard_kills_fired:
                        # One-shot per shard: the restarted frontend's
                        # requests must survive their rerun.
                        self._shard_kills_fired.add(shard)
                        self._record(site, shard=shard,
                                     route=ctx.get("route"))
                        action["die"] = True
            return action or None
        elif site == "data.batch":
            # Poison-batch injection (the model-health drill): the
            # trainer must act on {"poison": True} by replacing its
            # batch with a NaN-poisoned copy BEFORE dispatch, so the
            # health ledger's replay anchor records the poisoned
            # batch. One-shot per worker.
            worker = ctx.get("worker")
            at = cfg.poison_batch_at.get(worker)
            if at is not None and ctx.get("step", -1) >= at:
                with self._lock:
                    if worker in self._poisons_fired:
                        return None
                    self._poisons_fired.add(worker)
                    self._record(site, **ctx)
                return {"poison": True}
        elif site == "train.rank":
            # Straggler injection: the trainer sleeps {"delay": s}
            # before its step span / collective fence, so the delay is
            # visible to the cross-rank skew referee as a late arrival
            # (never hidden inside the victim's own measured step).
            rank = ctx.get("rank")
            spec = next((v for k, v in cfg.slow_rank_s.items()
                         if str(k) == str(rank)), None)
            if spec is not None:
                from_step, delay = int(spec[0]), float(spec[1])
                step = ctx.get("step")
                if delay > 0 and step is not None and step >= from_step:
                    with self._lock:
                        self._record(site, rank=rank, step=step,
                                     delay_s=delay)
                    return {"delay": delay}
        elif site == "ctl.process":
            # Non-cooperative process kill: the handle's liveness poll
            # asks "should this rank die NOW?" with the step its
            # heartbeat last reported. None until the step is reached;
            # one SIGKILL action per rank, ever (the restarted rerun
            # must survive).
            rank = ctx.get("rank")
            at = cfg.kill_process_at.get(rank)
            if at is not None:
                step = ctx.get("step")
                if step is not None and step >= at:
                    with self._lock:
                        if rank in self._process_kills_fired:
                            return None
                        self._process_kills_fired.add(rank)
                        self._record(site, rank=rank, step=step)
                    return {"sigkill": True}
        elif site == "serve.replica":
            # Same shape as 'fleet.shard': an optional straggler delay
            # plus a one-shot Nth-request kill, keyed by replica id.
            replica = str(ctx.get("replica"))
            action = {}
            delay = next((float(v) for k, v in cfg.slow_replica_s.items()
                          if str(k) == replica), None)
            if delay:
                with self._lock:
                    self._record(site, replica=replica, delay_s=delay)
                action["delay"] = delay
            at = next((int(v) for k, v in cfg.kill_replica_at.items()
                       if str(k) == replica), None)
            if at is not None:
                with self._lock:
                    count = self._replica_requests.get(replica, 0) + 1
                    self._replica_requests[replica] = count
                    if count >= at \
                            and replica not in self._replica_kills_fired:
                        # One-shot per replica: the monitor-restarted
                        # replica's requests survive their rerun.
                        self._replica_kills_fired.add(replica)
                        self._record(site, replica=replica)
                        action["die"] = True
            return action or None
        return None


# ---------------------------------------------------------------------------
# Process-global installation
# ---------------------------------------------------------------------------

_ACTIVE: Optional[ChaosInjector] = None
_ACTIVE_LOCK = threading.Lock()


def install(injector: ChaosInjector) -> ChaosInjector:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = injector
    return injector


def uninstall() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active() -> Optional[ChaosInjector]:
    return _ACTIVE


def fire(site: str, **ctx: Any) -> Optional[Dict[str, Any]]:
    """The call every injection point makes. Free when chaos is off."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.fire(site, **ctx)


def straggle(rank: Any, step: int) -> float:
    """The 'train.rank' injection point, packaged: fire the site and
    sleep any injected straggler delay. Trainers call this inside the
    step loop BEFORE the step span / collective fence, so the delay
    shows up to the cross-rank skew referee as a late fence arrival
    (the laggard's unattributed time), never as inflated step compute.
    Returns the seconds slept (0.0 when chaos is off — one global
    read, like every other site)."""
    act = fire("train.rank", rank=rank, step=step)
    if act and act.get("delay"):
        delay = float(act["delay"])
        time.sleep(delay)
        return delay
    return 0.0


def poison_batch(batch: Any) -> Any:
    """NaN-poison the first feature row of a DataBatch-shaped batch
    (the action a {"poison": True} verdict from the 'data.batch' site
    demands). Returns a NEW batch whose ``x`` is a new tensor (an
    ``index_fill``, never in place): the caller's rows stay as they
    were, and the fresh identity marks the poisoned batch."""
    import torch

    x = torch.as_tensor(batch.x)
    x = x.index_fill(0, torch.zeros(1, dtype=torch.long, device=x.device),
                     float("nan"))
    try:
        return batch._replace(x=x)
    except AttributeError:
        return type(batch)(x=x, y=batch.y, w=batch.w)


@contextlib.contextmanager
def inject(config_or_injector, telemetry: Optional[Any] = None):
    """Install an injector for a with-block; always uninstalls.

    (Named ``inject``, not ``chaos``: the package re-exports this
    beside the ``ft.chaos`` SUBMODULE, and shadowing the module name
    would break the injection points' ``from sparktorch_tpu_torch.ft
    import chaos`` imports.)"""
    inj = (config_or_injector
           if isinstance(config_or_injector, ChaosInjector)
           else ChaosInjector(config_or_injector, telemetry=telemetry))
    install(inj)
    try:
        yield inj
    finally:
        uninstall()
