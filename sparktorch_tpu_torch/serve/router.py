"""Load-aware multi-replica router for the online inference tier — the port of ``sparktorch_tpu/serve/router.py:52-615``.

One replica is a latency domain; production traffic needs N of them
behind a router that (a) ROUTES on load — weighted least-outstanding,
where the weight is each replica's measured latency, so a straggling
replica organically sheds traffic — (b) EVICTS replicas the ft
signals call dead (a failed hop, or a heartbeat aged past the
:class:`~sparktorch_tpu_torch.ft.policy.BarrierPolicy` deadline) and
RE-ADMITS them on recovery, and (c) never drops a request a live
replica could serve: a hop that fails mid-request is retried on the
remaining replicas until the request's own deadline, which is what
makes a chaos-injected replica kill cost latency, not answers.

Latency weights come from the replicas' buses (``serve.request_latency_s``),
or, when a :class:`~sparktorch_tpu_torch.obs.collector.FleetCollector`
is attached (replicas export, the collector merges, the router reads
one snapshot), from the collector's merged scrape.

:class:`InferenceTier` bundles the common deployment: N replicas +
router + a restart monitor (a dead replica is rebuilt from its last
served module, counted, and re-admitted by the router's probe) +
per-replica :class:`~sparktorch_tpu_torch.serve.infer.WeightPuller`
threads against a parameter server, so a training run's pushes reach
every serving replica within a few poll intervals.

Goodput: a hop (submit, queue and the replica's wall) is
``exposed_comm{site=router}`` on the router process's ambient ledger,
and a retry's backoff ``exposed_comm{site=router_retry}``; the
replica's own ledger attributes its compute. ``Router.start`` arms the
process's stack profiler (:func:`~sparktorch_tpu_torch.obs.profile.ensure`)
beside it.

Tracing (:mod:`~sparktorch_tpu_torch.obs.rpctrace`): each routed
request is an ``infer`` root span with one ``replica`` child a hop
(a retried request has several), whose context the replica's batch
loop parents its ``queue_wait`` and ``execute`` under.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from sparktorch_tpu_torch.ft.policy import FtPolicy
from sparktorch_tpu_torch.net.transport import TransportError
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.serve.infer import (
    DeadlineExceeded,
    InferenceReplica,
    Overloaded,
    ReplicaStopped,
    WeightPuller,
)

_LATENCY_FLOOR_S = 1e-3  # score floor: an unmeasured replica is "fast"


class NoReplicasAvailable(RuntimeError):
    """Every replica is evicted or refused — the router's 503."""

    status = 503


class _ReplicaState:
    __slots__ = ("handle", "outstanding", "evicted", "evict_reason",
                 "evicted_at", "probe_attempts")

    def __init__(self, handle):
        self.handle = handle
        self.outstanding = 0
        self.evicted = False
        self.evict_reason: Optional[str] = None
        self.evicted_at: Optional[float] = None
        self.probe_attempts = 0


class Router:
    """Route requests across registered replicas.

    ``ft_policy`` supplies the health semantics this module REUSES
    rather than reinvents: ``barrier.deadline_s`` bounds a replica's
    heartbeat age (evict an alive-but-wedged replica), ``restart``
    spaces re-admission probes with the same seeded backoff the
    training supervisor uses. ``heartbeat_dir`` is the replicas'
    shared heartbeat directory (rank == replica id);
    without one, liveness falls back to the handles' ``alive()``.
    ``collector`` (a started :class:`~sparktorch_tpu_torch.obs.collector.
    FleetCollector`) makes routing read latency weights from the
    collector's merged scrape instead of the handles' local buses.
    """

    def __init__(self, ft_policy: Optional[FtPolicy] = None,
                 heartbeat_dir: Optional[str] = None,
                 collector=None, telemetry=None,
                 probe_interval_s: float = 0.25,
                 default_deadline_s: float = 30.0):
        from sparktorch_tpu_torch.obs import get_telemetry

        self.collector = collector
        self.policy = ft_policy or FtPolicy()
        self.heartbeat_dir = heartbeat_dir
        self.telemetry = telemetry or get_telemetry()
        self.probe_interval_s = float(probe_interval_s)
        self.default_deadline_s = float(default_deadline_s)
        self._rng = random.Random(self.policy.seed)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaState] = {}
        # Routing-weight cache: a fresh p50 read costs a percentile
        # over the histogram ring. The bus snapshots the ring under its
        # lock and computes the percentile OUTSIDE it
        # (obs.telemetry.rollup_from_state), but the math itself is
        # still worth amortizing: load shifts on the outstanding term
        # instantly; the latency WEIGHT only needs to follow on this
        # horizon.
        self._p50_ttl_s = 0.25
        self._p50_cache: Dict[str, Tuple[float, Optional[float]]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- membership ---------------------------------------------------------

    def register(self, replica) -> None:
        """Add (or REPLACE — the restart-monitor path) a replica
        handle. A replacement for an evicted id stays evicted until a
        health probe passes, so re-admission is always observed and
        counted, never assumed."""
        rid = str(replica.replica_id)
        with self._lock:
            prior = self._replicas.get(rid)
            st = _ReplicaState(replica)
            if prior is not None and prior.evicted:
                st.evicted = True
                st.evict_reason = prior.evict_reason
                st.evicted_at = prior.evicted_at
                st.probe_attempts = prior.probe_attempts
            self._replicas[rid] = st
        self._gauge_live()

    def replicas(self) -> Dict[str, Any]:
        with self._lock:
            return {rid: st.handle for rid, st in self._replicas.items()}

    def _gauge_live(self) -> None:
        with self._lock:
            live = sum(not st.evicted for st in self._replicas.values())
        self.telemetry.gauge("router.live_replicas", live)

    # -- health -------------------------------------------------------------

    def _hb_ranks(self) -> Optional[Dict[int, Any]]:
        """One heartbeat-directory scan, shared by a whole health
        sweep — per-replica rescans multiply a full dir parse by N
        replicas per tick (and by every submit thread during an
        eviction window)."""
        if not self.heartbeat_dir:
            return None
        from sparktorch_tpu_torch.obs import gang_report

        return gang_report(self.heartbeat_dir).get("ranks", {})

    @staticmethod
    def _hb_age(rid: str, ranks: Optional[Dict[int, Any]]
                ) -> Optional[float]:
        if ranks is None:
            return None
        try:
            rank = int(rid)
        except ValueError:
            return None
        rec = ranks.get(rank)
        if rec is None:
            return None
        return float(rec.get("last_seen_age_s", 0.0))

    def evict(self, rid: str, reason: str = "error") -> None:
        with self._lock:
            st = self._replicas.get(rid)
            if st is None or st.evicted:
                return
            st.evicted = True
            st.evict_reason = reason
            st.evicted_at = time.monotonic()
            st.probe_attempts = 0
        self.telemetry.counter("router.evictions_total",
                               labels={"replica": rid, "reason": reason})
        self._gauge_live()

    def _probe(self, rid: str, st: _ReplicaState,
               hb_ranks: Optional[Dict[int, Any]]) -> bool:
        """One health decision for ``rid``: handle liveness AND (when
        a heartbeat dir is wired) heartbeat freshness under the
        barrier deadline — the exporter-vanished/wedged case handle
        liveness alone cannot see."""
        try:
            ok = bool(st.handle.alive())
        except Exception:  # noqa: BLE001 - a probe must never raise
            ok = False
        if ok:
            age = self._hb_age(rid, hb_ranks)
            if age is not None and age > self.policy.barrier.deadline_s:
                ok = False
        return ok

    def check_health(self) -> None:
        """One sweep: evict live replicas that fail the probe, re-admit
        evicted ones that pass it (probe spacing for evicted replicas
        follows the restart policy's seeded backoff — the supervisor's
        discipline, reused). Runs from the background loop and inline
        from :meth:`submit` when no live replica remains."""
        with self._lock:
            snapshot = list(self._replicas.items())
        now = time.monotonic()
        hb_ranks = self._hb_ranks()
        for rid, st in snapshot:
            if st.evicted:
                delay = self.policy.restart.delay_s(st.probe_attempts,
                                                    self._rng)
                if st.evicted_at is not None \
                        and now - st.evicted_at < delay:
                    continue
                if self._probe(rid, st, hb_ranks):
                    with self._lock:
                        cur = self._replicas.get(rid)
                        if cur is not None and cur.evicted:
                            cur.evicted = False
                            cur.evict_reason = None
                    self.telemetry.counter("router.readmissions_total",
                                           labels={"replica": rid})
                    self._gauge_live()
                else:
                    st.probe_attempts += 1
                    st.evicted_at = now
            else:
                if not self._probe(rid, st, hb_ranks):
                    self.evict(rid, reason="health")

    def start(self) -> "Router":
        """Launch the background health loop (optional — an in-process
        tier that only ever fails on submit can rely on the inline
        sweeps)."""
        # The stack sampler beside the router's goodput attribution:
        # serving processes profile like training ones.
        from sparktorch_tpu_torch.obs import profile as _profile

        _profile.ensure(self.telemetry)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._health_loop,
                                            daemon=True,
                                            name="router-health")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _health_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self.check_health()

    # -- routing ------------------------------------------------------------

    def _latency_p50(self, rid: str, st: _ReplicaState) -> Optional[float]:
        now = time.monotonic()
        cached = self._p50_cache.get(rid)
        if cached is not None and now - cached[0] < self._p50_ttl_s:
            return cached[1]
        p50 = self._latency_p50_fresh(rid, st)
        self._p50_cache[rid] = (now, p50)
        return p50

    def _latency_p50_fresh(self, rid: str,
                           st: _ReplicaState) -> Optional[float]:
        labels = {"replica": rid}
        if self.collector is not None:
            from sparktorch_tpu_torch.obs import snapshot_histogram

            roll = snapshot_histogram(self.collector.merged_snapshot(),
                                      "serve.request_latency_s", labels)
            if roll and roll.get("p50") is not None:
                return float(roll["p50"])
            return None
        tele = getattr(st.handle, "telemetry", None)
        if tele is None:
            return None
        roll = tele.histogram("serve.request_latency_s", labels)
        return float(roll["p50"]) if roll.get("p50") is not None else None

    def _choose(self, exclude: set) -> Optional[str]:
        """Weighted least-outstanding: score = (outstanding + 1) x
        p50 latency (the classic weighted-least-connection estimate of
        this replica's expected wait). Unmeasured replicas take the
        latency floor — new capacity attracts traffic until its real
        latency shows up. Deterministic tie-break by id."""
        with self._lock:
            candidates = [(rid, st) for rid, st in self._replicas.items()
                          if not st.evicted and rid not in exclude]
        best_rid, best_score = None, None
        for rid, st in sorted(candidates):
            p50 = self._latency_p50(rid, st)
            score = (st.outstanding + 1) * max(
                p50 if p50 is not None else 0.0, _LATENCY_FLOOR_S)
            if best_score is None or score < best_score:
                best_rid, best_score = rid, score
        return best_rid

    def submit(self, x, deadline_s: Optional[float] = None) -> np.ndarray:
        """Route one request; blocks until a replica answers. A hop
        failure (replica died, timed out, or was killed mid-batch)
        evicts that replica and re-routes the SAME request to the
        remaining ones — requests are pure reads, so the retry is
        safe — until the request's deadline. Raises
        :class:`Overloaded` when every live replica refused admission
        (the tier-wide 429) and :class:`NoReplicasAvailable` when the
        deadline lapses with no live replica."""
        from sparktorch_tpu_torch.obs.rpctrace import tracer_for

        tracer = tracer_for(self.telemetry)
        budget = (deadline_s if deadline_s is not None
                  else self.default_deadline_s)
        deadline = time.monotonic() + budget
        tried: set = set()
        all_overloaded_rounds = 0
        wait_s = min(0.02, self.probe_interval_s)
        self.telemetry.counter("router.requests_total")
        with tracer.root_span("infer", kind="client") as root:
            while True:
                rid = self._choose(tried)
                if rid is None:
                    # Nothing routable right now. If untried replicas
                    # may come back (monitor restart, probe pass), wait
                    # a beat and retry the FULL set inside the
                    # deadline; a request must survive the eviction
                    # window of a replica kill.
                    if time.monotonic() >= deadline:
                        if tried and all_overloaded_rounds > 0:
                            self.telemetry.counter("router.rejects_total")
                            raise Overloaded(
                                "every live replica refused admission")
                        self.telemetry.counter("router.unroutable_total")
                        raise NoReplicasAvailable(
                            f"no live replica within {budget}s")
                    self.check_health()
                    tried.clear()
                    # Refusals reset with the round: a 429 from a
                    # replica that has since DIED must not turn the
                    # deadline's verdict from 503 into 429.
                    all_overloaded_rounds = 0
                    # Doubling backoff (20ms -> 100ms cap): under
                    # SUSTAINED uniform overload each retry round costs
                    # every replica a refused admission — the backoff
                    # cuts that spam ~5x while a short-lived eviction
                    # window still gets a fast first retry. The
                    # request's own deadline stays the shed knob: a
                    # client that wants a fast tier-wide 429 passes a
                    # short deadline. The backoff is router wall.
                    with _goodput.span("exposed_comm",
                                       {"site": "router_retry"}):
                        time.sleep(wait_s)
                    wait_s = min(wait_s * 2, 0.1)
                    continue
                wait_s = min(0.02, self.probe_interval_s)
                with self._lock:
                    st = self._replicas[rid]
                    st.outstanding += 1
                remaining = max(deadline - time.monotonic(), 0.001)
                # The hop (submit, queue and the replica's wall) is this
                # process's exposed comm; the replica's own ledger
                # attributes its compute.
                with tracer.child_span("replica", root.ctx, kind="client",
                                       replica=rid) as tsp, \
                        _goodput.span("exposed_comm", {"site": "router"}):
                    try:
                        fut = st.handle.submit(x, deadline_s=remaining,
                                               trace_ctx=tsp.ctx)
                        out = fut.result(timeout=remaining + 1.0)
                        self.telemetry.counter("router.routed_total",
                                               labels={"replica": rid})
                        return out
                    except Overloaded as e:
                        # Healthy but full: not an eviction — try the
                        # others, shed only when everyone says 429.
                        tsp.set_error(e)
                        tried.add(rid)
                        all_overloaded_rounds += 1
                    except DeadlineExceeded as e:
                        # The REQUEST's own budget lapsed while queued
                        # — load, not replica death. Nothing left to
                        # retry with; surface it as-is.
                        tsp.set_error(e)
                        self.telemetry.counter(
                            "router.deadline_exceeded_total")
                        raise
                    except (ReplicaStopped, TransportError, OSError,
                            TimeoutError) as e:
                        tsp.set_error(e)
                        self.evict(rid, reason="error")
                        tried.add(rid)
                    finally:
                        with self._lock:
                            cur = self._replicas.get(rid)
                            if cur is not None:
                                cur.outstanding = max(
                                    0, cur.outstanding - 1)

    @property
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                rid: {"outstanding": st.outstanding,
                      "evicted": st.evicted,
                      "evict_reason": st.evict_reason}
                for rid, st in self._replicas.items()
            }


# ---------------------------------------------------------------------------
# The bundled tier: replicas + router + restart monitor + pullers
# ---------------------------------------------------------------------------


class InferenceTier:
    """N continuous-batching replicas behind one router, with the
    recovery loop wired: a dead replica (chaos kill, batch-loop crash)
    is rebuilt from its last served weights after the restart policy's
    backoff, re-registered, and re-admitted by the router's health
    probe — the serving twin of the param-server fleet's shard
    monitor. ``start_pullers(transport_factory)`` attaches one
    :class:`WeightPuller` per replica (the factory is called once per
    replica AND per restart — transports are connection-owning and
    must not be shared across threads).

    ``module`` serves ``params`` (a ``state_dict``; the module's own
    weights when None), loaded into it in place; the replicas share it
    until a weight update gives each its own copy. ``device``: CUDA
    unless ``"cpu"`` is asked for. ``collector`` goes to the
    :class:`Router`."""

    def __init__(self, module, params=None, model_state=None,
                 n_replicas: int = 2, mesh=None,
                 buckets=None, max_queue_rows: int = 256,
                 default_deadline_s: float = 30.0,
                 telemetry=None, heartbeat_dir: Optional[str] = None,
                 ft_policy: Optional[FtPolicy] = None, collector=None,
                 warm_input=None, restart_replicas: bool = True,
                 probe_interval_s: float = 0.1, device=None):
        from sparktorch_tpu_torch.obs import get_telemetry

        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.telemetry = telemetry or get_telemetry()
        self._mesh = mesh
        self._device = device
        self._buckets = buckets
        self._max_queue_rows = max_queue_rows
        self._default_deadline_s = default_deadline_s
        self._heartbeat_dir = heartbeat_dir
        self._warm_input = warm_input
        self.policy = ft_policy or FtPolicy()
        self.router = Router(ft_policy=self.policy,
                             heartbeat_dir=heartbeat_dir,
                             collector=collector,
                             telemetry=self.telemetry,
                             probe_interval_s=probe_interval_s,
                             default_deadline_s=default_deadline_s)
        self.replicas: Dict[str, InferenceReplica] = {}
        for i in range(n_replicas):
            self.replicas[str(i)] = self._build_replica(
                str(i), module, params, model_state)
            params = model_state = None  # loaded into the shared module
        for replica in self.replicas.values():
            self.router.register(replica)
        self.router.start()
        self._pullers: Dict[str, WeightPuller] = {}
        self._puller_factory: Optional[Callable[[], Any]] = None
        self._puller_kwargs: Dict[str, Any] = {}
        self._rng = self.policy.rng()
        self._restart_attempts: Dict[str, int] = {}
        self._restart_at: Dict[str, float] = {}
        self._rebuilding: set = set()
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        if restart_replicas:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="tier-monitor")
            self._monitor.start()

    def _build_replica(self, rid: str, module, params=None,
                       model_state=None,
                       params_version: int = 0) -> InferenceReplica:
        kwargs = {}
        if self._buckets is not None:
            kwargs["buckets"] = self._buckets
        return InferenceReplica(
            module, params, model_state=model_state,
            mesh=self._mesh, replica_id=rid, device=self._device,
            max_queue_rows=self._max_queue_rows,
            default_deadline_s=self._default_deadline_s,
            telemetry=self.telemetry,
            heartbeat_dir=self._heartbeat_dir,
            warm_input=self._warm_input,
            params_version=params_version, **kwargs,
        )

    # -- serving ------------------------------------------------------------

    def submit(self, x, deadline_s: Optional[float] = None) -> np.ndarray:
        return self.router.submit(x, deadline_s=deadline_s)

    # -- live weights -------------------------------------------------------

    def start_pullers(self, transport_factory: Callable[[], Any],
                      poll_s: float = 0.05,
                      quant: Optional[str] = None) -> None:
        """One weight puller per replica against ``transport_factory()``
        (a fresh transport per replica — they are worker-owned)."""
        self._puller_factory = transport_factory
        self._puller_kwargs = {"poll_s": poll_s, "quant": quant}
        for rid, replica in self.replicas.items():
            self._attach_puller(rid, replica)

    def _attach_puller(self, rid: str, replica: InferenceReplica) -> None:
        if self._puller_factory is None:
            return
        old = self._pullers.pop(rid, None)
        if old is not None:
            old.stop()
        self._pullers[rid] = WeightPuller(
            replica, self._puller_factory(),
            telemetry=self.telemetry, **self._puller_kwargs,
        ).start()

    # -- recovery -----------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(0.05):
            now = time.monotonic()
            for rid in list(self.replicas):
                replica = self.replicas[rid]
                if rid in self._rebuilding:
                    continue
                if replica.alive():
                    self._restart_attempts.pop(rid, None)
                    self._restart_at.pop(rid, None)
                    continue
                attempt = self._restart_attempts.get(rid, 0)
                if attempt >= self.policy.restart.max_restarts:
                    continue  # budget spent: stays evicted
                at = self._restart_at.get(rid)
                if at is None:
                    # Scheduled restart (the supervisor's discipline:
                    # a timestamp the loop checks, never an inline
                    # sleep — N deaths recover in max-of-backoffs).
                    self._restart_at[rid] = now + \
                        self.policy.restart.delay_s(attempt, self._rng)
                    continue
                if now < at:
                    continue
                self._restart_at.pop(rid, None)
                self._restart_attempts[rid] = attempt + 1
                # Rebuild in a thread PER replica: _build_replica's
                # bucket warmup runs a forward per bucket, and a serial
                # loop would recover N concurrent deaths in sum-of-
                # warmups — the max-of-backoffs discipline demands the
                # rebuilds overlap too.
                self._rebuilding.add(rid)
                threading.Thread(
                    target=self._rebuild_replica, args=(rid, replica),
                    daemon=True, name=f"tier-rebuild-{rid}",
                ).start()

    def _rebuild_replica(self, rid: str, dead: InferenceReplica) -> None:
        t0 = time.monotonic()
        try:
            # Rebuild from the dead replica's LAST SERVED module
            # (freshest weights it had); the puller then closes any
            # staleness against the param server.
            _v, module = dead._slot.read()
            fresh = self._build_replica(
                rid, module, params_version=dead.params_version)
            # Counted BEFORE the fresh replica is exposed: anything
            # that observes the recovered replica (a waiter polling
            # alive(), the bench's kill gate) must also see the
            # restart counter — the reverse order races.
            self.telemetry.counter("serve.replica_restarts_total",
                                   labels={"replica": rid})
            self.telemetry.observe("serve.replica_recovery_s",
                                   time.monotonic() - t0,
                                   labels={"replica": rid})
            self.replicas[rid] = fresh
            self.router.register(fresh)
            self._attach_puller(rid, fresh)
        except Exception:  # noqa: BLE001 - a failed rebuild retries
            # The attempt is already counted; the monitor reschedules
            # under the same backoff until the budget runs out.
            self.telemetry.counter("serve.replica_restart_failures_total",
                                   labels={"replica": rid})
        finally:
            self._rebuilding.discard(rid)

    def stop(self) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        for puller in self._pullers.values():
            puller.stop()
        self._pullers.clear()
        self.router.stop()
        for replica in self.replicas.values():
            replica.stop()
