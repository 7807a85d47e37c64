"""Continuous-batching online inference replica with live weight pulls — the port of ``sparktorch_tpu/serve/infer.py:59-712``.

:class:`~sparktorch_tpu_torch.inference.BatchPredictor` is a batch
tool: a caller hands it a matrix and waits. Online traffic is many
small requests arriving continuously, each with its own deadline:

- **Continuous batching** (:class:`InferenceReplica`): requests are
  admitted into a bounded queue and coalesced into the NEXT batch — no
  fixed windows, no timers. Batches pad up to one of a few BUCKET sizes
  (each warmed up front: the first forward of a shape builds the
  kernels and settles cuBLAS's choices), and padded rows are trimmed
  before results fan back out, so a request only ever sees its own
  rows. A full queue answers 429 (:class:`Overloaded`, counted); a
  request whose deadline lapses while queued is expired without a
  batch slot.
- **Live weight updates** (:class:`WeightPuller`): a background thread
  pulls version-tagged snapshots from a parameter server over the
  binary wire (a 304 when current) — per-tensor deltas from a fleet's
  ``/delta.bin`` when the transport has ``pull_delta``, full snapshots
  otherwise — and swaps the serving module BETWEEN batches.
- **Observability**: batch fill, queue depth, request latency and
  batch execution land on the telemetry bus under the JAX package's
  ``serve.*`` names; per-replica heartbeats give the router its
  liveness signal. One metric is the port's own:
  ``serve.weight_install_s``, the seconds of each
  :meth:`InferenceReplica.install_params` (the module's deep copy and
  the load of the new weights).

Replicas are threads of one process, as in the JAX package. Each
replica's batch loop enters ``torch.inference_mode()`` itself (the mode
is thread-local) and launches its kernels on its thread's current
stream. A replica runs on CUDA unless ``device="cpu"`` is passed.

:func:`run_replica_server` is one replica as a process of its own,
spawned as the ``replica_server`` kind of the ctl worker
(:mod:`sparktorch_tpu_torch.ctl.worker`) or run by hand.

A request's ``trace_ctx`` (:mod:`~sparktorch_tpu_torch.obs.rpctrace`,
the router's replica hop) gets two child spans from the batch loop:
``queue_wait`` (admission to the batch's pop) and ``execute`` (the
shared forward, closed after its result is read back to the host, so
it holds the card's work and not only the launch).
"""

from __future__ import annotations

import collections
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.net import wire as _wire
from sparktorch_tpu_torch.net.transport import BinaryTransport, TransportError
from sparktorch_tpu_torch.obs.telemetry import wall_ts
from sparktorch_tpu_torch.utils.locks import VersionedSlot

DEFAULT_BUCKETS = (1, 8, 32)


class Overloaded(RuntimeError):
    """Admission refused: the replica's (or router's) queue is full.
    The HTTP spelling is 429 — callers shed load or retry elsewhere."""

    status = 429


class DeadlineExceeded(RuntimeError):
    """The request's deadline lapsed before it reached a batch."""


class ReplicaStopped(RuntimeError):
    """The replica died (chaos kill, stop) with this request pending —
    the router re-routes; a direct caller retries elsewhere."""


class InferFuture:
    """Completion handle for one admitted request. ``result()`` blocks
    until the batch that carried the request lands, then returns this
    request's rows (padding already trimmed) or raises the failure."""

    __slots__ = ("_done", "_result", "_error")

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def _set_result(self, value: np.ndarray) -> None:
        self._result = value
        self._done.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("x", "n", "future", "deadline_t", "enq_ts", "enq_t0",
                 "trace_ctx")

    def __init__(self, x: np.ndarray, deadline_s: float, trace_ctx=None):
        self.x = x
        self.n = int(x.shape[0])
        self.future = InferFuture()
        self.enq_ts = wall_ts()
        self.enq_t0 = time.perf_counter()  # lint-obs: ok (request enqueue/deadline clock, not a measured region)
        self.deadline_t = self.enq_t0 + float(deadline_s)
        self.trace_ctx = trace_ctx


def state_dict_for(module: torch.nn.Module, params=None, model_state=None
                   ) -> Dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` with the entries of ``params`` and
    ``model_state`` (name → tensor or numpy array, as the wire decodes
    them) put in: a pull carries the parameters only, and the buffers
    stay the module's. A name the module does not have raises."""
    state = module.state_dict()
    for tree in (params, model_state):
        for name, value in (tree or {}).items():
            if name not in state:
                raise KeyError(f"{name!r}: no such entry in "
                               f"{type(module).__name__}'s state_dict")
            if not isinstance(value, torch.Tensor):
                # The wire's arrays are read-only views of a response
                # body. The load only reads them, so they are wrapped
                # as they are: a copy would cost a pass over the model.
                with warnings.catch_warnings():
                    warnings.filterwarnings(
                        "ignore", "The given NumPy array is not writable")
                    value = torch.from_numpy(np.asarray(value))
            state[name] = value
    return state


class InferenceReplica:
    """One serving replica: admission queue -> continuous batcher over
    a bucketed forward, with atomically swappable weights.

    ``module`` serves ``params`` (a ``state_dict``, numpy arrays or
    tensors; the module's own weights when None) with ``model_state``
    (buffers) put in. ``buckets`` are the padded batch sizes (ascending;
    the largest bounds one batch's rows). ``max_queue_rows`` bounds
    admission — beyond it, :meth:`submit` raises :class:`Overloaded`
    (the counted 429). ``heartbeat_dir`` publishes per-replica liveness
    the router's ft-policy health checks consume. The forward, device
    placement and pre/postprocessing are
    :class:`~sparktorch_tpu_torch.inference.BatchPredictor`'s — this
    class adds the online admission/coalescing/liveness layer on top.
    ``device``: CUDA unless ``"cpu"`` is asked for. ``mesh``: one of dp
    size 1 at most (a replica spanning ranks would need every rank to
    run every batch).
    """

    def __init__(self, module, params=None, model_state=None, mesh=None,
                 replica_id="0", buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_queue_rows: int = 256,
                 default_deadline_s: float = 30.0,
                 preprocess=None, postprocess=None,
                 telemetry=None, heartbeat_dir: Optional[str] = None,
                 heartbeat_interval_s: float = 0.25,
                 warm_input=None, auto_start: bool = True,
                 params_version: int = 0, device=None):
        from sparktorch_tpu_torch.inference import BatchPredictor
        from sparktorch_tpu_torch.obs import get_telemetry

        if mesh is not None and mesh.batch_shards > 1:
            raise NotImplementedError(
                "an InferenceReplica over a mesh of more than one batch shard "
                "(dp x fsdp > 1) is not ported: "
                "its ranks are processes, each would have to run every "
                "batch (ROADMAP, Queue 1, item 9)")
        self.replica_id = str(replica_id)
        self.telemetry = telemetry or get_telemetry()
        self._labels = {"replica": self.replica_id}
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.max_queue_rows = int(max_queue_rows)
        self.default_deadline_s = float(default_deadline_s)
        state = (None if params is None and model_state is None
                 else state_dict_for(module, params, model_state))
        self._bp = BatchPredictor(
            module, state, device=device, chunk=self.buckets[-1],
            preprocess=preprocess, postprocess=postprocess,
            telemetry=self.telemetry,
        )
        # The serving module, swapped BETWEEN batches: the loop reads it
        # in one slot read per batch, so a live weight update never
        # mixes new parameters with old buffers inside one forward.
        self._slot = VersionedSlot(self._bp.module)
        self.params_version = int(params_version)
        self._cond = threading.Condition()
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._queued_rows = 0
        self._admitted = 0
        self._batches = 0
        self._dead = False
        self._stopped = False
        self._hb = None
        if heartbeat_dir:
            from sparktorch_tpu_torch.obs import HeartbeatEmitter

            self._hb = HeartbeatEmitter(heartbeat_dir,
                                        rank=int(self.replica_id),
                                        telemetry=self.telemetry)
        self._hb_interval = float(heartbeat_interval_s)
        self._hb_last = 0.0
        self._thread: Optional[threading.Thread] = None
        self._warmed: set = set()
        self._warm_lock = threading.Lock()
        if warm_input is not None:
            # Warm every bucket NOW (one ``(n, *row_shape)`` sample is
            # enough), so the first real request pays for neither the
            # kernels' first use nor cuBLAS's choices.
            self._warm_for(tuple(np.asarray(warm_input).shape[1:]),
                           np.asarray(warm_input).dtype)
        if auto_start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def _forward(self, module, x: np.ndarray) -> np.ndarray:
        """The forward of ``module`` on host rows, read back to host."""
        return self._bp._fwd(self._bp._put(x), module).cpu().numpy()

    def _warm_for(self, row_shape: Tuple[int, ...], dtype) -> None:
        """Bucket warmup keyed on the observed row shape (the
        constructor cannot know it unless given ``warm_input`` —
        modules reshape): the first admission of a new shape runs every
        bucket up front — one stall, then steady state."""
        # A SET of warmed keys, not just the last one: traffic
        # alternating between two request shapes must not re-run the
        # full bucket loop in the admission path per request.
        key = (row_shape, str(dtype))
        if key in self._warmed:
            return
        with self._warm_lock:
            if key in self._warmed:
                return
            module = self._slot.read()[1]
            t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
            for b in self.buckets:
                self._forward(module, np.zeros((b, *row_shape), dtype))
            self._warmed.add(key)
            self.telemetry.observe("serve.warmup_s",
                                   time.perf_counter() - t0,  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                                   labels=self._labels)

    def start(self) -> "InferenceReplica":
        if (self._thread is not None and self._thread.is_alive()
                and (self._dead or self._stopped)):
            # A killed or stopped loop returns at its next wake-up: wait
            # for it, or this restart would leave the replica dead.
            self._thread.join(timeout=5.0)
        if self._thread is None or not self._thread.is_alive():
            self._dead = False
            self._stopped = False
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True,
                name=f"infer-replica-{self.replica_id}",
            )
            self._thread.start()
        return self

    def alive(self) -> bool:
        return (not self._dead and not self._stopped
                and self._thread is not None and self._thread.is_alive())

    def kill(self) -> None:
        """Crash the replica (the chaos path): queued requests fail
        with :class:`ReplicaStopped` (the router re-routes them — zero
        drops is the ROUTER'S contract, not a dead replica's), the
        loop thread exits, and heartbeats simply STOP — the last beat
        ages out, which is exactly the silent-death signature the
        ft barrier deadline detects."""
        with self._cond:
            self._dead = True
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._cond.notify_all()
        for req in pending:
            req.future._set_error(ReplicaStopped(
                f"replica {self.replica_id} died"))
        self.telemetry.counter("serve.replica_deaths_total",
                               labels=self._labels)

    def stop(self) -> None:
        """Graceful shutdown: queued requests fail fast, the loop
        exits, and the heartbeat closes with ``alive=False`` (a clean
        stop is distinguishable from a crash)."""
        with self._cond:
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._cond.notify_all()
        for req in pending:
            req.future._set_error(ReplicaStopped(
                f"replica {self.replica_id} stopped"))
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._hb is not None:
            self._hb.close()

    # -- weights ------------------------------------------------------------

    def install_params(self, params, model_state=None,
                       version: Optional[int] = None) -> None:
        """Swap the serving weights between batches: the predictor
        loads ``params`` (and ``model_state``) into a fresh copy of its
        module, which the batch loop picks up at its next slot read. The
        predictor's own ``predict`` serves the same weights."""
        t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
        self._bp.update_params(state_dict_for(self._bp.module, params,
                                              model_state))
        self._slot.swap(self._bp.module)
        self.telemetry.observe("serve.weight_install_s",
                               time.perf_counter() - t0,  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                               labels=self._labels)
        if version is not None:
            self.params_version = int(version)
        else:
            self.params_version += 1
        self.telemetry.counter("serve.weight_swaps_total",
                               labels=self._labels)
        self.telemetry.gauge("serve.params_version", self.params_version,
                             labels=self._labels)
        self.telemetry.gauge("serve.weight_last_update_ts", wall_ts(),
                             labels=self._labels)

    @property
    def predictor(self):
        return self._bp

    # -- admission ----------------------------------------------------------

    @property
    def queued_rows(self) -> int:
        return self._queued_rows

    def submit(self, x, deadline_s: Optional[float] = None,
               trace_ctx=None) -> InferFuture:
        """Admit one request (``x``: ``(n, *row_shape)``, n >= 1) into
        the next batch. Returns immediately with a future; raises
        :class:`Overloaded` (the counted 429) when the queue is full,
        :class:`ReplicaStopped` when the replica is down, and
        ``ValueError`` for a request bigger than the largest bucket
        (that is a batch job — use the :class:`BatchPredictor`).
        ``trace_ctx`` (the router's replica-hop context) parents this
        request's ``queue_wait`` and ``execute`` spans."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request needs a leading batch dim, "
                             f"got shape {x.shape}")
        if x.shape[0] > self.buckets[-1]:
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds the largest "
                f"bucket ({self.buckets[-1]}) — batch jobs go through "
                f"BatchPredictor"
            )
        act = _chaos.fire("serve.replica", replica=self.replica_id)
        if act and act.get("delay"):
            # Straggler replica: correct, just slow. Slept in the
            # admission path, so a traced request puts it on the
            # router's replica hop, and batch work on ``execute``.
            time.sleep(float(act["delay"]))
        if act and act.get("die"):
            self.kill()
        if self._dead or self._stopped:
            raise ReplicaStopped(f"replica {self.replica_id} is down")
        self._warm_for(tuple(x.shape[1:]), x.dtype)
        req = _Request(x, deadline_s if deadline_s is not None
                       else self.default_deadline_s, trace_ctx)
        with self._cond:
            # Re-checked UNDER the condition: kill()/stop() drain the
            # queue under this lock, so a request admitted after the
            # lock-free check above but appended after the drain would
            # otherwise be orphaned — its future never resolves.
            if self._dead or self._stopped:
                raise ReplicaStopped(
                    f"replica {self.replica_id} is down")
            if self._queued_rows + req.n > self.max_queue_rows:
                self.telemetry.counter(
                    "serve.rejected_total",
                    labels={**self._labels, "reason": "backpressure"})
                raise Overloaded(
                    f"replica {self.replica_id} queue full "
                    f"({self._queued_rows}/{self.max_queue_rows} rows)"
                )
            self._queue.append(req)
            self._queued_rows += req.n
            self._admitted += 1
            self._cond.notify()
        self.telemetry.counter("serve.requests_total", labels=self._labels)
        self.telemetry.counter("serve.rows_total", float(req.n),
                               labels=self._labels)
        return req.future

    def infer(self, x, deadline_s: Optional[float] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        return self.submit(x, deadline_s=deadline_s).result(
            timeout if timeout is not None
            else (deadline_s or self.default_deadline_s) + 5.0)

    # -- the batch loop -----------------------------------------------------

    def _beat(self, force: bool = False) -> None:
        if self._hb is None:
            return
        now = time.monotonic()
        if force or now - self._hb_last >= self._hb_interval:
            self._hb_last = now
            self._hb.notify_step(self._batches)

    def _pop_batch(self) -> List[_Request]:
        """Coalesce queued requests (FIFO, deterministic) into one
        batch up to the largest bucket. Only requests sharing the
        head's (row_shape, dtype) coalesce — a concatenate across
        mixed shapes would crash the shared batch; a mismatched head
        simply starts the NEXT batch, FIFO order preserved. Called
        under the condition."""
        batch: List[_Request] = []
        rows = 0
        key = None
        while self._queue and rows + self._queue[0].n <= self.buckets[-1]:
            head = self._queue[0]
            hkey = (head.x.shape[1:], head.x.dtype)
            if key is None:
                key = hkey
            elif hkey != key:
                break
            req = self._queue.popleft()
            self._queued_rows -= req.n
            rows += req.n
            batch.append(req)
        return batch

    def _serve_loop(self) -> None:
        # Inference mode is thread-local: the loop thread enters it.
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        from sparktorch_tpu_torch.obs.rpctrace import tracer_for

        tracer = tracer_for(self.telemetry)
        tele = self.telemetry
        while True:
            with self._cond:
                while (not self._queue and not self._dead
                       and not self._stopped):
                    self._cond.wait(timeout=self._hb_interval)
                    self._beat()  # idle liveness: beats without traffic
                if self._dead or self._stopped:
                    return
                batch = self._pop_batch()
                depth = self._queued_rows
            tele.observe("serve.queue_depth", depth, labels=self._labels)
            pop_t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)

            live: List[_Request] = []
            for req in batch:
                if pop_t0 > req.deadline_t:
                    # Expired while queued: fail it here rather than
                    # burn a batch slot computing rows nobody waits
                    # for.
                    tele.counter("serve.deadline_expired_total",
                                 labels=self._labels)
                    req.future._set_error(DeadlineExceeded(
                        f"deadline lapsed after "
                        f"{pop_t0 - req.enq_t0:.3f}s in queue"))
                else:
                    live.append(req)
            if not live:
                continue

            rows = sum(r.n for r in live)
            bucket = next(b for b in self.buckets if b >= rows)

            # ONE slot read per batch: the whole module flips at once
            # (the live-update atomicity contract).
            module = self._slot.read()[1]
            exec_ts = wall_ts()
            exec_t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
            try:
                # Pad/concat inside the guarded region: ANY failure
                # assembling or executing the batch must fail this
                # batch's futures, never kill the loop thread (a dead
                # loop orphans every queued request silently).
                xs = [r.x for r in live]
                if rows < bucket:
                    xs.append(np.zeros((bucket - rows, *xs[0].shape[1:]),
                                       xs[0].dtype))
                padded = xs[0] if len(xs) == 1 else np.concatenate(xs)
                out = self._forward(module, padded)
            except Exception as e:  # noqa: BLE001 - batch must not kill loop
                tele.counter("serve.batch_errors_total",
                             labels=self._labels)
                for req in live:
                    req.future._set_error(e)
                continue
            done_t = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
            exec_dur = done_t - exec_t0
            self._batches += 1
            self._beat(force=True)

            tele.observe("serve.batch_fill", rows / bucket,
                         labels=self._labels)
            tele.observe("serve.batch_exec_s", exec_dur,
                         labels=self._labels)
            tele.counter("serve.batches_total", labels=self._labels)
            tele.gauge("serve.last_bucket", bucket, labels=self._labels)

            offset = 0
            for req in live:
                req_out = out[offset:offset + req.n]
                offset += req.n
                if req.trace_ctx is not None and req.trace_ctx.sampled:
                    # Under the router's replica hop: where the
                    # request's time went, queued or computed.
                    tracer.record("queue_wait", req.trace_ctx,
                                  req.enq_ts, pop_t0 - req.enq_t0,
                                  kind="server", replica=self.replica_id)
                    tracer.record("execute", req.trace_ctx, exec_ts,
                                  exec_dur, kind="server",
                                  replica=self.replica_id,
                                  bucket=bucket, batch_rows=rows)
                tele.observe("serve.request_latency_s",
                             done_t - req.enq_t0, labels=self._labels)
                req.future._set_result(req_out)


# ---------------------------------------------------------------------------
# Live weight updates
# ---------------------------------------------------------------------------


class WeightPuller:
    """Background weight refresh for one replica.

    ``transport`` speaks the hogwild pull contract (either package's
    server):

    - a :class:`~sparktorch_tpu_torch.net.transport.BinaryTransport` —
      version-tagged pulls against one server; when the server also
      serves ``/delta.bin`` (a fleet's gateway, or a shard that owns the
      whole tree), per-tensor DELTA pulls are used (only the advanced
      leaves ship, int8 when ``quant='int8'``); a 404 from a server
      without the route falls back to full pulls, once, for good. A
      shard of a fleet of several serves only its hash range: point the
      transport at the gateway, or use a ShardedTransport;
    - a :class:`~sparktorch_tpu_torch.net.sharded.ShardedTransport` —
      delta scatter/gather over the fleet's shards (its ``pull`` is
      delta-based already).

    Every fresh pull installs via :meth:`InferenceReplica.install_params`;
    a changed server epoch (a rebuilt slot) clears the leaf cache and
    pulls everything again, counted on
    ``serve.weight_epoch_resyncs_total``. A pull failure counts and
    leaves the replica serving its last-good weights (staleness is the
    correct degraded mode for serving — never an outage).
    """

    def __init__(self, replica: InferenceReplica, transport,
                 poll_s: float = 0.05, quant: Optional[str] = None,
                 telemetry=None):
        self.replica = replica
        self.transport = transport
        self.poll_s = float(poll_s)
        self.quant = quant
        self.telemetry = telemetry or replica.telemetry
        self._labels = dict(replica._labels)
        self._have = -1
        self._epoch: Optional[int] = None
        self._leaves: Dict[Tuple[str, ...], object] = {}
        # None: undecided (try /delta.bin first); False: the server
        # answered 404 — full pulls from then on.
        self._use_delta: Optional[bool] = (
            None if hasattr(transport, "pull_delta") else False)
        self._buf: Optional[torch.Tensor] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WeightPuller":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"weight-puller-{self.replica.replica_id}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        close = getattr(self.transport, "close", None)
        if close is not None:
            close()

    @property
    def version(self) -> int:
        return self._have

    def poll_once(self) -> bool:
        """One pull sweep; True when fresh weights were installed."""
        t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
        try:
            if self._use_delta is not False:
                fresh = self._poll_delta()
            else:
                fresh = self._poll_full()
        finally:
            self.telemetry.observe("serve.weight_poll_s",
                                   time.perf_counter() - t0,  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                                   labels=self._labels)
        if fresh:
            self.telemetry.counter("serve.weight_updates_total",
                                   labels=self._labels)
        return fresh

    def _poll_delta(self) -> bool:
        try:
            res = self.transport.pull_delta(lambda: self._have,
                                            quant=self.quant)
        except TransportError as e:
            if self._use_delta is None and "404" in str(e):
                # A server without the delta route: full pulls for good.
                self._use_delta = False
                return self._poll_full()
            raise
        self._use_delta = True
        epoch = res.get("epoch")
        if (epoch is not None and self._epoch is not None
                and epoch != self._epoch):
            # The server's slot was rebuilt: its versions restarted, so
            # our version and leaf cache mean nothing — resync.
            self._have = -1
            self._leaves.clear()
            self.telemetry.counter("serve.weight_epoch_resyncs_total",
                                   labels=self._labels)
            res = self.transport.pull_delta(lambda: self._have,
                                            quant=self.quant)
            epoch = res.get("epoch")
        if epoch is not None:
            self._epoch = epoch
        if not res.get("fresh"):
            return False
        self._leaves.update(res["leaves"])
        self._have = int(res["version"])
        tree = _wire.unflatten_tree(list(self._leaves.items()))
        self.replica.install_params(tree, version=self._have)
        return True

    def _recv_buffer(self, nbytes: int) -> np.ndarray:
        """The buffer a full pull's body lands in, kept from pull to
        pull (pinned where a card is present), so the body's pages are
        not faulted in anew for each pull and the install's host-to-card
        copies run at the pinned rate. The pulled tree's arrays are
        views of it; the install has copied them out before the next
        pull overwrites it."""
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None  # the smaller one goes first
            self._buf = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=torch.cuda.is_available())
        return self._buf.numpy()

    def _poll_full(self) -> bool:
        if isinstance(self.transport, BinaryTransport):
            snap = self.transport.pull(self._have, into=self._recv_buffer)
        else:
            snap = self.transport.pull(self._have)
        if snap is None:
            return False
        version, tree = snap
        self._have = int(version)
        self.replica.install_params(tree, version=self._have)
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except (TransportError, _wire.WireError, OSError):
                # Stale-but-serving beats dead: count it, keep the
                # last-good weights, retry next tick.
                self.telemetry.counter("serve.weight_pull_errors_total",
                                       labels=self._labels)
            self._stop.wait(self.poll_s)


# ---------------------------------------------------------------------------
# Process entry point
# ---------------------------------------------------------------------------


def run_replica_server(torch_obj, replica_id="0",
                       server_url: Optional[str] = None,
                       seed: int = 0,
                       buckets: Sequence[int] = DEFAULT_BUCKETS,
                       max_queue_rows: int = 256,
                       pull_poll_s: float = 0.05,
                       pull_quant: Optional[str] = None,
                       heartbeat_interval_s: float = 1.0,
                       ctx=None, device=None, telemetry=None,
                       cancel: Optional[threading.Event] = None,
                       heartbeat_dir: Optional[str] = None
                       ) -> Dict[str, int]:
    """ONE inference replica as a standalone process.

    The replica initializes deterministically from ``(torch_obj,
    seed)`` (a lazily packaged module is built under ``seed``) and —
    when ``server_url`` names a parameter server — runs a
    :class:`WeightPuller`, so a live training run refreshes this
    process's weights continuously. It blocks until ``cancel`` is set;
    liveness rides a heartbeat in ``heartbeat_dir`` (step = batches
    executed). Requests enter through the in-process ``submit``.

    ``ctx`` (a :class:`~sparktorch_tpu_torch.ctl.worker.WorkerContext`,
    or anything with its attributes) supplies the bus, the cancel event
    (SIGTERM under the ctl entry) and the heartbeat, in place of
    ``telemetry``, ``cancel`` and ``heartbeat_dir``; either way the stack
    profiler is armed on the replica's bus (:func:`obs.profile.ensure`,
    gated by ``SPARKTORCH_TPU_PROFILE``).
    """
    from sparktorch_tpu_torch.obs import profile as _profile
    from sparktorch_tpu_torch.serve.param_server import build_module
    from sparktorch_tpu_torch.utils.serde import deserialize_model

    telemetry = getattr(ctx, "telemetry", None) or telemetry
    cancel = getattr(ctx, "cancel", None) or cancel
    spec = deserialize_model(torch_obj)
    replica = InferenceReplica(
        build_module(spec, seed), replica_id=replica_id, buckets=buckets,
        max_queue_rows=max_queue_rows, telemetry=telemetry, device=device,
    )
    puller = None
    if server_url:
        puller = WeightPuller(
            replica, BinaryTransport(server_url, quant=pull_quant),
            poll_s=pull_poll_s, telemetry=telemetry,
        ).start()
    _profile.ensure(replica.telemetry)
    cancel = cancel or threading.Event()
    # The ctl context's heartbeat belongs to its entry, which closes it.
    hb = getattr(ctx, "heartbeat", None)
    own_hb = None
    if hb is None and heartbeat_dir:
        from sparktorch_tpu_torch.obs import HeartbeatEmitter

        hb = own_hb = HeartbeatEmitter(heartbeat_dir, rank=int(replica_id),
                                       telemetry=replica.telemetry)
    try:
        while not cancel.wait(heartbeat_interval_s):
            if hb is not None:
                hb.notify_step(replica._batches)
    finally:
        if puller is not None:
            puller.stop()
        replica.stop()
        if own_hb is not None:
            own_hb.close()
    return {"replica_id": str(replica_id),
            "batches": int(replica._batches),
            "params_version": int(replica.params_version)}
