"""Asynchronous (hogwild) training against the parameter server — the port of ``sparktorch_tpu/train/hogwild.py``.

Reference: ``sparktorch/hogwild.py`` — HTTP helpers with one retry
(:31-62), a per-partition worker loop that pulls the state_dict, runs
forward and backward, pushes the grads and polls the early stop
(:65-142), and a ``train()`` that runs partition-shuffle rounds
and pulls the final weights (:145-186).

As in the JAX package, each worker is a thread that owns a copy of the
module on its device (worker *i* on device ``i % n_devices``: on one
card every worker shares it), holds its data shard there, pulls only
when the server's version moved, and pushes the weighted-mean gradient
of its minibatch (the reference's missing ``zero_grad`` is not
reproduced). ``push_every=k`` pushes the mean gradient of a window of
k minibatch steps, all taken on the parameters last pulled. Gradients
are computed with the module in eval mode — BatchNorm on its running
statistics, which the server never changes — as the JAX worker applies
its model without a mutable ``batch_stats``.

Transports: ``local`` (in-process; the snapshot is copied device to
device into the worker's module) or ``http``, on the binary wire
(:class:`~sparktorch_tpu_torch.net.transport.BinaryTransport`,
``quant`` None, ``bf16`` or ``int8``) or the reference's dill wire
(:class:`HttpTransport`). With ``shards=N`` the server is a fleet of N
shards (:class:`~sparktorch_tpu_torch.serve.fleet.ParamServerFleet`):
binary workers fan per-tensor delta pulls and scattered pushes over it
through a :class:`~sparktorch_tpu_torch.net.sharded.ShardedTransport`
(``pull_quant='int8'``: int8 pulls with the server's error feedback),
and dill workers go through its gateway.

Minibatch offsets come from a host ``torch.Generator`` seeded per worker
and round (the JAX worker draws them from a ``jax.random`` key), so the
two packages agree step for step only on full batches.

:func:`run_hogwild_worker` is one worker as a process of its own (a
Spark executor, or any process given the server's URL).

Telemetry and chaos, as in the JAX package: the driver, the server and
every worker record into one bus (``telemetry``, default the
process-global one): the ``hogwild/data_prep`` span; per worker the
``hogwild.iters`` and ``hogwild.pushes`` counters and the
``hogwild.pulled_version`` gauge, labelled by worker, bumped once per
push window (never per launch), and each round's ``hogwild.<phase>``
histograms; per round ``hogwild.round_s`` and ``hogwild.rounds``; the
server's ``param_server.*`` names. Each grad window is a ``train_step``
range (``profile_dir`` captures a ``torch.profiler`` trace of the
rounds). The chaos sites ``worker.step``, ``data.batch`` and
``train.rank`` fire before each window's pull.

``supervise=True`` (or an ``ft_policy``) runs each round's workers
under the ft :class:`~sparktorch_tpu_torch.ft.supervisor.Supervisor`:
a dead worker restarts under the policy's backoff and budget and
rejoins by pulling the current server version, and a cancelled one
(a straggler or stall preemption) stops at its next window with
:class:`~sparktorch_tpu_torch.ft.supervisor.WorkerPreempted`. A killed
attempt flushes no records, so the rerun keeps the count exact.

Goodput and model health, as in the JAX package: each worker's pull is
``exposed_comm{site=hogwild_pull}``, the pulled parameters' load into
its module ``data_wait{site=hogwild_place}``, a window a goodput step
span of ``count=k`` steps (it stamps the skew ring), its push split by
the transport's own stats into ``compute`` (materializing the
gradients, which waits for the window's device work) and
``exposed_comm`` (the wire), and the end-of-round drain of the losses
``compute``. Each worker owns a
:class:`~sparktorch_tpu_torch.obs.health.TrainHealthLedger` of rank
``w<id>`` on the shared bus (so the ``health`` section is the composite
``{"ranks": ...}``), fed each window's device losses, read back
``fetch_lag`` windows late; ``SPARKTORCH_TPU_HEALTH=0`` turns it off.
The supervised and process workers run the same loop.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

import dill
import numpy as np
import torch

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.inference import _resolve_device
from sparktorch_tpu_torch.models.transformer import collect_moe
from sparktorch_tpu_torch.obs import get_logger, get_telemetry
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs import health as _health
from sparktorch_tpu_torch.net.transport import (
    BinaryTransport,
    new_phase_stats,
    tree_to_host,
)
from sparktorch_tpu_torch.serve.param_server import (
    ParameterServer,
    ParamServerHttp,
    as_tensor,
    build_module,
)
from sparktorch_tpu_torch.train.step import forward
from sparktorch_tpu_torch.train.sync import TrainResult
from sparktorch_tpu_torch.utils.data import (
    DataBatch,
    handle_features,
    sample_minibatch,
)
from sparktorch_tpu_torch.utils.serde import (
    ModelSpec,
    deserialize_model,
    meta_copy,
)
from sparktorch_tpu_torch.utils.tracing import profile_run, step_annotation

log = get_logger("sparktorch_tpu_torch.train.hogwild")

_HTTP_TIMEOUT = 10.0  # hogwild.py:34-38 parity (10 s timeout, 1 retry)
_HTTP_PULL_TIMEOUT = 180.0

# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class LocalTransport:
    """Direct in-process access to the server object."""

    def __init__(self, server: ParameterServer):
        self.server = server
        self.stats = new_phase_stats()

    def pull(self, have_version: int):
        t0 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        snap = self.server.get_parameters(have_version)
        st = self.stats
        st["pull_s"] += time.perf_counter() - t0  # lint-obs: ok (phase stats pair)
        st["pulls"] += 1
        st["pull_fresh"] += snap is not None
        return snap

    def push(self, grads) -> None:
        t0 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        self.server.push_gradients(grads)
        self.stats["push_wire_s"] += time.perf_counter() - t0  # lint-obs: ok (phase stats pair)
        self.stats["pushes"] += 1

    def post_loss(self, loss: float) -> bool:
        t0 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        out = self.server.post_loss(loss)
        self.stats["poll_s"] += time.perf_counter() - t0  # lint-obs: ok (phase stats pair)
        return out

    def alive(self) -> bool:
        return True


class HttpTransport:
    """The reference's wire (hogwild.py:31-62): dill over HTTP, one
    retry and a 10 s timeout per call. Pushes go as bfloat16 tensors
    unless ``compress=False``; the server casts them back up."""

    def __init__(self, url: str, compress: bool = True):
        self.url = url.rstrip("/")
        self.compress = compress
        self.stats = new_phase_stats()

    def _request(self, req, timeout: float = _HTTP_TIMEOUT,
                 retry_on_timeout: bool = False):
        """One retry; a timeout is retried only for the pull, since a
        timed-out POST may have been applied."""
        retriable: tuple = (urllib.error.URLError, ConnectionError)
        if retry_on_timeout:
            retriable = retriable + (TimeoutError,)
        try:
            return urllib.request.urlopen(req, timeout=timeout)  # lint-obs: ok (dill data wire)
        except retriable:
            return urllib.request.urlopen(req, timeout=timeout)  # lint-obs: ok (dill data wire)

    def pull(self, have_version: int):
        st = self.stats
        t0 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        req = urllib.request.Request(
            self.url + "/parameters",
            headers={"X-Have-Version": str(have_version)})
        with self._request(req, timeout=_HTTP_PULL_TIMEOUT,
                           retry_on_timeout=True) as resp:
            body = resp.read() if resp.status != 204 else None
        st["pull_s"] += time.perf_counter() - t0  # lint-obs: ok (phase stats pair)
        st["pulls"] += 1
        if body is None:
            return None
        st["pull_fresh"] += 1
        st["pull_bytes"] += len(body)
        return dill.loads(body)

    def push(self, grads) -> None:
        st = self.stats
        t0 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        if self.compress:
            grads = {k: (v.to(torch.bfloat16) if v.is_floating_point()
                         else v) for k, v in grads.items()}
        payload = dill.dumps(tree_to_host(grads))
        t1 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        st["push_materialize_s"] += t1 - t0
        req = urllib.request.Request(self.url + "/update", data=payload,
                                     method="POST")
        with self._request(req) as resp:
            if resp.status != 200:
                raise RuntimeError(f"/update failed: {resp.status}")
        st["push_wire_s"] += time.perf_counter() - t1  # lint-obs: ok (phase stats pair)
        st["push_bytes"] += len(payload)
        st["pushes"] += 1

    def post_loss(self, loss: float) -> bool:
        t0 = time.perf_counter()  # lint-obs: ok (phase stats pair)
        req = urllib.request.Request(self.url + "/losses",
                                     data=dill.dumps(float(loss)),
                                     method="POST")
        with self._request(req) as resp:
            out = bool(dill.loads(resp.read())["stop"])
        self.stats["poll_s"] += time.perf_counter() - t0  # lint-obs: ok (phase stats pair)
        return out

    def alive(self) -> bool:
        req = urllib.request.Request(self.url + "/")
        with self._request(req) as resp:
            return resp.status == 200


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def make_grad_window(loss_fn: Callable, mini_batch: Optional[int], k: int):
    """``grad_window(module, shard, generator) -> (grads, losses)``: k
    minibatch gradient steps (each a contiguous block at a random
    offset when ``mini_batch`` is below the shard size) on the same
    parameters, the mean of their weighted-mean gradients, and the k
    losses. Each loss holds an MoE model's load-balance loss, and the
    batch's weights mask its weight-0 rows out of routing. The grads are
    new tensors the worker never touches again, so they may sit in the
    server's queue."""

    def grad_window(module, shard: DataBatch, generator):
        module.zero_grad(set_to_none=True)
        losses = []
        for _ in range(k):
            batch = shard
            if mini_batch and 0 < mini_batch < shard.size:
                batch = sample_minibatch(shard, generator, mini_batch)
            with collect_moe() as moe:
                preds = forward(module, batch.x, batch.w)
            per = loss_fn(preds, batch.y)
            loss = (per * batch.w).sum() / batch.w.sum().clamp_min(1.0)
            aux = moe.aux_total()  # MoE load balance, as the sync step
            if aux is not None:
                loss = loss + aux.to(loss.dtype)
            loss.backward()  # accumulates into .grad
            losses.append(loss.detach())
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in module.named_parameters()}
        if k > 1:
            torch._foreach_div_(list(grads.values()), float(k))
        return grads, torch.stack(losses)

    return grad_window


def make_grad_step(loss_fn: Callable, mini_batch: Optional[int] = None):
    """The gradient of one minibatch: a window of one step."""
    return make_grad_window(loss_fn, mini_batch, 1)


def make_grad_windows(loss_fn: Callable, mini_batch: Optional[int],
                      push_every: int, iters: int):
    """``(full_window, tail_window)`` for ``push_every=k``: the tail
    covers ``iters % k`` when k does not divide ``iters``. None when
    ``push_every <= 1``."""
    if not push_every or push_every <= 1:
        return None
    rem = iters % push_every
    window = make_grad_window(loss_fn, mini_batch, push_every)
    return window, (make_grad_window(loss_fn, mini_batch, rem) if rem
                    else window)


def make_eval_loss(loss_fn: Callable):
    """The weighted loss of a whole batch, no gradients — the
    validation probe for early stopping."""

    @torch.no_grad()
    def eval_loss(module, batch: DataBatch) -> torch.Tensor:
        per = loss_fn(module(batch.x), batch.y)
        return (per * batch.w).sum() / batch.w.sum().clamp_min(1.0)

    return eval_loss


def load_params(module: torch.nn.Module, params: Dict[str, Any]) -> None:
    """Copy a pulled snapshot into the worker's module (never alias
    it): one fused copy from device tensors, per-tensor uploads from
    host arrays."""
    own = dict(module.named_parameters())
    with torch.no_grad():
        dst = [own[n] for n in params]
        src = [as_tensor(v, own[n]) for n, v in params.items()]
        torch._foreach_copy_(dst, src)


_PHASE_HISTOGRAMS = ("pull_s", "pull_place_s", "dispatch_s",
                     "push_materialize_s", "push_wire_s", "poll_s",
                     "drain_s", "loop_s")


def _worker_loop(worker_id: int, transport, module: torch.nn.Module,
                 grad_step, shard: DataBatch,
                 val_shard: Optional[DataBatch], iters: int, verbose: int,
                 early_stop: bool, seed: int, records: List[dict],
                 errors: List[BaseException], push_every: int = 1,
                 eval_loss=None, grad_windows=None,
                 phase_out: Optional[List[dict]] = None, telemetry=None,
                 phase_histograms: bool = True, cancel=None):
    """One worker's round: pull → gradient (or a window of them) →
    push, ``iters`` times. Losses stay on the device until the round
    ends, unless ``verbose`` or the early stop needs one now. The
    worker's counters go to ``telemetry`` (default: the process-global
    bus) once per window; with ``phase_out`` and ``phase_histograms``
    its round's phase seconds are mirrored there too.

    ``cancel`` (an object with ``is_set()``, the supervisor's kill
    event) is polled between windows: once set, the worker stops with
    :class:`~sparktorch_tpu_torch.ft.supervisor.WorkerPreempted` and
    flushes no records."""
    tele = telemetry or get_telemetry()
    labels = {"worker": worker_id}
    dev = shard.x.device
    # One health ledger per worker on the shared bus: a NaN on one
    # worker surfaces as that worker's, never fleet-averaged.
    hl = (_health.TrainHealthLedger(rank=f"w{worker_id}", telemetry=tele)
          if _health.enabled() else None)
    try:
        transport.stats = new_phase_stats()  # per-round budget
        generator = torch.Generator().manual_seed(seed + worker_id)
        have_version = -1
        pending: list = []
        window_k = push_every if push_every and push_every > 1 else 1
        it = 0
        t_place = t_dispatch = 0.0
        t_loop0 = time.perf_counter()  # lint-obs: ok (loop-wall clock for the phase budget)
        while it < iters:
            if cancel is not None and cancel.is_set():
                from sparktorch_tpu_torch.ft.supervisor import WorkerPreempted

                raise WorkerPreempted(
                    f"worker {worker_id} preempted at iter {it}")
            # The chaos sites, before the pull (this loop's fence): a
            # seeded kill lands in ``errors`` like any real failure.
            _chaos.fire("worker.step", worker=worker_id, step=it)
            act = _chaos.fire("data.batch", worker=worker_id, step=it)
            if act and act.get("poison"):
                shard = _chaos.poison_batch(shard)
            _chaos.straggle(worker_id, it)
            # Wire waits are exposed comm (nothing overlaps them in this
            # loop); loading the pulled parameters is a data wait.
            with _goodput.span("exposed_comm", {"site": "hogwild_pull"}):
                snap = transport.pull(have_version)
            if snap is not None:
                have_version, params = snap
                with _goodput.span("data_wait",
                                   {"site": "hogwild_place"}) as place:
                    load_params(module, params)
                t_place += place.duration_s
            k = min(window_k, iters - it)
            # The window is dispatched asynchronously: the step span
            # counts its steps and the dispatch wall; the device seconds
            # land in compute at the push's materialize and the drain.
            with _goodput.step_span(step=it) as led:
                with step_annotation(it, telemetry=tele, device=dev):
                    if window_k > 1 and grad_windows is not None:
                        fn = (grad_windows[0] if k == window_k
                              else grad_windows[1])
                        grads, losses = fn(module, shard, generator)
                    else:
                        k = 1
                        grads, losses = grad_step(module, shard, generator)
                led.count = k
            t_dispatch += led.duration_s
            pre = (dict(transport.stats) if _goodput.active() is not None
                   else None)
            transport.push(grads)
            if pre is not None:
                # The push by the transport's own stats: materializing
                # the gradients waits for the window's device work
                # (compute), the rest is the wire (exposed comm).
                post = transport.stats
                _goodput.add("compute", post["push_materialize_s"]
                             - pre["push_materialize_s"])
                _goodput.add("exposed_comm",
                             post["push_wire_s"] - pre["push_wire_s"])
            tele.counter("hogwild.iters", k, labels=labels)
            tele.counter("hogwild.pushes", labels=labels)
            tele.gauge("hogwild.pulled_version", have_version, labels=labels)
            pending.append((it, k, have_version, losses, time.perf_counter()))  # lint-obs: ok (throughput timestamp)
            if hl is not None:
                hl.note_step(step=it, count=k, device={"loss": losses})
            it += k
            if verbose:
                log.info(f"[sparktorch_tpu_torch:hogwild] worker {worker_id} "
                         f"iter {it - 1} loss {float(losses[-1]):.6f} "
                         f"v{have_version}")
            if early_stop:
                signal = (eval_loss(module, val_shard)
                          if eval_loss is not None and val_shard is not None
                          else losses[-1])
                if transport.post_loss(float(signal)):
                    break
        t_drain0 = time.perf_counter()  # lint-obs: ok (phase stats pair, ledger-fed below)
        done = []
        for start, k, version, losses, ts in pending:
            for j, value in enumerate(losses.cpu().tolist()):  # lint-obs: ok (the end-of-loop drain: its seconds feed the ledger as compute below)
                done.append({"worker": worker_id, "iter": start + j,
                             "loss": value, "version": version, "t": ts})
        if done:
            # When the last loss reached the host: the end of the
            # worker's compute, for throughput.
            done[-1]["t_done"] = time.perf_counter()  # lint-obs: ok (throughput timestamp)
        records.extend(done)
        # The drain is where the windows' device compute lands.
        _goodput.add("compute", time.perf_counter() - t_drain0)  # lint-obs: ok (phase stats pair, feeds the ledger)
        if hl is not None:
            hl.flush()
        if phase_out is not None:
            st = dict(transport.stats)
            st.update(worker=worker_id, pull_place_s=t_place,
                      dispatch_s=t_dispatch,
                      drain_s=time.perf_counter() - t_drain0,  # lint-obs: ok (phase stats pair)
                      loop_s=time.perf_counter() - t_loop0, iters=it)  # lint-obs: ok (phase stats pair)
            phase_out.append(st)
            if phase_histograms:
                # The round's phase budget on the bus, beside the
                # counters bumped in the loop.
                for phase in _PHASE_HISTOGRAMS:
                    if st.get(phase):
                        tele.observe(f"hogwild.{phase}", float(st[phase]),
                                     labels=labels)
    except BaseException as e:  # raised again by train_async
        errors.append(e)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


_BUDGET_PHASES = ("pull_s", "pull_place_s", "dispatch_s",
                  "push_materialize_s", "push_wire_s", "poll_s", "drain_s")


def _budget(phase_stats: List[dict]) -> dict:
    """Per-phase seconds summed over the workers; ``other_s`` is loop
    bookkeeping no phase claims."""
    keys = _BUDGET_PHASES + ("loop_s", "pull_bytes", "push_bytes", "pulls",
                             "pushes", "pull_fresh")
    tot = {k: float(sum(d.get(k, 0) for d in phase_stats)) for k in keys}
    tot["other_s"] = tot["loop_s"] - sum(tot[k] for k in _BUDGET_PHASES)
    return tot


def _run_supervised_round(worker_args, round_idx: int, ft_policy, tele,
                          push_every: int, eval_loss, grad_windows,
                          phase_stats: List[dict]) -> dict:
    """One round's workers as supervised threads; returns the
    supervisor's summary and raises ``WorkerFailed`` past the budget."""
    from sparktorch_tpu_torch.ft.supervisor import Supervisor, ThreadWorker

    sup = Supervisor(policy=ft_policy, telemetry=tele,
                     name=f"hogwild_round{round_idx}")

    def make_start(args):
        def target(cancel):
            # A fresh error list per attempt: raising its failure hands
            # it to the handle; ``cancel`` is the handle's kill event.
            attempt_errors: List[BaseException] = []
            _worker_loop(*args, attempt_errors, push_every, eval_loss,
                         grad_windows, phase_stats, tele, cancel=cancel)
            if attempt_errors:
                raise attempt_errors[0]

        return lambda attempt: ThreadWorker(f"w{args[0]}", target,
                                            pass_cancel=True)

    for args in worker_args:
        sup.add(str(args[0]), make_start(args), rank=args[0])
    return sup.run()


def final_result(server: ParameterServer, spec: ModelSpec,
                 template: torch.nn.Module):
    """``(spec, state_dict)`` once the server's pending applies are
    done: its parameters and model state on the CPU in ``template``'s
    order, and the spec with an eager module made weight-free."""
    params, model_state = server.final_state()
    state = {**params, **model_state}
    state = {k: state[k].detach().cpu() for k in template.state_dict()}  # lint-obs: ok (end-of-run)
    if spec.module is not None:
        spec = dataclasses.replace(spec, module=meta_copy(template))
    return spec, state


def train_async(
    torch_obj,
    data: Any,
    labels: Optional[np.ndarray] = None,
    mesh=None,
    iters: int = 10,
    partition_shuffles: int = 1,
    verbose: int = 0,
    mini_batch: Optional[int] = None,
    validation_pct: float = 0.0,
    early_stop_patience: int = -1,
    acquire_lock: bool = True,
    port: int = 0,
    partitions: int = -1,
    seed: int = 0,
    transport: str = "local",
    push_every: int = 1,
    compress: bool = True,
    wire: str = "binary",
    quant: Optional[str] = None,
    shards: int = 1,
    pull_quant: Optional[str] = None,
    telemetry=None,
    profile_dir: Optional[str] = None,
    supervise: bool = False,
    ft_policy=None,
    device=None,
) -> TrainResult:
    """Asynchronous parameter-server training (``hogwild.train``,
    hogwild.py:145-186): start the server on ``device`` (CUDA unless
    the caller asks for the CPU), run ``partition_shuffles`` rounds of
    ``partitions`` worker threads (default: one per device), return
    the server's final parameters with the model state, and stop the
    server, on failure too.

    Every round shuffles the rows, round 0 included, then splits them
    over the workers (``np.array_split``), as the JAX package does.
    ``push_every=k`` pushes once per k-step window; pulls and the
    early-stop vote then happen once per window, so
    ``early_stop_patience`` counts windows. ``wire`` picks the HTTP
    wire (``binary`` or ``dill``); binary pushes are bfloat16 unless
    ``quant`` says ``int8`` or ``compress=False`` ships float32.
    ``mesh`` is accepted for the JAX signature and unused. The server
    and the workers record into ``telemetry`` (default: the
    process-global bus), so one ``/metrics`` scrape or JSONL dump tells
    the whole run; ``profile_dir`` captures a ``torch.profiler`` trace of
    the worker rounds there.

    ``shards=N`` (with ``transport='http'``) replaces the single server
    with an N-shard fleet on ``device``: the parameters consistent-hashed
    over N shard servers, binary workers on a ``ShardedTransport``
    (``pull_quant='int8'`` for int8 delta pulls), dill workers through
    the fleet's gateway. The summary's ``fleet`` holds the shard count,
    the ring version and this run's shard restarts. A fleet runs the
    optimizer per leaf; see :mod:`~sparktorch_tpu_torch.serve.fleet`.

    ``supervise=True`` (or any ``ft_policy``) runs each round's workers
    as :class:`~sparktorch_tpu_torch.ft.supervisor.ThreadWorker` handles
    under a :class:`~sparktorch_tpu_torch.ft.supervisor.Supervisor`: a
    dead worker restarts under the policy and rejoins by pulling the
    current server version; a killed attempt flushes no records, so the
    rerun of the round's assignment keeps the record count exact.
    Recovery shows as ``ft_restarts_total{worker=}`` and
    ``ft_recovery_latency_s`` on the bus and as the summary's ``ft``
    (each round's supervisor summary and ``restarts_total``).
    """
    if ft_policy is not None:
        supervise = True
    if shards and shards > 1 and transport != "http":
        raise ValueError("shards>1 requires transport='http' (the fleet "
                         "is an HTTP tier; local workers need no fleet)")
    if transport not in ("local", "http"):
        raise ValueError(f"unknown transport {transport!r}; use 'local' "
                         "or 'http'")
    if transport == "http" and wire not in ("binary", "dill"):
        raise ValueError(f"unknown wire {wire!r}; use 'binary' or 'dill'")
    dev = _resolve_device(device)
    tele = telemetry or get_telemetry()
    spec = deserialize_model(torch_obj)
    with tele.span("hogwild/data_prep"):
        train_batch, val_batch = handle_features(data, labels,
                                                 validation_pct, seed)
    if spec.input_shape is None:
        spec.input_shape = tuple(train_batch.x.shape[1:])
    devices = ([dev] if dev.type != "cuda" else
               [torch.device("cuda", j)
                for j in range(torch.cuda.device_count())])
    n_workers = partitions if partitions and partitions > 0 else len(devices)

    def restarts_total() -> float:
        return sum(v for k, v in tele.snapshot().get("counters", {}).items()
                   if k.startswith("fleet.shard_restarts_total"))

    # The server records into the run's bus too: pulls, pushes and
    # applies beside the workers' iterations.
    fleet = None
    if shards and shards > 1:
        from sparktorch_tpu_torch.serve.fleet import ParamServerFleet

        # A shared bus's counters span runs: this run's restarts are
        # counted from here.
        restarts_baseline = restarts_total()
        server = fleet = ParamServerFleet(
            spec, n_shards=shards, window_len=n_workers,
            early_stop_patience=early_stop_patience, seed=seed,
            telemetry=tele, device=dev)
    else:
        server = ParameterServer(spec, window_len=n_workers,
                                 early_stop_patience=early_stop_patience,
                                 acquire_lock=acquire_lock, device=dev,
                                 seed=seed, telemetry=tele)
    http: Optional[ParamServerHttp] = None
    transports: List[Any] = []
    profiler = None
    try:
        push_quant = quant if quant else ("bf16" if compress else None)
        if fleet is not None:
            from sparktorch_tpu_torch.net.sharded import ShardedTransport

            fleet.start(port=port)
            if wire == "dill":
                # Legacy workers train through the fleet's gateway.
                transports = [HttpTransport(fleet.gateway_url,
                                            compress=compress)
                              for _ in range(n_workers)]
            else:
                grace_s = float(getattr(ft_policy, "rejoin_grace_s", 30.0)
                                or 30.0)
                transports = [ShardedTransport(fleet, quant=push_quant,
                                               pull_quant=pull_quant,
                                               grace_s=grace_s,
                                               telemetry=tele,
                                               run_id=tele.run_id)
                              for _ in range(n_workers)]
            if not transports[0].alive():
                raise RuntimeError("parameter-server fleet is down")
        elif transport == "http":
            http = ParamServerHttp(server, port=port).start()
            if wire == "dill":
                transports = [HttpTransport(http.url, compress=compress)
                              for _ in range(n_workers)]
            else:
                # The run's tag rides every frame: a worker aimed at
                # another run's server is counted, never silent.
                transports = [BinaryTransport(http.url, quant=push_quant,
                                              telemetry=tele,
                                              run_id=tele.run_id)
                              for _ in range(n_workers)]
            if not transports[0].alive():  # torch_distributed.py:326
                raise RuntimeError(f"parameter server at {http.url} is down")
        else:
            transports = [LocalTransport(server) for _ in range(n_workers)]

        loss_fn = spec.loss_fn()
        grad_step = make_grad_step(loss_fn, mini_batch)
        grad_windows = make_grad_windows(loss_fn, mini_batch, push_every,
                                         iters)
        eval_loss = make_eval_loss(loss_fn) if val_batch is not None else None
        # The server's twin (the same module, or the same class built
        # under the same seed): its buffers are the server's model state.
        template = build_module(spec, seed)
        worker_devices = [devices[i % len(devices)] for i in range(n_workers)]
        modules = [copy.deepcopy(template).to(d).eval()
                   for d in worker_devices]
        val_shards = [val_batch.to(d) if val_batch is not None else None
                      for d in worker_devices]
        early_stop = early_stop_patience is not None and early_stop_patience > 0

        records: List[dict] = []
        errors: List[BaseException] = []
        phase_stats: List[dict] = []
        ft_summaries: List[dict] = []
        # The worker threads each attribute into the ambient goodput
        # ledger: each is a lane, so its budget is lanes x wall.
        ambient = _goodput.active()
        if ambient is not None:
            ambient.lanes = max(ambient.lanes, n_workers)
        x, y, w = (a.numpy() for a in train_batch)  # lint-obs: ok (host tensors from handle_features, no device involved)
        shuffle_rng = np.random.default_rng(seed + 1)
        # Exited in the outer finally, so a failed round still writes
        # its trace.
        profiler = profile_run(profile_dir, telemetry=tele)
        profiler.__enter__()
        for round_idx in range(max(1, partition_shuffles)):
            # Every round shuffles, round 0 included (the reference's
            # _fit always repartitions, torch_distributed.py:288-289): a
            # label-sorted input must not become single-class workers.
            perm = shuffle_rng.permutation(x.shape[0])
            x, y, w = x[perm], y[perm], w[perm]  # hogwild.py:161-177
            parts = zip(np.array_split(x, n_workers),
                        np.array_split(y, n_workers),
                        np.array_split(w, n_workers))
            t_round0 = time.perf_counter()  # lint-obs: ok (round-wall clock)
            worker_args = []
            for i, (xs, ys, ws) in enumerate(parts):
                shard = DataBatch(torch.from_numpy(xs), torch.from_numpy(ys),
                                  torch.from_numpy(ws)).to(worker_devices[i])
                worker_args.append(
                    (i, transports[i], modules[i], grad_step, shard,
                     val_shards[i], iters, verbose, early_stop,
                     seed + round_idx * n_workers, records))
            if supervise:
                ft_summaries.append(_run_supervised_round(
                    worker_args, round_idx, ft_policy, tele, push_every,
                    eval_loss, grad_windows, phase_stats))
            else:
                threads = []
                for args in worker_args:
                    t = threading.Thread(
                        target=_worker_loop,
                        args=(*args, errors, push_every, eval_loss,
                              grad_windows, phase_stats, tele),
                        daemon=True)
                    threads.append(t)
                    t.start()
                for t in threads:
                    t.join()
            tele.observe("hogwild.round_s", time.perf_counter() - t_round0)  # lint-obs: ok (round-wall pair)
            tele.counter("hogwild.rounds")
            if errors:
                raise RuntimeError("hogwild worker failed") from errors[0]
            if server.should_stop:
                break

        spec, state = final_result(server, spec, template)
        summary = None
        if phase_stats:
            summary = {"hogwild_phases": phase_stats,
                       "hogwild_budget": _budget(phase_stats),
                       "server_applied": server.applied_updates,
                       "server_apply_s": server.apply_s}
        if fleet is not None:
            summary = dict(summary or {})
            summary["fleet"] = {
                "shards": len(fleet.urls()),
                "ring_version": fleet.ring_version,
                "shard_restarts": int(restarts_total() - restarts_baseline),
            }
        if ft_summaries:
            summary = dict(summary or {})
            summary["ft"] = {
                "rounds": ft_summaries,
                "restarts_total": sum(sum(r.get("restarts", {}).values())
                                      for r in ft_summaries),
            }
        return TrainResult(params=state, metrics=records, spec=spec,
                           summary=summary)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        for t in transports:
            close = getattr(t, "close", None)
            if close is not None:
                close()
        if http is not None:
            http.stop()
        server.stop()


# ---------------------------------------------------------------------------
# Process entry point
# ---------------------------------------------------------------------------


def run_hogwild_worker(torch_obj, url: str, data, labels=None,
                       iters: int = 10, mini_batch: Optional[int] = None,
                       push_every: int = 1, seed: int = 0,
                       worker_id: int = 0, wire: str = "binary",
                       quant: Optional[str] = None, compress: bool = True,
                       records_path: Optional[str] = None, ctx=None,
                       device=None, validation_pct: float = 0.0,
                       verbose: int = 0, early_stop: bool = False,
                       model_seed: Optional[int] = None) -> dict:
    """ONE hogwild worker in its own process: pull/push against the
    parameter server at ``url`` on ``device`` (CUDA unless the caller
    asks for the CPU), with its own interpreter and device context.

    ``data`` is the worker's shard: arrays, an ``(x, y)`` tuple, or the
    path of an ``.npz`` holding ``x`` and ``y``; ``validation_pct`` of
    it is held out (split under ``seed``) for the early stop. Its model
    state (buffers) is the spec's module built under ``model_seed``
    (default ``seed``); its parameters come with each pull. ``wire``
    and ``quant`` as in :func:`train_async`. The step records are
    written to ``records_path`` at completion as JSON lines, atomically
    (a temporary file, then ``os.replace``): a killed attempt publishes
    nothing, so a supervisor-restarted rerun keeps counts exact. The
    worker records into ``ctx.telemetry`` (default: the process-global
    bus); ``ctx.cancel`` preempts it between windows
    (:class:`~sparktorch_tpu_torch.ft.supervisor.WorkerPreempted`), and
    ``ctx.heartbeat`` carries its iteration count for the skew and stall
    policies and the ``ctl.process`` chaos site. This is the
    ``hogwild_worker`` kind of the ctl worker
    (:mod:`sparktorch_tpu_torch.ctl.worker`).

    Returns the worker's summary: its losses and pulled versions, the
    examples it trained on, its pushes and its loop's seconds."""
    tele = getattr(ctx, "telemetry", None) or get_telemetry()
    cancel = getattr(ctx, "cancel", None)
    hb = getattr(ctx, "heartbeat", None)
    if hb is not None:
        # The loop polls cancel once per window: publish the worker's
        # iteration count on the heartbeat there. The real event is
        # bound under its own name before ``cancel`` is rebound.
        inner_cancel = cancel
        iters_key = f"hogwild.iters{{worker={worker_id}}}"

        class _HbCancel:
            def is_set(self) -> bool:
                hb.notify_step(int(tele.snapshot().get("counters", {})
                                   .get(iters_key, 0)))
                return (inner_cancel.is_set()
                        if inner_cancel is not None else False)

        cancel = _HbCancel()
    if wire not in ("binary", "dill"):
        raise ValueError(f"unknown wire {wire!r}; use 'binary' or 'dill'")
    if isinstance(data, str):
        loaded = np.load(data)
        x, y = loaded["x"], loaded["y"]
    elif isinstance(data, tuple) and labels is None:
        x, y = data
    else:
        x, y = data, labels
    dev = _resolve_device(device)
    spec = deserialize_model(torch_obj)
    if spec.input_shape is None:
        spec.input_shape = tuple(np.asarray(x).shape[1:])
    module = build_module(spec, seed if model_seed is None
                          else model_seed).to(dev).eval()
    loss_fn = spec.loss_fn()
    shard, val_shard = handle_features(x, y, validation_pct, seed=seed)
    if wire == "binary":
        transport = BinaryTransport(
            url, quant=quant if quant else ("bf16" if compress else None),
            telemetry=tele)
    else:
        transport = HttpTransport(url, compress=compress)
    records: List[dict] = []
    errors: List[BaseException] = []
    phases: List[dict] = []
    try:
        if not transport.alive():  # GET / (hogwild.py:60-62)
            raise RuntimeError(f"parameter server at {url} is down")
        _worker_loop(worker_id, transport, module,
                     make_grad_step(loss_fn, mini_batch), shard.to(dev),
                     val_shard.to(dev) if val_shard is not None else None,
                     iters, verbose, early_stop, seed, records, errors,
                     push_every,
                     make_eval_loss(loss_fn) if val_shard is not None
                     else None,
                     make_grad_windows(loss_fn, mini_batch, push_every,
                                       iters),
                     phases, tele, phase_histograms=False, cancel=cancel)
    finally:
        close = getattr(transport, "close", None)
        if close is not None:
            close()
    if errors:
        raise errors[0]
    if records_path:
        fd, tmp = tempfile.mkstemp(prefix=".hogwild_records.",
                                   suffix=".jsonl",
                                   dir=os.path.dirname(records_path) or ".")
        with os.fdopen(fd, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
        os.replace(tmp, records_path)
    return {"worker_id": worker_id, "iters": iters, "records": len(records),
            "final_loss": records[-1]["loss"] if records else None,
            "losses": [r["loss"] for r in records],
            "versions": [r["version"] for r in records],
            "examples": len(records) * (mini_batch or shard.size),
            "pushes": int(phases[0]["pushes"]),
            "loop_s": phases[0]["loop_s"]}
