"""The process-worker entry: ``python -m sparktorch_tpu_torch.ctl.worker`` — a copy of ``sparktorch_tpu/ctl/worker.py``.

One executable shape for every process-level worker the control plane
spawns: fleet shard servers, inference replicas, hogwild workers and
dill-shipped callables. The parent writes a dill payload file; this
entry

1. installs a SIGTERM handler that sets the **cancel event** (the
   supervisor's ``kill()`` sends SIGTERM first; SIGKILL lands only
   after the grace window);
2. builds a :class:`WorkerContext`: rank, cancel, a rank-attributed
   :class:`~sparktorch_tpu_torch.obs.HeartbeatEmitter` when the payload
   names a heartbeat directory, a run-scoped telemetry bus with a
   flight recorder, a goodput ledger and (unless
   ``SPARKTORCH_TPU_PROFILE=0``) a stack profiler, and, with
   ``ctl_port``, a
   :class:`~sparktorch_tpu_torch.native.gang.GangMetricsExporter`
   serving ``/metrics``, ``/telemetry`` and ``POST /ctl`` (kill and
   drain verbs), its bound URL published beside the payload;
3. dispatches the payload's ``kind`` and exits 0 (done), 75 (drained:
   SIGTERM honoured before the work finished) or 1 (crashed, with the
   traceback logged), the codes
   :attr:`~sparktorch_tpu_torch.ctl.proc.ProcessWorker.error` decodes.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

from sparktorch_tpu_torch.ctl.proc import EXIT_FAILED, EXIT_OK, EXIT_PREEMPTED
from sparktorch_tpu_torch.ctl.route import CtlRegistry
from sparktorch_tpu_torch.obs.log import get_logger

_LOG = get_logger("sparktorch_tpu_torch.ctl.worker")


class WorkerContext:
    """What every entry kind receives: identity, the SIGTERM-wired
    cancel event, heartbeat publishing, and the telemetry bus."""

    def __init__(self, name: str, rank: Optional[int], cancel,
                 heartbeat=None, telemetry=None,
                 ctl: Optional[CtlRegistry] = None):
        self.name = name
        self.rank = rank
        self.cancel = cancel
        self.heartbeat = heartbeat
        self.telemetry = telemetry
        self.ctl = ctl

    def notify_step(self, step: int) -> None:
        """Publish training/work progress on the heartbeat (readers
        derive step skew; the chaos ``kill_process_at`` fault and the
        straggler policies key off it). No-op without a heartbeat."""
        if self.heartbeat is not None:
            self.heartbeat.notify_step(step)

    def should_stop(self) -> bool:
        return self.cancel.is_set()


def _hard_exit_soon(code: int, delay_s: float = 0.1) -> None:
    """Reply-then-die for the ctl ``kill`` verb: the HTTP handler must
    get its 200 onto the wire before the process vanishes, or the
    controller counts a successful kill as a transport error."""

    def die():
        time.sleep(delay_s)
        os._exit(code)

    threading.Thread(target=die, daemon=True).start()


def build_context(payload: Dict[str, Any]) -> WorkerContext:
    name = payload.get("name") or "worker"
    rank = payload.get("rank")
    cancel = threading.Event()

    def on_sigterm(signum, frame):
        cancel.set()

    signal.signal(signal.SIGTERM, on_sigterm)

    heartbeat = None
    telemetry = None
    hb_dir = payload.get("heartbeat_dir")
    from sparktorch_tpu_torch.obs import Telemetry

    telemetry = Telemetry(run_id=os.environ.get(
        "SPARKTORCH_TPU_RUN_ID", f"ctl-{name}"))
    # Every process worker keeps a flight recorder: its recent spans
    # and events ride the /telemetry scrape as the ``blackbox``
    # section, so the collector's last-good snapshot of a rank that
    # then dies still holds the victim's final ring — the evidence a
    # postmortem bundle is assembled from.
    from sparktorch_tpu_torch.obs.blackbox import attach_recorder

    recorder = attach_recorder(telemetry)
    if hb_dir and rank is not None:
        from sparktorch_tpu_torch.obs import HeartbeatEmitter

        heartbeat = HeartbeatEmitter(hb_dir, rank, telemetry=telemetry)
        heartbeat.beat()  # liveness visible before the first step

    ctl: Optional[CtlRegistry] = None
    exporter = None
    if payload.get("ctl_port") is not None:
        from sparktorch_tpu_torch.native.gang import GangMetricsExporter

        ctl = CtlRegistry()
        # kill: reply, then die HARD (exit 86 reads as "killed by
        # ctl" in the parent's error — any nonzero code restarts
        # under budget). drain: cooperative — same path as SIGTERM.
        ctl.register("kill", lambda code=86: _hard_exit_soon(int(code)))
        ctl.register("drain", lambda: (cancel.set(), True)[1])
        ctl.register("ping", lambda: {"name": name, "rank": rank,
                                      "pid": os.getpid()})
        exporter = GangMetricsExporter(
            heartbeat_dir=hb_dir, telemetry=telemetry,
            port=int(payload["ctl_port"]), ctl=ctl,
        ).start()
        url_path = payload["__path__"] + ".url"
        tmp = url_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(exporter.url)
        os.replace(tmp, url_path)
    # Every process worker keeps a goodput ledger beside its flight
    # recorder: installed ambient, so the instrumentation in train/,
    # serve/ and utils/checkpoint attributes into it, and its
    # ``goodput`` section rides the same /telemetry scrape — the
    # collector's run-level /goodput merge (and a postmortem's
    # goodput-at-death block) is built from these per-rank ledgers.
    from sparktorch_tpu_torch.obs import goodput as _goodput

    ledger = _goodput.GoodputLedger(telemetry=telemetry, rank=rank)
    ledger.start_auto_publish()
    ledger.publish()  # section visible from the FIRST scrape
    _goodput.install(ledger)
    # And the stack sampler beside the ledger: the ledger says which
    # bucket is stealing, the profiler says which function inside it.
    # Env-gated (SPARKTORCH_TPU_PROFILE=0 disables); publishes
    # throttled from its own thread, so a SIGKILLed worker's last-good
    # snapshot still carries its final ``profile`` section.
    from sparktorch_tpu_torch.obs import profile as _profile

    profiler = None
    if _profile.enabled():
        profiler = _profile.StackProfiler(telemetry=telemetry, rank=rank)
        profiler.start()
        profiler.publish()  # section visible from the FIRST scrape
        _profile.install(profiler)
    ctx = WorkerContext(name, rank, cancel, heartbeat=heartbeat,
                        telemetry=telemetry, ctl=ctl)
    ctx._exporter = exporter  # kept alive for the process lifetime
    ctx._recorder = recorder
    ctx.ledger = ledger
    ctx.profiler = profiler
    return ctx


def _dispatch(payload: Dict[str, Any], ctx: WorkerContext) -> Any:
    kind = payload.get("kind", "callable")
    kwargs = dict(payload.get("kwargs") or {})
    if kind == "callable":
        fn: Callable[..., Any] = payload["fn"]
        return fn(ctx)
    if kind == "shard_server":
        from sparktorch_tpu_torch.serve.fleet import run_shard_server

        return run_shard_server(ctx=ctx, **kwargs)
    if kind == "replica_server":
        from sparktorch_tpu_torch.serve.infer import run_replica_server

        return run_replica_server(ctx=ctx, **kwargs)
    if kind == "hogwild_worker":
        from sparktorch_tpu_torch.train.hogwild import run_hogwild_worker

        return run_hogwild_worker(ctx=ctx, **kwargs)
    raise ValueError(f"unknown worker kind {kind!r}")


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        _LOG.error("usage: python -m sparktorch_tpu_torch.ctl.worker "
                   "<payload.dill>")
        return 2
    import dill

    with open(argv[0], "rb") as f:
        payload = dill.load(f)
    payload["__path__"] = argv[0]
    # The payload is consumed: remove it now so a worker the parent
    # never cleans up (chaos SIGKILL leaves the parent's handle, but a
    # long-lived controller relaunching for hours must not fill /tmp)
    # leaks at most the tiny .url handoff file, not a dill payload per
    # spawn. The .url path is derived from the NAME, so publishing
    # still works after the unlink.
    try:
        os.unlink(argv[0])
    except OSError:
        pass
    ctx = build_context(payload)
    try:
        _dispatch(payload, ctx)
    except BaseException as e:
        if ctx.cancel.is_set():
            # A drain that surfaced as an exception (a worker loop
            # raising its preemption error) is still a drain.
            _LOG.warning(f"[sparktorch_tpu_torch:ctl] {ctx.name} drained "
                         f"({type(e).__name__})")
            return EXIT_PREEMPTED
        _LOG.error(f"[sparktorch_tpu_torch:ctl] {ctx.name} failed: "
                   f"{type(e).__name__}: {e}")
        import traceback

        traceback.print_exc()
        return EXIT_FAILED
    finally:
        if ctx.heartbeat is not None:
            ctx.heartbeat.close()
        # Final ledger publish: the closing accounting lands on the
        # exporter's snapshot for whoever scrapes the corpse (a
        # SIGKILLed worker never reaches here — its last THROTTLED
        # publish is what the collector's last-good snapshot holds).
        ledger = getattr(ctx, "ledger", None)
        if ledger is not None:
            ledger.close()
        profiler = getattr(ctx, "profiler", None)
        if profiler is not None:
            profiler.stop()  # joins the sampler + final publish
    # A normal return is a fulfilled contract (entry fns drain by
    # returning early, with idempotent skip-on-restart semantics) —
    # exit 0 even when cancel fired late in the run.
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
