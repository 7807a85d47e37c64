"""Per-rank heartbeats with rank/host attribution — a copy of ``sparktorch_tpu/obs/heartbeat.py``.

Each emitter publishes a small JSON heartbeat file per tick (rank,
host, pid, current step, timestamp) via atomic rename, and any process
that can see the directory reads the full per-rank table back and
derives step skew and last-seen ages. The files are the JAX package's,
byte for byte in layout, so either package's :func:`gang_report` reads
the other's beats. The serving tier publishes one per replica (rank ==
replica id, step == batches executed); the router evicts a replica
whose beat ages past the ft barrier deadline.

A shared directory needs no extra ports and survives the death of
every process involved.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time
from typing import Any, Dict, List, Optional

from sparktorch_tpu_torch.ft import chaos as _chaos

HEARTBEAT_DIR_ENV = "SPARKTORCH_TPU_HEARTBEAT_DIR"
_PREFIX = "gang_hb_rank"


class HeartbeatEmitter:
    """Per-rank heartbeat publisher. ``beat()`` atomically replaces
    ``<dir>/gang_hb_rank<r>.json`` with the current record; mirrored
    into the telemetry bus as gauges so the same liveness shows up on
    ``/metrics`` when a server scope is wired."""

    def __init__(self, directory: str, rank: int,
                 host: Optional[str] = None, telemetry=None,
                 run_id: Optional[str] = None):
        self.directory = directory
        self.rank = int(rank)
        self.host = host or socket.gethostname()
        self.pid = os.getpid()
        self._telemetry = telemetry
        self._beats = 0
        self._step: Optional[int] = None
        # Gang run correlation: when the gang coordinator minted a
        # run_id at bring-up, every heartbeat record carries it, so a
        # collector can join this rank's liveness stream with its
        # telemetry/trace streams. Mutable via set_run_id (the worker
        # learns the id only after registration).
        self.run_id = run_id
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{_PREFIX}{self.rank}.json")

    def set_run_id(self, run_id: Optional[str]) -> None:
        self.run_id = run_id

    def notify_step(self, step: int) -> None:
        """Record training progress; published on the next (and this)
        beat so readers can compute cross-rank step skew."""
        self._step = int(step)
        self.beat()

    def beat(self, alive: bool = True) -> Dict[str, Any]:
        # Chaos freeze: the process stays alive but stops PUBLISHING —
        # readers see the last record's age grow, which is exactly the
        # alive-but-wedged signature the router's heartbeat deadline
        # exists to catch.
        act = _chaos.fire("heartbeat.beat", rank=self.rank,
                          step=self._step)
        if act and act.get("skip"):
            return {"rank": self.rank, "frozen": True}
        self._beats += 1
        record = {
            "rank": self.rank,
            "host": self.host,
            "pid": self.pid,
            "step": self._step,
            "alive": bool(alive),
            "beats": self._beats,
            "ts": time.time(),
        }
        if self.run_id is not None:
            record["run_id"] = self.run_id
        # Atomic publish: readers never see a torn heartbeat. The temp
        # file lives in the same directory so the rename cannot cross
        # filesystems.
        fd, tmp = tempfile.mkstemp(prefix=f".{_PREFIX}{self.rank}.",
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if self._telemetry is not None:
            labels = {"rank": self.rank, "host": self.host}
            self._telemetry.counter("gang.heartbeats", labels=labels)
            self._telemetry.gauge("gang.last_seen_ts", record["ts"],
                                  labels=labels)
            if self._step is not None:
                self._telemetry.gauge("gang.step", self._step, labels=labels)
            self._telemetry.gauge("gang.alive", 1.0 if alive else 0.0,
                                  labels=labels)
        return record

    def close(self) -> None:
        """Final beat with ``alive=False`` — a clean shutdown is
        distinguishable from a silent death (whose last heartbeat
        stays ``alive=True`` and just ages)."""
        try:
            self.beat(alive=False)
        except OSError:
            pass  # shutdown must never fail on a full/removed dir


def read_heartbeats(directory: str) -> List[Dict[str, Any]]:
    """All per-rank heartbeat records in the directory, rank-sorted.
    Torn or foreign files are skipped, never fatal."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and "rank" in rec:
            out.append(rec)
    out.sort(key=lambda r: r.get("rank", -1))
    return out


def gang_report(directory: str,
                now: Optional[float] = None) -> Dict[str, Any]:
    """Aggregate the per-rank table into the numbers an operator (or a
    test) actually asks: who is alive, how stale is each rank's
    heartbeat, and how far apart the ranks' steps are (step skew —
    the async-lag signal)."""
    now = time.time() if now is None else now
    beats = read_heartbeats(directory)
    ranks = {}
    steps = []
    for rec in beats:
        age = max(0.0, now - float(rec.get("ts", now)))
        ranks[int(rec["rank"])] = {
            "host": rec.get("host"),
            "pid": rec.get("pid"),
            "step": rec.get("step"),
            "alive": bool(rec.get("alive", False)),
            "beats": rec.get("beats", 0),
            "last_seen_age_s": age,
            "run_id": rec.get("run_id"),
        }
        if rec.get("step") is not None:
            steps.append(int(rec["step"]))
    report: Dict[str, Any] = {
        "n_ranks": len(ranks),
        "ranks": ranks,
        "alive": sorted(r for r, v in ranks.items() if v["alive"]),
    }
    if steps:
        report["step_min"] = min(steps)
        report["step_max"] = max(steps)
        report["step_skew"] = max(steps) - min(steps)
    return report
