"""Python API over the native gang coordinator — the port of ``sparktorch_tpu/native/gang.py``.

Gang scheduling, rendezvous and failure detection for multi-host
bring-up, over the repository's ``native/gang.cpp`` (compiled unchanged;
the line protocol is the JAX package's, so a port worker can join a JAX
coordinator and the reverse). The typical flow:

    # host 0
    coord = GangCoordinator(world_size=4)
    # every host (including 0)
    worker = GangWorker(coord_host, coord.port, rank, my_addr)
    worker.barrier(0)                 # gang entry
    peers = worker.world()            # rank-ordered addresses
    torch.distributed.init_process_group(init_method=f"tcp://{peers[0]}", ...)

Heartbeats run on a daemon thread; a dead host flips every barrier into
a :class:`GangFailure`, so surviving hosts fail fast instead of hanging
in a collective. With a heartbeat directory (``heartbeat_dir=`` or the
``SPARKTORCH_TPU_HEARTBEAT_DIR`` variable) each tick also publishes the
rank's attributed heartbeat file
(:class:`~sparktorch_tpu_torch.obs.heartbeat.HeartbeatEmitter`: rank,
host, pid, the step the trainers last reported), which either
package's ``gang_report`` reads.

:class:`GangMetricsExporter` is the gang's HTTP surface (``/metrics``,
``/telemetry``, ``/heartbeats`` and, with a control registry,
``POST /ctl``); :meth:`GangCoordinator.resize` changes the world size
live for the elastic controller (:mod:`sparktorch_tpu_torch.ctl.elastic`).
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import List, Optional

from sparktorch_tpu_torch.native.build import load_library
from sparktorch_tpu_torch.obs.heartbeat import (
    HEARTBEAT_DIR_ENV,
    HeartbeatEmitter,
)


class GangFailure(RuntimeError):
    pass


class GangMetricsExporter:
    """The gang's HTTP surface, a copy of the JAX package's.

    ``GET /metrics`` serves the attached telemetry snapshot
    as Prometheus text with the heartbeat table folded in as per-rank
    gauges (liveness, step, last-seen age, step skew — derived at
    scrape time from the shared heartbeat directory, so a dead rank
    shows up as a growing age even though it stopped publishing), plus
    coordinator state (registered/failed/dead_rank) when a
    :class:`GangCoordinator` is attached. ``GET /telemetry`` is the
    same merged view as JSON; ``GET /heartbeats`` just the per-rank
    table. Runs on a daemon thread like :class:`ParamServerHttp`; all
    three pieces (telemetry, heartbeat dir, coordinator) are optional,
    so the exporter serves whatever the deployment actually has.
    """

    def __init__(self, heartbeat_dir: Optional[str] = None,
                 coordinator: Optional["GangCoordinator"] = None,
                 telemetry=None, host: str = "127.0.0.1", port: int = 0,
                 ctl=None):
        self.heartbeat_dir = heartbeat_dir or os.environ.get(HEARTBEAT_DIR_ENV)
        self.coordinator = coordinator
        self.telemetry = telemetry
        self.host = host
        self.port = port
        # Control surface (``POST /ctl``): a
        # :class:`sparktorch_tpu_torch.ctl.CtlRegistry` (duck-typed — anything with ``check_token``
        # and ``handle``) lets an elastic controller manage this
        # process (kill/drain/resize verbs) over HTTP when it holds no
        # local handle on it. None = the route answers 404 (the
        # original read-only exporter).
        self.ctl = ctl
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def _merged_snapshot(self) -> dict:
        from sparktorch_tpu_torch.obs import Telemetry, gang_report

        tele = self.telemetry
        snap = (tele.snapshot() if tele is not None
                else Telemetry(run_id="gang_exporter").snapshot())
        gauges = snap.setdefault("gauges", {})
        if self.heartbeat_dir:
            report = gang_report(self.heartbeat_dir)
            snap["gang_report"] = report
            for rank, rec in report.get("ranks", {}).items():
                gauges[f"gang.hb_alive{{rank={rank}}}"] = (
                    1.0 if rec["alive"] else 0.0
                )
                gauges[f"gang.hb_last_seen_age_s{{rank={rank}}}"] = (
                    rec["last_seen_age_s"]
                )
                if rec.get("step") is not None:
                    gauges[f"gang.hb_step{{rank={rank}}}"] = float(rec["step"])
            if "step_skew" in report:
                gauges["gang.hb_step_skew"] = float(report["step_skew"])
            gauges["gang.hb_ranks"] = float(report.get("n_ranks", 0))
        coord = self.coordinator
        if coord is not None:
            gauges["gang.coordinator_registered"] = float(coord.registered)
            gauges["gang.coordinator_failed"] = 1.0 if coord.failed else 0.0
            gauges["gang.coordinator_dead_rank"] = float(coord.dead_rank)
            gauges["gang.coordinator_world_size"] = float(coord.world_size)
            gauges["gang.coordinator_generation"] = float(coord.generation)
            if getattr(coord, "run_id", None):
                # The gang run_id rides the scrape like a build_info
                # string, so a collector can correlate this exporter
                # with the rank streams without parsing REG lines.
                snap.setdefault("info", {})["gang.run_id"] = coord.run_id
        return snap

    def start(self) -> "GangMetricsExporter":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from sparktorch_tpu_torch.obs import (
            PROMETHEUS_CONTENT_TYPE,
            render_prometheus,
        )

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes = b"",
                      content_type: Optional[str] = None):
                self.send_response(code)
                if content_type:
                    self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_GET(self):
                route = self.path.split("?", 1)[0]
                if route == "/":
                    self._send(200, b"sparktorch-tpu gang exporter")
                elif route == "/metrics":
                    snap = exporter._merged_snapshot()
                    snap.pop("gang_report", None)  # gauges carry it
                    self._send(200, render_prometheus(snap).encode(),
                               content_type=PROMETHEUS_CONTENT_TYPE)
                elif route == "/telemetry":
                    self._send(200,
                               json.dumps(
                                   exporter._merged_snapshot()).encode(),
                               content_type="application/json")
                elif route == "/heartbeats":
                    from sparktorch_tpu_torch.obs import gang_report

                    report = (gang_report(exporter.heartbeat_dir)
                              if exporter.heartbeat_dir else {"n_ranks": 0,
                                                              "ranks": {},
                                                              "alive": []})
                    self._send(200, json.dumps(report).encode(),
                               content_type="application/json")
                else:
                    self._send(404)

            def do_POST(self):
                route = self.path.split("?", 1)[0]
                if route != "/ctl" or exporter.ctl is None:
                    self._send(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("ctl body must be an object")
                except (ValueError, TypeError) as e:
                    self._send(400, str(e).encode())
                    return
                if not exporter.ctl.check_token(
                        self.headers.get("X-Ctl-Token")):
                    self._send(403, b"bad ctl token")
                    return
                verb = body.get("verb")
                args = body.get("args") or {}
                try:
                    result = exporter.ctl.handle(verb, args)
                except KeyError:
                    self._send(400, f"unknown verb {verb!r}".encode())
                    return
                except Exception as e:  # verb handlers are user code
                    self._send(500, f"{type(e).__name__}: {e}".encode())
                    return
                self._send(200, json.dumps(
                    {"ok": True, "verb": verb, "result": result}).encode(),
                    content_type="application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self):
        return self.start() if self._httpd is None else self

    def __exit__(self, *exc):
        self.stop()


def _lib():
    lib = load_library("gang")
    lib.gang_server_start3.restype = ctypes.c_void_p
    lib.gang_server_start3.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.gang_server_port.argtypes = [ctypes.c_void_p]
    lib.gang_server_resize.restype = ctypes.c_long
    lib.gang_server_resize.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gang_server_generation.restype = ctypes.c_long
    lib.gang_server_generation.argtypes = [ctypes.c_void_p]
    lib.gang_server_failed.argtypes = [ctypes.c_void_p]
    lib.gang_server_dead_rank.argtypes = [ctypes.c_void_p]
    lib.gang_server_registered.argtypes = [ctypes.c_void_p]
    lib.gang_server_stop.argtypes = [ctypes.c_void_p]
    lib.gang_client_connect.restype = ctypes.c_void_p
    lib.gang_client_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.gang_client_connect4.restype = ctypes.c_void_p
    lib.gang_client_connect4.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_long, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.gang_client_run_id.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.gang_client_generation.restype = ctypes.c_long
    lib.gang_client_generation.argtypes = [ctypes.c_void_p]
    lib.gang_client_barrier.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.gang_client_heartbeat.argtypes = [ctypes.c_void_p]
    lib.gang_client_world.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.gang_client_close.argtypes = [ctypes.c_void_p]
    return lib


class GangCoordinator:
    """The gang's coordinator; ``world_size`` hosts must register. A
    member silent for ``heartbeat_timeout_ms`` is declared dead.

    ``rejoin_grace_ms`` (0: off, a dead gang refuses registrations for
    good): after a member is declared dead, a fresh registration within
    this window opens a NEW GENERATION, whose members all register
    again, so a supervisor-restarted gang reforms on the same
    coordinator. Registration and heartbeat lines carry the generation
    a client joined, so a survivor of the failed generation cannot
    slip into the new one. :meth:`resize` opens a generation the same
    way for a new world size. ``run_id`` (None = untagged) is announced
    in every OK reply; it travels as one token of the line protocol, so
    it must be printable ASCII without whitespace, at most 120 bytes.
    """

    def __init__(self, world_size: int, port: int = 0,
                 heartbeat_timeout_ms: int = 10_000,
                 rejoin_grace_ms: int = 0,
                 run_id: Optional[str] = None):
        if run_id is not None and (
                not run_id or len(run_id) > 120
                or not run_id.isascii() or not run_id.isprintable()
                or any(c.isspace() for c in run_id)):
            raise ValueError(
                f"run_id {run_id!r} is not line-protocol-safe: need a "
                f"non-empty printable-ASCII token without whitespace, "
                f"<= 120 chars")
        self._lib = _lib()
        self.run_id = run_id
        self._handle = self._lib.gang_server_start3(
            port, world_size, heartbeat_timeout_ms, rejoin_grace_ms,
            (run_id or "").encode())
        if not self._handle:
            raise RuntimeError("gang coordinator failed to start")
        self.port = self._lib.gang_server_port(self._handle)
        self.world_size = world_size
        self.rejoin_grace_ms = rejoin_grace_ms
        # The native state as stop() last saw it: reading a property
        # after stop() must not pass the freed handle to the library.
        self._final = {"failed": False, "dead_rank": -1,
                       "generation": 0, "registered": 0}

    def _state(self, key: str, fn):
        return self._final[key] if not self._handle else fn(self._handle)

    @property
    def failed(self) -> bool:
        return bool(self._state("failed", self._lib.gang_server_failed))

    @property
    def dead_rank(self) -> int:
        return int(self._state("dead_rank", self._lib.gang_server_dead_rank))

    @property
    def generation(self) -> int:
        """The gang's generation: bumped by each rejoin after a failure
        and each :meth:`resize`; 0 is the original gang."""
        return int(self._state("generation",
                               self._lib.gang_server_generation))

    @property
    def registered(self) -> int:
        return int(self._state("registered",
                               self._lib.gang_server_registered))

    def resize(self, new_world_size: int) -> int:
        """Change the world size live: the generation bumps,
        membership and barrier state clear, parked barrier waiters are
        released with an error, and every surviving or new rank
        registers again into the new generation. The elastic controller
        calls it to shrink around a rank that spent its restart budget
        and to grow. Returns the new generation."""
        if new_world_size < 1:
            raise ValueError(
                f"world_size must be >= 1, got {new_world_size}")
        if not self._handle:
            raise RuntimeError("cannot resize a stopped coordinator")
        gen = int(self._lib.gang_server_resize(self._handle,
                                               int(new_world_size)))
        if gen < 0:
            raise RuntimeError("gang coordinator refused the resize")
        self.world_size = int(new_world_size)
        return gen

    def stop(self):
        if self._handle:
            self._final = {key: getattr(self, key) for key in self._final}
            self._lib.gang_server_stop(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class GangWorker:
    """Per-host client: register, barrier, heartbeat, peer table."""

    # Consecutive local heartbeat I/O failures tolerated before the gang
    # is taken as lost; a DEAD reply from the coordinator is final at once.
    _HB_MAX_IO_FAILURES = 3

    def __init__(self, host: str, port: int, rank: int, address: str,
                 timeout_ms: int = 30_000, heartbeat_interval_s: float = 2.0,
                 heartbeat_dir: Optional[str] = None, telemetry=None):
        self._lib = _lib()
        self.rank = rank
        # Rank-attributed liveness: the native protocol carries a
        # liveness bit; the emitter adds who, where and at which step.
        heartbeat_dir = heartbeat_dir or os.environ.get(HEARTBEAT_DIR_ENV)
        self.heartbeat = (
            HeartbeatEmitter(heartbeat_dir, rank, telemetry=telemetry)
            if heartbeat_dir else None)
        # A heartbeat file that cannot be written fails the gang check.
        self._hb_error: Optional[BaseException] = None
        self._endpoint = (host, port, address, timeout_ms)
        # A fresh registration; the OK reply names the generation joined
        # (-1: a coordinator that predates generation tags) and the run id.
        self._handle = self._lib.gang_client_connect(
            host.encode(), port, rank, address.encode(), timeout_ms)
        if not self._handle:
            raise GangFailure(f"rank {rank}: cannot register with {host}:{port}")
        self._generation = int(self._lib.gang_client_generation(self._handle))
        buf = ctypes.create_string_buffer(256)
        n = self._lib.gang_client_run_id(self._handle, buf, len(buf))
        self.run_id: Optional[str] = buf.value.decode() if n > 0 else None
        if self.run_id:
            # The gang's run id on this rank's heartbeat records and
            # telemetry events, so per-rank streams can be joined.
            if self.heartbeat is not None:
                self.heartbeat.set_run_id(self.run_id)
            if telemetry is not None:
                telemetry.set_run_id(self.run_id)
        # Heartbeats get their own connection, tagged with the generation
        # and run id just learned: the main one may sit in a barrier read.
        # Without it there is no failure detection, so refuse to start.
        self._hb_handle = self._connect_heartbeat(timeout_ms)[0]
        if not self._hb_handle:
            self._lib.gang_client_close(self._handle)
            self._handle = None
            raise GangFailure(
                f"rank {rank}: heartbeat channel to {host}:{port} refused")
        self._hb_lock = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb_dead = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_interval_s,),
            daemon=True)
        self._hb_thread.start()

    def _connect_heartbeat(self, timeout_ms: int):
        """A generation- and run-tagged registration; returns (handle or
        None, status: 1 when the coordinator answered DEAD)."""
        host, port, address, _ = self._endpoint
        status = ctypes.c_int(-1)
        handle = self._lib.gang_client_connect4(
            host.encode(), port, self.rank, address.encode(), timeout_ms,
            self._generation, (self.run_id or "").encode(),
            ctypes.byref(status))
        return handle or None, status.value

    def _heartbeat_loop(self, interval: float):
        io_failures = 0
        while not self._hb_stop.wait(interval):
            if self.heartbeat is not None:
                try:
                    self.heartbeat.beat()
                except OSError as e:
                    self._hb_error = e
                    self._hb_dead.set()
                    return
            with self._hb_lock:
                if self._hb_handle is None:
                    return
                rc = self._lib.gang_client_heartbeat(self._hb_handle)
            if rc == 0:
                io_failures = 0
                continue
            if rc > 0:  # the coordinator replied DEAD
                self._hb_dead.set()
                return
            io_failures += 1
            if io_failures >= self._HB_MAX_IO_FAILURES:
                self._hb_dead.set()
                return
            # A failed socket stays failed: dial again, outside the lock
            # and briefly. A DEAD reply to the re-registration is final
            # (the gang failed, or reformed without this rank).
            fresh, status = self._connect_heartbeat(
                min(self._endpoint[3], 2000))
            if status == 1:
                self._hb_dead.set()
                return
            with self._hb_lock:
                if self._hb_handle is None:  # close()d meanwhile
                    if fresh:
                        self._lib.gang_client_close(fresh)
                    return
                if fresh:
                    self._lib.gang_client_close(self._hb_handle)
                    self._hb_handle = fresh

    def barrier(self, epoch: int) -> None:
        """Block until every rank reaches barrier ``epoch``. Raises
        :class:`GangFailure` when the gang has failed."""
        if self._hb_dead.is_set():
            raise GangFailure("gang member declared dead")
        rc = self._lib.gang_client_barrier(self._handle, epoch)
        if rc != 0:
            raise GangFailure(f"barrier {epoch} failed (rc={rc})")

    @property
    def failed(self) -> bool:
        """True once the coordinator has declared any member dead
        (survivors learn it within one heartbeat interval)."""
        return self._hb_dead.is_set()

    @property
    def generation(self) -> int:
        """The generation this worker registered into; -1 when the
        coordinator predates generation tags."""
        return self._generation

    def check(self) -> None:
        """Raise :class:`GangFailure` if the gang has failed. Cheap (a
        local event): trainers call it between steps, so a dead host
        aborts the survivors before their next collective."""
        if self._hb_error is not None:
            raise GangFailure(f"rank {self.rank}: heartbeat file write "
                              "failed") from self._hb_error
        if self.failed:
            raise GangFailure(
                f"rank {self.rank}: gang failed (peer declared dead)")

    def world(self) -> List[str]:
        """The rank-ordered peer addresses."""
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.gang_client_world(self._handle, buf, len(buf))
        if n < 0:
            raise GangFailure("world query failed")
        return buf.value.decode().split(",") if buf.value else []

    def suspend_heartbeat(self):
        """Test hook: silence this member so the coordinator's failure
        detector fires."""
        self._hb_stop.set()

    @property
    def closed(self) -> bool:
        return self._handle is None

    def close(self):
        self._hb_stop.set()
        if self.heartbeat is not None:
            # Join the heartbeat thread before the final beat, so a tick
            # past its stop check cannot publish alive=True over the
            # alive=False record a clean shutdown leaves.
            self._hb_thread.join(timeout=5.0)
            self.heartbeat.close()
        with self._hb_lock:
            if self._hb_handle:
                self._lib.gang_client_close(self._hb_handle)
                self._hb_handle = None
        if self._handle:
            self._lib.gang_client_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
