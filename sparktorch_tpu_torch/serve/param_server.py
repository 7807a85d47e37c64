"""Device-resident parameter server for asynchronous (hogwild) training — the port of ``sparktorch_tpu/serve/param_server.py``.

The reference (``sparktorch/server.py``) is a Flask app holding the
canonical model in shared CPU memory, with routes ``GET /``,
``GET /parameters``, ``POST /update`` (``optimizer.step()`` per push)
and ``POST /losses`` (windowed early stop), tolerating 10 update errors.

As in the JAX package:

- the canonical parameters live on the card behind a
  :class:`~sparktorch_tpu_torch.utils.locks.VersionedSlot`; a pull is
  a lock-free read of an immutable (version, snapshot) pair, and a
  client that holds the current version gets nothing;
- one writer thread drains a FIFO queue of gradient trees through the
  spec's optimizer, each gradient cast up to its parameter's dtype
  first (pushes may arrive in bfloat16);
- the model state (BatchNorm running statistics) never changes: hogwild
  workers compute their gradients on the running statistics.

torch optimizers update in place, and a published snapshot must stay
as it was, so the writer keeps its own master parameters and optimizer
and publishes a copy after each apply: one device-to-device copy of the
parameters per apply (a fused ``_foreach_copy_``). Workers copy a
snapshot into their own module and never alias it. The writer and the
workers all enqueue on the device's default stream, so an apply and
its snapshot copy are ordered before any worker work enqueued after the
swap, and applies serialise with the workers' compute on the card.

:class:`ParamServerHttp` serves the reference's routes plus the binary
ones (``/parameters.bin`` with a 304 for a current client,
``/update.bin``, ``/losses.json``) and the server's telemetry:
``GET /metrics`` (Prometheus text) and ``GET /telemetry`` (the same
snapshot as JSON). The server records the JAX package's
``param_server.*`` names into its bus (its own unless the caller passes
one), and hosts the ``param_server.pull`` (a torn pull body) and
``param_server.update`` (a forced 500) chaos sites.

For the sharded fleet (:mod:`~sparktorch_tpu_torch.serve.fleet`), when
the backing server has ``render_delta`` (a fleet shard, or the fleet's
gateway) :class:`ParamServerHttp` also serves ``GET /delta.bin``, the
per-tensor delta pull, each reply (304s too) carrying ``X-Slot-Epoch``
and, with ``ring_version_fn``, ``X-Ring-Version``; ``shard=`` labels
the wire metrics with the shard id and arms the ``fleet.shard`` chaos
site (the frontend's kill, the straggler's delay), and
``extra_json_routes`` mounts small JSON routes (``/fleet.json``).

Request tracing (:mod:`~sparktorch_tpu_torch.obs.rpctrace`): a sampled
context arrives in a pushed frame's trace extension or the
``X-Trace-Context`` header; each handler adds a ``serve`` span (with
``render`` or ``decode`` below it) on the server's bus, and the writer
thread records the push's ``queue_wait`` and ``apply``. An apply is
also the rank's ``compute`` in an installed goodput ledger.
"""

from __future__ import annotations

import contextlib
import copy
import json
import queue
import socket as _socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple, Union

import dill
import numpy as np
import torch

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.inference import _resolve_device
from sparktorch_tpu_torch.net import wire as binwire
from sparktorch_tpu_torch.net.transport import run_tag, tree_to_host
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs import rpctrace as _rpctrace
from sparktorch_tpu_torch.obs.prom import CONTENT_TYPE as PROM_CONTENT_TYPE
from sparktorch_tpu_torch.obs.prom import render_prometheus
from sparktorch_tpu_torch.obs.telemetry import Telemetry, wall_ts
from sparktorch_tpu_torch.utils.early_stopper import EarlyStopping
from sparktorch_tpu_torch.utils.locks import VersionedSlot
from sparktorch_tpu_torch.utils.optim import flax_shapes
from sparktorch_tpu_torch.utils.serde import ModelSpec, deserialize_model

MAX_TOLERATED_ERRORS = 10  # server.py:139-142 parity


def as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a tensor, or a numpy array as the wire decodes it) on
    ``like``'s device in ``like``'s dtype."""
    if not isinstance(value, torch.Tensor):
        # The wire's arrays are read-only views of a request body;
        # torch wraps only writable memory.
        value = torch.from_numpy(np.require(value, requirements="W"))
    return value.to(like.device, like.dtype, non_blocking=True)


def build_module(spec: ModelSpec, seed: int) -> torch.nn.Module:
    """The spec's module, on the CPU: a copy of an eager spec's module
    (its weights), or a lazy spec's class built under ``seed``."""
    if spec.module is not None:
        return copy.deepcopy(spec.make_module())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return spec.make_module()


def snapshot(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``tensors`` made by one fused copy."""
    out = {k: torch.empty_like(v) for k, v in tensors.items()}
    if out:
        torch._foreach_copy_(list(out.values()), list(tensors.values()))
    return out


class ParameterServer:
    """Canonical-parameter holder and asynchronous applier."""

    def __init__(self, torch_obj, window_len: int = 3,
                 early_stop_patience: int = -1, acquire_lock: bool = True,
                 device=None, seed: int = 0, telemetry=None):
        self.spec: ModelSpec = deserialize_model(torch_obj)
        # A server-scoped bus unless the caller brings one: each
        # server's counters are its own, and /metrics serves this one.
        self.telemetry = telemetry or Telemetry(run_id="param_server")
        self.device = _resolve_device(device)
        self.acquire_lock = acquire_lock  # parity knob; the single
        # writer thread always serialises applies.
        module = build_module(self.spec, seed).to(self.device)
        with torch.no_grad():
            self._master = {n: p.detach().clone()
                            for n, p in module.named_parameters()}
            self._model_state = {n: b.detach().clone()
                                 for n, b in module.named_buffers()}
        self._opt = self.spec.make_optimizer(
            list(self._master.values()), flax_shapes(module, self._master))
        self.slot = VersionedSlot(snapshot(self._master))

        # Windowed early stop (server.py:102-123 parity).
        self.window_len = max(1, window_len)
        self._losses: list = []
        self._stopper = (EarlyStopping(patience=early_stop_patience)
                         if early_stop_patience and early_stop_patience > 0
                         else None)
        self._stop_flag = False
        self._loss_lock = threading.Lock()

        self._queue: "queue.Queue" = queue.Queue()
        self._errors = 0
        self._failed: Optional[BaseException] = None
        self._applied = 0
        self.apply_s = 0.0  # host seconds in the writer's applies
        self._running = True
        self._writer = threading.Thread(target=self._apply_loop, daemon=True)
        self._writer.start()

    # -- state access ------------------------------------------------------

    def get_parameters(self, have_version: int = -1
                       ) -> Optional[Tuple[int, Dict[str, torch.Tensor]]]:
        """The (version, snapshot) pair, or None when the client holds
        the current version (``GET /parameters``, server.py:93-100)."""
        snap = self.slot.read_if_newer(have_version)
        self.telemetry.counter("param_server.pulls")
        if snap is not None:
            self.telemetry.counter("param_server.pull_fresh")
        return snap

    def model_state(self) -> Dict[str, torch.Tensor]:
        return self._model_state

    @property
    def applied_updates(self) -> int:
        return self._applied

    # -- gradient path -----------------------------------------------------

    def push_gradients(self, grads, wait: bool = True,
                       timeout: float = 60.0, trace_ctx=None) -> None:
        """Queue a gradient tree (parameter name → gradient) for the
        writer thread. With ``wait`` the call returns once this
        gradient is applied, so a worker's next pull sees its own push
        (``POST /update``, server.py:125-147). ``trace_ctx`` (a sampled
        span context off the wire) rides the queue item, so the writer
        records this request's queue wait and apply as child spans."""
        if self._failed is not None:
            raise RuntimeError("parameter server failed") from self._failed
        done = threading.Event() if wait else None
        self._queue.put((grads, done, trace_ctx, wall_ts(),
                         time.perf_counter()))  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
        self.telemetry.counter("param_server.pushes")
        self.telemetry.gauge("param_server.queue_depth", self._queue.qsize())
        if done is not None and not done.wait(timeout):
            raise TimeoutError("parameter server apply timed out")

    def _apply(self, grads) -> int:
        """One optimizer step on the master weights, published as a new
        snapshot; returns the version the step started from."""
        with torch.no_grad():
            for name, p in self._master.items():
                p.grad = as_tensor(grads[name], p)
            self._opt.step()
            return self.slot.swap(snapshot(self._master)) - 1

    def _apply_loop(self):
        tracer = _rpctrace.tracer_for(self.telemetry)
        while self._running:
            try:
                grads, done, tctx, enq_ts, enq_t0 = self._queue.get(
                    timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                # The wait began on a handler thread and ends here: an
                # after-the-fact record.
                tracer.record("queue_wait", tctx, enq_ts, t0 - enq_t0,
                              kind="server")
                with tracer.child_span("apply", tctx, kind="server"), \
                        _goodput.span("compute", {"site": "ps_apply"}):
                    version = self._apply(grads)
                dt = time.perf_counter() - t0  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                self.apply_s += dt
                self._applied += 1
                self.telemetry.counter("param_server.applies")
                self.telemetry.observe("param_server.apply_s", dt)
                self.telemetry.gauge("param_server.version", version + 1)
            except Exception as e:  # tolerate a bounded error count
                self._errors += 1
                self.telemetry.counter("param_server.apply_errors")
                if self._errors > MAX_TOLERATED_ERRORS:
                    self._failed = e
                    self._running = False
            finally:
                if done is not None:
                    done.set()
                self._queue.task_done()

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every queued gradient is applied."""
        deadline = time.monotonic() + timeout
        while self._queue.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    # -- early stopping ----------------------------------------------------

    def post_loss(self, loss: float) -> bool:
        """Windowed-average early-stop vote; True => stop
        (``POST /losses``, server.py:102-123)."""
        self.telemetry.counter("param_server.losses_posted")
        with self._loss_lock:
            if self._stop_flag:
                return True
            if self._stopper is None:
                return False
            self._losses.append(float(loss))
            if len(self._losses) >= self.window_len:
                avg = float(np.mean(self._losses))
                self._losses.clear()
                if self._stopper.step(avg):
                    self._stop_flag = True
        return self._stop_flag

    @property
    def should_stop(self) -> bool:
        return self._stop_flag

    # -- lifecycle ---------------------------------------------------------

    def stop(self):
        self._running = False
        if self._writer.is_alive():
            self._writer.join(timeout=5.0)

    def final_state(self):
        """(params, model_state) after the pending applies."""
        self.drain()
        if self._failed is not None:
            raise RuntimeError("parameter server failed") from self._failed
        _, params = self.slot.read()
        return params, self._model_state


# ---------------------------------------------------------------------------
# HTTP wire (stdlib; the reference used Flask — server.py:79-149)
# ---------------------------------------------------------------------------


class _KeepAliveHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer whose ``stop`` also closes the kept-alive
    client connections, so a stopped server goes dark."""

    daemon_threads = True
    # A fleet's monitor restarts a killed shard frontend on its old port.
    allow_reuse_address = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._live_requests: set = set()
        self._live_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._live_lock:
            self._live_requests.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_lock:
            self._live_requests.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address):
        # A client that hung up, or a kill closing the connection under
        # a request: nothing the server did wrong, so no traceback.
        if isinstance(sys.exc_info()[1], ConnectionError):
            return
        super().handle_error(request, client_address)

    def close_all_connections(self):
        with self._live_lock:
            live = list(self._live_requests)
        for sock in live:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # already closing


class ParamServerHttp:
    """A :class:`ParameterServer` over HTTP/1.1 (keep-alive).

    ``GET /`` liveness; ``GET /parameters`` (dill ``(version, tree)``,
    204 when not newer than ``X-Have-Version``); ``POST /update`` (dill
    gradient tree); ``POST /losses`` (dill float -> dill
    ``{"stop": bool}``); and the binary routes ``GET /parameters.bin``
    (a wire frame, 304 when the client is current), ``POST /update.bin``
    (400 on a malformed frame) and ``POST /losses.json``. Both pull
    routes render from one host copy per version. ``GET /metrics``
    serves the server's bus as Prometheus text and ``GET /telemetry``
    the same snapshot as JSON.

    Fleet mode: ``GET /delta.bin`` when the server has ``render_delta``
    (the leaves past ``X-Have-Version``, int8 with ``X-Pull-Quant:
    int8``; ``X-Slot-Epoch`` and ``X-Ring-Version`` on every reply);
    ``shard`` labels the wire metrics and arms the ``fleet.shard``
    chaos site; ``extra_json_routes`` maps a route to a callable whose
    result is served as JSON.
    """

    def __init__(self, server: ParameterServer, host: str = "127.0.0.1",
                 port: int = 3000, shard: Optional[str] = None,
                 extra_json_routes=None, ring_version_fn=None):
        self.server = server
        self.host = host
        self.port = port
        self.shard = str(shard) if shard is not None else None
        self.extra_json_routes = dict(extra_json_routes or {})
        self.ring_version_fn = ring_version_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        ps = self.server
        tele = ps.telemetry
        cache: Dict[str, Any] = {"version": None, "host": None,
                                 "dill": None, "bin": None}
        cache_lock = threading.Lock()
        # Frames this server sends carry the tag of its bus's run id; a
        # push tagged by another run is counted, and applied all the
        # same (the tag is a join key, not an access check).
        server_tag = run_tag(tele.run_id)
        # Each handler adds a serve span (and render/decode below it) on
        # the server's bus; the collector stitches them under the
        # client's root by trace id.
        tracer = _rpctrace.tracer_for(tele)

        def cached_body(fmt: str) -> Tuple[int, Union[bytes, list]]:
            """(version, body) from one slot read; the host copy and
            each rendering are made once per version. The binary body
            is the frame's buffers, views of the host copy, sent one
            after another: joining a BERT-base frame would copy 0.44 GB
            before the first byte goes out."""
            with cache_lock:
                version, params = ps.slot.read()
                if cache["version"] != version:
                    # The old copy goes first: its pinned memory then
                    # serves the new one unless a reply still sends it.
                    cache.update(version=None, host=None, dill=None,
                                 bin=None)
                    cache.update(version=version, host=tree_to_host(params))
                if cache[fmt] is None:
                    cache[fmt] = (
                        dill.dumps((version, cache["host"])) if fmt == "dill"
                        else binwire.encode(cache["host"], version=version,
                                            run_tag=server_tag))
                return version, cache[fmt]

        psh = self
        shard_label = self.shard
        extra_json = self.extra_json_routes
        ring_version_fn = self.ring_version_fn

        def record_wire(route: str, direction: str, nbytes: int,
                        t0: float) -> None:
            """Per-route bytes and latency on the bus, labelled by shard
            on a fleet shard."""
            labels = {"route": route, "dir": direction}
            hist_labels = {"route": route}
            if shard_label is not None:
                labels["shard"] = hist_labels["shard"] = shard_label
            tele.counter("param_server.wire_bytes_total", nbytes,
                         labels=labels)
            tele.observe("param_server.wire_latency_s",
                         time.perf_counter() - t0, labels=hist_labels)  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)

        def fire_shard_chaos(handler, route: str) -> bool:
            """The fleet's ``fleet.shard`` site: a straggler's delay, or
            this frontend's death at its Nth request. True when the
            request must be dropped unanswered, as a dying shard's
            is."""
            if shard_label is None:
                return False
            act = _chaos.fire("fleet.shard", shard=shard_label, route=route)
            if act and act.get("delay"):
                time.sleep(float(act["delay"]))
            if act and act.get("die"):
                # stop() from another thread: it joins the machinery
                # this handler thread is part of.
                threading.Thread(target=psh.stop, daemon=True).start()
                handler.close_connection = True
                return True
            return False

        def delta_headers() -> Dict[str, str]:
            """Resync metadata on every delta reply: the slot's epoch
            (a rebuilt server), the ring version (a shard added or
            drained)."""
            out = {}
            epoch = getattr(ps.slot, "epoch", None)
            if epoch is not None:
                out["X-Slot-Epoch"] = str(int(epoch))
            if ring_version_fn is not None:
                out["X-Ring-Version"] = str(int(ring_version_fn()))
            return out

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # A reply is two writes (headers, body): with Nagle on, a
            # small body waits for the client's delayed ACK (~40 ms).
            disable_nagle_algorithm = True

            def log_message(self, *a):
                pass

            def _send(self, code: int, body: Union[bytes, list] = b"",
                      content_type: Optional[str] = None,
                      extra_headers: Optional[Dict[str, str]] = None):
                """``body``: bytes, or a frame's buffers (a list)."""
                chunks = body if isinstance(body, list) else [body]
                self.send_response(code)
                if content_type:
                    self.send_header("Content-Type", content_type)
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length",
                                 str(binwire.frame_nbytes(chunks)))
                chunks = [c for c in chunks if len(c)]
                if not chunks:
                    self.reply_t = time.perf_counter()  # lint-obs: ok (the serve span's end, a trace timestamp, not a ledger region)
                self.end_headers()
                for i, chunk in enumerate(chunks):
                    if i == len(chunks) - 1:
                        self.reply_t = time.perf_counter()  # lint-obs: ok (the serve span's end, a trace timestamp, not a ledger region)
                    self.wfile.write(chunk)

            def _trace_ctx(self, raw: Optional[bytes] = None):
                """The request's span context: a pushed frame's trace
                extension when a body is given, else the HTTP header.
                None on anything absent or malformed: a garbled context
                never fails a request."""
                if raw:
                    try:
                        ctx = binwire.frame_trace(raw)
                    except binwire.WireError:
                        ctx = None
                    if ctx is not None:
                        return ctx
                return _rpctrace.SpanContext.from_header(
                    self.headers.get(_rpctrace.TRACE_HEADER))

            @contextlib.contextmanager
            def _serve_span(self, route: str, ctx):
                """The request's ``serve`` span. It ends on the
                handler's clock just before the reply's last write:
                the client cannot have read the reply before then, so
                the span lies inside the client's wall; the
                bookkeeping after the write falls outside it."""
                ann = {"route": route}
                if shard_label is not None:
                    ann["shard"] = shard_label
                self.reply_t = None
                with tracer.child_span("serve", ctx, kind="server",
                                       **ann) as span:
                    yield span
                    span.end_at(self.reply_t)

            def do_GET(self):
                route = self.path.split("?", 1)[0]
                if fire_shard_chaos(self, route):
                    return
                tele.counter("param_server.http_requests",
                             labels={"route": route})
                if route == "/delta.bin" and hasattr(ps, "render_delta"):
                    with self._serve_span(route, self._trace_ctx()) as ssp:
                        t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                        have = int(self.headers.get("X-Have-Version", "-1"))
                        quant = self.headers.get("X-Pull-Quant") or None
                        try:
                            with tracer.child_span("render", ssp.ctx,
                                                   kind="server"):
                                _version, body = ps.render_delta(
                                    have, quant=quant, run_tag=server_tag)
                        except ValueError:
                            self._send(400)
                            return
                        hdrs = delta_headers()
                        if body is None:
                            self._send(304, extra_headers=hdrs)
                            record_wire(route, "tx", 0, t0)
                            return
                        act = _chaos.fire("param_server.pull", route=route)
                        if act and act.get("truncate"):
                            body = body[: max(1, len(body) // 2)]
                        self._send(200, body, binwire.CONTENT_TYPE, hdrs)
                        record_wire(route, "tx", len(body), t0)
                    return
                if route in extra_json:
                    try:
                        doc = extra_json[route]()
                    except Exception:
                        self._send(500)
                        return
                    self._send(200, json.dumps(doc).encode(),
                               "application/json")
                    return
                if route == "/":
                    self._send(200, b"sparktorch-tpu parameter server")
                elif route in ("/parameters", "/parameters.bin"):
                    with self._serve_span(route, self._trace_ctx()) as ssp:
                        self._serve_parameters(route, ssp)
                elif route == "/metrics":
                    self._send(200, render_prometheus(tele.snapshot()).encode(),
                               PROM_CONTENT_TYPE)
                elif route == "/telemetry":
                    self._send(200, json.dumps(tele.snapshot()).encode(),
                               "application/json")
                else:
                    self._send(404)

            def _serve_parameters(self, route: str, ssp) -> None:
                t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                have = int(self.headers.get("X-Have-Version", "-1"))
                binary = route.endswith(".bin")
                with tracer.child_span("render", ssp.ctx, kind="server"):
                    version, body = cached_body("bin" if binary else "dill")
                if version <= have:
                    self._send(304 if binary else 204)
                    record_wire(route, "tx", 0, t0)
                    return
                act = _chaos.fire("param_server.pull", route=route)
                if act and act.get("truncate"):
                    # A torn reply whose declared length is honest for
                    # the bytes sent: the client's frame check must
                    # catch it.
                    if binary:
                        body = binwire.frame_bytes(body)
                    body = body[: max(1, len(body) // 2)]
                self._send(200, body, binwire.CONTENT_TYPE
                           if binary else None)
                record_wire(route, "tx", binwire.frame_nbytes(
                    body if isinstance(body, list) else [body]), t0)

            def _serve_update(self, route: str, raw: bytes, binary: bool,
                              ssp) -> None:
                t0 = time.perf_counter()  # lint-obs: ok (request-latency histogram clock pair, not a ledger region)
                try:
                    with tracer.child_span("decode", ssp.ctx, kind="server"):
                        grads = (binwire.decode(raw)[1] if binary
                                 else dill.loads(raw))
                except Exception:
                    # A malformed body is the client's fault: 400, never
                    # counted against the apply budget.
                    ssp.annotate(http_status=400)
                    self._send(400)
                    return
                if binary:
                    tag = binwire.frame_run_tag(raw)
                    if tag and server_tag and tag != server_tag:
                        tele.counter("param_server.run_tag_mismatches_total")
                try:
                    # A chaos 500 takes the path a failed apply takes.
                    _chaos.fire("param_server.update", route=route)
                    ps.push_gradients(grads, trace_ctx=ssp.ctx)
                except Exception:
                    ssp.annotate(http_status=500)
                    self._send(500)
                    return
                self._send(200, b"OK")
                record_wire(route, "rx", len(raw), t0)

            def do_POST(self):
                route = self.path.split("?", 1)[0]
                if fire_shard_chaos(self, route):
                    return
                tele.counter("param_server.http_requests",
                             labels={"route": route})
                raw = self.rfile.read(int(self.headers.get("Content-Length",
                                                           "0")))
                if route in ("/update", "/update.bin"):
                    binary = route == "/update.bin"
                    with self._serve_span(route, self._trace_ctx(
                            raw if binary else None)) as ssp:
                        self._serve_update(route, raw, binary, ssp)
                elif route == "/losses":
                    stop = ps.post_loss(dill.loads(raw))
                    self._send(200, dill.dumps({"stop": bool(stop)}))
                elif route == "/losses.json":
                    try:
                        loss = float(json.loads(raw)["loss"])
                    except (ValueError, KeyError, TypeError):
                        self._send(400)
                        return
                    self._send(200, json.dumps(
                        {"stop": bool(ps.post_loss(loss))}).encode(),
                        "application/json")
                else:
                    self._send(404)

        self._httpd = _KeepAliveHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        # A short poll: stop() waits out one (a fleet stops five
        # frontends, and its monitor restarts a killed one).
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        # Taken first: a chaos kill's thread and the owner may both stop
        # the frontend, and the fleet's monitor reads None as "dead".
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.close_all_connections()
            httpd.server_close()
