"""Persistent binary-wire client for the hogwild parameter server — the port of ``BinaryTransport`` (``sparktorch_tpu/net/transport.py:69-450``).

The reference's client opens a new TCP connection per call and ships
dill both ways. :class:`BinaryTransport` keeps one HTTP/1.1 connection
per worker (redialled with exponential backoff when it drops), pushes
:mod:`~sparktorch_tpu_torch.net.wire` frames, and pulls with
``X-Have-Version`` so a current worker gets a 304 and no parameters.
Pushes may be quantized to bfloat16 or int8, with the quantization
residual fed into the next push (error feedback).

It keeps the hogwild transport contract (``pull`` / ``push`` /
``post_loss`` / ``alive`` / ``stats``), and speaks to either package's
server. As in the JAX package, every attempt passes the
``transport.request`` chaos site (an injected drop takes the real
reconnect path), each redial counts on ``transport_reconnects_total``,
and pushes carry the run's 16-bit tag (:func:`run_tag`): a pulled frame
tagged by another run counts on ``transport_run_tag_mismatches_total``.

:meth:`BinaryTransport.pull_delta` is the sharded fleet's per-tensor
delta pull (``GET /delta.bin``, optionally int8 with the server's error
feedback): its reply carries the server slot's boot ``epoch`` and the
fleet's ``ring_version``, 304s included. :meth:`~BinaryTransport.fetch_json`
reads a small JSON control route (the fleet's ``/fleet.json``) over the
same connection. Not ported yet (ROADMAP, Queue 1, item 10, step 4): the
rpctrace hooks; a trace context (``_trace``) raises
``NotImplementedError``.
"""

from __future__ import annotations

import http.client
import json
import socket
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple, Union
from urllib.parse import urlsplit

import numpy as np
import torch

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.utils.streams import copy_stream

_TIMEOUT = 10.0        # hogwild.py:34-38 parity for push/poll
_PULL_TIMEOUT = 180.0  # full-snapshot pulls get their own deadline
_RETRIES, _BACKOFF_S = 3, 0.05  # attempts a request, first backoff
_RECONNECT_DEADLINE = 240.0  # wall-clock cap on one request's retries


def new_phase_stats() -> dict:
    """Per-transport phase accounting (seconds, bytes, counts): where a
    worker's wall time goes besides its gradient compute."""
    return {
        "pull_s": 0.0, "pull_bytes": 0, "pulls": 0, "pull_fresh": 0,
        "push_wire_s": 0.0, "push_materialize_s": 0.0,
        "push_bytes": 0, "pushes": 0,
        "poll_s": 0.0, "reconnects": 0,
    }


def run_tag(run_id: Optional[str]) -> int:
    """The 16-bit correlation tag of ``run_id`` for the wire header's
    reserved bytes (the JAX package's ``obs.collector.run_tag``): 0 is
    "untagged", so a real run id always maps to a nonzero tag."""
    if not run_id:
        return 0
    tag = zlib.crc32(str(run_id).encode()) & 0xFFFF
    return tag or 1


class _Connection(http.client.HTTPConnection):
    """An HTTP/1.1 connection with Nagle's algorithm off: a request goes
    out as several writes (headers, then each buffer), and a small last
    write would otherwise wait for the server's delayed ACK (~40 ms on
    Linux) — a stall on every small push or delta."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class TransportError(RuntimeError):
    """The server answered with an unexpected status, or stayed
    unreachable through every retry."""


def no_trace(trace, what: str = "_trace") -> None:
    """Refuse an RPC trace context: ``obs/rpctrace.py`` is not ported."""
    if trace is not None:
        raise NotImplementedError(
            f"{what}: RPC trace contexts (obs/rpctrace.py) are not ported "
            "yet (ROADMAP, Queue 1, item 10, step 4)")


def _int_header(headers: Dict[str, str], name: str) -> Optional[int]:
    """An int reply header; None when absent or garbled (an old server
    that does not send it reads as unknown, not 0)."""
    raw = headers.get(name)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def tree_to_host(tree: Any) -> Any:
    """Device tensors to CPU, keeping the tree: float32 and integer
    leaves as numpy arrays, bfloat16 leaves as CPU tensors. A card's
    leaves come over together, into pinned memory, off the card's
    current stream (:func:`~sparktorch_tpu_torch.utils.streams.copy_stream`)."""
    on_card: Dict[torch.device, list] = {}

    def collect(node) -> None:
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, torch.Tensor) and node.device.type == "cuda":
            on_card.setdefault(node.device, []).append(node)

    collect(tree)
    host: Dict[int, torch.Tensor] = {}
    for device, leaves in on_card.items():
        with copy_stream(device):
            for t in leaves:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t.detach(), non_blocking=True)
                host[id(t)] = h

    def build(node) -> Any:
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            t = host[id(node)] if id(node) in host else node.detach().cpu()
            return t if t.dtype == torch.bfloat16 else t.numpy()
        return np.asarray(node)

    return build(tree)


def _read_into(resp: http.client.HTTPResponse, into) -> memoryview:
    """``resp``'s body, read into ``into(length)``."""
    n = resp.length
    view = memoryview(into(n)).cast("B")[:n]
    got = 0
    while got < n:
        k = resp.readinto(view[got:])
        if not k:
            raise http.client.IncompleteRead(b"", n - got)
        got += k
    return view


class BinaryTransport:
    """Binary-wire client for one hogwild worker. Not thread-safe: each
    worker owns its transport, its connection and its residuals.

    ``residuals`` injects a shared path-keyed error-feedback store: the
    sharded fan-out keeps one per fleet, so a leaf that migrates between
    shards keeps its accumulated quantization noise. ``timeout``,
    ``pull_timeout``, ``retries`` and ``deadline_s`` bound a request
    (the sharded transport shrinks them to fit its grace window)."""

    def __init__(self, url: str, quant: Optional[str] = "bf16",
                 telemetry=None, run_id: Optional[str] = None,
                 timeout: float = _TIMEOUT,
                 pull_timeout: float = _PULL_TIMEOUT,
                 retries: int = _RETRIES,
                 deadline_s: Optional[float] = _RECONNECT_DEADLINE,
                 residuals: Optional[Dict[Tuple[str, ...],
                                          np.ndarray]] = None):
        parts = urlsplit(url if "//" in url else f"http://{url}")
        if parts.scheme not in ("", "http"):
            raise ValueError(f"BinaryTransport speaks http only, got {url!r}")
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or 80
        if quant not in (None, "bf16", "int8"):
            raise ValueError(f"quant {quant!r}; use None, 'bf16' or 'int8'")
        self.quant = quant
        # Error-feedback residuals, path -> np.ndarray.
        self._residuals: Optional[Dict[Tuple[str, ...], np.ndarray]] = (
            residuals if residuals is not None
            else ({} if quant is not None else None))
        self.timeout = timeout
        self.pull_timeout = pull_timeout
        self.retries = max(1, int(retries))
        self.deadline_s = deadline_s
        self.stats = new_phase_stats()
        # The bus for the reconnect and run-tag counters (the
        # process-global one, resolved at first use, when None).
        self.telemetry = telemetry
        self.run_tag = run_tag(run_id)
        self._conn: Optional[http.client.HTTPConnection] = None

    def _count(self, name: str) -> None:
        if self.telemetry is None:
            from sparktorch_tpu_torch.obs import get_telemetry

            self.telemetry = get_telemetry()
        self.telemetry.counter(name, labels={"host": self.host,
                                             "port": self.port})

    # -- connection management ---------------------------------------------

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = _Connection(self.host, self.port, timeout=timeout)
        else:
            self._conn.timeout = timeout
            if self._conn.sock is not None:
                self._conn.sock.settimeout(timeout)
        return self._conn

    def _drop_connection(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def close(self) -> None:
        self._drop_connection()

    def _request(self, method: str, path: str, body=None,
                 headers: Union[None, dict, Callable[[], dict]] = None,
                 timeout: Optional[float] = None,
                 retry_on_timeout: bool = False, into=None
                 ) -> Tuple[int, Any, Dict[str, str]]:
        """One request over the kept-alive connection, redialled with
        exponential backoff on connection-level failures; ``(status,
        body, reply headers)``. ``headers`` may be a callable, called
        again on every attempt: a retried pull must send the client's
        version as it is then, not as it was before the first attempt.
        A timeout is retried only for an idempotent request (a pull): a
        timed-out push may have been applied, and sending it again
        would apply it twice. ``into`` (``nbytes -> writable buffer``)
        receives a 200's body, which is then a memoryview of it."""
        timeout = self.timeout if timeout is None else timeout
        last: Optional[BaseException] = None
        t_start = time.monotonic()
        for attempt in range(self.retries):
            if (attempt > 0 and self.deadline_s is not None
                    and time.monotonic() - t_start > self.deadline_s):
                raise TransportError(
                    f"{method} {path}: reconnect deadline "
                    f"({self.deadline_s} s) exceeded after {attempt} "
                    "attempts") from last
            conn = self._connection(timeout)
            try:
                act = _chaos.fire("transport.request", method=method,
                                  path=path, attempt=attempt)
                if act and act.get("drop"):
                    # An injected connection loss fails this attempt the
                    # way a server-closed keep-alive socket would.
                    raise ConnectionResetError("chaos: connection dropped")
                hdrs = headers() if callable(headers) else (headers or {})
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                if into is not None and resp.status == 200 \
                        and resp.length is not None:
                    data = _read_into(resp, into)
                else:
                    data = resp.read()  # drained: the connection is reusable
                return resp.status, data, dict(resp.headers)
            except TimeoutError as e:
                self._drop_connection()
                last = e
                if not retry_on_timeout:
                    raise
            except (ConnectionError, http.client.HTTPException, OSError) as e:
                self._drop_connection()
                last = e
            self.stats["reconnects"] += 1
            self._count("transport_reconnects_total")
            if attempt + 1 < self.retries:
                time.sleep(_BACKOFF_S * (2 ** attempt))
        raise TransportError(
            f"{method} {path} failed after {self.retries} attempts") from last

    # -- hogwild transport contract -----------------------------------------

    def _check_run_tag(self, body) -> None:
        tag = wire.frame_run_tag(body)
        if tag and self.run_tag and tag != self.run_tag:
            self._count("transport_run_tag_mismatches_total")

    @staticmethod
    def _have(have_version) -> str:
        return str(int(have_version() if callable(have_version)
                       else have_version))

    def pull(self, have_version, _trace=None, into=None):
        """``(version, params)`` newer than ``have_version``, or None on
        the server's 304. ``have_version`` may be a callable, read again
        on every reconnect attempt. ``into`` (``nbytes -> writable
        buffer``) receives the body in place of a fresh bytes object:
        the arrays of ``params`` are then views of that buffer, good
        until the caller reuses it."""
        no_trace(_trace)
        st = self.stats
        t0 = time.perf_counter()
        status, body, _ = self._request(
            "GET", "/parameters.bin",
            headers=lambda: {"X-Have-Version": self._have(have_version)},
            timeout=self.pull_timeout, retry_on_timeout=True, into=into)
        st["pull_s"] += time.perf_counter() - t0
        st["pulls"] += 1
        if status == 304:
            return None
        if status != 200:
            raise TransportError(f"/parameters.bin -> {status}")
        st["pull_fresh"] += 1
        st["pull_bytes"] += len(body)
        self._check_run_tag(body)
        return wire.decode(body)

    def pull_delta(self, have_version, quant: Optional[str] = None,
                   _trace=None) -> Dict[str, Any]:
        """A per-tensor delta pull from a fleet's ``GET /delta.bin``:
        only the leaves whose version advanced past ``have_version``
        (int or callable, read again on every reconnect attempt; the
        client's last version from THIS server). ``quant='int8'`` asks
        for int8 leaves with the server's error feedback; they come
        back dequantized.

        Returns a dict: ``fresh`` (False on a 304), ``version``,
        ``leaves`` (``{path: array}``), ``leaf_versions``, ``nbytes``,
        and what every reply carries: ``epoch`` (the server slot's boot
        nonce; a change means its state was rebuilt and the client must
        pull again from -1) and ``ring_version`` (bumped when a shard is
        added or drained; a change means the shard map moved)."""
        no_trace(_trace)
        st = self.stats
        t0 = time.perf_counter()

        def headers() -> Dict[str, str]:
            h = {"X-Have-Version": self._have(have_version)}
            if quant:
                h["X-Pull-Quant"] = quant
            return h

        status, body, rhdrs = self._request(
            "GET", "/delta.bin", headers=headers,
            timeout=self.pull_timeout, retry_on_timeout=True)
        st["pull_s"] += time.perf_counter() - t0
        st["pulls"] += 1
        out: Dict[str, Any] = {
            "fresh": False, "version": None, "leaves": {},
            "leaf_versions": {}, "nbytes": 0,
            "epoch": _int_header(rhdrs, "X-Slot-Epoch"),
            "ring_version": _int_header(rhdrs, "X-Ring-Version"),
        }
        if status == 304:
            return out
        if status != 200:
            raise TransportError(f"/delta.bin -> {status}")
        st["pull_fresh"] += 1
        st["pull_bytes"] += len(body)
        self._check_run_tag(body)
        version, leaves, leaf_versions = wire.decode_delta(body)
        out.update(fresh=True, version=version, leaves=leaves,
                   leaf_versions=leaf_versions, nbytes=len(body))
        return out

    def fetch_json(self, path: str, timeout: Optional[float] = None) -> Any:
        """GET and parse a small JSON control route (``/fleet.json``)
        over the same connection and retries as the data wire."""
        status, body, _ = self._request("GET", path, timeout=timeout,
                                        retry_on_timeout=True)
        if status != 200:
            raise TransportError(f"{path} -> {status}")
        try:
            return json.loads(body)
        except ValueError as e:
            raise TransportError(f"{path}: invalid JSON: {e}") from e

    def push(self, grads, _trace=None) -> None:
        """Quantize (with error feedback) and POST the gradient tree.
        Copying it to the host waits for the device, so that term is
        timed apart from the wire."""
        no_trace(_trace)
        st = self.stats
        t0 = time.perf_counter()
        host = tree_to_host(grads)
        if self.quant is not None:
            leaves, _ = wire.quantize_tree(host, self.quant, self._residuals)
        else:
            leaves = wire.flatten_tree(host)
        buffers = wire.encode(leaves, run_tag=self.run_tag)
        nbytes = wire.frame_nbytes(buffers)
        t1 = time.perf_counter()
        st["push_materialize_s"] += t1 - t0
        # The buffer list, not an iterator: a retry re-sends it.
        status, _, _ = self._request(
            "POST", "/update.bin", body=buffers,
            headers={"Content-Length": str(nbytes),
                     "Content-Type": wire.CONTENT_TYPE})
        if status != 200:
            raise TransportError(f"/update.bin -> {status}")
        st["push_wire_s"] += time.perf_counter() - t1
        st["push_bytes"] += nbytes
        st["pushes"] += 1

    def post_loss(self, loss: float) -> bool:
        """Early-stop vote, as JSON."""
        t0 = time.perf_counter()
        status, body, _ = self._request(
            "POST", "/losses.json",
            body=json.dumps({"loss": float(loss)}).encode(),
            headers={"Content-Type": "application/json"})
        if status != 200:
            raise TransportError(f"/losses.json -> {status}")
        self.stats["poll_s"] += time.perf_counter() - t0
        return bool(json.loads(body)["stop"])

    def alive(self) -> bool:
        status, _, _ = self._request("GET", "/", retry_on_timeout=True)
        return status == 200
