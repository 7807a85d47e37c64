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
Not ported yet (ROADMAP, Queue 1): the rpctrace hooks (item 10, step 4)
and the fleet's ``pull_delta`` (item 9, step 2).
"""

from __future__ import annotations

import http.client
import json
import time
import zlib
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np
import torch

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.net import wire

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


class TransportError(RuntimeError):
    """The server answered with an unexpected status, or stayed
    unreachable through every retry."""


def tree_to_host(tree: Any) -> Any:
    """Device tensors to CPU, keeping the tree: float32 and integer
    leaves as numpy arrays, bfloat16 leaves as CPU tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


class BinaryTransport:
    """Binary-wire client for one hogwild worker. Not thread-safe: each
    worker owns its transport, its connection and its residuals."""

    def __init__(self, url: str, quant: Optional[str] = "bf16",
                 telemetry=None, run_id: Optional[str] = None):
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
            {} if quant is not None else None)
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
            self._conn = http.client.HTTPConnection(self.host, self.port,
                                                    timeout=timeout)
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

    def _request(self, method: str, path: str, body=None, headers=None,
                 timeout: float = _TIMEOUT, retry_on_timeout: bool = False
                 ) -> Tuple[int, bytes]:
        """One request over the kept-alive connection, redialled with
        exponential backoff on connection-level failures. A timeout is
        retried only for an idempotent request (a pull): a timed-out
        push may have been applied, and sending it again would apply it
        twice."""
        last: Optional[BaseException] = None
        t_start = time.monotonic()
        for attempt in range(_RETRIES):
            if (attempt > 0
                    and time.monotonic() - t_start > _RECONNECT_DEADLINE):
                raise TransportError(
                    f"{method} {path}: reconnect deadline "
                    f"({_RECONNECT_DEADLINE} s) exceeded after {attempt} "
                    "attempts") from last
            conn = self._connection(timeout)
            try:
                act = _chaos.fire("transport.request", method=method,
                                  path=path, attempt=attempt)
                if act and act.get("drop"):
                    # An injected connection loss fails this attempt the
                    # way a server-closed keep-alive socket would.
                    raise ConnectionResetError("chaos: connection dropped")
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                return resp.status, resp.read()
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
            if attempt + 1 < _RETRIES:
                time.sleep(_BACKOFF_S * (2 ** attempt))
        raise TransportError(
            f"{method} {path} failed after {_RETRIES} attempts") from last

    # -- hogwild transport contract -----------------------------------------

    def pull(self, have_version: int):
        """``(version, params)`` newer than ``have_version``, or None on
        the server's 304."""
        st = self.stats
        t0 = time.perf_counter()
        status, body = self._request(
            "GET", "/parameters.bin",
            headers={"X-Have-Version": str(int(have_version))},
            timeout=_PULL_TIMEOUT, retry_on_timeout=True)
        st["pull_s"] += time.perf_counter() - t0
        st["pulls"] += 1
        if status == 304:
            return None
        if status != 200:
            raise TransportError(f"/parameters.bin -> {status}")
        st["pull_fresh"] += 1
        st["pull_bytes"] += len(body)
        tag = wire.frame_run_tag(body)
        if tag and self.run_tag and tag != self.run_tag:
            self._count("transport_run_tag_mismatches_total")
        return wire.decode(body)

    def push(self, grads) -> None:
        """Quantize (with error feedback) and POST the gradient tree.
        Copying it to the host waits for the device, so that term is
        timed apart from the wire."""
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
        status, _ = self._request(
            "POST", "/update.bin", body=buffers,
            headers={"Content-Length": str(nbytes),
                     "Content-Type": wire.CONTENT_TYPE},
            timeout=_TIMEOUT)
        if status != 200:
            raise TransportError(f"/update.bin -> {status}")
        st["push_wire_s"] += time.perf_counter() - t1
        st["push_bytes"] += nbytes
        st["pushes"] += 1

    def post_loss(self, loss: float) -> bool:
        """Early-stop vote, as JSON."""
        t0 = time.perf_counter()
        status, body = self._request(
            "POST", "/losses.json",
            body=json.dumps({"loss": float(loss)}).encode(),
            headers={"Content-Type": "application/json"},
            timeout=_TIMEOUT)
        if status != 200:
            raise TransportError(f"/losses.json -> {status}")
        self.stats["poll_s"] += time.perf_counter() - t0
        return bool(json.loads(body)["stop"])

    def alive(self) -> bool:
        status, _ = self._request("GET", "/", timeout=_TIMEOUT,
                                  retry_on_timeout=True)
        return status == 200
