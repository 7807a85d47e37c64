"""Event sinks: durable JSONL output for the telemetry bus — a copy of ``sparktorch_tpu/obs/sinks.py``.

The contract every writer here honors (and the reference never did —
its only "sink" was stdout):

- parent directories are created on demand (``os.makedirs(...,
  exist_ok=True)``), so a run pointed at a fresh log directory never
  dies on the first write;
- append mode is supported (and is the default for streaming sinks),
  so multi-phase runs — warmup then measure, shuffle rounds, resumed
  jobs — accumulate records instead of clobbering earlier phases.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, Optional


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def write_jsonl(path: str, records: Iterable[Dict[str, Any]],
                append: bool = False) -> int:
    """Write records as JSON lines; returns the number written."""
    _ensure_parent(path)
    n = 0
    with open(path, "a" if append else "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> list:
    """Read a JSONL file, skipping blank and truncated lines (a killed
    run can leave a torn final line; readers must not die on it)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


class JsonlSink:
    """Streaming JSONL event sink. Thread-safe; each event is one
    flushed line, so a crashed run keeps everything up to its last
    completed event."""

    def __init__(self, path: str, append: bool = True, telemetry=None):
        _ensure_parent(path)
        self.path = path
        self._telemetry = telemetry
        self._lock = threading.Lock()
        self._f: Optional[Any] = open(path, "a" if append else "w")

    def __call__(self, event: Dict[str, Any]) -> None:
        # Serialize OUTSIDE the lock: the lock is
        # the file's writer lock — it buys line atomicity, not a
        # json.dumps of an arbitrarily large event while every other
        # emitter waits.
        line = json.dumps(event) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        """Detach from the bus (if attached) and close the file."""
        if self._telemetry is not None:
            self._telemetry.remove_sink(self)
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
