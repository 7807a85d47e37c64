"""Concurrency primitives for the parameter server — a copy of ``sparktorch_tpu/utils/locks.py:27-122``.

``RWLock`` is the reference's writer-priority reader/writer lock
(``sparktorch/rw_lock.py:11-67``). ``VersionedSlot`` holds the
server's published parameters as an immutable (version, value) pair:
a read never blocks, a swap serialises writers, and the version lets a
client that is already current skip the transfer. The value must not
be mutated once swapped in — the port's server publishes a fresh copy
of its parameters after each apply.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple


class RWLock:
    """Writer-priority reader/writer lock (rw_lock.py:11-67 parity)."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writers = 0
        self._waiting_writers = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writers > 0 or self._waiting_writers > 0:
                self._cond.wait()
            self._readers += 1

    def acquire_write(self) -> None:
        with self._cond:
            self._waiting_writers += 1
            try:
                while self._readers > 0 or self._writers > 0:
                    self._cond.wait()
            finally:
                self._waiting_writers -= 1
            self._writers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def release_write(self) -> None:
        with self._cond:
            self._writers -= 1
            self._cond.notify_all()

    # The reference exposes a single release() that infers which side
    # to release (rw_lock.py:48-67); keep it for drop-in use.
    def release(self) -> None:
        with self._cond:
            if self._writers > 0:
                self._writers -= 1
            elif self._readers > 0:
                self._readers -= 1
            self._cond.notify_all()


class VersionedSlot:
    """Lock-free-read, single-writer versioned value holder.

    The parameter server keeps its canonical params here: ``read()``
    never blocks (immutable snapshot semantics), ``swap()`` serializes
    writers. Version numbers let pull clients skip redundant transfers
    (the reference re-ships the full state_dict every iteration,
    ``hogwild.py:103`` — the central pathology §3.2 flags).
    """

    def __init__(self, value: Any = None):
        self._write_lock = threading.Lock()
        # Single attribute holding the (version, value) pair: Python
        # reference assignment is atomic, so readers can never observe
        # a torn (new_version, old_value) combination.
        self._snapshot: Tuple[int, Any] = (0, value)

    def read(self) -> Tuple[int, Any]:
        return self._snapshot

    def read_if_newer(self, have_version: int) -> Optional[Tuple[int, Any]]:
        version, value = self._snapshot
        if version > have_version:
            return version, value
        return None

    @property
    def version(self) -> int:
        return self._snapshot[0]

    def swap(self, new_value: Any) -> int:
        with self._write_lock:
            version = self._snapshot[0] + 1
            self._snapshot = (version, new_value)
            return version

    def update(self, fn) -> Tuple[int, Any]:
        """Apply ``fn(old) -> new`` atomically w.r.t. other writers."""
        with self._write_lock:
            version, value = self._snapshot
            self._snapshot = (version + 1, fn(value))
            return self._snapshot
