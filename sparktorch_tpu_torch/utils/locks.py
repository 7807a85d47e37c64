"""Concurrency primitives for the parameter server — a copy of ``sparktorch_tpu/utils/locks.py``.

``RWLock`` is the reference's writer-priority reader/writer lock
(``sparktorch/rw_lock.py:11-67``). ``VersionedSlot`` holds the
server's published parameters as an immutable (version, value) pair:
a read never blocks, a swap serialises writers, and the version lets a
client that is already current skip the transfer. The value must not
be mutated once swapped in — the port's server publishes a fresh copy
of its parameters after each apply.

:class:`TreeVersionedSlot` keeps a version tag per leaf beside the
global one: the substrate of the fleet's delta pulls (a shard answers
"every leaf that advanced past the client's version" by comparing
integers). Its ``epoch`` is a random nonce minted per slot, so a client
detects a rebuilt server by an epoch change, never by version
arithmetic.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple


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


# ---------------------------------------------------------------------------
# Per-leaf versioning (the delta-pull substrate)
# ---------------------------------------------------------------------------

Path = Tuple[str, ...]


def _flatten_value(value: Any) -> Dict[Path, Any]:
    """``{path: leaf}`` from a nested tree (or a bare leaf at ())."""
    flat: Dict[Path, Any] = {}

    def walk(node: Any, prefix: Path) -> None:
        if isinstance(node, Mapping):
            for k in node:
                walk(node[k], prefix + (str(k),))
        else:
            flat[prefix] = node

    walk(value, ())
    return flat


def _unflatten(leaves: Mapping[Path, Any]) -> Any:
    """Nested dict from ``{path: leaf}`` (local twin of
    ``net.wire.unflatten_tree``, kept here so utils/ stays import-free
    of the wire layer)."""
    if len(leaves) == 1 and () in leaves:
        return leaves[()]
    tree: Dict[str, Any] = {}
    for path, value in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


class TreeVersionedSlot(VersionedSlot):
    """A :class:`VersionedSlot` whose value is a tensor TREE with a
    version tag per LEAF beside the global version.

    This is the server half of delta pulls: ``swap_leaves`` installs
    new values for a subset of paths and stamps exactly those leaves
    with the new global version, so ``read_delta(have)`` answers
    "every leaf that advanced past ``have``" by comparing integers,
    never by diffing tensors. A whole-tree ``swap`` keeps working
    (every leaf re-stamped — the conservative answer).

    ``epoch`` is a random nonce minted at construction and carried on
    every delta reply: a RESTARTED server (fresh slot, version counter
    reset to 0) is detected by epoch mismatch, not by version
    arithmetic — without it, a client holding version N would read the
    fresh server's ``0 <= N`` as "nothing newer" forever and silently
    train on stale weights.

    Reads stay lock-free: the (version, leaves, leaf_versions) triple
    lives in ONE attribute assigned atomically, so a reader can never
    observe new values with old version tags.
    """

    def __init__(self, leaves: Optional[Mapping[Path, Any]] = None,
                 epoch: Optional[int] = None):
        super().__init__(None)
        self.epoch = (int(epoch) if epoch is not None
                      else int.from_bytes(os.urandom(8), "little") >> 1)
        flat: Dict[Path, Any] = dict(leaves or {})
        vers: Dict[Path, int] = {p: 0 for p in flat}
        # (version, {path: leaf}, {path: leaf_version}) — one atomic ref.
        self._delta: Tuple[int, Dict[Path, Any], Dict[Path, int]] = (
            0, flat, vers
        )
        self._snapshot = (0, _unflatten(flat) if flat else {})

    # -- reads (lock-free) -------------------------------------------------

    def read_leaves(self) -> Tuple[int, Dict[Path, Any], Dict[Path, int]]:
        """``(version, {path: leaf}, {path: leaf_version})`` — one
        coherent snapshot."""
        return self._delta

    def read_delta(
        self, have_version: int
    ) -> Optional[Tuple[int, List[Tuple[Path, Any, int]]]]:
        """``(version, [(path, leaf, leaf_version), ...])`` for every
        leaf whose version advanced past ``have_version``; None when
        the client is up to date (the 304 answer)."""
        version, flat, vers = self._delta
        if version <= have_version:
            return None
        return version, [
            (p, flat[p], vers[p]) for p in flat if vers[p] > have_version
        ]

    @property
    def paths(self) -> List[Path]:
        return list(self._delta[1])

    # -- writes (single-writer) --------------------------------------------

    def _commit(self, flat: Dict[Path, Any], vers: Dict[Path, int],
                version: int) -> int:
        # Order matters for the lock-free readers of the LEGACY
        # surface: the nested snapshot is derived first, then both
        # attributes are swapped — each is individually coherent.
        self._delta = (version, flat, vers)
        self._snapshot = (version, _unflatten(flat) if flat else {})
        return version

    def swap_leaves(self, updates: Mapping[Path, Any]) -> int:
        """Install new values for ``updates``' paths; exactly those
        leaves (new paths included) get the bumped global version."""
        with self._write_lock:
            version, flat, vers = self._delta
            version += 1
            flat = dict(flat)
            vers = dict(vers)
            for path, value in updates.items():
                flat[tuple(path)] = value
                vers[tuple(path)] = version
            return self._commit(flat, vers, version)

    def remove_leaves(self, paths: Iterable[Path]) -> Dict[Path, Any]:
        """Drop leaves (a shard draining them to a new owner). Bumps
        the global version so whole-tree pullers refresh; removed
        paths simply stop appearing in deltas."""
        with self._write_lock:
            version, flat, vers = self._delta
            flat = dict(flat)
            vers = dict(vers)
            removed: Dict[Path, Any] = {}
            for path in list(paths):
                path = tuple(path)
                if path in flat:
                    removed[path] = flat.pop(path)
                    vers.pop(path, None)
            if removed:
                self._commit(flat, vers, version + 1)
            return removed

    def swap(self, new_value: Any) -> int:
        """Whole-tree replacement: every leaf of ``new_value`` is
        re-stamped with the new version (the legacy single-version
        contract, kept so a TreeVersionedSlot drops in anywhere a
        VersionedSlot did)."""
        flat = _flatten_value(new_value)
        with self._write_lock:
            version = self._delta[0] + 1
            vers = {p: version for p in flat}
            return self._commit(flat, vers, version)

    def update(self, fn) -> Tuple[int, Any]:
        """Atomic ``fn(old_tree) -> new_tree`` (the inherited
        VersionedSlot contract). Overridden because the base version
        writes only ``_snapshot`` — it would silently desync the
        per-leaf ``_delta`` state the delta wire serves from. Every
        leaf of the result is re-stamped (the conservative answer, as
        with :meth:`swap`)."""
        with self._write_lock:
            _version, tree = self._snapshot
            flat = _flatten_value(fn(tree))
            version = self._delta[0] + 1
            self._commit(flat, {p: version for p in flat}, version)
            return self._snapshot
