"""Client-side scatter/gather over a sharded parameter-server fleet — the port of ``sparktorch_tpu/net/sharded.py``.

One hogwild server caps the gang's pull bandwidth at one socket loop
however many workers train. The fleet (Li et al., OSDI '14;
:mod:`sparktorch_tpu_torch.serve.fleet`) hash-partitions the parameter
tree across N shard servers and every worker talks to all of them. This
module is the client half:

- :class:`HashRing` — consistent hashing of leaf paths (md5 points, 64
  virtual nodes a shard), shared by the fleet, so both sides compute the
  same owner for every tensor from the shard ids alone, and the JAX
  package's owner for the same path. Adding or draining a shard remaps
  only ~1/N of the keys.
- :class:`ShardedTransport` — the hogwild transport contract (``pull`` /
  ``push`` / ``post_loss`` / ``alive`` / ``stats``) over one
  :class:`~sparktorch_tpu_torch.net.transport.BinaryTransport` a shard.
  Pulls are per-tensor DELTA requests (``/delta.bin``; int8 with the
  server's error feedback on ``pull_quant='int8'``) merged into a
  client-side leaf cache and reassembled into the full tree; pushes are
  split by ring ownership and scattered, with the push error-feedback
  residuals kept per leaf at this level, so a leaf that moves to another
  shard keeps them.
- Degradation: a shard that stops answering freezes its leaves at the
  cached values and loses its gradient partials (counted) for a grace
  window; only a shard dead past the window fails the worker. The
  fleet's monitor restarts a dead frontend well inside it.
- Topology refresh: every delta reply carries ``X-Ring-Version``; a newer
  one makes the client fetch ``/fleet.json`` again, so workers learn of
  an add or a drain within one pull.

The port's trees are flat ``state_dict`` names, so a leaf's path is
``(name,)``. Each pull and push is one RPC trace root
(:mod:`~sparktorch_tpu_torch.obs.rpctrace`) with a ``shard_pull`` or
``shard_push`` child per shard hop; the shards' transports only
propagate its context.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.net.transport import (
    BinaryTransport,
    TransportError,
    new_phase_stats,
    tree_to_host,
)

Path = Tuple[str, ...]

RING_REPLICAS = 64  # virtual nodes per shard: evens out the md5 arcs


def _hash64(token: str) -> int:
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashing of leaf paths onto shard ids.

    Deterministic across processes (md5, not the salted builtin
    ``hash``), so a fleet and every remote client agree on ownership from
    the shard-id list alone. ``replicas`` virtual points per shard keep
    the arcs even; an add or a remove moves only the keys on the changed
    arcs.
    """

    def __init__(self, shard_ids=(), replicas: int = RING_REPLICAS):
        self.replicas = int(replicas)
        self._points: List[Tuple[int, str]] = []  # sorted (hash, sid)
        self._ids: List[str] = []
        for sid in shard_ids:
            self.add(sid)

    def add(self, shard_id) -> None:
        sid = str(shard_id)
        if sid in self._ids:
            raise ValueError(f"shard {sid!r} already on the ring")
        self._ids.append(sid)
        for i in range(self.replicas):
            bisect.insort(self._points, (_hash64(f"{sid}#{i}"), sid))

    def remove(self, shard_id) -> None:
        sid = str(shard_id)
        if sid not in self._ids:
            raise ValueError(f"shard {sid!r} not on the ring")
        self._ids.remove(sid)
        self._points = [p for p in self._points if p[1] != sid]

    @property
    def shard_ids(self) -> List[str]:
        return list(self._ids)

    def owner(self, path: Path) -> str:
        """The shard owning ``path``: the first ring point clockwise of
        the key's hash."""
        if not self._points:
            raise ValueError("empty ring")
        h = _hash64("/".join(path))
        i = bisect.bisect_right(self._points, (h, "\uffff"))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def assignment(self, paths) -> Dict[str, List[Path]]:
        """``{shard_id: [paths]}``, every shard present, even when it
        owns nothing."""
        out: Dict[str, List[Path]] = {sid: [] for sid in self._ids}
        for path in paths:
            out[self.owner(tuple(path))].append(tuple(path))
        return out


class StaticFleetView:
    """A fixed shard map, for clients of a fleet that never reshapes."""

    def __init__(self, shards: Mapping[Any, str],
                 replicas: int = RING_REPLICAS):
        self._doc = {
            "ring_version": 1,
            "replicas": int(replicas),
            "shards": {str(s): url for s, url in shards.items()},
        }

    def describe(self) -> Dict[str, Any]:
        return self._doc


class HttpFleetView:
    """The fleet's topology from any shard's (or the gateway's)
    ``/fleet.json``: how a remote worker finds the shards."""

    def __init__(self, url: str, timeout: float = 5.0):
        self._transport = BinaryTransport(url, quant=None, timeout=timeout)

    def describe(self) -> Dict[str, Any]:
        return self._transport.fetch_json("/fleet.json")

    def close(self) -> None:
        self._transport.close()


class _ShardClient:
    __slots__ = ("sid", "transport", "have", "epoch", "first_fail",
                 "synced")

    def __init__(self, sid: str, transport: BinaryTransport):
        self.sid = sid
        self.transport = transport
        self.have = -1                    # last version pulled from it
        self.epoch: Optional[int] = None  # its slot's boot nonce
        self.first_fail: Optional[float] = None  # degrade-window start
        # True once its leaves have reached the cache: not derivable
        # from ``have``, which an epoch resync resets to -1 while the
        # cache stays whole.
        self.synced = False


class ShardedTransport:
    """Scatter/gather hogwild transport over a parameter-server fleet.

    Worker-owned like :class:`BinaryTransport` (its connections,
    residuals and leaf cache); the fan-out threads touch disjoint shards
    and disjoint cache keys, so only the shared counters take a lock.

    ``fleet`` is anything with ``describe() ->`` the ``/fleet.json``
    document (a :class:`~sparktorch_tpu_torch.serve.fleet.ParamServerFleet`
    in process, an :class:`HttpFleetView`, a :class:`StaticFleetView`).
    ``quant`` compresses pushes (bf16 by default, or int8, with error
    feedback); ``pull_quant='int8'`` asks for int8 delta pulls with the
    server's error feedback. ``grace_s`` bounds how long a dead shard
    degrades the worker before it fails it. Requests fan out to the
    shards on a thread pool, so the shards render and send at once
    (``wire_costs.py`` times it against one shard after another).
    :meth:`close` shuts the pool and the connections.
    """

    def __init__(self, fleet, quant: Optional[str] = "bf16",
                 pull_quant: Optional[str] = None, grace_s: float = 30.0,
                 telemetry=None, run_id: Optional[str] = None,
                 **transport_kwargs):
        if pull_quant not in (None, "int8"):
            raise ValueError(f"pull_quant {pull_quant!r}; use None or 'int8'")
        self._fleet = fleet
        self.quant = quant
        self.pull_quant = pull_quant
        self.grace_s = float(grace_s)
        self.telemetry = telemetry
        self.run_id = run_id
        # A dead shard must fail inside the grace window, socket timeouts
        # included (the reconnect deadline is checked between attempts
        # only); the deadline stays above one pull's timeout.
        transport_kwargs.setdefault("retries", 2)
        transport_kwargs.setdefault("pull_timeout", max(1.0, grace_s / 3))
        transport_kwargs.setdefault("timeout",
                                    min(10.0, max(1.0, grace_s / 3)))
        transport_kwargs.setdefault("deadline_s", max(1.0, grace_s / 2))
        self._transport_kwargs = transport_kwargs
        self._clients: Dict[str, _ShardClient] = {}
        self._ring: Optional[HashRing] = None
        self._ring_version = -1
        # One push-residual store for the whole fleet, keyed by leaf path
        # and shared by every shard's transport: residuals follow the
        # leaf, not the shard.
        self._push_residuals: Optional[Dict[Path, np.ndarray]] = (
            {} if quant is not None else None)
        self._leaves: Dict[Path, Any] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        self._own = self._fresh_own()
        self._own_lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._refresh()

    # -- stats (the hogwild budget contract) ---------------------------------

    @staticmethod
    def _fresh_own() -> dict:
        st = new_phase_stats()
        st.update({"shards": 0, "shard_failures": 0, "pushes_skipped": 0,
                   "delta_leaves": 0})
        return st

    @property
    def stats(self) -> dict:
        """Fan-out wall times measured here (the per-shard walls would
        overstate parallel time); bytes and redials summed over the
        shards' transports."""
        out = dict(self._own)
        out["shards"] = len(self._clients)
        for c in self._clients.values():
            ct = c.transport.stats
            out["pull_bytes"] += ct.get("pull_bytes", 0)
            out["push_bytes"] += ct.get("push_bytes", 0)
            out["reconnects"] += ct.get("reconnects", 0)
        return out

    @stats.setter
    def stats(self, value) -> None:
        # The worker loop installs fresh stats each round: reset the
        # shards' too, so bytes are not counted twice.
        self._own = self._fresh_own()
        for c in self._clients.values():
            c.transport.stats = new_phase_stats()

    # -- topology ------------------------------------------------------------

    def _refresh(self) -> None:
        """(Re)build the ring and the per-shard clients from the fleet's
        document. Existing clients (connections, have-versions) stay;
        removed shards' close."""
        with self._refresh_lock:
            doc = self._fleet.describe()
            version = int(doc.get("ring_version", 0))
            if version == self._ring_version and self._clients:
                return
            shards = {str(s): u for s, u in (doc.get("shards") or {}).items()}
            ring = HashRing(replicas=int(doc.get("replicas", RING_REPLICAS)))
            for sid in shards:
                ring.add(sid)
            for sid in list(self._clients):
                if sid not in shards:
                    self._clients.pop(sid).transport.close()
            for sid, url in shards.items():
                if sid not in self._clients:
                    self._clients[sid] = _ShardClient(sid, BinaryTransport(
                        url, quant=self.quant, telemetry=self.telemetry, run_id=self.run_id,
                        residuals=self._push_residuals,
                        **self._transport_kwargs))
            self._ring = ring
            self._ring_version = version
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None

    def _fan(self, fn, items: list) -> list:
        """``fn`` over the shards at once, one pool thread a shard."""
        if len(items) <= 1:
            return [fn(item) for item in items]
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=max(1, len(self._clients)),
                thread_name_prefix="sharded-transport")
        return list(self._executor.map(fn, items))

    def _count(self, name: str, labels: Optional[dict] = None) -> None:
        if self.telemetry is not None:
            self.telemetry.counter(name, labels=labels or {})

    def _tracer(self):
        """This transport's tracer (the worker bus's), resolved once, so
        the fan-out threads do not contend on the registry's lock. The
        fan-out owns the request's root span."""
        tracer = getattr(self, "_tracer_cached", None)
        if tracer is None:
            from sparktorch_tpu_torch.obs.rpctrace import tracer_for

            tracer = self._tracer_cached = tracer_for(self.telemetry)
        return tracer

    # -- fault degradation ---------------------------------------------------

    def _degrade(self, client: _ShardClient, exc: BaseException,
                 op: str) -> None:
        """A shard failed one operation: degrade inside the grace window,
        fail the worker past it; counted either way."""
        now = time.monotonic()
        if client.first_fail is None:
            client.first_fail = now
        with self._own_lock:
            self._own["shard_failures"] += 1
        self._count("sharded_shard_failures_total",
                    {"shard": client.sid, "op": op})
        if now - client.first_fail > self.grace_s:
            raise TransportError(
                f"shard {client.sid} dead past the {self.grace_s}s grace "
                f"window ({op})") from exc

    # -- hogwild transport contract -----------------------------------------

    def pull(self, have_version):
        """Fan a delta pull over every shard, merge the advanced leaves
        into the cache, and return ``(version, tree)`` when anything
        moved, None when every shard answered 304. The version is the sum
        of the shards' (what the worker hands back; the real freshness
        state is per shard). A caller starting from scratch
        (``have_version < 0``) gets the cached tree even on all-304s."""
        st = self._own
        t0 = time.perf_counter()
        clients = list(self._clients.values())
        with self._tracer().root_span("pull", kind="client",
                                      shards=len(clients)) as root:
            results = self._fan(
                lambda c: self._pull_shard(c, root.ctx), clients)
        st["pull_s"] += time.perf_counter() - t0
        st["pulls"] += 1
        fresh = any(r and r.get("fresh") for r in results)
        ring_versions = [r["ring_version"] for r in results
                         if r and r.get("ring_version") is not None]
        if ring_versions and max(ring_versions) > self._ring_version:
            self._refresh()
        version = sum(c.have for c in self._clients.values() if c.have > 0)
        if not fresh and not (not callable(have_version)
                              and int(have_version) < 0 and self._leaves):
            return None
        st["pull_fresh"] += 1
        return version, wire.unflatten_tree(list(self._leaves.items()))

    def _pull_shard(self, client: _ShardClient,
                    trace_parent=None) -> Optional[dict]:
        # The client-side hop latency: where a straggling shard shows.
        hop_t0 = time.perf_counter()
        try:
            return self._pull_shard_inner(client, trace_parent)
        finally:
            if self.telemetry is not None:
                self.telemetry.observe("sharded.shard_pull_latency_s",
                                       time.perf_counter() - hop_t0,
                                       labels={"shard": client.sid})

    def _pull_shard_inner(self, client: _ShardClient,
                          trace_parent=None) -> Optional[dict]:
        with self._tracer().child_span("shard_pull", trace_parent,
                                       kind="client",
                                       shard=client.sid) as tsp:
            # The root's context when this hop does not record: the
            # shard's transport then carries the root's sampling
            # decision on, in place of minting a root a shard.
            hop_ctx = tsp.ctx or trace_parent
            try:
                res = client.transport.pull_delta(lambda: client.have,
                                                  quant=self.pull_quant,
                                                  _trace=hop_ctx)
                epoch = res.get("epoch")
                if (epoch is not None and client.epoch is not None
                        and epoch != client.epoch):
                    # The shard's slot was rebuilt: its versions
                    # restarted, so ours mean nothing there — pull all
                    # again from -1.
                    client.have = -1
                    self._count("sharded_epoch_resyncs_total",
                                {"shard": client.sid})
                    res = client.transport.pull_delta(
                        lambda: client.have, quant=self.pull_quant,
                        _trace=hop_ctx)
                    epoch = res.get("epoch")
                if epoch is not None:
                    client.epoch = epoch
            except (TransportError, wire.WireError, OSError) as e:
                tsp.set_error(e)
                if not client.synced:
                    # No cached leaves to freeze: a partial tree would
                    # fail the worker somewhere less clear. Fail the
                    # pull.
                    raise TransportError(
                        f"shard {client.sid} unreachable before its first "
                        "sync — no cached leaves to degrade to") from e
                self._degrade(client, e, "pull")
                # The hop stays in the trace, closed in error and
                # marked degraded.
                tsp.annotate(degraded=True)
                return None
            client.first_fail = None
            if res.get("fresh"):
                client.have = int(res["version"])
                client.synced = True
                with self._own_lock:
                    self._own["delta_leaves"] += len(res["leaves"])
                # Disjoint keys per shard: concurrent merges never
                # collide.
                self._leaves.update(res["leaves"])
            return res

    def push(self, grads) -> None:
        """Split the gradient tree by ring ownership and push each part to
        its shard. A shard inside its grace window loses its part
        (counted), as hogwild tolerates a lost gradient."""
        st = self._own
        t0 = time.perf_counter()
        flat = dict(wire.flatten_tree(tree_to_host(grads)))
        groups = self._ring.assignment(flat)
        t1 = time.perf_counter()
        st["push_materialize_s"] += t1 - t0

        def push_one(item, trace_parent=None) -> None:
            sid, paths = item
            if not paths:
                return
            client = self._clients[sid]
            with self._tracer().child_span("shard_push", trace_parent,
                                           kind="client", shard=sid) as tsp:
                try:
                    # The root's context when this hop does not record,
                    # as in _pull_shard_inner.
                    client.transport.push(
                        wire.unflatten_tree([(p, flat[p]) for p in paths]),
                        _trace=tsp.ctx or trace_parent)
                    client.first_fail = None
                except (TransportError, wire.WireError, OSError) as e:
                    tsp.set_error(e)
                    tsp.annotate(degraded=True)
                    with self._own_lock:
                        self._own["pushes_skipped"] += 1
                    self._count("sharded_pushes_skipped_total",
                                {"shard": sid})
                    self._degrade(client, e, "push")

        with self._tracer().root_span("push", kind="client",
                                      shards=len(self._clients)) as root:
            self._fan(lambda item: push_one(item, root.ctx),
                      list(groups.items()))
        st["push_wire_s"] += time.perf_counter() - t1
        st["pushes"] += 1

    def post_loss(self, loss: float) -> bool:
        """Early-stop vote on the lowest-id shard that answers (every
        shard shares the fleet's vote); False when none can take it."""
        t0 = time.perf_counter()
        out = False
        for sid in sorted(self._clients):
            client = self._clients[sid]
            try:
                out = client.transport.post_loss(loss)
                client.first_fail = None
                break
            except (TransportError, OSError) as e:
                self._degrade(client, e, "post_loss")
        self._own["poll_s"] += time.perf_counter() - t0
        return out

    def alive(self) -> bool:
        self._refresh()
        for client in self._clients.values():
            try:
                if client.transport.alive():
                    return True
            except (TransportError, OSError):
                continue
        return False

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        for client in self._clients.values():
            client.transport.close()
