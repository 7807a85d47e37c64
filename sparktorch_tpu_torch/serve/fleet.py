"""Sharded parameter-server fleet with per-tensor delta pulls — the port of ``sparktorch_tpu/serve/fleet.py``.

One process serving full-state pulls to every hogwild worker caps the
gang's pull bandwidth at one socket loop (the reference's Flask server,
``server.py:33-149``). The fleet is Li et al.'s parameter-server shape
(OSDI '14): the parameter tree hash-partitioned across N shards by
consistent hashing over leaf paths
(:class:`~sparktorch_tpu_torch.net.sharded.HashRing`), each shard an
apply loop of its own behind an HTTP frontend of its own.

Per-tensor versions make pulls deltas: a shard keeps its leaves in a
:class:`~sparktorch_tpu_torch.utils.locks.TreeVersionedSlot`, and
``GET /delta.bin`` ships only the leaves whose version advanced past the
client's ``X-Have-Version``. ``X-Pull-Quant: int8`` serves them int8,
each (leaf, version) quantized once for every puller, with a server-side
error-feedback residual folded into the leaf's next version (Lin et
al.'s Deep Gradient Compression, on the pull direction).

Live resharding: :meth:`ParamServerFleet.add_shard` and
:meth:`~ParamServerFleet.drain_shard` move only the leaves whose hash
arc changed, with their optimizer state; the ring version bumps and
clients refresh from any shard's ``/fleet.json``. A shard frontend that
dies is restarted on its old port by the fleet's monitor (counted);
clients degrade for a grace window meanwhile
(:class:`~sparktorch_tpu_torch.net.sharded.ShardedTransport`).

Legacy workers keep working: the fleet's GATEWAY is a stock
:class:`~sparktorch_tpu_torch.serve.param_server.ParamServerHttp` over a
facade that assembles the full tree across the shards, scatters pushed
gradients by ring ownership and serves the shards' deltas re-stamped
with one composite version.

On the port, a shard's leaves live on its device (CUDA unless the caller
asks for the CPU): master copies that one ``torch.optim`` optimizer per
shard steps in place, and a published copy of each leaf it applied (the
slot's snapshots never change under a reader). A push sets ``.grad`` on
the leaves it carries only, so the optimizer skips the others and each
leaf's state advances with its own pushes, as each leaf's optax state
does in the JAX package; leaves are stepped in groups of equal step
count, so a count-dependent rule (Adam's bias correction, Adafactor's
decay) sees each leaf's own count under sparse pushes too. This is exact
for element-wise rules; one that couples leaves (global-norm clipping)
would see per-shard norms, as in the JAX package: pick the single server
for those. A delta render copies a leaf to the host once per (leaf,
version) under the render lock, never the state lock, so a pull does not
wait on an apply.

Not ported yet: RPC trace contexts (``trace_ctx``; ``obs/rpctrace.py``,
ROADMAP, Queue 1, item 10, step 4) raise ``NotImplementedError``;
:func:`run_shard_server` takes a duck-typed ``ctx`` (``telemetry``,
``cancel``, ``heartbeat``), and its spawn under the ctl worker waits for
the supervisor (item 9, step 3).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sparktorch_tpu_torch.inference import _resolve_device
from sparktorch_tpu_torch.net import wire as binwire
from sparktorch_tpu_torch.net.sharded import HashRing
from sparktorch_tpu_torch.net.transport import no_trace, tree_to_host
from sparktorch_tpu_torch.obs.telemetry import Telemetry
from sparktorch_tpu_torch.serve.param_server import (
    MAX_TOLERATED_ERRORS,
    ParamServerHttp,
    as_tensor,
    build_module,
    snapshot,
)
from sparktorch_tpu_torch.utils.early_stopper import EarlyStopping
from sparktorch_tpu_torch.utils.locks import TreeVersionedSlot
from sparktorch_tpu_torch.utils.optim import flax_shapes
from sparktorch_tpu_torch.utils.serde import ModelSpec, deserialize_model

Path = Tuple[str, ...]


class ShardStopped(RuntimeError):
    """A push enqueued on a shard whose writer has exited (drained or
    failed): the caller re-routes against the current ring."""


class _LossVote:
    """The fleet-wide windowed early-stop vote (``server.py:102-123``),
    shared by every shard so they and the gateway agree on one stop."""

    def __init__(self, window_len: int = 3, patience: int = -1):
        self.window_len = max(1, window_len)
        self._stopper = (EarlyStopping(patience=patience)
                         if patience and patience > 0 else None)
        self._losses: List[float] = []
        self._stop = False
        self._lock = threading.Lock()

    def post(self, loss: float) -> bool:
        with self._lock:
            if self._stop:
                return True
            if self._stopper is None:
                return False
            self._losses.append(float(loss))
            if len(self._losses) >= self.window_len:
                avg = float(np.mean(self._losses))
                self._losses.clear()
                if self._stopper.step(avg):
                    self._stop = True
        return self._stop

    @property
    def should_stop(self) -> bool:
        return self._stop


def _numel(arr) -> int:
    return arr.numel() if isinstance(arr, torch.Tensor) else arr.size


def _render_leaf_body(owner, items, version: int, quant: Optional[str],
                      run_tag: int) -> bytes:
    """The encode tail both delta renderers (shard and gateway) share:
    int8 with server-side error feedback — each (leaf, cache_tag)
    quantized once, its residual folded into the leaf's next version —
    then one v2 frame. ``items``: (path, cache_tag, leaf_version, host
    array). The caller holds its render lock."""
    leaves: List[Tuple[Path, Any]] = []
    leaf_versions: Dict[Path, int] = {}
    for path, cache_tag, lver, arr in items:
        if quant == "int8" and binwire._is_float(arr) and _numel(arr):
            qc = owner._quant_cache.get(path)
            if qc is None or qc[0] != cache_tag:
                qleaf, residual = binwire.quantize_leaf_int8(
                    arr, owner._pull_residuals.get(path))
                owner._pull_residuals[path] = residual
                owner._quant_cache[path] = (cache_tag, qleaf)
            else:
                qleaf = qc[1]
            leaves.append((path, qleaf))
        else:
            leaves.append((path, arr))
        leaf_versions[path] = lver
    return binwire.frame_bytes(binwire.encode(
        leaves, version=version, run_tag=run_tag,
        leaf_versions=leaf_versions))


def _body_cache_get(owner, key, version: int):
    """The body cache both renderers share, with one eviction rule: a
    new version or more than 64 keys clears it. Caller holds its render
    lock."""
    if owner._bodies_version != version or len(owner._bodies) > 64:
        owner._bodies.clear()
        owner._bodies_version = version
    return owner._bodies.get(key)


def _flat_grads(grads) -> Dict[Path, Any]:
    """``{path: grad}`` from a nested tree or a ``{path-tuple: grad}``
    mapping."""
    if isinstance(grads, Mapping) and any(isinstance(k, tuple)
                                          for k in grads):
        return {tuple(p): g for p, g in grads.items()}
    return dict(binwire.flatten_tree(grads))


class ParamShardServer:
    """One fleet shard: the canonical owner of a hash range of leaves.

    ``make_optimizer(params, flax_shapes)`` builds the shard's optimizer
    (a spec's ``make_optimizer``); ``shapes`` gives Adafactor the Flax
    shape of a leaf whose layout differs (``{path: shape}``). The leaves
    live on ``device``; one writer thread applies gradient partials, and
    :meth:`render_delta` renders version-2 delta frames with per-version
    body and quantization caches, so a swarm pulling the same delta
    shares one render.

    It satisfies the :class:`ParamServerHttp` server contract (``slot``,
    ``telemetry``, ``push_gradients``, ``post_loss``), so a stock
    frontend serves it, the full-pull routes included (they ship the
    shard's part of the tree).
    """

    def __init__(self, shard_id, leaves: Mapping[Path, Any],
                 make_optimizer, device=None,
                 telemetry: Optional[Telemetry] = None,
                 loss_vote: Optional[_LossVote] = None,
                 shapes: Optional[Mapping[Path, Tuple[int, ...]]] = None):
        self.shard_id = str(shard_id)
        self.device = _resolve_device(device)
        self.telemetry = telemetry or Telemetry(
            run_id=f"param_shard_{self.shard_id}")
        self._labels = {"shard": self.shard_id}
        self._loss_vote = loss_vote or _LossVote()
        self._make_optimizer = make_optimizer
        self._opt: Optional[torch.optim.Optimizer] = None
        self._master: Dict[Path, torch.Tensor] = {}
        self._steps: Dict[Path, int] = {}  # applies that carried the leaf
        self._shapes: Dict[Path, Tuple[int, ...]] = dict(shapes or {})
        self.apply_s = 0.0  # host seconds in the writer's applies
        self._adopt({tuple(p): {"param": v} for p, v in leaves.items()})
        self.slot = TreeVersionedSlot(snapshot(self._master))

        # Render caches, all under _render_lock: host copies per (path,
        # leaf_version), int8 quantizations with their error-feedback
        # residuals, and whole delta bodies per leaf set.
        self._render_lock = threading.Lock()
        self._host_leaves: Dict[Path, Tuple[int, Any]] = {}
        self._quant_cache: Dict[Path, Tuple[int, binwire.QuantLeaf]] = {}
        self._pull_residuals: Dict[Path, np.ndarray] = {}
        self._bodies: Dict[Tuple, bytes] = {}
        self._bodies_version: Optional[int] = None

        self._state_lock = threading.Lock()
        # Orders the running check and the enqueue against stop()'s
        # drain, so no push lands on a queue nobody serves.
        self._enqueue_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._errors = 0
        self._failed: Optional[BaseException] = None
        self._applied = 0
        self._misrouted = 0
        self._running = True
        self._writer = threading.Thread(target=self._apply_loop, daemon=True)
        self._writer.start()

    def _adopt(self, entries: Mapping[Path, Mapping[str, Any]]) -> None:
        """Take leaves (with their optimizer state, step count and Flax
        shape when they migrate) into the master copies and the
        optimizer. Caller holds the state lock, or owns the shard."""
        new = []
        for path, entry in entries.items():
            value = entry["param"]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
            p = value.detach().to(self.device).clone()
            self._master[path] = p
            self._steps[path] = int(entry.get("step", 0))
            if entry.get("flax_shape") is not None:
                self._shapes[path] = tuple(entry["flax_shape"])
            new.append((path, p, entry.get("opt")))
        if not new:
            return
        shapes = {p: self._shapes[path] for path, p, _ in new
                  if path in self._shapes}
        if self._opt is None:
            self._opt = self._make_optimizer([p for _, p, _ in new], shapes)
        else:
            self._opt.param_groups[0]["params"].extend(p for _, p, _ in new)
            if shapes and hasattr(self._opt, "flax_shapes"):
                self._opt.flax_shapes.update(shapes)
        for _, p, opt_state in new:
            if opt_state:
                # Moments follow the leaf to this device; a 0-d count
                # (Adam's ``step``) stays where its optimizer keeps it.
                self._opt.state[p] = {
                    k: (v.to(self.device) if isinstance(v, torch.Tensor)
                        and v.dim() else v)
                    for k, v in opt_state.items()}

    # -- gradient path -------------------------------------------------------

    def push_gradients(self, grads, wait: bool = True,
                       timeout: float = 60.0,
                       trace_ctx=None) -> threading.Event:
        """Enqueue a gradient partial (a nested tree or ``{path: grad}``)
        for the writer thread, FIFO like the single server. Returns the
        apply's completion event either way, so a scatter can enqueue on
        every shard first and wait on them together."""
        no_trace(trace_ctx, "trace_ctx")
        if self._failed is not None:
            raise RuntimeError(
                f"param shard {self.shard_id} failed") from self._failed
        flat = _flat_grads(grads)
        done = threading.Event()
        with self._enqueue_lock:
            if not self._running:
                raise ShardStopped(f"param shard {self.shard_id} is stopped")
            self._queue.put((flat, done))
        self.telemetry.counter("param_server.pushes", labels=self._labels)
        if wait and not done.wait(timeout):
            raise TimeoutError(f"param shard {self.shard_id} apply timed out")
        return done

    def _apply(self, staged: Dict[Path, torch.Tensor]) -> bool:
        """One optimizer step per group of pushed leaves with equal step
        counts, then a published copy of each applied leaf. Caller holds
        the state lock. False when no leaf was this shard's."""
        owned = [p for p in staged if p in self._master]
        for path in staged:
            if path not in self._master:
                # Routed by a stale ring (the leaf moved): dropped and
                # counted; the client's next ring refresh fixes it.
                self._misrouted += 1
                self.telemetry.counter("fleet.misrouted_leaves_total",
                                       labels=self._labels)
        if not owned:
            return False
        groups: Dict[int, List[Path]] = {}
        for path in owned:
            groups.setdefault(self._steps[path], []).append(path)
        with torch.no_grad():
            for _count, paths in sorted(groups.items()):
                for p in self._master.values():
                    p.grad = None
                for path in paths:
                    self._master[path].grad = staged[path]
                self._opt.step()
                for path in paths:
                    self._steps[path] += 1
            for p in self._master.values():
                p.grad = None
            self.slot.swap_leaves(snapshot({p: self._master[p]
                                            for p in owned}))
        return True

    def _apply_loop(self) -> None:
        while self._running:
            try:
                flat, done = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.perf_counter()
                # Host-to-device copies before the state lock: pulls and
                # migrations never wait on a transfer.
                staged = {}
                for path, grad in flat.items():
                    like = self._master.get(path)
                    staged[path] = (as_tensor(grad, like) if like is not None
                                    else grad)
                with self._state_lock:
                    if self._apply(staged):
                        self._applied += 1
                        self.telemetry.counter("param_server.applies",
                                               labels=self._labels)
                dt = time.perf_counter() - t0
                self.apply_s += dt
                self.telemetry.observe("param_server.apply_s", dt,
                                       labels=self._labels)
                self.telemetry.gauge("param_server.version",
                                     self.slot.version, labels=self._labels)
            except Exception as e:
                self._errors += 1
                self.telemetry.counter("param_server.apply_errors",
                                       labels=self._labels)
                if self._errors > MAX_TOLERATED_ERRORS:
                    self._failed = e
                    self._running = False
            finally:
                done.set()
                self._queue.task_done()

    def drain(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while self._queue.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    @property
    def applied_updates(self) -> int:
        return self._applied

    # -- delta rendering -----------------------------------------------------

    def render_delta(self, have_version: int, quant: Optional[str] = None,
                     run_tag: int = 0) -> Tuple[int, Optional[bytes]]:
        """``(version, body)``: a v2 delta frame of every leaf whose
        version advanced past ``have_version``; ``(version, None)`` when
        the client is current (the route's 304).

        ``quant='int8'`` serves int8 leaves with server-side error
        feedback: each (leaf, version) is quantized once, so every client
        of that version gets the same bytes and the residual is spent
        once, and is added before the leaf's next version is quantized.
        """
        if quant not in (None, "", "int8"):
            raise ValueError(f"pull quant {quant!r}; use int8 or nothing")
        self.telemetry.counter("fleet.delta_pulls", labels=self._labels)
        delta = self.slot.read_delta(int(have_version))
        if delta is None:
            return self.slot.version, None
        version, entries = delta
        # Keyed by the (path, leaf_version) set, not the client's have:
        # clients at different versions usually select the same leaves
        # and share one render.
        key = (version, quant or "",
               tuple(sorted((p, v) for p, _, v in entries)))
        with self._render_lock:
            body = _body_cache_get(self, key, version)
            if body is not None:
                return version, body
            # The leaves without a host copy of their version come over
            # in one pass; a stale copy goes first, so its pinned memory
            # can serve the new one.
            stale = {}
            for path, leaf, lver in entries:
                cached = self._host_leaves.get(path)
                if cached is None or cached[0] != lver:
                    self._host_leaves.pop(path, None)
                    stale[path] = leaf
            fresh = tree_to_host(stale)
            items = []
            for path, _leaf, lver in entries:
                if path in fresh:
                    self._host_leaves[path] = (lver, fresh[path])
                items.append((path, lver, lver, self._host_leaves[path][1]))
            body = _render_leaf_body(self, items, version, quant, run_tag)
            self._bodies[key] = body
            self.telemetry.counter("fleet.delta_renders", labels=self._labels)
            return version, body

    # -- live resharding -----------------------------------------------------

    def extract(self, paths) -> Dict[Path, Dict[str, Any]]:
        """Remove ``paths`` — parameters with their optimizer state, step
        counts and Flax shapes — for migration to another shard. The
        writer applies under the same lock, so it cannot interleave."""
        with self._state_lock, self._render_lock:
            removed = self.slot.remove_leaves(paths)
            out: Dict[Path, Dict[str, Any]] = {}
            for path in removed:
                p = self._master.pop(path)
                state = self._opt.state.pop(p, None) if self._opt else None
                if self._opt is not None:
                    group = self._opt.param_groups[0]
                    group["params"] = [q for q in group["params"]
                                       if q is not p]
                    getattr(self._opt, "flax_shapes", {}).pop(p, None)
                out[path] = {"param": p, "opt": state,
                             "step": self._steps.pop(path),
                             "flax_shape": self._shapes.pop(path, None)}
                self._host_leaves.pop(path, None)
                self._quant_cache.pop(path, None)
                self._pull_residuals.pop(path, None)
            self._bodies.clear()
            self._bodies_version = None
            return out

    def install(self, entries: Mapping[Path, Mapping[str, Any]]) -> None:
        """Adopt migrated leaves, their optimizer state with them, each
        stamped with a fresh version so every delta client pulls it."""
        if not entries:
            return
        with self._state_lock:
            entries = {tuple(p): e for p, e in entries.items()}
            self._adopt(entries)
            self.slot.swap_leaves(snapshot({p: self._master[p]
                                            for p in entries}))

    # -- early stopping / lifecycle ------------------------------------------

    def post_loss(self, loss: float) -> bool:
        self.telemetry.counter("param_server.losses_posted",
                               labels=self._labels)
        return self._loss_vote.post(loss)

    @property
    def should_stop(self) -> bool:
        return self._loss_vote.should_stop

    def stop(self) -> None:
        self._running = False
        if self._writer.is_alive():
            self._writer.join(timeout=5.0)
        # Release every pusher that enqueued before the flag flipped: its
        # gradient is lost with the shard, but a waiting caller must not
        # sit out its timeout.
        with self._enqueue_lock:
            while True:
                try:
                    _flat, done = self._queue.get_nowait()
                except queue.Empty:
                    break
                done.set()
                self._queue.task_done()


# ---------------------------------------------------------------------------
# Gateway facade: the single-server wire over the whole fleet
# ---------------------------------------------------------------------------


class _CompositeSlot:
    """A read-only slot view assembling the full tree across shards. The
    composite version is the sum of the shard versions plus the fleet's
    drain offset: monotonic through applies, adds and drains, so the
    legacy ``X-Have-Version`` 204/304 logic holds."""

    def __init__(self, fleet: "ParamServerFleet"):
        self._fleet = fleet
        # The gateway delta route's boot nonce (TreeVersionedSlot.epoch).
        self.epoch = int.from_bytes(os.urandom(8), "little") >> 1

    def read(self) -> Tuple[int, Any]:
        # Under the topology lock: mid-drain the offset and the shard map
        # change in two steps, and a read between them would count the
        # drained shard twice.
        with self._fleet._topology_lock:
            version = self._fleet._version_offset
            flat: Dict[Path, Any] = {}
            for shard in self._fleet._shards.values():
                v, leaves, _ = shard.slot.read_leaves()
                version += v
                flat.update(leaves)
        return version, binwire.unflatten_tree(list(flat.items()))

    @property
    def version(self) -> int:
        with self._fleet._topology_lock:
            return self._fleet._version_offset + sum(
                s.slot.version for s in self._fleet._shards.values())


class _GatewayFacade:
    """The :class:`ParameterServer` surface :class:`ParamServerHttp`
    serves, backed by the whole fleet: pulls assemble, pushes scatter by
    ring ownership, and ``render_delta`` serves the shards' deltas as one
    frame, so a client of the single-server wire (a serving replica at
    the gateway) gets the delta bytes without speaking the ring."""

    def __init__(self, fleet: "ParamServerFleet"):
        self._fleet = fleet
        self.slot = _CompositeSlot(fleet)
        self.telemetry = fleet.telemetry
        # Shard leaf versions are independent counters, so the gateway
        # re-stamps each observed (shard, leaf_version) change with the
        # composite version at observation, and serves every leaf whose
        # composite stamp advanced past the client's have. All under
        # _render_lock.
        self._render_lock = threading.Lock()
        self._stamp: Dict[Path, Tuple[str, int]] = {}
        self._cstamp: Dict[Path, int] = {}
        self._host_leaves: Dict[Path, Tuple[Tuple[str, int], Any]] = {}
        self._quant_cache: Dict[Path, Tuple[Tuple[str, int],
                                            binwire.QuantLeaf]] = {}
        self._pull_residuals: Dict[Path, np.ndarray] = {}
        self._bodies: Dict[Tuple, bytes] = {}
        self._bodies_version: Optional[int] = None
        self._last_walk_sig: Optional[Tuple] = None

    def render_delta(self, have_version: int, quant: Optional[str] = None,
                     run_tag: int = 0) -> Tuple[int, Optional[bytes]]:
        """``(composite_version, body)``: one v2 frame of every leaf (of
        any shard) that changed past the client's composite
        ``have_version``; ``(version, None)`` when current. The shard's
        int8 and caching contract, with the gateway's own residuals. A
        composite version that moved with no leaf change (an empty shard
        drained) answers 304."""
        if quant not in (None, "", "int8"):
            raise ValueError(f"pull quant {quant!r}; use int8 or nothing")
        have = int(have_version)
        self.telemetry.counter("fleet.gateway_delta_pulls")
        with self._fleet._topology_lock:
            version = self._fleet._version_offset
            shard_reads = []
            for shard in self._fleet._shards.values():
                v, leaves, vers = shard.slot.read_leaves()
                version += v
                shard_reads.append((shard.shard_id, v, leaves, vers))
        with self._render_lock:
            # When no shard's version moved since the last walk, the
            # stamps are current: skip the walk over every leaf.
            sig = tuple(sorted((sid, v) for sid, v, _, _ in shard_reads))
            if sig != self._last_walk_sig:
                restamped = {}
                for sid, _v, leaves, vers in shard_reads:
                    for path, lver in vers.items():
                        tag = (sid, lver)
                        # An older concurrent read must never re-stamp a
                        # leaf backwards: real changes always advance the
                        # composite version.
                        if self._stamp.get(path) != tag \
                                and version > self._cstamp.get(path, -1):
                            self._stamp[path] = tag
                            self._cstamp[path] = version
                            self._host_leaves.pop(path, None)
                            restamped[path] = leaves[path]
                # The re-stamped leaves come over in one pass.
                for path, arr in tree_to_host(restamped).items():
                    self._host_leaves[path] = (self._stamp[path], arr)
                self._last_walk_sig = sig
            if have >= version:
                return version, None
            changed = [p for p, cv in self._cstamp.items() if cv > have]
            if not changed:
                return version, None
            key = (version, quant or "",
                   tuple(sorted((p, self._cstamp[p]) for p in changed)))
            body = _body_cache_get(self, key, version)
            if body is not None:
                return version, body
            items = []
            for path in changed:
                tag, arr = self._host_leaves[path]
                items.append((path, tag, self._cstamp[path], arr))
            body = _render_leaf_body(self, items, version, quant, run_tag)
            self._bodies[key] = body
            self.telemetry.counter("fleet.gateway_delta_renders")
            return version, body

    def push_gradients(self, grads, wait: bool = True,
                       timeout: float = 60.0, trace_ctx=None) -> None:
        self._fleet.scatter_push(grads, wait=wait, timeout=timeout,
                                 trace_ctx=trace_ctx)

    def post_loss(self, loss: float) -> bool:
        return self._fleet.post_loss(loss)


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


class ParamServerFleet:
    """N parameter-server shards, a gateway and a restart monitor, behind
    the driver-side surface of :class:`ParameterServer` (``model_state``,
    ``final_state``, ``should_stop``, ``applied_updates``, ``stop``), so
    ``train_async(shards=N)`` swaps it in without touching the worker
    loop.

    The fleet builds the spec's module under ``seed`` (as the single
    server does) and partitions its parameters over the ring; its
    buffers are the model state, which never changes. Shard *i* lives
    on card ``i % n_cards`` of every visible card, or on ``device`` when
    the caller names one (the CPU, or one card by index).
    """

    def __init__(self, torch_obj, n_shards: int = 2,
                 window_len: int = 3, early_stop_patience: int = -1,
                 seed: int = 0, telemetry: Optional[Telemetry] = None,
                 restart_shards: bool = True, device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.spec: ModelSpec = deserialize_model(torch_obj)
        self.telemetry = telemetry or Telemetry(run_id="param_fleet")
        dev = _resolve_device(device)
        self._devices = ([dev] if dev.type != "cuda" or dev.index is not None
                         else [torch.device("cuda", j)
                               for j in range(torch.cuda.device_count())])
        self._loss_vote = _LossVote(window_len, early_stop_patience)
        self.restart_shards = restart_shards

        # One deterministic init, the single server's, then the leaf
        # paths partitioned over the ring.
        module = build_module(self.spec, seed)
        with torch.no_grad():
            named = {n: p.detach() for n, p in module.named_parameters()}
            self._model_state = {n: b.detach().clone().to(self._devices[0])
                                 for n, b in module.named_buffers()}
        shapes = flax_shapes(module, named)
        self._flax_shapes = {(n,): shapes[p] for n, p in named.items()
                             if p in shapes}
        flat = {(n,): p for n, p in named.items()}

        self.ring = HashRing(range(n_shards))
        self.ring_version = 1
        # Keeps the gateway version monotonic across drains (a drained
        # shard's versions leave the sum).
        self._version_offset = 0
        assignment = self.ring.assignment(flat)
        self._shards: Dict[str, ParamShardServer] = {}
        for i, sid in enumerate(self.ring.shard_ids):
            self._shards[sid] = self._new_shard(
                sid, {p: flat[p] for p in assignment[sid]},
                self._devices[i % len(self._devices)])
        self.telemetry.gauge("fleet.shards", len(self._shards))

        self._https: Dict[str, ParamServerHttp] = {}
        self._gateway: Optional[ParamServerHttp] = None
        self._desired: set = set()
        self._death_noticed: Dict[str, float] = {}
        self._topology_lock = threading.RLock()
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._host = "127.0.0.1"

    def _new_shard(self, sid: str, leaves, device) -> ParamShardServer:
        return ParamShardServer(
            sid, leaves, make_optimizer=self.spec.make_optimizer,
            device=device, telemetry=self.telemetry,
            loss_vote=self._loss_vote,
            shapes={p: s for p, s in self._flax_shapes.items()
                    if p in leaves})

    # -- topology ------------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """The ``/fleet.json`` document clients build their ring from,
        served by every shard and the gateway; read under the topology
        lock, so it never pairs an old ring version with a new map."""
        with self._topology_lock:
            return {
                "run_id": self.telemetry.run_id,
                "ring_version": self.ring_version,
                "replicas": self.ring.replicas,
                "shards": self.urls(),
                "gateway": self._gateway.url if self._gateway else None,
            }

    def urls(self) -> Dict[str, str]:
        with self._topology_lock:
            return {sid: http.url for sid, http in self._https.items()}

    @property
    def gateway_url(self) -> str:
        if self._gateway is None:
            raise RuntimeError("fleet not started")
        return self._gateway.url

    def collector_targets(self, per_shard: bool = False) -> Dict[str, str]:
        """Scrape targets for a metrics collector: by default one (the
        gateway, else the first shard) — every shard of this in-process
        fleet records into one bus, so scraping each would count every
        series once a target; ``per_shard=True`` gives one a frontend."""
        with self._topology_lock:
            if per_shard:
                targets = {f"shard{sid}": url
                           for sid, url in self.urls().items()}
                if self._gateway is not None:
                    targets["gateway"] = self._gateway.url
                return targets
            if self._gateway is not None:
                return {"fleet": self._gateway.url}
            urls = self.urls()
            return {"fleet": urls[sorted(urls)[0]]}

    def _start_shard_http(self, sid: str, port: int = 0) -> ParamServerHttp:
        return ParamServerHttp(
            self._shards[sid], host=self._host, port=port, shard=sid,
            extra_json_routes={"/fleet.json": self.describe},
            ring_version_fn=lambda: self.ring_version,
        ).start()

    def start(self, host: str = "127.0.0.1", port: int = 0,
              gateway: bool = True) -> "ParamServerFleet":
        """Start every shard frontend (ephemeral ports), the gateway on
        ``port`` and the restart monitor."""
        self._host = host
        with self._topology_lock:
            for sid in self.ring.shard_ids:
                if sid not in self._https:
                    self._https[sid] = self._start_shard_http(sid)
                    self._desired.add(sid)
            if gateway and self._gateway is None:
                self._gateway = ParamServerHttp(
                    _GatewayFacade(self), host=host, port=port,
                    extra_json_routes={"/fleet.json": self.describe},
                    ring_version_fn=lambda: self.ring_version,
                ).start()
        if self.restart_shards and self._monitor is None:
            self._monitor_stop.clear()
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="fleet-monitor")
            self._monitor.start()
        return self

    def _monitor_loop(self) -> None:
        """A dead shard frontend (a chaos kill, a crashed handler) is
        restarted on its old port, counted on
        ``fleet.shard_restarts_total`` and timed on
        ``fleet.shard_recovery_latency_s``, well inside the clients'
        grace window."""
        while not self._monitor_stop.wait(0.05):
            with self._topology_lock:
                dead = [(sid, http) for sid, http in self._https.items()
                        if sid in self._desired and http._httpd is None]
            for sid, http in dead:
                self._death_noticed.setdefault(sid, time.monotonic())
                try:
                    new = self._start_shard_http(sid, port=http.port)
                except OSError:
                    continue  # the old socket is still closing: next tick
                with self._topology_lock:
                    if sid in self._desired:
                        self._https[sid] = new
                        self.telemetry.counter("fleet.shard_restarts_total",
                                               labels={"shard": sid})
                        self.telemetry.observe(
                            "fleet.shard_recovery_latency_s",
                            time.monotonic() - self._death_noticed.pop(sid))
                    else:
                        new.stop()  # drained while restarting

    def kill_shard(self, shard_id) -> None:
        """Take one shard's frontend down without draining it (what the
        ``fleet.shard`` chaos site does); the monitor restarts it."""
        self._https[str(shard_id)].stop()

    def add_shard(self, device=None) -> str:
        """Grow the ring live: a new shard joins, and only the leaves
        whose hash arc moved migrate to it, optimizer state included.
        Returns the new shard's id."""
        with self._topology_lock:
            sid = str(max((int(s) for s in self._shards), default=-1) + 1)
            shard = self._new_shard(
                sid, {}, device or self._devices[
                    len(self._shards) % len(self._devices)])
            self.ring.add(sid)
            moved: Dict[Path, Dict[str, Any]] = {}
            for other in self._shards.values():
                other.drain()
                mine = [p for p in other.slot.paths
                        if self.ring.owner(p) == sid]
                if mine:
                    moved.update(other.extract(mine))
            shard.install(moved)
            self._shards[sid] = shard
            if self._https:  # a started fleet serves the new shard now
                self._https[sid] = self._start_shard_http(sid)
                self._desired.add(sid)
            self.ring_version += 1
            self.telemetry.gauge("fleet.shards", len(self._shards))
            self.telemetry.counter("fleet.reshards_total",
                                   labels={"op": "add"})
            self.telemetry.counter("fleet.leaves_moved_total", len(moved),
                                   labels={"op": "add"})
            return sid

    def drain_shard(self, shard_id) -> int:
        """Shrink the ring live: the shard's leaves (with their optimizer
        state) move to their new owners, then the shard stops. Returns
        the number of leaves moved."""
        sid = str(shard_id)
        with self._topology_lock:
            if len(self._shards) <= 1:
                raise ValueError("cannot drain the last shard")
            shard = self._shards[sid]
            self.ring.remove(sid)
            self._desired.discard(sid)
            shard.drain()
            entries = shard.extract(shard.slot.paths)
            groups: Dict[str, Dict[Path, Any]] = {}
            for path, entry in entries.items():
                groups.setdefault(self.ring.owner(path), {})[path] = entry
            for target_sid, part in groups.items():
                self._shards[target_sid].install(part)
            # The drained shard's count leaves the sum for good.
            self._version_offset += shard.slot.version
            http = self._https.pop(sid, None)
            if http is not None:
                http.stop()
            del self._shards[sid]
            shard.stop()
            self.ring_version += 1
            self.telemetry.gauge("fleet.shards", len(self._shards))
            self.telemetry.counter("fleet.reshards_total",
                                   labels={"op": "drain"})
            self.telemetry.counter("fleet.leaves_moved_total",
                                   len(entries), labels={"op": "drain"})
            return len(entries)

    # -- driver-side ParameterServer surface ---------------------------------

    def scatter_push(self, grads, wait: bool = True,
                     timeout: float = 60.0, trace_ctx=None) -> None:
        """Split a gradient tree (nested, or ``{path: grad}``; partials
        welcome) by ring ownership and push each part to its shard,
        enqueuing on every shard before waiting on any. A shard drained
        between the ring read and the push fails fast with
        :class:`ShardStopped`, and the parts not yet landed re-route once
        against the new ring."""
        no_trace(trace_ctx, "trace_ctx")
        flat = _flat_grads(grads)
        pending = set(flat)
        events: List[Tuple[str, threading.Event]] = []
        for attempt in range(2):
            with self._topology_lock:
                groups = self.ring.assignment(pending)
                shards = dict(self._shards)
            try:
                for sid, paths in groups.items():
                    if paths:
                        events.append((sid, shards[sid].push_gradients(
                            {p: flat[p] for p in paths}, wait=False,
                            timeout=timeout)))
                        # Only landed parts leave the retry set: a blind
                        # retry would apply twice where one landed.
                        pending.difference_update(paths)
                break
            except ShardStopped:
                if attempt:
                    raise
                self.telemetry.counter("fleet.push_reroutes_total")
        if wait:
            deadline = time.monotonic() + timeout
            for sid, event in events:
                if not event.wait(max(0.0, deadline - time.monotonic())):
                    raise TimeoutError(f"param shard {sid} apply timed out")

    def post_loss(self, loss: float) -> bool:
        return self._loss_vote.post(loss)

    @property
    def should_stop(self) -> bool:
        return self._loss_vote.should_stop

    @property
    def applied_updates(self) -> int:
        with self._topology_lock:
            return sum(s.applied_updates for s in self._shards.values())

    @property
    def apply_s(self) -> float:
        """Host seconds in the shards' applies, summed."""
        with self._topology_lock:
            return sum(s.apply_s for s in self._shards.values())

    def model_state(self) -> Dict[str, torch.Tensor]:
        return self._model_state

    def drain(self, timeout: float = 30.0) -> None:
        with self._topology_lock:
            shards = list(self._shards.values())
        for shard in shards:
            shard.drain(timeout=timeout)

    def assemble(self) -> Dict[str, Any]:
        """The full parameter tree across every shard (leaves stay on
        their shards' devices)."""
        with self._topology_lock:
            shards = list(self._shards.values())
        flat: Dict[Path, Any] = {}
        for shard in shards:
            _v, leaves, _vers = shard.slot.read_leaves()
            flat.update(leaves)
        return binwire.unflatten_tree(list(flat.items()))

    def final_state(self):
        self.drain()
        return self.assemble(), self._model_state

    def stop(self) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._topology_lock:
            self._desired.clear()
            for http in self._https.values():
                http.stop()
            self._https.clear()
            if self._gateway is not None:
                self._gateway.stop()
                self._gateway = None
        for shard in self._shards.values():
            shard.stop()


# ---------------------------------------------------------------------------
# Process entry point
# ---------------------------------------------------------------------------


def run_shard_server(torch_obj, shard_id, n_shards: int, seed: int = 0,
                     host: str = "127.0.0.1", port: int = 0,
                     window_len: int = 3, early_stop_patience: int = -1,
                     heartbeat_interval_s: float = 1.0,
                     url_path: Optional[str] = None, ctx=None,
                     device=None) -> Dict[str, Any]:
    """ONE fleet shard as a process of its own.

    Determinism replaces coordination: every shard process builds the
    same module from ``(torch_obj, seed)`` and the same ring from
    ``n_shards``, then keeps its own hash range, as
    clients compute ownership from ``/fleet.json`` alone. It serves the
    stock shard frontend on ``host:port`` until ``ctx.cancel`` is set,
    then drains its queue and stops. ``url_path`` receives the bound URL
    (written atomically). ``ctx`` is duck-typed: ``telemetry``,
    ``cancel`` (an event) and ``heartbeat`` (``notify_step``, given the
    applied-update count) are each optional."""
    spec = deserialize_model(torch_obj)
    module = build_module(spec, seed)
    named = {n: p.detach() for n, p in module.named_parameters()}
    shapes = flax_shapes(module, named)
    ring = HashRing(range(int(n_shards)))
    own = ring.assignment([(n,) for n in named]).get(str(shard_id), [])
    telemetry = getattr(ctx, "telemetry", None) or Telemetry(
        run_id=f"shard_{shard_id}")
    shard = ParamShardServer(
        shard_id, {p: named[p[0]] for p in own},
        make_optimizer=spec.make_optimizer, device=device,
        telemetry=telemetry,
        loss_vote=_LossVote(window_len, early_stop_patience),
        shapes={p: shapes[named[p[0]]] for p in own
                if named[p[0]] in shapes})
    http = ParamServerHttp(shard, host=host, port=port,
                           shard=str(shard_id)).start()
    if url_path:
        tmp = url_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(http.url)
        os.replace(tmp, url_path)
    cancel = getattr(ctx, "cancel", None) or threading.Event()
    hb = getattr(ctx, "heartbeat", None)
    try:
        while not cancel.wait(heartbeat_interval_s):
            if hb is not None:
                hb.notify_step(shard.applied_updates)
    finally:
        try:
            shard.drain(timeout=10.0)
        finally:
            http.stop()
            shard.stop()
    return {"shard_id": str(shard_id), "url": http.url,
            "leaves": len(own), "applied_updates": shard.applied_updates}
