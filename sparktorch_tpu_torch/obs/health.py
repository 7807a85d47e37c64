"""The model-facing observability lane — the port of ``sparktorch_tpu/obs/health.py``.

The rest of the obs stack judges the *system* (goodput buckets, SLO
alerts, the stack profiler); this module judges the *model*: is the
training run numerically healthy, and when it is not, which batch
poisoned it. Three pieces:

- :class:`TrainHealthLedger` — a per-rank ledger every trainer feeds
  each step with a small metrics vector (loss, global grad norm,
  update/param-norm ratio, finite bit, per-leaf grad norms) computed on
  the device by :func:`~sparktorch_tpu_torch.train.step.train_step`.
  Values are queued as device tensors and read back **``fetch_lag``
  steps late**, so ``note_step`` never waits for the step it was
  handed; the delayed read-back seconds go to the goodput ledger as
  ``data_wait{site=health}`` rather than hiding inside compute.

- Anomaly detectors run on the host at ingest: a NaN/Inf sentinel, a
  loss-spike check against a reset-aware EWMA, a grad-norm explosion
  check, and a stalled-loss plateau check. Detections publish
  ``health.anomaly{akind=...}`` flag gauges, bump
  ``health.anomalies_total`` and emit ``health.anomaly`` events; the
  latched :class:`~sparktorch_tpu_torch.obs.alerts.AlertRule` s of
  :func:`health_alert_rules` ride the ordinary alert path.

- On a NaN or spike the ledger writes a **replay bundle**: the
  offending batch, the pre-step state anchor (the module's
  ``state_dict`` and the optimizer's state), the step number and a
  checksum, such that ``python -m sparktorch_tpu_torch.obs.replay``
  re-runs that step in a fresh process and reproduces the bad numerics
  bitwise (:mod:`sparktorch_tpu_torch.obs.replay`). ``optimizer.step()``
  updates in place, so the pre-step state is gone after dispatch: the
  ledger keeps a cadence of *pre-dispatch host anchors*
  (``note_replay_anchor``, every ``replay_anchor_every`` steps and on
  every batch change) and pairs the newest anchor at or before the bad
  step with the recorded batch.

What differs from the JAX package: a state anchor is a mapping of
dotted names to tensors (:func:`trainer_state`, the port's
``model.<name>`` and ``optim.<index>.<key>`` leaves, in insertion
order, where JAX flattens its pytree in sorted-key order); bfloat16
leaves travel as int16 bit patterns; :func:`health_leaf_keys` names the
module's trainable parameters in the order of the step's gradient
list; the bundle also records the process's deterministic settings
(:func:`determinism_settings`), which the replay applies. A note lands
in an inbox that the ledger settles every READ_BATCH notes (and before
anything reads it), reading the entries that fell due meanwhile in one
copy: an anomaly keeps the JAX ledger's ``detect_lag`` (counted from
the note its entry fell due at) and adds ``ingest_lag``, counted from
the last note made when it was really ingested (up to READ_BATCH - 1
notes more; a publish, every ``publish_interval_s``, settles).

Per-rank docs publish under the ``health`` telemetry section (a
composite ``{"ranks": {rank: doc}}`` so hogwild's many workers share
one bus); the fleet collector merges scraped sections with
:func:`merge_sections` into ``GET /health`` — rank-tagged, never
averaged across ranks.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import weakref
import zlib
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs.alerts import AlertRule
from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.telemetry import (
    Telemetry,
    get_telemetry,
    wall_ts,
)

_LOG = get_logger("sparktorch_tpu_torch.obs.health")

SECTION = "health"
RUN_SECTION = "health_run"

ENV_GATE = "SPARKTORCH_TPU_HEALTH"

#: Detector kinds, in severity order. ``nonfinite`` and ``loss_spike``
#: arm the replay-bundle writer; ``plateau`` is informational.
ANOMALY_KINDS = ("nonfinite", "loss_spike", "grad_explosion", "plateau")

#: Goodput site label for every device->host readback this lane does
#: (the delayed fetch AND the pre-dispatch replay anchors) — satellite
#: requirement: the lane's own cost is attributed, never invisible.
GOODPUT_SITE = "health"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector and fetch knobs (README "Model health" documents each).

    ``fetch_lag`` is K from the tentpole contract: a step's device
    values are only materialised once K *newer* steps have been noted,
    so the readback never blocks the dispatch it belongs to."""

    fetch_lag: int = 2
    ewma_alpha: float = 0.25
    warmup_steps: int = 5
    spike_factor: float = 3.0
    spike_min_delta: float = 0.25
    explode_factor: float = 10.0
    plateau_window: int = 32
    plateau_rel_delta: float = 1e-5
    flag_window: int = 8
    series_window: int = 64
    top_k: int = 3
    max_anomalies: int = 64
    publish_interval_s: float = 0.25
    # Replay arming: None disables bundles entirely.
    replay_dir: Optional[str] = None
    replay_anchor_every: int = 8
    replay_max_bundles: int = 4
    replay_builder: Optional[str] = None
    replay_builder_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)


# Per-bus ledger registry so many ledgers on ONE bus (hogwild: one per
# worker) publish a single composite section instead of clobbering
# each other. Weak-valued: entries die with their ledgers; a live
# ledger strongly references its bus, so id(bus) cannot be recycled
# while its entry is alive.
_REGISTRY: "weakref.WeakValueDictionary[Tuple[int, str], TrainHealthLedger]" \
    = weakref.WeakValueDictionary()
_REG_LOCK = threading.Lock()


def _finite(v: Any) -> bool:
    try:
        return bool(np.isfinite(v))
    except (TypeError, ValueError):
        return False


def _f(v: Any) -> Optional[float]:
    if v is None:
        return None
    try:
        return float(np.asarray(v).reshape(-1)[0]) if np.ndim(v) else float(v)
    except (TypeError, ValueError, IndexError):
        return None


def float_bits(v: Any) -> int:
    """The exact float32 bit pattern of ``v`` as an int — the unit of
    the bitwise replay contract (NaN payloads compare equal by bits
    where ``==`` never can)."""
    return int(np.asarray(v, dtype=np.float32).reshape(()).view(np.uint32))


def _is_tensor(x: Any) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "dtype") \
        and hasattr(x, "device")


def _leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of mappings (insertion order), tuples and
    lists, tensors and arrays."""
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaf_to_host(leaf: Any) -> np.ndarray:
    """Host copy of one leaf: a tensor as numpy, bfloat16 as its int16
    bit pattern (numpy has no bfloat16; replay views it back over the
    builder's template dtype)."""
    if _is_tensor(leaf):
        import torch

        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        # A CPU tensor's numpy view shares its memory: copy, since the
        # optimizer updates the live tensor in place.
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    return np.asarray(leaf)


def tree_to_host(tree: Any) -> Any:
    """Host copy of every leaf of ``tree``, as :func:`_leaf_to_host`.
    A card's leaves come over together: each is copied into pinned
    memory without blocking, then one wait on the current stream."""
    cuda = [leaf for leaf in _leaves(tree)
            if _is_tensor(leaf) and leaf.device.type == "cuda"]
    if not cuda:
        return _map(_leaf_to_host, tree)
    import torch

    staged = {}
    for t in cuda:
        src = t.detach()
        if src.dtype == torch.bfloat16:
            src = src.view(torch.int16)
        h = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        h.copy_(src, non_blocking=True)
        staged[id(t)] = h
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return _map(lambda leaf: (staged[id(leaf)].numpy() if id(leaf) in staged
                              else _leaf_to_host(leaf)), tree)


def tree_checksum(tree: Any) -> str:
    """CRC32 over every leaf's dtype/shape/bytes — the cheap param
    checksum stamped into replay bundles so a replay against drifted
    params fails loudly instead of 'reproducing' something else."""
    crc = 0
    for leaf in _leaves(tree):
        a = _leaf_to_host(leaf)
        crc = zlib.crc32(str((a.shape, str(a.dtype))).encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def health_leaf_keys(module: Any) -> List[str]:
    """Dotted names of ``module``'s trainable parameters, in the order
    of the step's gradient list and so of the per-leaf grad-norm vector
    (``module.parameters()`` order: registration, not sorted)."""
    return [name for name, p in module.named_parameters()
            if p.requires_grad]


def trainer_state(module: Any, optimizer: Any) -> Dict[str, Any]:
    """A trainer's state as one flat mapping of live tensors (no copy):
    ``model.<name>`` for each ``state_dict`` entry, then
    ``optim.<index>.<key>`` for each tensor of the optimizer's
    per-parameter state, ``index`` counting parameters across the
    param groups as ``optimizer.state_dict()`` does."""
    out: Dict[str, Any] = {f"model.{k}": v
                           for k, v in module.state_dict().items()}
    i = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key, v in optimizer.state.get(p, {}).items():
                if _is_tensor(v):
                    out[f"optim.{i}.{key}"] = v
            i += 1
    return out


def load_trainer_state(module: Any, optimizer: Any,
                       state: Mapping[str, Any]) -> None:
    """Load a :func:`trainer_state` mapping (tensors or host arrays) into
    ``module`` and ``optimizer``, bit for bit."""
    import torch

    def tensor(a: Any, like: Any) -> Any:
        t = a if _is_tensor(a) else torch.from_numpy(np.asarray(a))
        if like is not None and like.dtype == torch.bfloat16 \
                and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        return t

    own = module.state_dict()
    model = {k[len("model."):]: v for k, v in state.items()
             if k.startswith("model.")}
    module.load_state_dict({k: tensor(v, own.get(k))
                            for k, v in model.items()})
    params = [p for g in optimizer.param_groups for p in g["params"]]
    per: Dict[int, Dict[str, Any]] = {}
    for k, v in state.items():
        if k.startswith("optim."):
            _, idx, key = k.split(".", 2)
            per.setdefault(int(idx), {})[key] = tensor(v, params[int(idx)])
    sd = optimizer.state_dict()
    sd["state"] = per
    optimizer.load_state_dict(sd)


def determinism_settings() -> Dict[str, Any]:
    """The process settings that decide which kernels PyTorch and cuBLAS
    pick, and so the bits of a step: deterministic algorithms (and
    warn-only), ``CUBLAS_WORKSPACE_CONFIG``, cuDNN's flags and the TF32
    switches. A replay bundle records them; the replay applies them."""
    import torch

    return {
        "use_deterministic_algorithms":
            torch.are_deterministic_algorithms_enabled(),
        "warn_only": torch.is_deterministic_algorithms_warn_only_enabled(),
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def apply_determinism_settings(settings: Mapping[str, Any]) -> None:
    """Apply :func:`determinism_settings` output to this process. Call
    before the first CUDA call (cuBLAS reads its workspace setting at
    its initialisation)."""
    import torch

    ws = settings.get("cublas_workspace_config")
    if ws is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = str(ws)
    torch.use_deterministic_algorithms(
        bool(settings.get("use_deterministic_algorithms", False)),
        warn_only=bool(settings.get("warn_only", False)))
    torch.backends.cudnn.deterministic = bool(
        settings.get("cudnn_deterministic", False))
    torch.backends.cudnn.benchmark = bool(
        settings.get("cudnn_benchmark", False))
    torch.backends.cuda.matmul.allow_tf32 = bool(
        settings.get("matmul_allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(
        settings.get("cudnn_allow_tf32", True))
    torch.set_float32_matmul_precision(
        settings.get("float32_matmul_precision", "highest"))


def _read_device(device: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Host copies of a step's device values: the card's tensors come
    back in one read (stacked by shape and dtype, concatenated as
    float32 on the card), anything else through numpy. A value that
    cannot be read becomes NaN."""
    out: Dict[str, np.ndarray] = {}
    groups: Dict[Tuple[Tuple[int, ...], Any], List[Any]] = {}
    for k, v in device.items():
        if _is_tensor(v) and v.device.type == "cuda":
            groups.setdefault((tuple(v.shape), v.dtype), []).append(k)
    if groups:
        import torch

        flat = [torch.stack([device[k] for k in keys]).detach().reshape(-1)
                .float() for keys in groups.values()]
        flat = (flat[0] if len(flat) == 1 else torch.cat(flat)).cpu().numpy()
        off = 0
        for (shape, _dtype), keys in groups.items():
            n = int(np.prod(shape, dtype=np.int64))
            for k in keys:
                out[k] = flat[off:off + n].reshape(shape)
                off += n
    for k, v in device.items():
        if k in out:
            continue
        try:
            # By value (bfloat16 too), and a copy: a host tensor's numpy
            # view shares the live tensor's memory.
            out[k] = v.detach().float().cpu().numpy().copy() \
                if _is_tensor(v) else np.asarray(v)
        except Exception:  # noqa: BLE001 — a poisoned value
            out[k] = np.asarray(np.nan)
    return out


def _read_many(devices: Sequence[Mapping[str, Any]]
               ) -> List[Dict[str, np.ndarray]]:
    """:func:`_read_device` over several entries' device values at once:
    the card's tensors of all of them come back in one copy."""
    merged = {(j, k): v for j, device in enumerate(devices)
              for k, v in device.items()}
    out: List[Dict[str, np.ndarray]] = [{} for _ in devices]
    for (j, k), v in _read_device(merged).items():
        out[j][k] = v
    return out


#: Notes a ledger's inbox collects before it is settled: the entries
#: that fell due meanwhile are read back in one copy (one wait for the
#: card, one goodput span) and ingested in note order.
READ_BATCH = 8


class TrainHealthLedger:
    """Per-rank model-health ledger. Thread-safe; one per trainer rank
    (or per hogwild worker) on a shared bus.

    Feed it with :meth:`note_step` (device values stay un-synced until
    ``fetch_lag`` newer steps arrive), arm replay with
    ``config.replay_dir`` + :meth:`note_replay_anchor`, and call
    :meth:`flush` when the loop ends so the tail of the queue is
    ingested and the section reflects the final step."""

    def __init__(self, rank: Any = 0,
                 config: Optional[HealthConfig] = None,
                 telemetry: Optional[Telemetry] = None,
                 leaf_keys: Optional[Sequence[str]] = None) -> None:
        self.rank = rank
        self.config = config or HealthConfig()
        self.telemetry = telemetry or get_telemetry()
        self.leaf_keys = list(leaf_keys) if leaf_keys else None
        self._lock = threading.RLock()
        self._queue: deque = deque()
        self._next_step = 0
        self._last_note_step = -1
        self._last_ingest_step = -1
        self._n_ingested = 0
        self._series: deque = deque(maxlen=max(8, self.config.series_window))
        self._ewma_loss: Optional[float] = None
        self._ewma_gnorm: Optional[float] = None
        self._warm = 0
        self._plateau_ring: deque = deque(
            maxlen=max(2, self.config.plateau_window))
        self._in_plateau = False
        self._last: Dict[str, Any] = {}
        self._top_leaves: List[Tuple[str, float]] = []
        self._anomalies: deque = deque(maxlen=max(8,
                                                  self.config.max_anomalies))
        self._counts: Dict[str, int] = {}
        self._last_flag: Dict[str, int] = {}
        self._anchors: deque = deque(maxlen=4)
        self._bundles: List[str] = []
        self._last_publish = 0.0
        # note_step's throttle: the wall time of the next due publish.
        self._publish_at = 0.0 if self.telemetry is not None else math.inf
        self._started_ts = wall_ts()
        # Notes land in _inbox and are settled every READ_BATCH notes
        # and before anything reads the ledger. _noted is the note an
        # entry fell due at, which is what an anomaly's detect_lag is
        # measured from (its ingest_lag, from the notes made when it is
        # really ingested: _noted_now).
        self._noted = -1
        self._inbox: deque = deque()
        with _REG_LOCK:
            _REGISTRY[(id(self.telemetry), str(rank))] = self

    # -- feeding -------------------------------------------------------

    def note_step(self, step: Optional[int] = None, count: int = 1,
                  device: Optional[Mapping[str, Any]] = None,
                  host: Optional[Mapping[str, Any]] = None) -> None:
        """Queue one step's (or a fused chunk of ``count`` steps')
        health values. ``device`` values are tensors left on the card
        — scalars for ``count == 1``, stacked on axis 0 for a chunk;
        ``host`` values are already-synced floats/rows the
        trainer fetched anyway (loss it logs, etc.). Never forces a
        sync for the steps being noted; ingest of queued entries only
        happens once they are ``fetch_lag`` notes old.

        The note itself only lands in an inbox; the ledger settles the
        inbox (numbers the steps, queues and ingests what fell due, as
        if each note had done it) every READ_BATCH notes and before
        anything reads it (``snapshot``, ``publish``, ``flush``,
        ``reset``, a replay anchor)."""
        inbox = self._inbox
        inbox.append((step, count, dict(device) if device else {},
                      dict(host) if host else {}))
        if len(inbox) >= READ_BATCH:
            with self._lock:
                self._settle_locked()
        # The publish throttle, inline: most notes end here.
        if wall_ts() >= self._publish_at:
            self.publish()

    def note_replay_anchor(self, state: Any, batch: Any,
                           rng: Any = None) -> None:
        """Record a pre-dispatch host snapshot of ``(state, batch)``
        for the step about to be noted. ``optimizer.step()`` updates in
        place, so this is the ONLY moment the pre-step state exists;
        the cadence (``replay_anchor_every``) bounds the cost, and a
        batch-identity change (a new chunk, a poisoned copy) always
        re-anchors so the recorded batch is the one actually
        dispatched. ``state`` is a :func:`trainer_state` mapping, or a
        callable returning one (called only when an anchor is due).
        No-op unless ``config.replay_dir`` is set."""
        cfg = self.config
        if not cfg.replay_dir:
            return
        # Every earlier note ingests before the anchor list changes, as
        # when each note drained inline.
        self._settle()
        with self._lock:
            step = self._next_step
            last = self._anchors[-1] if self._anchors else None
            due = (last is None
                   or step - last["step"] >= max(1, cfg.replay_anchor_every)
                   or last["batch_id"] != id(batch))
            if not due:
                return
        if callable(state):
            state = state()
        with _goodput.span("data_wait", {"site": GOODPUT_SITE}):
            state_host = tree_to_host(state)
            batch_host = tree_to_host(tuple(batch))
            rng_host = None if rng is None else _leaf_to_host(rng)
        with self._lock:
            self._anchors.append({
                "step": step, "state": state_host, "batch": batch_host,
                "rng": rng_host, "batch_id": id(batch),
            })

    def flush(self) -> None:
        """Drain every queued entry (end of the loop: nothing newer is
        coming, so the lag contract no longer applies) and force a
        publish so the section carries the final step."""
        with self._lock:
            self._settle_locked()
            due: List[tuple] = []
            self._drain_locked(final=True, into=due)
            self._ingest_due(due)
        self.publish(force=True)

    def reset(self) -> None:
        """Reset-aware restart point: a checkpoint restore or an
        elastic resize re-bases the EWMAs and the plateau ring so the
        first post-restart losses are not judged against a stale
        baseline (the classic restart false-spike)."""
        self._settle()
        with self._lock:
            self._ewma_loss = None
            self._ewma_gnorm = None
            self._warm = 0
            self._plateau_ring.clear()
            self._in_plateau = False

    # -- delayed fetch -------------------------------------------------

    def _settle_locked(self) -> None:
        """Take the inbox's notes in order, each as ``note_step`` once
        handled it (number its steps, queue it, take what fell due),
        then read what fell due in one copy and ingest it in order."""
        inbox = self._inbox
        due: List[tuple] = []
        while inbox:
            step, count, device, host = inbox.popleft()
            count = max(1, int(count))
            start = self._next_step if step is None else int(step)
            self._next_step = start + count
            self._last_note_step = self._next_step - 1
            self._queue.append((start, count, device, host))
            self._drain_locked(final=False, into=due)
        self._ingest_due(due)

    def _settle(self) -> None:
        """Settle the inbox: afterwards the ledger holds every note as
        if each had drained inline."""
        with self._lock:
            self._settle_locked()

    def _drain_locked(self, final: bool, into: List[tuple]) -> None:
        lag = max(0, self.config.fetch_lag)
        while self._queue:
            start, count, device, host = self._queue[0]
            if not final and self._last_note_step - (start + count - 1) < lag:
                break
            self._queue.popleft()
            into.append((start, count, device, host, self._last_note_step))

    def _ingest_due(self, due: Sequence[tuple]) -> None:
        if not due:
            return
        devices = [entry[2] for entry in due]
        fetched: List[Dict[str, np.ndarray]] = [{} for _ in due]
        if any(devices):
            # The one device sync this lane ever does: the entries are
            # fetch_lag notes old, read back together and attributed.
            with _goodput.span("data_wait", {"site": GOODPUT_SITE}):
                fetched = _read_many(devices)
        for (start, count, _device, host, noted), got in zip(due, fetched):
            for name, val in host.items():
                got.setdefault(name, np.asarray(val))
            self._noted = noted
            for j in range(count):
                self._ingest_row(start + j, count, j, got)

    def _noted_now(self) -> int:
        """The last step the trainer has noted, the inbox's included."""
        last = self._last_note_step
        for step, count, _device, _host in list(self._inbox):
            count = max(1, int(count))
            last = last + count if step is None else int(step) + count - 1
        return last

    @staticmethod
    def _row(arr: np.ndarray, count: int, j: int) -> np.ndarray:
        if count > 1 and arr.ndim >= 1 and arr.shape[0] >= count:
            return arr[j]
        return arr

    def _ingest_row(self, step: int, count: int, j: int,
                    fetched: Mapping[str, np.ndarray]) -> None:
        cfg = self.config
        vals: Dict[str, Optional[float]] = {}
        for name in ("loss", "grad_norm", "update_ratio", "finite"):
            if name in fetched:
                vals[name] = _f(self._row(fetched[name], count, j))
        leaf = fetched.get("leaf_norms")
        if leaf is not None:
            leaf = np.asarray(self._row(leaf, count, j)).reshape(-1)
        self._n_ingested += 1
        self._last_ingest_step = step
        loss, gnorm = vals.get("loss"), vals.get("grad_norm")
        finite_bit = vals.get("finite")
        self._series.append((step,
                             loss if loss is not None else float("nan"),
                             gnorm if gnorm is not None else float("nan")))
        self._last = {k: v for k, v in vals.items() if v is not None}
        self._last["step"] = step
        if leaf is not None and leaf.size:
            k = min(max(1, cfg.top_k), leaf.size)
            idx = np.argsort(leaf)[::-1][:k]
            keys = self.leaf_keys or []
            self._top_leaves = [
                (keys[i] if i < len(keys) else f"leaf{i}", float(leaf[i]))
                for i in idx]

        # -- detectors (host-side, on K-late values) -------------------
        bad = ((finite_bit is not None and finite_bit < 0.5)
               or (loss is not None and not _finite(loss))
               or (gnorm is not None and not _finite(gnorm))
               or (leaf is not None and leaf.size
                   and not bool(np.all(np.isfinite(leaf)))))
        if bad:
            self._anomaly("nonfinite", step, loss if loss is not None
                          else gnorm, None, vals)
            return  # a poisoned row must not feed the EWMAs
        a = cfg.ewma_alpha
        if loss is not None:
            if self._ewma_loss is not None and self._warm >= cfg.warmup_steps:
                limit = (self._ewma_loss * cfg.spike_factor
                         + cfg.spike_min_delta)
                if loss > limit:
                    self._anomaly("loss_spike", step, loss, limit, vals)
            self._ewma_loss = (loss if self._ewma_loss is None
                               else (1 - a) * self._ewma_loss + a * loss)
            self._plateau_ring.append(loss)
            ring = self._plateau_ring
            if len(ring) == ring.maxlen:
                lo, hi = min(ring), max(ring)
                mean = sum(ring) / len(ring)
                flat = (hi - lo) <= cfg.plateau_rel_delta * max(
                    abs(mean), 1e-9)
                if flat and not self._in_plateau:
                    self._in_plateau = True
                    self._anomaly("plateau", step, loss, None, vals)
                elif not flat:
                    self._in_plateau = False
        if gnorm is not None:
            if (self._ewma_gnorm is not None
                    and self._warm >= cfg.warmup_steps):
                limit = self._ewma_gnorm * cfg.explode_factor + 1e-6
                if gnorm > limit:
                    self._anomaly("grad_explosion", step, gnorm, limit, vals)
            self._ewma_gnorm = (gnorm if self._ewma_gnorm is None
                                else (1 - a) * self._ewma_gnorm + a * gnorm)
        self._warm += 1

    # -- anomalies & replay bundles ------------------------------------

    def _anomaly(self, akind: str, step: int, value: Optional[float],
                 threshold: Optional[float],
                 vals: Mapping[str, Optional[float]]) -> None:
        lag = max(0, self._noted - step)
        ingest_lag = max(lag, self._noted_now() - step)
        rec = {
            "akind": akind, "step": step, "rank": str(self.rank),
            "value": value, "threshold": threshold, "detect_lag": lag,
            "ingest_lag": ingest_lag, "ts": wall_ts(),
        }
        self._anomalies.append(rec)
        self._counts[akind] = self._counts.get(akind, 0) + 1
        self._last_flag[akind] = step
        tele = self.telemetry
        if tele is not None:
            tele.counter("health.anomalies_total", 1,
                         labels={"akind": akind, "rank": str(self.rank)})
            tele.event("health.anomaly", akind=akind, step=step,
                       value=value, lag=lag, ingest_lag=ingest_lag,
                       ledger_rank=str(self.rank))
        _LOG.warning("health anomaly %s at step %s (rank %s): value=%s",
                     akind, step, self.rank, value)
        if akind in ("nonfinite", "loss_spike"):
            try:
                self._write_bundle_locked(rec, vals)
            except Exception as exc:  # noqa: BLE001 — never kill training
                _LOG.warning("replay bundle write failed: %s", exc)

    def _write_bundle_locked(self, rec: Mapping[str, Any],
                             vals: Mapping[str, Optional[float]]) -> None:
        cfg = self.config
        if not cfg.replay_dir or len(self._bundles) >= cfg.replay_max_bundles:
            return
        step = int(rec["step"])
        anchor = None
        for cand in reversed(self._anchors):
            if cand["step"] <= step:
                anchor = cand
                break
        if anchor is None:
            return
        os.makedirs(cfg.replay_dir, exist_ok=True)
        base = f"replay_step{step:06d}_r{self.rank}"
        meta_path = os.path.join(cfg.replay_dir, base + ".json")
        npz_path = os.path.join(cfg.replay_dir, base + ".npz")
        if os.path.exists(meta_path):
            return
        state = anchor["state"]
        state_keys = (list(state) if isinstance(state, Mapping) else None)
        state_leaves = _leaves(state)
        batch_leaves = _leaves(anchor["batch"])
        arrays = {f"state_{i}": np.asarray(a)
                  for i, a in enumerate(state_leaves)}
        arrays.update({f"batch_{i}": np.asarray(a)
                       for i, a in enumerate(batch_leaves)})
        if anchor.get("rng") is not None:
            arrays["rng"] = np.asarray(anchor["rng"])
        bad = {name: {"value": v, "bits": float_bits(v), "dtype": "float32"}
               for name, v in vals.items() if v is not None}
        meta = {
            "kind": "health_replay", "schema": 1,
            "step": step, "anchor_step": int(anchor["step"]),
            "rank": str(self.rank), "akind": rec["akind"],
            "ts": wall_ts(),
            "param_checksum": tree_checksum(anchor["state"]),
            "builder": cfg.replay_builder,
            "builder_kwargs": dict(cfg.replay_builder_kwargs or {}),
            "bad": bad,
            "npz": os.path.basename(npz_path),
            "n_state_leaves": len(state_leaves),
            "n_batch_leaves": len(batch_leaves),
            "has_rng": anchor.get("rng") is not None,
            "state_keys": state_keys,
            "deterministic": determinism_settings(),
        }
        np.savez(npz_path + ".tmp.npz", **arrays)
        os.replace(npz_path + ".tmp.npz", npz_path)
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)
        self._bundles.append(meta_path)
        if self.telemetry is not None:
            self.telemetry.event("health.replay_bundle", path=meta_path,
                                 step=step, akind=rec["akind"],
                                 anchor_step=int(anchor["step"]),
                                 ledger_rank=str(self.rank))
        _LOG.warning("health replay bundle written: %s", meta_path)

    # -- publishing ----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """This rank's health doc (the unit :func:`merge_sections`
        merges). Cheap; safe from any thread."""
        self._settle()
        with self._lock:
            steps = [s for s, _, _ in self._series]
            cfg = self.config
            doc = {
                "rank": str(self.rank),
                "ts": wall_ts(),
                "started_ts": self._started_ts,
                "steps_ingested": self._n_ingested,
                "last_step": self._last_ingest_step,
                "noted_step": self._last_note_step,
                "pending_fetch": len(self._queue),
                "fetch_lag": cfg.fetch_lag,
                "series": {
                    "steps": steps,
                    "loss": [ls for _, ls, _ in self._series],
                    "grad_norm": [g for _, _, g in self._series],
                },
                "last": dict(self._last),
                "ewma": {"loss": self._ewma_loss,
                         "grad_norm": self._ewma_gnorm},
                "top_grad_leaves": [[k, v] for k, v in self._top_leaves],
                "anomalies": [dict(a) for a in self._anomalies],
                "counts": dict(self._counts),
                "config": {
                    "spike_factor": cfg.spike_factor,
                    "explode_factor": cfg.explode_factor,
                    "plateau_window": cfg.plateau_window,
                    "warmup_steps": cfg.warmup_steps,
                },
            }
            if cfg.replay_dir:
                doc["replay"] = {
                    "dir": cfg.replay_dir,
                    "bundles": list(self._bundles),
                    "anchor_step": (self._anchors[-1]["step"]
                                    if self._anchors else None),
                }
            return doc

    def _flags(self) -> Dict[str, float]:
        with self._lock:
            window = max(1, self.config.flag_window)
            out = {}
            for akind in ANOMALY_KINDS:
                at = self._last_flag.get(akind)
                out[akind] = (1.0 if at is not None
                              and self._last_ingest_step - at < window
                              else 0.0)
            return out

    def publish(self, force: bool = False) -> None:
        """Throttled: push gauges + the composite ``health`` section
        (this ledger plus every peer ledger registered on the same
        bus) so hogwild workers co-publish instead of clobbering."""
        tele = self.telemetry
        if tele is None:
            return
        now = wall_ts()
        with self._lock:
            if not force and (now - self._last_publish
                              < self.config.publish_interval_s):
                return
            self._last_publish = now
            self._publish_at = now + self.config.publish_interval_s
        doc = self.snapshot()
        labels = {"rank": str(self.rank)}
        last = doc["last"]
        for name in ("loss", "grad_norm", "update_ratio", "finite"):
            if last.get(name) is not None:
                v = last[name]
                tele.gauge(f"health.{name}",
                           v if _finite(v) else float("nan"), labels=labels)
        tele.gauge("health.last_step", float(doc["last_step"]),
                   labels=labels)
        tele.gauge("health.pending_fetch", float(doc["pending_fetch"]),
                   labels=labels)
        for akind, flag in self._flags().items():
            tele.gauge("health.anomaly", flag,
                       labels={"akind": akind, "rank": str(self.rank)})
        with _REG_LOCK:
            peers = {r: led for (tid, r), led in list(_REGISTRY.items())
                     if tid == id(tele)}
        # Upsert into the published section rather than rebuilding it
        # from live peers: a finished worker's ledger is only weakly
        # registered, so its final doc must survive on the bus after
        # the thread (and the ledger) are gone — the last rank to
        # flush publishes the WHOLE gang's last-known docs.
        ranks: Dict[str, Any] = {}
        prev_sec = tele.get_section(SECTION) \
            if hasattr(tele, "get_section") else None
        if isinstance(prev_sec, Mapping):
            prev_ranks = prev_sec.get("ranks")
            if isinstance(prev_ranks, Mapping):
                ranks.update({str(r): d for r, d in prev_ranks.items()
                              if isinstance(d, Mapping)})
        for r, led in peers.items():
            if led is not self:
                ranks[r] = led.snapshot()
        ranks[str(self.rank)] = doc
        tele.set_section(SECTION, {"ts": now, "ranks": ranks})


# ---------------------------------------------------------------------------
# Merging (collector tier)
# ---------------------------------------------------------------------------

def _expand(rank_docs: Mapping[Any, Mapping[str, Any]]
            ) -> Dict[str, Mapping[str, Any]]:
    """Flatten scraped sections — each a composite ``{"ranks": ...}``
    or a bare single-rank doc — into one rank->doc map. Inner rank
    tags win; a collision across processes is disambiguated with the
    process rank prefix, never silently merged."""
    per_rank: Dict[str, Mapping[str, Any]] = {}
    for proc, sec in rank_docs.items():
        if not isinstance(sec, Mapping):
            continue
        inner = sec.get("ranks")
        items = (inner.items() if isinstance(inner, Mapping)
                 else [(sec.get("rank", proc), sec)])
        for r, doc in items:
            if not isinstance(doc, Mapping):
                continue
            key = str(r)
            if key in per_rank:
                key = f"{proc}/{r}"
            per_rank[key] = doc
    return per_rank


def merge_sections(rank_docs: Mapping[Any, Mapping[str, Any]]
                   ) -> Dict[str, Any]:
    """Merge per-rank health docs into the run-level ``health_run``
    doc served at ``GET /health``. Anomalies stay **rank-tagged** and
    loss series are **never averaged across ranks** — a NaN on one
    rank must surface as that rank's NaN, not dissolve into a healthy
    fleet mean."""
    per_rank = _expand(rank_docs)
    anomalies: List[Dict[str, Any]] = []
    counts: Dict[str, int] = {}
    last_by_rank: Dict[str, Any] = {}
    steps_total = 0
    last_step = -1
    for r, doc in per_rank.items():
        for a in doc.get("anomalies") or []:
            tagged = dict(a)
            tagged.setdefault("rank", r)
            anomalies.append(tagged)
        for k, n in (doc.get("counts") or {}).items():
            counts[k] = counts.get(k, 0) + int(n)
        steps_total += int(doc.get("steps_ingested") or 0)
        last_step = max(last_step, int(doc.get("last_step", -1)))
        last = dict(doc.get("last") or {})
        last_by_rank[r] = last
    anomalies.sort(key=lambda a: (a.get("ts") or 0, a.get("step") or 0))
    worst = anomalies[-1] if anomalies else None
    return {
        "kind": "health_run",
        "ts": wall_ts(),
        "n_ranks": len(per_rank),
        "steps_total": steps_total,
        "last_step": last_step,
        "anomalies": anomalies[-128:],
        "anomalies_total": sum(counts.values()),
        "counts": counts,
        "worst": worst,
        "last_by_rank": last_by_rank,
        "per_rank": per_rank,
    }


def sections_from_snapshots(snapshots: Mapping[Any, Optional[Mapping]]
                            ) -> Dict[Any, Mapping[str, Any]]:
    """Pull each scraped rank's ``health`` section out of its full
    telemetry snapshot (collector helper, mirrors goodput's)."""
    out: Dict[Any, Mapping[str, Any]] = {}
    for rank, snap in snapshots.items():
        if not isinstance(snap, Mapping):
            continue
        sec = (snap.get("sections") or {}).get(SECTION)
        if isinstance(sec, Mapping):
            out[rank] = sec
    return out


def health_alert_rules(severity: str = "critical") -> List[AlertRule]:
    """Latched threshold rules over the ``health.anomaly`` flag
    gauges, one per detector. Register them on the fleet
    AlertManager and they ride the ordinary alert path — including
    the ``ctl.scale_signal`` subscribers ("is the training *worth*
    scaling")."""
    rules = []
    for akind in ANOMALY_KINDS:
        rules.append(AlertRule(
            name=f"health_{akind}",
            metric="health.anomaly",
            labels={"akind": akind},
            kind="threshold",
            op=">",
            threshold=0.5,
            severity="warning" if akind == "plateau" else severity,
        ))
    return rules


# ---------------------------------------------------------------------------
# Ambient (process-global) ledger
# ---------------------------------------------------------------------------

_ACTIVE: Optional[TrainHealthLedger] = None
_ACTIVE_LOCK = threading.Lock()


def enabled() -> bool:
    return os.environ.get(ENV_GATE, "1").lower() not in (
        "0", "false", "no", "off")


def ensure(telemetry: Optional[Telemetry] = None, rank: Any = None,
           config: Optional[HealthConfig] = None
           ) -> Optional[TrainHealthLedger]:
    """The trainers' install point, called next to wherever they
    install their goodput ledger: return the ambient health ledger,
    creating a fresh one when none exists or when the caller brings a
    different bus (a new run must not inherit the previous run's EWMA
    baselines). Returns None when ``SPARKTORCH_TPU_HEALTH=0``."""
    global _ACTIVE
    if not enabled():
        return None
    with _ACTIVE_LOCK:
        led = _ACTIVE
        fresh = (led is None
                 or (telemetry is not None and led.telemetry is not telemetry)
                 or (config is not None and led.config is not config))
        if fresh:
            led = _ACTIVE = TrainHealthLedger(
                rank=0 if rank is None else rank,
                config=config, telemetry=telemetry)
        elif rank is not None and str(rank) != str(led.rank):
            led.rank = rank
            with _REG_LOCK:
                _REGISTRY[(id(led.telemetry), str(rank))] = led
    return led


def active() -> Optional[TrainHealthLedger]:
    return _ACTIVE


def install(ledger: Optional[TrainHealthLedger]
            ) -> Optional[TrainHealthLedger]:
    """Swap the ambient ledger (tests; explicit owners); returns the
    previous one."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, ledger
    return prev
