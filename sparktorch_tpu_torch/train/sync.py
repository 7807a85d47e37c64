"""Synchronous training — the port of ``train_distributed`` (``sparktorch_tpu/train/sync.py:159``), ``train_distributed_multihost`` (:581) and ``train_distributed_streaming`` (:743).

:func:`train_distributed` puts the whole training batch onto the card
once. Each round (the reference's partition shuffle) starts with an
on-device permutation of the resident rows, drawn from a
``torch.Generator`` seeded with ``seed + 1``; round 0 shuffles too when
minibatch sampling is on, since the sampler takes contiguous blocks.
Each step is :func:`~sparktorch_tpu_torch.train.step.train_step`.

Data parallelism: with a process group initialized (or a ``mesh`` from
:func:`~sparktorch_tpu_torch.parallel.mesh.build_mesh`), every rank
calls :func:`train_distributed` with the same data and trains its
contiguous shard of it, padded to a multiple of the world with weight-0
rows; the step makes one all-reduce of the weighted sums. The validation
split and the round shuffles (a host permutation of the whole batch,
from ``seed + 1``) are drawn alike on every rank, so the shards agree;
minibatch offsets come from ``seed + rank``. The reported losses are
global. Rank 0 writes the checkpoints, behind a barrier, and every rank
restores from the shared directory. Between chunks :func:`check_gang`
raises ``GangFailure`` when a peer host has died.
:func:`train_distributed_multihost` takes each rank's own partition
instead.

:func:`train_distributed_streaming` keeps the data in host memory and
walks it in fixed-size chunks, one chunk ahead on the card: chunk i+1
is copied from a pinned staging buffer on a side stream while chunk
i's steps run, so device memory holds about two chunks.

Read-backs: the step losses come back to the host once per chunk of
``steps_per_call`` steps (default: up to 32), so the card is never
stalled by a per-step sync. With early stopping or a validation split
the host needs each step's signal before it may start the next step, so
then every step is read back — which makes the stop fire at exactly the
step the JAX package's stops at.

Checkpoints (``checkpoint_dir``): a snapshot of the module, the
optimizer and the global step at the first chunk boundary at or past
each ``checkpoint_every`` steps, and a final one on clean completion.
With ``resume`` the newest snapshot is restored first and ``iters``
counts the steps run after it; the shuffle generators restart from
their seeds, as the reference's do, so a resumed run equals the
straight one on full-batch runs.

Records have the JAX package's keys: ``round, iter, loss, val_loss,
examples, grad_norm, step_time_s``, and ``moe_drop_fraction`` for a
model with MoE layers (not in the streaming trainer's records, as in the
JAX package; its loss holds the aux loss all the same).

Telemetry and chaos, as in the JAX package: each trainer records into
its ``telemetry`` bus (the process-global one by default) the spans
``train/data_prep``, ``train/init``, ``train/shuffle``,
``train/step_chunk`` (``train/step`` when every step is read back) and
``train/checkpoint`` (``train_streaming/chunk`` in the streaming
trainer), and through its :class:`MetricsRecorder` the ``train.*``
(``train_streaming.*``) counters, step-time histogram and loss gauge.
A chunk's span closes after the chunk's one read-back, so the hooks add
no device sync. Each dispatched chunk is a ``train_step`` range
(:func:`~sparktorch_tpu_torch.utils.tracing.step_annotation`), and
``profile_dir`` captures a ``torch.profiler`` trace of the loop. The
chaos sites ``worker.step``, ``data.batch`` (a poisoned batch replaces
the resident one) and ``train.rank`` (a straggler's sleep) fire before
each chunk's dispatch, beside the gang check. Not ported yet (ROADMAP,
Queue 1): meshes with axes other than ``dp``, pipeline parallelism
(item 8), and the goodput and health hooks (item 10, step 4).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.inference import _resolve_device, torch_dtype
from sparktorch_tpu_torch.obs import get_logger, get_telemetry
from sparktorch_tpu_torch.parallel.launch import check_gang, notify_gang_step
from sparktorch_tpu_torch.parallel.mesh import Mesh, build_mesh
from sparktorch_tpu_torch.train.step import eval_step, train_step
from sparktorch_tpu_torch.utils.checkpoint import CheckpointManager
from sparktorch_tpu_torch.utils.data import (
    DataBatch,
    handle_features,
    pad_batch,
    pad_to_multiple,
    shard_batch,
)
from sparktorch_tpu_torch.utils.early_stopper import EarlyStopping
from sparktorch_tpu_torch.utils.metrics import MetricsRecorder
from sparktorch_tpu_torch.utils.optim import flax_shapes
from sparktorch_tpu_torch.utils.tracing import profile_run, step_annotation
from sparktorch_tpu_torch.utils.serde import (
    ModelSpec,
    deserialize_model,
    meta_copy,
)

log = get_logger("sparktorch_tpu_torch.train")


class TrainResult(NamedTuple):
    params: Any      # the trained state_dict, on the CPU
    metrics: list    # per-step record dicts
    spec: ModelSpec  # weight-free: the module on the meta device
    summary: Optional[dict] = None


def _shuffle_batch(batch: DataBatch, generator: torch.Generator) -> DataBatch:
    """On-device permutation of the resident rows between rounds."""
    perm = torch.randperm(batch.size, generator=generator,
                          device=batch.x.device)
    return DataBatch(*(a[perm] for a in batch))


def _resolve_steps_per_call(steps_per_call: Optional[int], default: int,
                            iters: int, checkpoint_every: int = 0,
                            ckpt_active: bool = False) -> int:
    """Chunk size between read-backs: ``steps_per_call`` or the default,
    at most ``iters``, and a divisor of ``iters``. A DEFAULTED chunk
    never strides past the checkpoint cadence (saves happen between
    chunks); an explicit ``steps_per_call`` wins, and saves then land at
    the chunk boundaries at or past the cadence."""
    if steps_per_call is None:
        steps_per_call = default
        if ckpt_active and checkpoint_every and checkpoint_every > 0:
            steps_per_call = min(steps_per_call, checkpoint_every)
    n = max(1, min(int(steps_per_call), iters))
    while iters % n:
        n -= 1
    return n


def _trainer_state(module: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, step: int) -> dict:
    return {"model": module.state_dict(),
            "optimizer": optimizer.state_dict(), "step": int(step)}


def _open_checkpoint(checkpoint_dir: Optional[str], resume: bool,
                     module: torch.nn.Module,
                     optimizer: torch.optim.Optimizer):
    """Open the manager and, when resuming from a finalized snapshot,
    load it into ``module`` and ``optimizer``. Returns (manager or
    None, the restored global step or 0)."""
    if not checkpoint_dir:
        return None, 0
    ckpt = CheckpointManager(checkpoint_dir)
    if not (resume and ckpt.latest_step() is not None):
        return ckpt, 0
    # Loaded on the CPU: load_state_dict copies the weights and moments
    # onto the module's device and leaves the optimizer's step counters
    # on the CPU, where torch keeps them (on the card, a non-capturable
    # Adam would read each counter back every step).
    state = ckpt.restore(map_location="cpu")
    module.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return ckpt, int(state["step"])


def _save_if_due(ckpt, module, optimizer, step: int, last_ckpt_step: int,
                 every: int, mesh: Optional[Mesh] = None) -> int:
    """Save on the first chunk boundary at or past the cadence (a chunk
    that strides over the exact multiple must not skip the save).
    In a data-parallel world rank 0 writes and every rank then waits at
    a barrier. Returns the (possibly advanced) last-saved step."""
    if ckpt is None or every <= 0 or step - last_ckpt_step < every:
        return last_ckpt_step
    if mesh is None or mesh.rank == 0:
        ckpt.save(step, _trainer_state(module, optimizer, step))
    _barrier(mesh)
    return step


def _barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def _finalize_checkpoint(ckpt, module, optimizer, step: int,
                         completed: bool, mesh: Optional[Mesh] = None) -> None:
    """The final snapshot, on clean completion only (the periodic ones
    already on disk keep a failed run resumable); rank 0 decides and
    writes, every rank waits for it."""
    if ckpt is None:
        return
    if completed:
        if ((mesh is None or mesh.rank == 0)
                and ckpt.latest_step() != step):
            ckpt.save(step, _trainer_state(module, optimizer, step),
                      force=True)
        _barrier(mesh)
    ckpt.wait()
    ckpt.close()


def _build_trainer(torch_obj, spec: ModelSpec, dev: torch.device):
    """The module on ``dev`` in train mode, its optimizer and loss."""
    module = spec.make_module()
    if isinstance(torch_obj, ModelSpec) and spec.module is not None:
        module = copy.deepcopy(module)  # leave the caller's module as it is
    module = module.to(dev).train()
    opt = spec.make_optimizer(module.parameters(), flax_shapes(module))
    return module, opt, spec.loss_fn()


def _result(module: torch.nn.Module, spec: ModelSpec,
            recorder: MetricsRecorder) -> TrainResult:
    params = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    if spec.module is not None:
        spec = dataclasses.replace(spec, module=meta_copy(module))
    return TrainResult(params=params, metrics=recorder.records, spec=spec,
                       summary=recorder.summary())


class _Shards:
    """The training rows as this rank holds them on ``dev``.

    Without a process group: the whole batch, shuffled on the device
    from a ``torch.Generator`` seeded with ``seed + 1``. In a
    data-parallel world: the whole (padded) batch stays on the host,
    every rank draws the same permutation from a CPU generator seeded
    with ``seed + 1``, and only the rank's contiguous shard goes to the
    card. ``local`` batches (a rank's own partition) are one shard:
    their shuffle permutes the rank's own rows."""

    def __init__(self, batch: DataBatch, mesh: Mesh, dev, seed: int,
                 local: bool = False):
        self.dev = dev
        if mesh.group is None:
            self.host = None
            self.batch = batch.to(dev)
            self.gen = torch.Generator(device=dev).manual_seed(seed + 1)
            return
        self.rank, self.world = (0, 1) if local else (mesh.rank, mesh.dp)
        self.host = pad_to_multiple(batch, self.world)
        self.gen = torch.Generator().manual_seed(seed + 1)
        self.batch = shard_batch(self.host, self.rank, self.world).to(dev)

    def shuffle(self) -> None:
        if self.host is None:
            self.batch = _shuffle_batch(self.batch, self.gen)
            return
        perm = torch.randperm(self.host.size, generator=self.gen)
        self.host = DataBatch(*(a[perm] for a in self.host))
        self.batch = shard_batch(self.host, self.rank, self.world).to(self.dev)


def _broadcast_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's weights and buffers on every rank (a lazily packaged
    model initialises on each rank from its own generator)."""
    if mesh.group is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=src, group=mesh.group)


def _dp_trainer(torch_obj, spec: ModelSpec, mesh: Mesh, dev: torch.device,
                checkpoint_dir: Optional[str] = None, resume: bool = False):
    """The data-parallel set-up of a rank, shared by
    :func:`train_distributed` and the bench: the module on ``dev`` with
    its optimizer and loss, the newest snapshot restored where asked,
    then rank 0's weights and buffers on every rank. Returns ``(module,
    optimizer, loss_fn, checkpoint manager, restored step)``."""
    module, optimizer, loss_fn = _build_trainer(torch_obj, spec, dev)
    ckpt, step = _open_checkpoint(checkpoint_dir, resume, module, optimizer)
    _broadcast_module(module, mesh)
    return module, optimizer, loss_fn, ckpt, step


def _dp_steps(n: int, module, loss_fn, optimizer, shards: "_Shards",
              mesh: Mesh, mini_batch: Optional[int] = None,
              generator: Optional[torch.Generator] = None) -> list:
    """``n`` train steps on this rank's shard, queued back to back with
    no read-back; each makes its all-reduce over the mesh's group."""
    return [train_step(module, loss_fn, optimizer, shards.batch, mini_batch,
                       generator, mesh.group) for _ in range(n)]


def _check_pipeline_args(n_micro: int, pipeline_schedule: str,
                         virtual_stages: int) -> None:
    """The pipeline-parallel knobs are accepted for the JAX signature;
    anything but their defaults needs ``train/pipeline.py``."""
    if (n_micro, pipeline_schedule, virtual_stages) != (4, "gpipe", 1):
        raise NotImplementedError(
            f"n_micro={n_micro}, pipeline_schedule={pipeline_schedule!r}, "
            f"virtual_stages={virtual_stages}: pipeline parallelism is not "
            "ported yet (ROADMAP, Queue 1, item 8)")


def _fire_chaos(rank: int, step: int, batch: DataBatch,
                kill: bool = True) -> DataBatch:
    """The chaos sites before a chunk's dispatch, in the JAX package's
    order: ``worker.step`` (a seeded kill raises ``ChaosKill`` here),
    ``data.batch`` (a poisoned copy replaces the resident batch), then
    ``train.rank`` (a straggler sleeps before the step span, so its
    delay shows as a late arrival, not a longer step). Returns the batch
    to dispatch."""
    if kill:
        _chaos.fire("worker.step", worker=rank, step=step)
    act = _chaos.fire("data.batch", worker=rank, step=step)
    if act and act.get("poison"):
        batch = _chaos.poison_batch(batch)
    _chaos.straggle(rank, step)
    return batch


def train_distributed(
    torch_obj: Union[str, ModelSpec],
    data: Any,
    labels: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    iters: int = 10,
    partition_shuffles: int = 1,
    verbose: int = 0,
    mini_batch: Optional[int] = None,
    validation_pct: float = 0.0,
    early_stop_patience: int = -1,
    seed: int = 0,
    device=None,
    metrics_hook: Optional[Callable[[dict], None]] = None,
    steps_per_call: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    profile_dir: Optional[str] = None,
    pre_sharded: bool = False,
    n_micro: int = 4,
    pipeline_schedule: str = "gpipe",
    virtual_stages: int = 1,
    telemetry=None,
) -> TrainResult:
    """Synchronous training of the packaged model (device: CUDA unless
    ``device`` says otherwise; raises when there is no card and no
    device was asked for). The parameters are the JAX package's, in its
    order. ``data``/``labels`` as
    :func:`~sparktorch_tpu_torch.utils.data.handle_features` takes them.
    ``mini_batch`` ≤ 0 or None trains on the full batch each step; in a
    data-parallel world it is per shard, so a step takes
    ``mini_batch × world`` rows in all. ``mesh`` defaults to
    :func:`build_mesh` (the default process group, or a world of one).
    ``metrics_hook`` sees every step record. ``pre_sharded``: ``data`` is
    this rank's own :class:`DataBatch`
    (:func:`train_distributed_multihost`). ``profile_dir`` captures a
    ``torch.profiler`` trace of the training loop there; ``telemetry``
    is the bus the run records into (default: the process-global one).
    ``n_micro``, ``pipeline_schedule`` and ``virtual_stages`` take only
    their defaults (pipeline parallelism is not ported)."""
    _check_pipeline_args(n_micro, pipeline_schedule, virtual_stages)
    dev = _resolve_device(device)
    mesh = mesh or build_mesh()
    group = mesh.group
    tele = telemetry or get_telemetry()
    spec = deserialize_model(torch_obj)
    if pre_sharded:
        train_batch, val_batch = data, None
        if spec.input_shape is None:
            spec.input_shape = tuple(train_batch.x.shape[1:])
        shards = _Shards(train_batch, mesh, dev, seed, local=True)
    else:
        with tele.span("train/data_prep"):
            train_batch, val_batch = handle_features(data, labels,
                                                     validation_pct, seed)
            if spec.input_shape is None:
                spec.input_shape = tuple(train_batch.x.shape[1:])
            shards = _Shards(train_batch, mesh, dev, seed)
            if val_batch is not None:
                val_batch = (val_batch if group is None else
                             shard_batch(val_batch, mesh.rank, mesh.dp)
                             ).to(dev)

    with tele.span("train/init"):
        module, optimizer, loss_fn, ckpt, global_step = _dp_trainer(
            torch_obj, spec, mesh, dev, checkpoint_dir, resume)
    last_ckpt_step = global_step

    stopper = (EarlyStopping(patience=early_stop_patience)
               if early_stop_patience is not None and early_stop_patience > 0
               else None)
    per_step = stopper is not None or val_batch is not None
    chunk = 1 if per_step else _resolve_steps_per_call(
        steps_per_call, min(iters, 32), iters, checkpoint_every,
        ckpt is not None)
    mini_batch = mini_batch if mini_batch is not None and mini_batch > 0 else None
    sample_gen = torch.Generator().manual_seed(seed + mesh.rank)

    recorder = MetricsRecorder(n_chips=mesh.dp, telemetry=tele)
    # Exited in the finally: a failed run still writes its trace.
    profiler = profile_run(profile_dir, telemetry=tele)
    profiler.__enter__()
    completed = False
    try:
        for shuffle_round in range(max(1, partition_shuffles)):
            if shuffle_round > 0 or mini_batch is not None:
                with tele.span("train/shuffle"):
                    shards.shuffle()
            stop = False
            i = 0
            while i < iters and not stop:
                # A dead peer raises here, not inside the next collective;
                # the chaos sites sit beside the check.
                check_gang()
                notify_gang_step(i)
                shards.batch = _fire_chaos(mesh.rank, i, shards.batch)
                n = min(chunk, iters - i)
                first = (recorder.records[-1]["iter"] + 1
                         if recorder.records else 0)
                with tele.span("train/step_chunk" if chunk > 1
                               else "train/step"), \
                        step_annotation(first, telemetry=tele, device=dev):
                    t0 = time.perf_counter()
                    steps = _dp_steps(n, module, loss_fn, optimizer, shards,
                                      mesh, mini_batch, sample_gen)
                    # The chunk's one read-back: (n, 3) loss, examples,
                    # grad norm, and the MoE drop fraction where the model
                    # has one. The span closes after it: no extra sync.
                    host = torch.stack(
                        [torch.stack([v for v in m if v is not None])
                         for m in steps]).tolist()
                    dt = (time.perf_counter() - t0) / n
                val_loss = (float(eval_step(module, loss_fn, val_batch, group))
                            if val_batch is not None else None)
                for loss, examples, gnorm, *drop in host:
                    record = {
                        "round": shuffle_round,
                        "iter": i,
                        "loss": loss,
                        "val_loss": val_loss,
                        "examples": examples,
                        "grad_norm": gnorm,
                        "step_time_s": dt,
                    }
                    if drop:
                        record["moe_drop_fraction"] = drop[0]
                    recorder.record(record)
                    if metrics_hook is not None:
                        metrics_hook(record)
                    global_step += 1
                    if verbose:
                        msg = (f"[sparktorch_tpu_torch] round {shuffle_round} "
                               f"iter {i} loss {loss:.6f}")
                        if val_loss is not None:
                            msg += f" val_loss {val_loss:.6f}"
                        log.info(msg)
                    # The loss is global, so every rank stops at one step.
                    if stopper is not None and stopper.step(
                            val_loss if val_loss is not None else loss):
                        stop = True
                        break
                    i += 1
                if ckpt is not None:
                    with tele.span("train/checkpoint"):
                        last_ckpt_step = _save_if_due(
                            ckpt, module, optimizer, global_step,
                            last_ckpt_step, checkpoint_every, mesh)
            if stop:
                break
        completed = True
    finally:
        profiler.__exit__(None, None, None)
        _finalize_checkpoint(ckpt, module, optimizer, global_step,
                             completed, mesh)
    return _result(module, spec, recorder)


# Feature and label shapes travel in one fixed-width vector per rank:
# [rows, x_rank, x_dims(8), y_rank, y_dims(8), x_dtype, y_dtype], with
# y_rank -1 when the rank has no labels.
_MAX_RANK = 8
_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.int8, np.uint8,
           np.int16, np.uint16, np.uint32, np.uint64, np.bool_]


def _dtype_code(dt) -> int:
    for i, d in enumerate(_DTYPES):
        if np.dtype(dt) == np.dtype(d):
            return i
    raise ValueError(f"unsupported multihost shard dtype {np.dtype(dt)}; use "
                     f"one of {[np.dtype(d).name for d in _DTYPES]}")


def _shape_vector(x: np.ndarray, y: Optional[np.ndarray]) -> np.ndarray:
    if x.ndim - 1 > _MAX_RANK or (y is not None and y.ndim - 1 > _MAX_RANK):
        raise ValueError(f"feature or label rank above {_MAX_RANK}")
    vec = np.zeros((2 * _MAX_RANK + 4,), np.int64)
    vec[0], vec[1] = x.shape[0], x.ndim - 1
    vec[2:2 + x.ndim - 1] = x.shape[1:]
    y_off = 2 + _MAX_RANK
    vec[y_off] = -1 if y is None else y.ndim - 1
    if y is not None:
        vec[y_off + 1:y_off + y.ndim] = y.shape[1:]
    vec[-2] = _dtype_code(x.dtype)
    vec[-1] = -1 if y is None else _dtype_code(y.dtype)
    return vec


def _gather_shape_vectors(vec: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Every rank's shape vector, rank-ordered (one all-gather)."""
    if mesh.group is None:
        return vec[None]
    on = "cuda" if dist.get_backend(mesh.group) == "nccl" else "cpu"
    mine = torch.from_numpy(vec).to(on)
    out = [torch.empty_like(mine) for _ in range(mesh.dp)]
    dist.all_gather(out, mine, group=mesh.group)
    return torch.stack(out).cpu().numpy()


def train_distributed_multihost(
    torch_obj: Union[str, ModelSpec],
    local_x: np.ndarray,
    local_y: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    **kwargs,
) -> TrainResult:
    """Data-parallel training where each rank brings ITS partition of
    the data (the reference's executor-side partition iterator,
    ``distributed.py:66-128``). The ranks agree on a common row count
    by an all-gather of their shapes; shorter partitions pad with
    weight-0 rows, and an empty one takes its feature and label shapes
    and dtypes from a rank that has rows — so skewed and empty
    partitions are absorbed exactly into the global weighted mean.
    ``kwargs`` go to :func:`train_distributed` (no validation split:
    as in the reference, the multihost path trains on every row)."""
    mesh = mesh or build_mesh()
    local_x = np.asarray(local_x)
    if not np.issubdtype(local_x.dtype, np.integer):
        local_x = local_x.astype(np.float32)
    if local_x.ndim == 1:
        local_x = (local_x.reshape(0, 1) if local_x.size == 0
                   else local_x[:, None])
    local_y = np.asarray(local_y) if local_y is not None else None

    gathered = _gather_shape_vectors(_shape_vector(local_x, local_y), mesh)
    if local_x.shape[0] == 0:
        donors = gathered[gathered[:, 0] > 0]
        if len(donors):
            d = donors[0]
            feat = tuple(int(v) for v in d[2:2 + int(d[1])])
            local_x = np.zeros((0, *feat), _DTYPES[int(d[-2])])
            if local_y is not None:
                y_off = 2 + _MAX_RANK
                y_feat = tuple(int(v) for v in
                               d[y_off + 1:y_off + 1 + max(0, int(d[y_off]))])
                y_code = int(d[-1])
                local_y = np.zeros(
                    (0, *y_feat),
                    _DTYPES[y_code] if y_code >= 0 else local_y.dtype)
    if local_y is None:
        local_y = local_x  # label-free: the target is the input
    per_rank = max(1, int(gathered[:, 0].max()))
    batch, _ = handle_features(local_x, local_y)
    batch = pad_batch(batch, per_rank)
    return train_distributed(torch_obj, batch, mesh=mesh, pre_sharded=True,
                             **kwargs)


class _ChunkFeeder:
    """Host rows to the device one chunk ahead of the steps.

    ``put(idx)`` gathers rows ``idx`` of each host array into a
    ``chunk_rows`` buffer (the tail zero: weight-0 padding rows) and
    starts its upload; ``take(handle)`` returns the chunk as a
    :class:`DataBatch` the current stream may use. On CUDA the gather
    fills one of two pinned staging buffers and the copy runs on a side
    stream: the current stream waits on the copy's event before its
    first use, ``record_stream`` keeps the device tensors alive until
    that stream is done with them, and a staging buffer is refilled only
    after the event of the copy that read it has fired."""

    def __init__(self, arrays, chunk_rows: int, device: torch.device):
        self.arrays = arrays
        self.rows = chunk_rows
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.staging = [
                [torch.empty((chunk_rows, *a.shape[1:]),
                             dtype=torch_dtype(a.dtype),
                             pin_memory=True) for a in arrays]
                for _ in range(2)]
            self.copied = [None, None]
            self.turn = 0

    def _fill(self, bufs, idx: np.ndarray):
        k = len(idx)
        for buf, a in zip(bufs, self.arrays):
            np.take(a, idx, axis=0, out=buf[:k])
            buf[k:] = 0
        return bufs

    def put(self, idx: np.ndarray):
        if not self.cuda:
            bufs = self._fill([np.empty((self.rows, *a.shape[1:]), a.dtype)
                               for a in self.arrays], idx)
            return DataBatch(*(torch.from_numpy(b) for b in bufs)), None
        b, self.turn = self.turn, self.turn ^ 1
        if self.copied[b] is not None:
            self.copied[b].synchronize()
        host = self.staging[b]
        self._fill([t.numpy() for t in host], idx)
        with torch.cuda.stream(self.stream):
            batch = DataBatch(*(t.to(self.device, non_blocking=True)
                                for t in host))
            self.copied[b] = self.stream.record_event()
        return batch, self.copied[b]

    def take(self, handle) -> DataBatch:
        batch, ready = handle
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in batch:
                t.record_stream(current)
        return batch


def train_distributed_streaming(
    torch_obj: Union[str, ModelSpec],
    data: Any,
    labels: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    chunk_rows: int = 65536,
    epochs: int = 1,
    steps_per_chunk: Optional[int] = None,
    mini_batch: Optional[int] = None,
    verbose: int = 0,
    seed: int = 0,
    metrics_hook: Optional[Callable[[dict], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    telemetry=None,
    device=None,
) -> TrainResult:
    """Train on data larger than the card's memory by streaming host
    chunks (device: as :func:`train_distributed`). The parameters are
    the JAX package's, in its order, then ``device``.

    ``data`` is a host numpy array (or an ``(x, y)`` pair), walked in
    ``chunk_rows`` slices per epoch in a fresh permutation from one
    ``np.random.default_rng(seed + 1 + restored_step)`` — the
    reference's order, row for row. The last chunk is padded to
    ``chunk_rows`` with weight-0 rows, so every chunk has one shape.
    Per chunk, ``steps_per_chunk`` steps run (default: one pass,
    ``ceil(chunk_rows / mini_batch)`` minibatch steps, or 1 full-chunk
    step) and their losses come back in one read-back. ``metrics_hook``
    sees every step record; ``telemetry`` is the bus the run records
    into (default: the process-global one). Checkpoints are saved at
    chunk boundaries; ``resume`` continues from the newest one. Records
    have the reference's keys; ``grad_norm`` and ``val_loss`` are None.
    One rank only: ``mesh`` may be None or a world of one; in a
    data-parallel world of more than one it raises, since each rank
    would train its own copy on all the data and write to one
    ``checkpoint_dir``."""
    world = (mesh.dp if mesh is not None else
             dist.get_world_size() if dist.is_initialized() else 1)
    if world > 1:
        raise NotImplementedError(
            "train_distributed_streaming over a data-parallel world is not "
            "ported yet (ROADMAP, Queue 1: several GPUs, item 4); run it in "
            "one process, or train_distributed(mesh=...) on resident data")
    dev = _resolve_device(device)
    tele = telemetry or get_telemetry()
    spec = deserialize_model(torch_obj)
    if isinstance(data, tuple) and len(data) == 2 and labels is None:
        data, labels = data
    train_all, _ = handle_features(data, labels, 0.0, seed)
    arrays = [t.numpy() for t in train_all]
    n = arrays[0].shape[0]
    if spec.input_shape is None:
        spec.input_shape = tuple(arrays[0].shape[1:])
    chunk_rows = max(1, min(int(chunk_rows), n))
    mini_batch = mini_batch if mini_batch is not None and mini_batch > 0 else None
    steps = steps_per_chunk or (-(-chunk_rows // mini_batch)
                                if mini_batch is not None else 1)

    module, optimizer, loss_fn = _build_trainer(torch_obj, spec, dev)
    ckpt, global_step = _open_checkpoint(checkpoint_dir, resume, module,
                                         optimizer)
    last_ckpt_step = global_step
    # Fold the restored step into the shuffle seed: a resumed run draws
    # fresh permutations instead of replaying the epochs already run.
    shuffle_rng = np.random.default_rng(seed + 1 + global_step)
    sample_gen = torch.Generator().manual_seed(seed)
    feeder = _ChunkFeeder(arrays, chunk_rows, dev)

    recorder = MetricsRecorder(n_chips=world, telemetry=tele,
                               prefix="train_streaming")
    it = 0
    completed = False
    try:
        for epoch in range(max(1, epochs)):
            check_gang()
            order = shuffle_rng.permutation(n)
            starts = range(0, n, chunk_rows)
            pending = feeder.put(order[:chunk_rows])
            for ci, lo in enumerate(starts):
                check_gang()
                notify_gang_step(it)
                batch = _fire_chaos(0, it, feeder.take(pending), kill=False)
                with tele.span("train_streaming/chunk"):
                    t0 = time.perf_counter()
                    metrics = [train_step(module, loss_fn, optimizer, batch,
                                          mini_batch, sample_gen)
                               for _ in range(steps)]
                    # The next chunk's upload rides under these steps.
                    if ci + 1 < len(starts):
                        nxt = starts[ci + 1]
                        pending = feeder.put(order[nxt:nxt + chunk_rows])
                    host = torch.stack([torch.stack((m.loss, m.examples))
                                        for m in metrics]).tolist()
                    dt = (time.perf_counter() - t0) / steps
                for loss, examples in host:
                    record = {
                        "round": epoch, "iter": it, "loss": loss,
                        "val_loss": None, "examples": examples,
                        "grad_norm": None, "step_time_s": dt,
                    }
                    recorder.record(record)
                    if metrics_hook is not None:
                        metrics_hook(record)
                    it += 1
                global_step += steps
                last_ckpt_step = _save_if_due(ckpt, module, optimizer,
                                              global_step, last_ckpt_step,
                                              checkpoint_every)
                if verbose:
                    log.info(f"[sparktorch_tpu_torch] epoch {epoch} chunk "
                             f"{ci} loss {host[-1][0]:.6f}")
        completed = True
    finally:
        _finalize_checkpoint(ckpt, module, optimizer, global_step, completed)
    return _result(module, spec, recorder)
