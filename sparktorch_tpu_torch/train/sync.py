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
contiguous shard of it, padded to a multiple of the batch shards (dp ×
fsdp: the parameters stay replicated here, as in the JAX trainer; the
sharded trainer is :mod:`~sparktorch_tpu_torch.train.sharded`) with
weight-0 rows; the step makes one all-reduce of the weighted sums over
the batch group. tp peers are replicas of one batch shard, as in the
JAX package's shard_map trainers: they train the same rows, draw the
same minibatches and stay equal. The validation
split and the round shuffles (a host permutation of the whole batch,
from ``seed + 1``) are drawn alike on every rank, so the shards agree;
minibatch offsets come from ``seed + batch_index``. The reported losses
are global. Rank 0 writes the checkpoints, behind a barrier of the whole
world, and every rank restores from the shared directory. Between
chunks :func:`check_gang` raises ``GangFailure`` when a peer host has
died. :func:`train_distributed_multihost` takes each rank's own
partition instead (tp peers must be given the same one).

:func:`train_distributed_streaming` keeps the data in host memory and
walks it in fixed-size chunks, one chunk ahead on the card: chunk i+1
is copied from a pinned staging buffer on a side stream while chunk
i's steps run, so device memory holds about two chunks. In a
data-parallel world each rank feeds its shard of every chunk.

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
each chunk's dispatch, beside the gang check.

Goodput and model health, as in the JAX package: each dispatched chunk
is a goodput step span (``obs/goodput.py``; ``step_time_s`` comes off
its duration, and it stamps the cross-rank skew ring), inside which
the chunk's read-back lands; batch preparation and the streaming
feeder's waits are ``data_wait``, the trainer's set-up is ``compile``
(``site=train_init``) and the validation forward ``compute``
(``site=eval``). The JAX trainer moves a step to ``compile`` when its
jit cache grew under it; the port's counterpart is a hand-written
kernel's first use, whose build and load (``ops/_build.py``) happen
inside that step, so a step during which
:func:`~sparktorch_tpu_torch.ops._build.loads` grew is re-bucketed to
``compile``. The health lane (``obs/health.py``, on unless
``SPARKTORCH_TPU_HEALTH=0``) is a per-rank ledger: each chunk's steps
compute the :class:`~sparktorch_tpu_torch.train.step.HealthVec` on the
card and the ledger reads it back ``fetch_lag`` chunks later; with a
``replay_dir`` in its config it anchors the trainer's state before
dispatch (after the ``data.batch`` chaos swapped in a poisoned batch)
for replay bundles. Not ported yet (ROADMAP, Queue 1): meshes with
axes other than ``dp`` and ``fsdp`` and pipeline parallelism (item 8).
"""

from __future__ import annotations

import copy
import dataclasses
import time
import zlib
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.inference import _resolve_device, torch_dtype
from sparktorch_tpu_torch.obs import get_logger, get_telemetry
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs import health as _health
from sparktorch_tpu_torch.ops import _build as _kernels
from sparktorch_tpu_torch.parallel.launch import check_gang, notify_gang_step
from sparktorch_tpu_torch.parallel.mesh import Mesh, build_mesh
from sparktorch_tpu_torch.train.step import (
    eval_step,
    health_buffer,
    train_step,
)
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
    """Every rank of the world (tp peers too) waits here."""
    if mesh is not None and mesh.batch_group is not None:
        dist.barrier(group=dist.group.WORLD)


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
    params = {k: v.detach().cpu() for k, v in module.state_dict().items()}  # lint-obs: ok (end-of-run)
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
        if mesh.batch_group is None:
            self.host = None
            self.batch = batch.to(dev)
            self.gen = torch.Generator(device=dev).manual_seed(seed + 1)
            return
        self.rank, self.world = ((0, 1) if local
                                 else (mesh.batch_index, mesh.batch_shards))
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
    """Rank 0's weights and buffers on every rank of the world, tp peers
    too (a lazily packaged model initialises on each rank from its own
    generator)."""
    if mesh.batch_group is None:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=dist.group.WORLD)


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
              generator: Optional[torch.Generator] = None,
              health_buf=None) -> list:
    """``n`` train steps on this rank's shard, queued back to back with
    no read-back; each makes its all-reduce over the mesh's group."""
    return [train_step(module, loss_fn, optimizer, shards.batch, mini_batch,
                       generator, mesh.batch_group, health_buf)
            for _ in range(n)]


def _health_lane(tele, rank, module):
    """The run's health ledger (None when ``SPARKTORCH_TPU_HEALTH=0``),
    re-based for this run, with its leaf keys, and the step's pre-step
    parameter buffer."""
    hl = _health.ensure(tele, rank=rank)
    if hl is None:
        return None, None
    hl.reset()
    if hl.leaf_keys is None:
        hl.leaf_keys = _health.health_leaf_keys(module)
    return hl, health_buffer(module)


def _anchor(hl, module, optimizer):
    """The ``data.batch`` chaos site's anchor callback: the pre-dispatch
    replay anchor of ``hl`` (None without a ledger or a replay dir)."""
    if hl is None or not hl.config.replay_dir:
        return None
    return lambda batch: hl.note_replay_anchor(
        lambda: _health.trainer_state(module, optimizer), batch)


def _note_health(hl, metrics: list, host_loss, host_gnorm) -> None:
    """Hand a chunk's health vectors (left on the device, stacked over
    the chunk's steps) and its read-back losses and grad norms to
    ``hl``."""
    if hl is None or not metrics:
        return
    hv = [m.health for m in metrics]
    hl.note_step(
        count=len(metrics),
        device=None if hv[0] is None else {
            "finite": torch.stack([h.finite for h in hv]),
            "update_ratio": torch.stack([h.update_ratio for h in hv]),
            "leaf_norms": torch.stack([h.leaf_norms for h in hv]),
        },
        host={"loss": np.asarray(host_loss, np.float32),
              "grad_norm": np.asarray(host_gnorm, np.float32)})


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
                kill: bool = True, anchor=None) -> DataBatch:
    """The chaos sites before a chunk's dispatch, in the JAX package's
    order: ``worker.step`` (a seeded kill raises ``ChaosKill`` here),
    ``data.batch`` (a poisoned copy replaces the resident batch), the
    health ledger's replay ``anchor`` of the batch about to dispatch,
    then ``train.rank`` (a straggler sleeps before the step span, so its
    delay shows as a late arrival, not a longer step). Returns the batch
    to dispatch."""
    if kill:
        _chaos.fire("worker.step", worker=rank, step=step)
    act = _chaos.fire("data.batch", worker=rank, step=step)
    if act and act.get("poison"):
        batch = _chaos.poison_batch(batch)
    if anchor is not None:
        anchor(batch)
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
    group = mesh.batch_group
    tele = telemetry or get_telemetry()
    spec = deserialize_model(torch_obj)
    if pre_sharded:
        train_batch, val_batch = data, None
        if spec.input_shape is None:
            spec.input_shape = tuple(train_batch.x.shape[1:])
        shards = _Shards(train_batch, mesh, dev, seed, local=True)
    else:
        # Batch preparation and placement: the card waits on input.
        with tele.span("train/data_prep"), _goodput.span("data_wait"):
            train_batch, val_batch = handle_features(data, labels,
                                                     validation_pct, seed)
            if spec.input_shape is None:
                spec.input_shape = tuple(train_batch.x.shape[1:])
            shards = _Shards(train_batch, mesh, dev, seed)
            if val_batch is not None:
                val_batch = (val_batch if group is None else
                             shard_batch(val_batch, mesh.batch_index,
                                         mesh.batch_shards)
                             ).to(dev)

    with tele.span("train/init"), _goodput.span("compile",
                                                 {"site": "train_init"}):
        module, optimizer, loss_fn, ckpt, global_step = _dp_trainer(
            torch_obj, spec, mesh, dev, checkpoint_dir, resume)
    last_ckpt_step = global_step
    hl, health_buf = _health_lane(tele, mesh.rank, module)
    anchor = _anchor(hl, module, optimizer)

    stopper = (EarlyStopping(patience=early_stop_patience)
               if early_stop_patience is not None and early_stop_patience > 0
               else None)
    per_step = stopper is not None or val_batch is not None
    chunk = 1 if per_step else _resolve_steps_per_call(
        steps_per_call, min(iters, 32), iters, checkpoint_every,
        ckpt is not None)
    mini_batch = mini_batch if mini_batch is not None and mini_batch > 0 else None
    # tp peers draw the same minibatches: seeded by the batch shard.
    sample_gen = torch.Generator().manual_seed(seed + mesh.batch_index)

    recorder = MetricsRecorder(n_chips=mesh.batch_shards, telemetry=tele)
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
                shards.batch = _fire_chaos(mesh.rank, i, shards.batch,
                                           anchor=anchor)
                n = min(chunk, iters - i)
                first = (recorder.records[-1]["iter"] + 1
                         if recorder.records else 0)
                loads0 = (_kernels.loads() if _goodput.active() is not None
                          else None)
                with _goodput.step_span(step=i) as led:
                    with tele.span("train/step_chunk" if chunk > 1
                                   else "train/step"), \
                            step_annotation(first, telemetry=tele,
                                            device=dev):
                        steps = _dp_steps(n, module, loss_fn, optimizer,
                                          shards, mesh, mini_batch,
                                          sample_gen, health_buf)
                        # The chunk's one read-back: (n, 3) loss,
                        # examples, grad norm, and the MoE drop fraction
                        # where the model has one. The spans close after
                        # it: no extra sync.
                        host = torch.stack(
                            [torch.stack([v for v in m[:4] if v is not None])
                             for m in steps]).tolist()
                        # Inside the range, so the lane's device work
                        # (the stacks, the delayed read) is the step's.
                        _note_health(hl, steps, [r[0] for r in host],
                                     [r[2] for r in host])
                    led.count = n
                    if loads0 is not None and _kernels.loads() > loads0:
                        led.rebucket("compile")
                dt = led.duration_s / n
                val_loss = None
                if val_batch is not None:
                    # Productive device work, just not a train step.
                    with _goodput.span("compute", {"site": "eval"}):
                        val_loss = float(eval_step(module, loss_fn,
                                                   val_batch, group))
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
        if hl is not None:
            # The delayed fetch's tail: the section ends on the last step.
            hl.flush()
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
    if mesh.batch_group is None:
        return vec[None]
    on = "cuda" if dist.get_backend(mesh.batch_group) == "nccl" else "cpu"
    mine = torch.from_numpy(vec).to(on)
    out = [torch.empty_like(mine) for _ in range(mesh.batch_shards)]
    dist.all_gather(out, mine, group=mesh.batch_group)
    return torch.stack(out).cpu().numpy()  # lint-obs: ok (one set-up gather of the batch shapes, before any step)


def _check_tp_peers(vec: np.ndarray, x: np.ndarray, y: Optional[np.ndarray],
                    mesh: Mesh) -> None:
    """tp peers are replicas of one batch shard, so each must bring the
    same partition: raise unless their shape vectors and the CRC-32 of
    their rows agree (one all-gather over the tp group)."""
    if mesh.tp == 1 or mesh.tp_group is None:
        return
    crcs = [-1 if a is None else zlib.crc32(np.ascontiguousarray(a).data)
            for a in (x, y)]
    digest = np.concatenate([vec, np.asarray(crcs, np.int64)])
    on = "cuda" if dist.get_backend(mesh.tp_group) == "nccl" else "cpu"
    mine = torch.from_numpy(digest).to(on)
    out = [torch.empty_like(mine) for _ in range(mesh.tp)]
    dist.all_gather(out, mine, group=mesh.tp_group)
    peers = torch.stack(out).cpu().numpy()  # lint-obs: ok (one set-up gather of the partitions' digests, before any step)
    if not (peers == peers[0]).all():
        raise ValueError(
            f"train_distributed_multihost: the tp peers of batch shard "
            f"{mesh.batch_index} brought different partitions (rows "
            f"{[int(v) for v in peers[:, 0]]}, CRC-32 of x "
            f"{[int(v) for v in peers[:, -2]]}); "
            "tp peers are replicas of one batch shard and must be given "
            "the same rows")


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
    as in the reference, the multihost path trains on every row). tp
    peers must bring the same partition, or every rank raises."""
    mesh = mesh or build_mesh()
    local_x = np.asarray(local_x)
    if not np.issubdtype(local_x.dtype, np.integer):
        local_x = local_x.astype(np.float32)
    if local_x.ndim == 1:
        local_x = (local_x.reshape(0, 1) if local_x.size == 0
                   else local_x[:, None])
    local_y = np.asarray(local_y) if local_y is not None else None

    vec = _shape_vector(local_x, local_y)
    _check_tp_peers(vec, local_x, local_y, mesh)
    gathered = _gather_shape_vectors(vec, mesh)
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
            self.copied[b].synchronize()  # lint-obs: ok (staging-buffer reuse guard; every put runs under a data_wait span)
        host = self.staging[b]
        self._fill([t.numpy() for t in host], idx)  # lint-obs: ok (pinned host staging buffers, no device involved)
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
    In a data-parallel world (``mesh``, default :func:`build_mesh`) every
    rank walks the same permutation: each chunk is padded up to a
    multiple of the batch shards (dp × fsdp) with weight-0 rows, each
    rank feeds its contiguous shard of it, the steps make their
    all-reduce over the batch group, and only rank 0 writes
    ``checkpoint_dir`` (every rank restores from it)."""
    mesh = mesh or build_mesh()
    world, rank, shard_i = mesh.batch_shards, mesh.rank, mesh.batch_index
    dev = _resolve_device(device)
    tele = telemetry or get_telemetry()
    spec = deserialize_model(torch_obj)
    if isinstance(data, tuple) and len(data) == 2 and labels is None:
        data, labels = data
    train_all, _ = handle_features(data, labels, 0.0, seed)
    arrays = [t.numpy() for t in train_all]  # lint-obs: ok (host tensors from handle_features, no device involved)
    n = arrays[0].shape[0]
    if spec.input_shape is None:
        spec.input_shape = tuple(arrays[0].shape[1:])
    chunk_rows = max(1, min(int(chunk_rows), n))
    chunk_rows = -(-chunk_rows // world) * world  # pad up to the shards
    per_shard = chunk_rows // world
    mini_batch = mini_batch if mini_batch is not None and mini_batch > 0 else None
    steps = steps_per_chunk or (-(-per_shard // mini_batch)
                                if mini_batch is not None else 1)

    # Set-up, the JAX trainer's compile-dominated init.
    with _goodput.span("compile", {"site": "train_init"}):
        module, optimizer, loss_fn, ckpt, global_step = _dp_trainer(
            torch_obj, spec, mesh, dev, checkpoint_dir, resume)
    last_ckpt_step = global_step
    hl, health_buf = _health_lane(tele, rank, module)
    anchor = _anchor(hl, module, optimizer)
    # Fold the restored step into the shuffle seed: a resumed run draws
    # fresh permutations instead of replaying the epochs already run.
    shuffle_rng = np.random.default_rng(seed + 1 + global_step)
    sample_gen = torch.Generator().manual_seed(seed + shard_i)
    feeder = _ChunkFeeder(arrays, per_shard, dev)

    def shard(lo: int, order: np.ndarray) -> np.ndarray:
        """The rows of this rank's batch shard of the chunk at ``lo``."""
        chunk = order[lo:lo + chunk_rows]
        return chunk[shard_i * per_shard:(shard_i + 1) * per_shard]

    recorder = MetricsRecorder(n_chips=world, telemetry=tele,
                               prefix="train_streaming")
    it = 0
    completed = False
    try:
        for epoch in range(max(1, epochs)):
            check_gang()
            order = shuffle_rng.permutation(n)
            starts = range(0, n, chunk_rows)
            # The epoch's first chunk has nothing to hide under.
            with _goodput.span("data_wait", {"site": "streaming_chunk"}):
                pending = feeder.put(shard(0, order))
            for ci, lo in enumerate(starts):
                check_gang()
                notify_gang_step(it)
                batch = _fire_chaos(rank, it, feeder.take(pending),
                                    kill=False, anchor=anchor)
                loads0 = (_kernels.loads() if _goodput.active() is not None
                          else None)
                with _goodput.step_span(step=it) as led, \
                        tele.span("train_streaming/chunk"):
                    metrics = [train_step(module, loss_fn, optimizer, batch,
                                          mini_batch, sample_gen,
                                          mesh.batch_group, health_buf)
                               for _ in range(steps)]
                    # The next chunk's upload rides under these steps; its
                    # host-side wait is a nested data_wait.
                    if ci + 1 < len(starts):
                        with _goodput.span("data_wait",
                                           {"site": "streaming_chunk"}):
                            pending = feeder.put(shard(starts[ci + 1], order))
                    host = torch.stack([torch.stack((m.loss, m.examples,
                                                     m.grad_norm))
                                        for m in metrics]).tolist()
                    _note_health(hl, metrics, [r[0] for r in host],
                                 [r[2] for r in host])
                    led.count = steps
                    if loads0 is not None and _kernels.loads() > loads0:
                        led.rebucket("compile")
                dt = led.duration_s / steps
                for loss, examples, _gnorm in host:
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
                                              checkpoint_every, mesh)
                if verbose:
                    log.info(f"[sparktorch_tpu_torch] epoch {epoch} chunk "
                             f"{ci} loss {host[-1][0]:.6f}")
        completed = True
    finally:
        if hl is not None:
            hl.flush()
        _finalize_checkpoint(ckpt, module, optimizer, global_step,
                             completed, mesh)
    return _result(module, spec, recorder)
