"""The sharded trainer over a (dp, fsdp, tp) mesh — the port of ``sparktorch_tpu/train/sharded.py``.

The JAX package lays its parameters out by sharding rules, splits the
batch over ``BATCH_AXES`` (dp × fsdp, replicated over tp) and lets GSPMD
insert every collective into one jitted step. The port does the same in
two layers: :func:`create_sharded_state` builds the module, asks
:func:`~sparktorch_tpu_torch.parallel.sharding_rules.shard_params` for
each leaf's placement, lays the tp-split leaves out on this rank's
shards (:func:`~sparktorch_tpu_torch.parallel.tp.parallelize`: heads,
MLP columns and vocabulary, with the f/g collectives inside the forward
and backward), then calls FSDP2's ``fully_shard`` on every transformer
block and on the root over the (dp, fsdp) sub-mesh of the rank's tp
coordinate (a 2-D mesh is HSDP: replicated over dp, sharded over fsdp).
A leaf whose rule names ``fsdp`` on dimension d becomes a DTensor
``Shard(d)`` of its (tp-local) tensor; every other leaf (tp-split or
replicated) is a plain tensor, left to the step in ``ignored_params``.
FSDP2 runs at one batch shard too (a one-rank fsdp axis), except where
the mesh is gloo's (device type "cpu") and the parameters are on CUDA:
FSDP2 would move them to the mesh's device type, so there every leaf
stays a plain tensor, and an fsdp axis above 1 raises.

The step (:func:`make_sharded_train_step`'s ``run``):

    den = Σ_batch w (one all-reduce over the batch group before the
          forward),
    objective = Σ_shard(per·w) / max(den, 1) + aux / batch_shards,

so the backward's sums over the batch group are the global gradients:
FSDP2 reduce-scatters the sharded leaves' gradients over fsdp and
all-reduces them over dp with a SUM (its divide-by-world default would
be wrong whenever shards carry different weight sums, e.g. weight-0
padding rows), and the plain leaves' gradients go through the step's
one coalesced all-reduce over the batch group (the dp × fsdp ranks of
this tp coordinate, which hold the same tp shards), with the loss sums
and the MoE drop counts; at one batch shard neither batch-group
collective is made. tp peers see the same rows, and the f/g pair
gives every replicated leaf its whole gradient on each of them. The MoE
aux loss is each shard's mean over its routing groups, averaged over the
shards: the global mean over groups, as GSPMD computes it. The loss is
Σ(per·w) / max(Σw, 1) plus that aux. ``grad_norm``, the health vector's
per-leaf norms and ``update_ratio`` are global: each leaf's squared
local norm is summed over the axes it is split on (fsdp, tp, both or
none; the dp replicas hold equal shards), in one all-reduce an axis.

Optimizers: the elementwise ones (sgd, adam, adamw, rmsprop, adagrad,
lion) run on the DTensor and tp shards unchanged; Lamb's per-tensor
trust ratio takes global norms (the DTensor norms are global over fsdp,
and the tp-split leaves' are summed over tp). The optimizer gets two
parameter groups, the DTensor leaves and the plain ones, so no fused
update mixes DTensors and plain tensors. Adafactor's factored moments
are not ported to shards: it raises on fsdp- or tp-split leaves
(ROADMAP, Queue 1, step 6).

What differs from the JAX package: the state is a
:class:`ShardedState` (module, optimizer, step) that ``run`` updates in
place and returns, not a pytree a jitted step returns anew;
``apply_fn`` and ``tx`` are the state's module and the spec's optimizer
(``create_sharded_state`` takes neither a ``tx`` nor ``rules``); the step
is eager, so the goodput ledger's first call is the ``compile`` one
(FSDP2's lazy init and any hand kernel's build happen there).
``mesh="auto"`` (``parallel/tune.py``, step 7) and ``seq_sharded=True``
(sp, step 6 part 3) raise.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from sparktorch_tpu_torch.ft import chaos as _chaos
from sparktorch_tpu_torch.inference import _resolve_device
from sparktorch_tpu_torch.models.transformer import EncoderLayer, collect_moe
from sparktorch_tpu_torch.obs import get_telemetry
from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs import health as _health
from sparktorch_tpu_torch.obs import profile as _stackprof
from sparktorch_tpu_torch.ops import _build as _kernels
from sparktorch_tpu_torch.parallel import tp as _tp
from sparktorch_tpu_torch.parallel.mesh import (
    AXIS_FSDP,
    AXIS_TP,
    BATCH_AXES,
    Mesh,
)
from sparktorch_tpu_torch.parallel.sharding_rules import (
    shard_params,
    transformer_rules,
)
from sparktorch_tpu_torch.train.step import (
    HealthVec,
    StepMetrics,
    all_reduce_sums,
    batchnorm_stats,
    forward,
)
from sparktorch_tpu_torch.utils import optim as _optim
from sparktorch_tpu_torch.utils.data import DataBatch
from sparktorch_tpu_torch.utils.tracing import profile_run, step_annotation


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, Queue 1, "
                               f"{where})")


def batch_specs(seq_sharded: bool) -> DataBatch:
    """Placements of (x, y, w): the batch dimension over dp × fsdp."""
    if seq_sharded:
        raise _later("seq_sharded=True (the sequence over sp)",
                     "step 6 part 3: sp with ring attention")
    return DataBatch(x=(BATCH_AXES,), y=(BATCH_AXES,), w=(BATCH_AXES,))


@dataclasses.dataclass
class ShardedState:
    """The sharded trainer's state: the laid-out module, its optimizer
    and the global step."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # The mesh axes (of size > 1) each trainable leaf is split on, in
    # parameter order.
    split_axes: List[Tuple[str, ...]] = dataclasses.field(
        default_factory=list, repr=False)
    # Per axis: which trainable leaves it splits, on the device (made
    # at the first step).
    split_masks: Optional[Dict[str, torch.Tensor]] = dataclasses.field(
        default=None, repr=False)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def _blocks(module: nn.Module) -> List[nn.Module]:
    """The units ``fully_shard`` wraps below the root: the transformer
    blocks."""
    return [m for m in module.modules() if isinstance(m, EncoderLayer)]


def _fully_shard(module: nn.Module, mesh: Mesh,
                 placements: Dict[str, tuple]) -> None:
    """``fully_shard`` every block, then the root, over the (dp, fsdp)
    sub-mesh: each leaf whose placement names fsdp is a ``Shard`` of
    that dimension, every other leaf is ignored (replicated over dp ×
    fsdp). Gradients are reduced as sums. A gloo mesh over CUDA
    parameters (two processes on one card) is left alone: FSDP2 would
    move them to the mesh's device type, "cpu"."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    on, kind = (next(module.parameters()).device.type,
                mesh.batch_mesh.device_type)
    if kind != on:
        if mesh.fsdp > 1:
            raise ValueError(f"fsdp={mesh.fsdp} over a {kind!r} mesh with "
                             f"{on!r} parameters: "
                             "FSDP2 needs the mesh on the parameters' "
                             "device (NCCL for CUDA)")
        return
    dims, ignored = {}, set()
    for name, p in module.named_parameters():
        spec = placements[name]
        if AXIS_FSDP in spec:
            dims[p] = Shard(spec.index(AXIS_FSDP))
        else:
            ignored.add(p)
    if not dims:
        return
    kw = dict(mesh=mesh.batch_mesh, shard_placement_fn=dims.get)
    for block in _blocks(module):
        own = set(block.parameters())
        fully_shard(block, ignored_params=own & ignored, **kw)
    fully_shard(module, ignored_params=ignored, **kw)
    for m in module.modules():
        if hasattr(m, "set_gradient_divide_factor"):
            m.set_gradient_divide_factor(1.0)
            # Without it a factor of 1 is a PREMUL_SUM, which gloo lacks.
            if hasattr(m, "set_force_sum_reduction_for_comms"):
                m.set_force_sum_reduction_for_comms(True)


def _split_axes(spec: tuple, mesh: Mesh) -> Tuple[str, ...]:
    named = {a for entry in spec if entry is not None
             for a in (entry if isinstance(entry, tuple) else (entry,))}
    return tuple(a for a in (AXIS_FSDP, AXIS_TP)
                 if a in named and mesh.shape[a] > 1)


def _tp_norms(split: set, group) -> Callable:
    """The optimizer's ``global_norms`` hook: the norms of the tp-split
    leaves (global over fsdp already, as DTensor norms are) summed over
    tp, in one all-reduce."""
    from torch.distributed.tensor import DTensor, Replicate

    def global_norms(params, norms):
        idx = [i for i, p in enumerate(params) if p in split]
        if not idx:
            return norms
        sq = torch.stack([(norms[i].full_tensor() if _is_dtensor(norms[i])
                           else norms[i]) for i in idx]).square()
        dist.all_reduce(sq, group=group)
        out = list(norms)
        for j, i in enumerate(idx):
            v = sq[j].sqrt()
            if _is_dtensor(norms[i]):
                m = norms[i].device_mesh
                v = DTensor.from_local(v, m, [Replicate()] * m.ndim)
            out[i] = v
        return out

    return global_norms


def _param_groups(module: nn.Module) -> List[dict]:
    sharded, plain = [], []
    for p in module.parameters():
        (sharded if _is_dtensor(p) else plain).append(p)
    return [{"params": g} for g in (sharded, plain) if g]


def create_sharded_state(spec, mesh: Mesh, rng: int = 0, device=None
                         ) -> Tuple[ShardedState, Dict[str, tuple]]:
    """The module of ``spec`` (built with the global generator seeded
    with ``rng``; an eager spec's module is copied as it is) on the
    device (CUDA unless ``device`` says otherwise), laid out by
    :func:`transformer_rules`, with the spec's optimizer. Returns the
    state and each parameter's placement (name → spec). Torch modules
    know their shapes without the JAX signature's ``sample_x`` trace."""
    dev = _resolve_device(device)
    if mesh.device_mesh is None:
        raise ValueError("the sharded trainer needs a process group: "
                         "init_process_group, then build_mesh (a world of "
                         "one too)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(rng))
        module = spec.make_module()
    if spec.module is not None:
        module = copy.deepcopy(module)  # leave the caller's module as it is
    module = module.to(dev).train()
    shardings = shard_params(module, mesh, transformer_rules(mesh))
    tp_split = _tp.parallelize(module, mesh, shardings)
    _fully_shard(module, mesh, shardings)
    optimizer = spec.make_optimizer(_param_groups(module),
                                    _optim.flax_shapes(module))
    split_axes = [_split_axes(shardings[k], mesh)
                  for k, p in module.named_parameters() if p.requires_grad]
    if isinstance(optimizer, _optim.Adafactor) and any(split_axes):
        raise _later("adafactor on fsdp- or tp-split leaves (its factored "
                     "moments over shards)",
                     "step 6: the sharded trainer's optimizers")
    if tp_split:
        named = dict(module.named_parameters())
        optimizer.global_norms = _tp_norms(
            {named[k] for k in tp_split}, mesh.tp_group)
    return ShardedState(module, optimizer, split_axes=split_axes), shardings


def shard_batch(batch: DataBatch, mesh: Mesh,
                seq_sharded: bool = False) -> DataBatch:
    """This rank's rows of ``batch``: the batch padded to a multiple of
    the batch shards with weight-0 rows, then the contiguous block of
    the rank's batch shard, dp outer and fsdp inner, as
    ``P(BATCH_AXES)`` lays it out (tp peers get the same rows)."""
    from sparktorch_tpu_torch.utils.data import shard_batch as _rows

    batch_specs(seq_sharded)
    return _rows(batch, mesh.batch_index, mesh.batch_shards)


def _sharded_step(state: ShardedState, batch: DataBatch, loss_fn: Callable,
                  mesh: Mesh, health: bool) -> StepMetrics:
    module, optimizer = state.module, state.optimizer
    group = mesh.batch_group
    optimizer.zero_grad(set_to_none=True)
    den = batch.w.sum().float()
    # One batch shard: nothing to sum over the batch group.
    if mesh.batch_shards == 1:
        group = None
    if group is not None:
        den = den.clone()
        dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    safe_den = den.clamp_min(1.0)
    # The block closes before the backward, so a remat layer recomputed
    # there records nothing a second time.
    with collect_moe() as moe:
        preds = forward(module, batch.x, batch.w)
    per = loss_fn(preds, batch.y)
    num = (per * batch.w).sum()
    objective = num / safe_den.to(num.dtype)
    aux = moe.aux_total()
    if aux is not None:
        aux = aux / mesh.batch_shards
        objective = objective + aux.to(objective.dtype)
    objective.backward()

    params, grads = [], []
    for p in module.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        params.append(p)
        grads.append(p.grad)
    sums = torch.stack([num.detach().float(),
                        torch.zeros_like(safe_den) if aux is None
                        else aux.detach().float()])
    counts = moe.counts()
    if group is not None:
        plain = [g for g in grads if not _is_dtensor(g)]
        stats = batchnorm_stats(module) if module.training else []
        all_reduce_sums([sums, *([] if counts is None else [counts]),
                         *plain, *stats], group)
        if stats:
            torch._foreach_div_(stats, float(mesh.batch_shards))
    loss = sums[0] / safe_den + sums[1]

    grad_sq = torch.stack(torch._foreach_norm(
        [_local(g) for g in grads])).float().square()
    upd_sq = new_sq = None
    if health:
        local_params = [_local(p) for p in params]
        with torch.no_grad():
            old = [t.clone() for t in local_params]
    optimizer.step()
    if health:
        with torch.no_grad():
            torch._foreach_sub_(old, local_params)  # old - new
            upd_sq = torch.stack(torch._foreach_norm(old)).float().square()
            new_sq = torch.stack(torch._foreach_norm(
                local_params)).float().square()
    # Global squares: each leaf's local square summed over the axes it
    # is split on (the dp replicas hold equal shards), a replicated
    # leaf's as it is; one all-reduce an axis.
    parts = [grad_sq] + ([upd_sq, new_sq] if health else [])
    if state.split_masks is None:
        state.split_masks = {
            axis: torch.tensor([axis in a for a in state.split_axes],
                               device=grad_sq.device)
            for axis in (AXIS_FSDP, AXIS_TP)
            if any(axis in a for a in state.split_axes)}
    n = len(params)
    for axis, mask in state.split_masks.items():
        group = mesh.fsdp_group if axis == AXIS_FSDP else mesh.tp_group
        flat = torch.cat([torch.where(mask, t, 0.0) for t in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        parts = [torch.where(mask, flat[i * n:(i + 1) * n], t)
                 for i, t in enumerate(parts)]
    leaf_norms = parts[0].sqrt()
    grad_norm = parts[0].sum().sqrt()
    hv = None
    if health:
        hv = HealthVec(
            finite=(torch.isfinite(loss) & torch.isfinite(grad_norm)).float(),
            update_ratio=parts[1].sum().sqrt()
            / parts[2].sum().sqrt().clamp_min(1e-12),
            leaf_norms=leaf_norms)
    state.step += 1
    return StepMetrics(
        loss=loss, examples=den, grad_norm=grad_norm,
        drop_fraction=None if counts is None
        else counts[0] / counts[1].clamp_min(1.0), health=hv)


def make_sharded_train_step(loss_fn: Callable, mesh, state_shardings=None,
                            seq_sharded: bool = False,
                            profile_dir: Optional[str] = None,
                            telemetry=None) -> Callable:
    """One sharded train step: the global weighted-mean loss and its
    gradients over the mesh (module docstring). Returns ``run(state,
    batch) -> (state, StepMetrics)``, ``batch`` being this rank's
    :func:`shard_batch`, with ``run.mesh``, ``run.shardings``,
    ``run.jitted`` (the bare step: no span, trace range, capture or
    health note, as the JAX run's jitted function), ``run.state``
    (None), ``run.tune_result`` (None) and ``run.finish()``.

    Every call is a ``train_sharded/step`` span on the bus and a
    ``train_step`` trace range; with ``profile_dir`` the first call
    starts a ``torch.profiler`` capture there, and ``run.finish()`` ends
    it and returns its :mod:`~sparktorch_tpu_torch.obs.xprof` analysis
    (None when nothing was captured). Under an active goodput ledger a
    call is a step span synced on the loss (the first one re-bucketed to
    ``compile``, with ``goodput.compiles_total{site=train_sharded}``),
    after ``chaos.straggle(rank, step)``. The health lane's ledger gets
    each step's device values. ``mesh="auto"`` raises (ROADMAP, step 7;
    the JAX signature's ``spec``, ``sample_batch``, ``rng`` and
    ``tune_kwargs`` serve that path only)."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a Mesh or 'auto', got {mesh!r}")
        raise _later("mesh='auto' (the mesh tuner, parallel/tune.py)",
                     "step 7")
    batch_specs(seq_sharded)
    tele = telemetry or get_telemetry()
    _stackprof.ensure(tele)
    _health.ensure(tele, rank=mesh.rank)
    loop = {"calls": 0, "profiler": None, "handle": None}

    def feed_health(state: ShardedState, m: StepMetrics) -> None:
        hl = _health.active()
        if hl is None:
            return
        if hl.leaf_keys is None:
            hl.leaf_keys = _health.health_leaf_keys(state.module)
        dev = {"loss": m.loss, "grad_norm": m.grad_norm}
        if m.health is not None:
            dev.update(finite=m.health.finite,
                       update_ratio=m.health.update_ratio,
                       leaf_norms=m.health.leaf_norms)
        hl.note_step(device=dev)

    def run(state: ShardedState, batch: DataBatch):
        if profile_dir and loop["profiler"] is None:
            loop["profiler"] = profile_run(profile_dir, telemetry=tele)
            loop["handle"] = loop["profiler"].__enter__()
        step_no = loop["calls"]
        loop["calls"] += 1
        dev = batch.x.device
        health = _health.active() is not None
        ledger = _goodput.active()
        if ledger is None:
            with tele.span("train_sharded/step"), \
                    step_annotation(step_no, telemetry=tele, device=dev):
                m = _sharded_step(state, batch, loss_fn, mesh, health)
            feed_health(state, m)
            return state, m
        _chaos.straggle(mesh.rank, step_no)
        loads0 = _kernels.loads()
        with tele.span("train_sharded/step"), \
                step_annotation(step_no, telemetry=tele, device=dev):
            with ledger.step_span(step=step_no) as led:
                m = _sharded_step(state, batch, loss_fn, mesh, health)
                if step_no == 0 or _kernels.loads() > loads0:
                    led.rebucket("compile")
                m.loss.cpu()  # the span's sync on the loss
        if led.bucket == "compile":
            tele.counter("goodput.compiles_total",
                         labels={"site": "train_sharded"})
        feed_health(state, m)
        return state, m

    def finish():
        profiler, loop["profiler"] = loop["profiler"], None
        if profiler is not None:
            profiler.__exit__(None, None, None)
        handle, loop["handle"] = loop["handle"], None
        analysis = handle["analysis"] if handle else None
        ledger = _goodput.active()
        if ledger is not None and analysis is not None:
            ledger.apply_analysis(analysis)
        return analysis

    def jitted(state: ShardedState, batch: DataBatch):
        return state, _sharded_step(state, batch, loss_fn, mesh,
                                    _health.active() is not None)

    run.mesh = mesh
    run.shardings = state_shardings
    run.jitted = jitted
    run.state = None
    run.tune_result = None
    run.finish = finish
    return run
