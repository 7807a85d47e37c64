"""The (dp, fsdp, tp) mesh over a ``torch.distributed`` world — the port of ``sparktorch_tpu/parallel/mesh.py:46-156``.

The JAX package carves its devices into six named axes. The port runs
one process per GPU and three of them: ``dp`` (data parallel, parameters
replicated), ``fsdp`` (data parallel with parameters sharded, FSDP2
over the ``fsdp`` sub-mesh) and ``tp`` (tensor parallel: the
transformer's heads, MLP columns and vocabulary split over the ``tp``
sub-mesh, :mod:`~sparktorch_tpu_torch.parallel.tp`). :class:`MeshConfig`
refuses ``sp``, ``ep`` and ``pp`` above 1. Ranks fill the (dp, fsdp, tp)
grid row-major, as the JAX mesh's devices fill ``ALL_AXES``: tp peers
are adjacent ranks. The batch is split over dp × fsdp (``BATCH_AXES``)
and replicated over tp, dp outermost: a rank's batch shard is its place
on the (dp, fsdp) grid, :attr:`Mesh.batch_index` (the rank itself when
tp = 1), its rows the contiguous block the JAX mesh's
``P(("dp", "fsdp"))`` gives that device
(:func:`sparktorch_tpu_torch.utils.data.shard_batch`). So every trainer
reads :attr:`Mesh.batch_index`, :attr:`Mesh.batch_shards` and
:attr:`Mesh.batch_group` (the ranks of the other batch shards that
share this rank's tp coordinate), never the rank or the dp axis alone.

Shardings are placement descriptors: a tuple with one entry per
dimension of the leaf, each ``None`` (not split), an axis name or a
tuple of axis names — ``jax.sharding.PartitionSpec``'s entries, with the
trailing ``None`` s dropped (``()`` is replicated).

Multi-host bring-up goes through :func:`initialize_distributed`
(``torch.distributed.init_process_group``: NCCL on CUDA, gloo on the
CPU) or :func:`sparktorch_tpu_torch.parallel.launch.bringup_multihost`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"
ALL_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP)
# Axes over which the batch dimension is split (and grads are summed).
BATCH_AXES = (AXIS_DP, AXIS_FSDP)
COORDINATOR_ENV = "SPARKTORCH_TPU_COORDINATOR"

# The axes a process's mesh spans, outermost first.
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP)
# Where each refused axis is queued (ROADMAP, Queue 1).
_LATER = {AXIS_SP: "step 6 part 3 (ring attention)",
          AXIS_EP: "step 6 part 4 (expert all-to-all)",
          AXIS_PP: "step 7 (train/pipeline.py)"}

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX package's axes. ``dp=None`` takes what ``fsdp`` and
    ``tp`` leave of the world; ``sp``, ``ep`` and ``pp`` must stay 1."""

    dp: Optional[int] = None
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def __post_init__(self):
        wide = {a: getattr(self, a) for a in _LATER if getattr(self, a) != 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} are not ported yet (ROADMAP, Queue 1, "
                f"{'; '.join(_LATER[a] for a in wide)}; items 7 and 8); the "
                "port's mesh is dp x fsdp x tp")

    def resolve(self, world_size: int) -> dict:
        fixed = self.fsdp * self.tp
        if self.fsdp < 1 or self.tp < 1 or world_size % fixed:
            raise ValueError(f"world size {world_size} not divisible by "
                             f"fsdp*tp={self.fsdp}*{self.tp}")
        dp = self.dp if self.dp is not None else world_size // fixed
        if dp * fixed != world_size:
            raise ValueError(f"mesh dp={dp} x fsdp={self.fsdp} x tp={self.tp}"
                             f" != world size {world_size}: the port runs one "
                             "process per device")
        return {AXIS_DP: dp, AXIS_FSDP: self.fsdp, AXIS_TP: self.tp,
                **{a: 1 for a in ALL_AXES[3:]}}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, fsdp, tp) world this process belongs to.
    ``batch_group`` is the group the batch is split over and the
    gradients are summed over: the dp × fsdp ranks that share this
    rank's tp coordinate (the whole world when tp = 1), None when no
    process group is initialized (a world of one that makes no
    collective call); ``device_mesh`` is the torch ``DeviceMesh`` of
    shape (dp, fsdp, tp), when there is one."""

    shape: dict
    rank: int = 0
    batch_group: Optional[object] = None
    device_mesh: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.shape[AXIS_DP]

    @property
    def fsdp(self) -> int:
        return self.shape[AXIS_FSDP]

    @property
    def tp(self) -> int:
        return self.shape[AXIS_TP]

    @property
    def world(self) -> int:
        """Processes in the mesh: dp × fsdp × tp."""
        return self.batch_shards * self.tp

    @property
    def batch_shards(self) -> int:
        """How many shards the batch is split into: dp × fsdp."""
        return self.dp * self.fsdp

    @property
    def batch_index(self) -> int:
        """This rank's batch shard: its place on the (dp, fsdp) grid.
        tp peers share it, and with it their rows and their draws."""
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the tp axis."""
        return self.rank % self.tp

    @property
    def fsdp_group(self):
        """The ranks that share one replica's parameter shards."""
        return (None if self.device_mesh is None
                else self.device_mesh.get_group(AXIS_FSDP))

    @property
    def tp_group(self):
        """The tp peers of this rank (one batch shard's ranks)."""
        return (None if self.device_mesh is None
                else self.device_mesh.get_group(AXIS_TP))

    @property
    def batch_mesh(self):
        """The (dp, fsdp) sub-mesh of this rank's tp coordinate, over
        which ``fully_shard`` lays the fsdp shards out."""
        return (None if self.device_mesh is None
                else self.device_mesh[BATCH_AXES])


def _batch_group(shape: dict, device_mesh):
    """The group of the (dp, fsdp) sub-mesh of this rank's tp
    coordinate: the whole world when tp = 1."""
    if shape[AXIS_TP] == 1:
        return dist.group.WORLD
    return device_mesh[BATCH_AXES]._flatten().get_group()


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over the default process group, or a world of one when
    none is initialized. Ranks fill the (dp, fsdp, tp) grid
    row-major."""
    config = config or MeshConfig()
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(config.resolve(1))
    shape = config.resolve(dist.get_world_size())
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type,
                                   tuple(shape[a] for a in MESH_AXES),
                                   mesh_dim_names=MESH_AXES)
    return Mesh(shape, rank=dist.get_rank(),
                batch_group=_batch_group(shape, device_mesh),
                device_mesh=device_mesh)


def local_mesh(n: Optional[int] = None, **axes) -> Mesh:
    """:func:`build_mesh` of ``MeshConfig(**axes)``; ``n``, when given,
    must be the world size (a process is one device)."""
    mesh = build_mesh(MeshConfig(**axes))
    if n is not None and n != mesh.world:
        raise ValueError(f"local_mesh({n}) in a world of {mesh.world}")
    return mesh


def batch_sharding(mesh: Mesh) -> Spec:
    """Sharding for (batch, ...) arrays: batch split over dp+fsdp,
    replicated over tp."""
    return (BATCH_AXES,)


def replicated(mesh: Mesh) -> Spec:
    return ()


def fsdp_param_sharding(mesh: Mesh, leaf: Union[torch.Tensor,
                                                Sequence[int]]) -> Spec:
    """Shard a parameter leaf (or a shape) over the fsdp axis along its
    largest divisible dimension (the first of equal ones); replicate if
    nothing divides."""
    shape = tuple(leaf.shape if isinstance(leaf, torch.Tensor) else leaf)
    n = mesh.shape[AXIS_FSDP]
    if n <= 1 or not shape:
        return replicated(mesh)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0 and shape[d] >= n:
            return (None,) * d + (AXIS_FSDP,)
    return replicated(mesh)


def param_shardings(mesh: Mesh, params: Mapping[str, torch.Tensor]) -> dict:
    """Name → :func:`fsdp_param_sharding` of each leaf of ``params``."""
    return {k: fsdp_param_sharding(mesh, v) for k, v in params.items()}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group: ``init_process_group`` over
    ``tcp://<coordinator_address>`` (``host:port``; default from
    ``$SPARKTORCH_TPU_COORDINATOR``). ``backend`` defaults to NCCL when a
    CUDA device is present, each process on the card ``process_id %
    device_count``, and to gloo otherwise (pass ``"gloo"`` for CPU
    tensors on a machine with cards). No-op when a group is already
    initialized or no coordinator is named (single process)."""
    if dist.is_initialized():
        return
    coordinator_address = (coordinator_address
                           or os.environ.get(COORDINATOR_ENV))
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with a "
                         "coordinator address")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
