"""The data-parallel mesh over a ``torch.distributed`` world — the port of ``sparktorch_tpu/parallel/mesh.py:46-156``.

The JAX package carves its devices into six named axes. The port runs
one process per GPU and data parallelism only: ``dp`` is the world of
the default process group (or a world of one when none is initialized),
and :class:`MeshConfig` refuses every other axis above 1. The batch is
split over ``dp`` in contiguous shards, as the JAX mesh's dp sharding
lays it out (:func:`sparktorch_tpu_torch.utils.data.shard_batch`).

Multi-host bring-up goes through :func:`initialize_distributed`
(``torch.distributed.init_process_group``: NCCL on CUDA, gloo on the
CPU) or :func:`sparktorch_tpu_torch.parallel.launch.bringup_multihost`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"
ALL_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP)
COORDINATOR_ENV = "SPARKTORCH_TPU_COORDINATOR"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX package's axes. ``dp=None`` takes the whole world; every
    other axis must stay 1 (not ported yet)."""

    dp: Optional[int] = None
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def __post_init__(self):
        wide = {a: getattr(self, a) for a in ALL_AXES[1:]
                if getattr(self, a) != 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} are not ported yet (ROADMAP, Queue 1: the "
                "rest of multi-GPU training, items 7 and 8: sharding, "
                "sequence and expert parallelism, train/pipeline.py); the "
                "port's mesh is data-parallel only")

    def resolve(self, world_size: int) -> dict:
        dp = self.dp if self.dp is not None else world_size
        if dp != world_size:
            raise ValueError(f"mesh dp={dp} != world size {world_size}: the "
                             "port runs one process per device")
        return {AXIS_DP: dp, **{a: 1 for a in ALL_AXES[1:]}}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The dp world this process belongs to. ``group`` is None when no
    process group is initialized (a world of one that makes no
    collective call); ``device_mesh`` is the torch ``DeviceMesh`` over
    the group, when there is one."""

    shape: dict
    rank: int = 0
    group: Optional[object] = None
    device_mesh: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.shape[AXIS_DP]


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over the default process group, or a world of one when
    none is initialized."""
    config = config or MeshConfig()
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(config.resolve(1))
    shape = config.resolve(dist.get_world_size())
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, (shape[AXIS_DP],),
                                   mesh_dim_names=(AXIS_DP,))
    return Mesh(shape, rank=dist.get_rank(),
                group=device_mesh.get_group(AXIS_DP),
                device_mesh=device_mesh)


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
