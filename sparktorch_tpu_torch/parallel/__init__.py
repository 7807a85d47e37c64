"""Mesh construction, sharding rules and multi-host launch — the port of ``sparktorch_tpu/parallel``.

:class:`~.mesh.MeshConfig` keeps the JAX package's six axes; ``dp``,
``fsdp`` and ``tp`` (:mod:`~.tp`) are ported, and ``sp``, ``ep`` or
``pp`` above 1 raise (ROADMAP, Queue 1, step 6's later parts and step
7).
"""

from sparktorch_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    initialize_distributed,
    local_mesh,
)

__all__ = ["BATCH_AXES", "Mesh", "MeshConfig", "build_mesh",
           "initialize_distributed", "local_mesh"]
