"""Mesh construction and multi-host launch — the port of ``sparktorch_tpu/parallel``.

Data parallelism only: :class:`~.mesh.MeshConfig` keeps the JAX
package's six axes, and any axis but ``dp`` above 1 raises
(ROADMAP, Queue 1, items 7 and 8).
"""

from sparktorch_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    build_mesh,
    initialize_distributed,
)

__all__ = ["Mesh", "MeshConfig", "build_mesh", "initialize_distributed"]
