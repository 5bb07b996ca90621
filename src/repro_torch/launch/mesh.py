"""Production mesh shapes, as axis-name -> size maps.

Port of the JAX package's ``repro/launch/mesh.py`` for the dry run: the mesh
is its axis sizes (``repro_torch.sharding.MeshCtx``), and no device is
created.  ``make_mesh`` over cards (a ``torch.distributed`` device mesh)
waits for the multi-card slice.
"""

from __future__ import annotations

__all__ = ["production_mesh_axes"]


def production_mesh_axes(multi_pod: bool = False) -> dict[str, int]:
    """Single pod: 16 x 16 = 256 chips (data, model).
    Multi-pod: 2 pods x 256 = 512 chips (pod, data, model)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}
