"""Device meshes: abstract ones (axis names and sizes) for the dry-run, and
real ones over the ranks of a process group.

Port of ``repro/launch/mesh.py``.  The reference builds its meshes over
placeholder CPU devices for the dry-run; the port's dry-run runs each
device's program on ``meta`` tensors, so a production mesh here is only
its shape: the single-pod (16, 16) = 256-device mesh or the 2-pod (2, 16,
16) = 512-device mesh.  :func:`make_device_mesh` is the reference's
``make_mesh(shape, axes, devices)`` over real devices: a
``torch.distributed.device_mesh.DeviceMesh`` of this process group's ranks
(one process per device, started e.g. by ``distributed.process_mesh.spawn``),
which ``distributed.shardings.MeshRules`` places ``DTensor``s on.

Axis semantics:
  pod   — data-parallel across pods (gradient all-reduce across pods);
  data  — data-parallel + FSDP parameter sharding within a pod;
  model — tensor/expert parallel (heads, d_ff, vocab, experts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device mesh's shape: ``shape[i]`` devices along ``axis_names[i]``."""
    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    """Any other mesh, e.g. for tests."""
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def make_device_mesh(shape: Sequence[int], axes: Sequence[str],
                     device_type: str = "cuda"):
    """A real mesh over every rank of the default process group, rank r at
    row-major position r of ``shape``, with ``mesh_dim_names`` ``axes``.
    The group must exist and hold exactly ``prod(shape)`` ranks.  CUDA
    ranks under gloo (several ranks on one card) gather through host
    memory (``process_mesh.stage_functional_all_gather``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("a device mesh is built after "
                           "torch.distributed.init_process_group")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.distributed.process_mesh import (
            stage_functional_all_gather)
        stage_functional_all_gather()
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
