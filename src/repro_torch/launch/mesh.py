"""Production mesh shapes, as abstract meshes: axis names and sizes.

Port of ``repro/launch/mesh.py``.  The reference builds its meshes over
placeholder CPU devices for the dry-run; the port's dry-run runs each
device's program on ``meta`` tensors, so a mesh here is only its shape:
the single-pod (16, 16) = 256-device mesh or the 2-pod (2, 16, 16) =
512-device mesh.

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
