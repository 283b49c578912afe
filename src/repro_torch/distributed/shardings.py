"""Logical-axis sharding rules with divisibility-checked fallback.

Port of ``repro/distributed/shardings.py`` over an abstract mesh: axis
names and sizes (``launch.mesh``), no devices.  Model code names array
dimensions by *logical* axis ("batch", "heads", ...); ``MeshRules`` maps
them to mesh axes and drops any mapping whose mesh axes do not divide the
dimension (e.g. kv_heads=2 on a 16-way 'model' axis -> replicated).  A
mesh axis is never used twice in one spec.

``spec`` returns a tuple with the entries of the reference's
``PartitionSpec`` (None, one axis name, or a tuple of them), and
``local_shape`` one device's shape under it: what the dry-run
(``launch.dryrun``) runs each device's program at.  ``shard`` is the
identity: the port runs one card, and a real multi-card mesh behind the
rules is still to come.

``MeshRules(None, ...)`` is the single-device no-op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

AxisVal = Union[str, Sequence[str], None]

# Baseline rule set for the production (pod, data, model) mesh.  'fsdp' axes
# shard parameters/optimizer state (ZeRO-3 style); activations use 'batch'.
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,                    # sequence-parallel variant: "model"
    "seq_q": None,                  # attention query-seq parallelism: "model"
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "layers": None,
    "state": None,
    "conv": None,
    # parameter (FSDP) axes
    "fsdp_d_model": ("data", "pod"),
    "fsdp_d_ff": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
}


def _axes_tuple(v: AxisVal):
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Optional[object]          # launch.mesh.AbstractMesh, or None
    rules: dict

    @classmethod
    def single_device(cls) -> "MeshRules":
        return cls(mesh=None, rules=dict(DEFAULT_RULES))

    @classmethod
    def for_mesh(cls, mesh, overrides: Optional[dict] = None) -> "MeshRules":
        rules = dict(DEFAULT_RULES)
        if overrides:
            rules.update(overrides)
        return cls(mesh=mesh, rules=rules)

    def with_overrides(self, **overrides) -> "MeshRules":
        rules = dict(self.rules)
        rules.update(overrides)
        return MeshRules(mesh=self.mesh, rules=rules)

    def axis_sizes(self) -> dict:
        """{mesh axis: size}; empty without a mesh."""
        if self.mesh is None:
            return {}
        return dict(zip(self.mesh.axis_names, self.mesh.shape))

    # ---------------- spec construction ----------------
    def spec(self, shape: Sequence[int],
             logical: Sequence[Optional[str]]) -> tuple:
        """The partition spec of ``shape`` under the rules, with fallbacks:
        per dimension None, one mesh axis, or a tuple of them."""
        if self.mesh is None:
            return ()
        assert len(shape) == len(logical), (shape, logical)
        used: set = set()
        out = []
        sizes = self.axis_sizes()
        for dim, name in zip(shape, logical):
            axes = _axes_tuple(self.rules.get(name)) if name else ()
            # drop axes already used or not dividing the dimension
            picked = []
            prod = 1
            for a in axes:
                if a in used or a not in sizes:
                    continue
                if dim % (prod * sizes[a]) == 0:
                    picked.append(a)
                    prod *= sizes[a]
            for a in picked:
                used.add(a)
            out.append(tuple(picked) if len(picked) > 1
                       else (picked[0] if picked else None))
        return tuple(out)

    def shards(self, entry) -> int:
        """How many ways one spec entry splits its dimension."""
        sizes = self.axis_sizes()
        return math.prod(sizes[a] for a in _axes_tuple(entry))

    def local_shape(self, shape: Sequence[int],
                    logical: Sequence[Optional[str]]) -> tuple:
        """One device's shape: each dimension divided by the product of
        the mesh axes ``spec`` picked for it."""
        if self.mesh is None:
            return tuple(shape)
        return tuple(d // self.shards(e)
                     for d, e in zip(shape, self.spec(shape, logical)))

    def shard(self, x, *logical: Optional[str]):
        """The identity: no multi-card mesh stands behind the rules yet."""
        return x

    def num_devices(self) -> int:
        return 1 if self.mesh is None else math.prod(self.mesh.shape)
