"""Logical-axis sharding rules with divisibility-checked fallback.

Port of ``repro/distributed/shardings.py``.  Model code names array
dimensions by *logical* axis ("batch", "heads", ...); ``MeshRules`` maps
them to mesh axes and drops any mapping whose mesh axes do not divide the
dimension (e.g. kv_heads=2 on a 16-way 'model' axis -> replicated).  A
mesh axis is never used twice in one spec.

The mesh behind the rules is one of two kinds (``launch.mesh``):

* an ``AbstractMesh``, axis names and sizes with no devices: ``spec``
  and ``local_shape`` (one device's shape under the spec) are what the
  dry-run (``launch.dryrun``) runs each device's program at, and
  ``shard`` is the identity;
* a real ``torch.distributed.device_mesh.DeviceMesh`` (``is_real``): GSPMD's
  counterpart in PyTorch.  ``placements`` turns a spec into one
  ``Shard(dim)`` or ``Replicate()`` per mesh axis, ``sharding`` into a
  :class:`NamedSharding` (the reference's ``NamedSharding``), whose
  ``place`` is ``jax.device_put``, and ``shard`` redistributes a
  ``DTensor`` to the spec (the reference's ``with_sharding_constraint``).

Where a spec shards one dimension over several mesh axes, DTensor splits
it in the mesh's axis order; the reference splits it in the spec's order.
The values are the same; which device holds which block may differ.

``MeshRules(None, ...)`` is the single-device no-op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _mesh_axes(mesh) -> tuple:
    """(axis names, sizes) of an abstract or a real mesh."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.shape)


class NamedSharding:
    """A layout on a real mesh: one ``Shard(dim)`` or ``Replicate()`` per
    mesh axis, the counterpart of ``jax.sharding.NamedSharding``.  A leaf
    of a tree (not a node), so trees of them pair with parameter trees."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh: DeviceMesh, placements: Sequence):
        self.mesh, self.placements = mesh, tuple(placements)

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {list(self.placements)})"

    def place(self, x: torch.Tensor) -> DTensor:
        """``x``, the whole tensor, held alike by every rank, as a DTensor
        with this rank's block: ``jax.device_put``.  Every rank cuts its
        own block, so no bytes move between ranks (``distribute_tensor``
        would scatter from rank 0).  A DTensor is redistributed."""
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        local = x
        coord = self.mesh.get_coordinate()
        for axis, pl in enumerate(self.placements):
            if isinstance(pl, Shard):
                n = self.mesh.size(axis)
                if local.shape[pl.dim] % n:
                    raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does "
                                     f"not split {n} ways")
                local = local.chunk(n, dim=pl.dim)[coord[axis]]
        # a copy, so the block does not keep the whole tensor's storage
        return DTensor.from_local(
            local.clone(memory_format=torch.contiguous_format), self.mesh,
            self.placements, run_check=False)

    def zeros(self, shape, dtype, device) -> DTensor:
        """A zero DTensor of global ``shape``: each rank allocates only its
        block."""
        local = list(shape)
        for axis, pl in enumerate(self.placements):
            if isinstance(pl, Shard):
                local[pl.dim] //= self.mesh.size(axis)
        return DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=device), self.mesh,
            self.placements, run_check=False)


def block_index(x: DTensor, dim: int, coord=None) -> int:
    """Which of the equal blocks of the DTensor ``x``'s dimension ``dim``
    the rank at mesh coordinate ``coord`` (this rank's by default) holds
    (0 where the dimension is whole); blocks are split in the mesh's axis
    order."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate() if coord is None else coord
    idx = 0
    for axis, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * mesh.size(axis) + coord[axis]
    return idx


def gather_to_first(x: DTensor):
    """The DTensor ``x`` (Shard or Replicate placements) whole on the host
    of rank 0 of its mesh, None on every other rank: each rank sends its
    block once (``dist.gather``), a quarter of an all-gather's bytes on
    four ranks.  A collective over the mesh's ranks, which must be the
    whole default group."""
    import torch.distributed as dist

    mesh = x.device_mesh
    grid = mesh.mesh
    local = x.to_local().detach()
    if dist.get_backend() != "nccl":
        local = local.cpu()
    local = local.contiguous()
    first = int(grid.flatten()[0])
    rank = dist.get_rank()
    parts = ([torch.empty_like(local) for _ in range(grid.numel())]
             if rank == first else None)
    dist.gather(local, parts, dst=first)
    if rank != first:
        return None
    whole = torch.empty(x.shape, dtype=local.dtype)
    for r, part in enumerate(parts):
        coord = [int(c) for c in (grid == r).nonzero()[0]]
        idx = []
        for d, size in enumerate(x.shape):
            n = math.prod(mesh.size(a) for a, pl in enumerate(x.placements)
                          if isinstance(pl, Shard) and pl.dim == d)
            b = block_index(x, d, coord)
            idx.append(slice(b * size // n, (b + 1) * size // n))
        whole[tuple(idx)] = part.cpu()
    return whole


def full(x):
    """A DTensor's whole value on every rank (a collective); any other
    value as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Optional[object]          # AbstractMesh, DeviceMesh or None
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

    @property
    def is_real(self) -> bool:
        """Whether a ``DeviceMesh`` of ranks stands behind the rules."""
        return isinstance(self.mesh, DeviceMesh)

    def axis_sizes(self) -> dict:
        """{mesh axis: size}; empty without a mesh."""
        if self.mesh is None:
            return {}
        return dict(zip(*_mesh_axes(self.mesh)))

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

    def placements(self, shape: Sequence[int],
                   logical: Sequence[Optional[str]]) -> tuple:
        """``spec`` as DTensor placements: per mesh axis, ``Shard(d)`` for
        the dimension d whose entry names the axis, else ``Replicate()``."""
        names = _mesh_axes(self.mesh)[0]
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec(shape, logical)):
            for a in _axes_tuple(entry):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def sharding(self, shape: Sequence[int],
                 logical: Sequence[Optional[str]]) -> Optional[NamedSharding]:
        """The layout of ``shape`` under the rules on a real mesh; None
        without one, as the reference's is without a mesh."""
        if not self.is_real:
            return None
        return NamedSharding(self.mesh, self.placements(shape, logical))

    def shard(self, x, *logical: Optional[str]):
        """``with_sharding_constraint`` by logical axes: on a real mesh the
        DTensor ``x`` redistributed to the spec (a collective where its
        placements differ); the identity otherwise."""
        if not self.is_real:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(f"rules.shard on a real mesh takes a DTensor; got "
                            f"a {type(x).__name__} (place it first with "
                            f"rules.put)")
        return x.redistribute(self.mesh, self.placements(x.shape, logical))

    def put(self, x, *logical: Optional[str]):
        """``x`` placed by logical axes: a whole tensor held alike by every
        rank becomes a DTensor with this rank's block (no bytes move), a
        DTensor is redistributed; the identity without a real mesh."""
        if not self.is_real:
            return x
        return self.sharding(x.shape, logical).place(x)

    def num_devices(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(_mesh_axes(self.mesh)[1])
