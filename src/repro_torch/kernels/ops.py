"""Packing wrappers around the N-body force kernels.

Port of ``repro/kernels/ops.py`` (the TPU-specific VMEM accounting is
not ported).  These functions own
the (un)packing between the physics-facing layout (pos/vel/mass tensors,
any N, any float dtype) and the kernels' packed, block-padded float32
layout, then call ``nbody_force``'s packed wrappers, which launch the CUDA
kernel for a CUDA tensor and run the plain version for a CPU tensor.  There
is no ``impl`` switch: the tensors' device decides.

The contract is rectangular: N_t targets against N_s sources.  A target that
also appears in the source set self-cancels; a source with m = 0 (block
padding) contributes exactly zero.  The optional target mask ``mask_t``
zeroes inactive rows, and a kernel block whose targets are all inactive
skips its work.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools

import torch

from repro_torch.kernels import nbody_force

_PAD_COLS = 8

# The precision axis (--dtype): fp64 = the oracle path in core.evaluate,
# fp32 = the float32 kernels, mixed = float32 I/O with bfloat16-rounded
# per-pair terms and compensated float32 accumulation.
DTYPES = ("fp64", "fp32", "mixed")
_COMPUTE_DTYPE = {"fp32": None, "mixed": "bfloat16"}
_IO_BYTES = {"fp64": 8, "fp32": 4, "mixed": 4}

# The source axis (--sources): "full" sweeps every launch over the complete
# source extent; "neighbor" is the Ahmad-Cohen split, each target block
# sweeping only its gathered window of neighbor source blocks at every
# event, the far field refreshed on a slower level (``kernels/neighbor.py``).
SOURCES = ("full", "neighbor")


def compute_dtype_for(dtype: str):
    """Kernel compute dtype for a precision-axis name (None = full fp32).

    ``mixed`` uses bfloat16 rather than fp16: the pairwise ``m_j / d^3``
    term overflows fp16's 65504 on softened close encounters, while bf16
    keeps fp32's exponent range.  ``fp64`` never reaches the packed
    kernels; ``core.evaluate``'s oracle branch owns it.
    """
    try:
        return _COMPUTE_DTYPE[dtype]
    except KeyError:
        raise ValueError(
            f"kernel dtype must be 'fp32' or 'mixed' (fp64 runs the oracle "
            f"path in core.evaluate); got {dtype!r}") from None


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows(x, n_pad):
    """Zero rows appended along the row axis (-2) up to ``n_pad``."""
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[-2]))


def pack_targets(pos, vel, n_pad: int, mask=None):
    """(B?, N, 3) x 2 -> (B?, n_pad, 8) target block [x y z act vx vy vz 0].

    Column 3 carries the target activity mask: 1.0 = evaluate this row,
    0.0 = skip.  ``mask=None`` means all targets active; alignment padding
    rows are always inactive.  An optional leading batch axis carries
    through.
    """
    f32 = torch.float32
    lead = pos.shape[:-1]
    act = (torch.ones(lead, dtype=f32, device=pos.device) if mask is None
           else mask.to(f32))
    zero = torch.zeros(lead, dtype=f32, device=pos.device)
    cols = [pos[..., 0], pos[..., 1], pos[..., 2], act,
            vel[..., 0], vel[..., 1], vel[..., 2], zero]
    tgt = torch.stack([c.to(f32) for c in cols], dim=-1)
    return _pad_rows(tgt, n_pad)


def pack_sources(pos, vel, mass, n_pad: int):
    """(B?, N, 3) x 2 + (B?, N) -> (B?, 8, n_pad) source block, rows
    [x y z m vx vy vz 0]."""
    f32 = torch.float32
    zero = torch.zeros(pos.shape[:-1], dtype=f32, device=pos.device)
    rows = [pos[..., 0], pos[..., 1], pos[..., 2], mass,
            vel[..., 0], vel[..., 1], vel[..., 2], zero]
    src = torch.stack([r.to(f32) for r in rows], dim=-2)
    return torch.nn.functional.pad(src, (0, n_pad - pos.shape[-2]))


def pack_acc_targets(acc, n_pad: int):
    """(B?, N, 3) -> (B?, n_pad, 8) [ax ay az 0...] snap-pass target
    operand."""
    a = torch.nn.functional.pad(acc.to(torch.float32),
                                (0, _PAD_COLS - 3))
    return _pad_rows(a, n_pad)


def pack_acc_sources(acc, n_pad: int):
    """(B?, N, 3) -> (B?, 8, n_pad) rows [ax ay az 0...] snap-pass source
    operand."""
    a = torch.nn.functional.pad(acc.to(torch.float32).transpose(-1, -2),
                                (0, n_pad - acc.shape[-2], 0, _PAD_COLS - 3))
    return a.contiguous()


def _mask_rows(mask_t, *arrays):
    """Zero the rows of each array where the target mask is inactive
    (``mask_t`` is ``(B?, N)``; an array is ``(B?, N)`` or ``(B?, N, k)``)."""
    m = mask_t.to(arrays[0].dtype)
    return tuple(a * (m[..., None] if a.dim() > m.dim() else m)
                 for a in arrays)


# --------------------------------------------------------------------------
# active-target compaction (gather/scatter around the rect kernels)
# --------------------------------------------------------------------------
# The activity mask lets the kernels skip blocks whose targets are all
# inactive, but the grid still covers the full target extent.  Compaction
# gathers the active targets into a dense, block-aligned buffer of one of a
# few capacities, runs the rect kernels on a ceil(cap/BI) x N/BJ grid
# (sources stay full, so the physics is unchanged) and scatters the outputs
# back to their particle slots.  Each output row is a row-local sum over
# the same sources in the same order, so the compacted result is bit for
# bit the masked dense one.  The reference picks the capacity on the device
# with ``lax.switch``; a CUDA launch needs its extent on the host, so here
# the capacity is a Python int.


def capacity_buckets(n: int, block_i: int) -> tuple:
    """Capacity schedule for ``n`` targets: block-aligned powers of two
    ``(BI, 2*BI, 4*BI, ..., ceil(n/BI)*BI)``."""
    n_pad = _round_up(n, block_i)
    caps = []
    c = block_i
    while c < n_pad:
        caps.append(c)
        c *= 2
    caps.append(n_pad)
    return tuple(caps)


@functools.lru_cache(maxsize=64)
def _caps_tensor(caps: tuple, device) -> torch.Tensor:
    """``caps`` as an int64 tensor on ``device``, made once: a tensor made
    from host data on the card is a copy that waits for the device."""
    return torch.tensor(caps, dtype=torch.int64, device=device)


def bucket_index(n_active, caps):
    """Index of the smallest capacity bucket with ``caps[i] >= n_active``
    (``n_active`` an int or an integer tensor; the last bucket is ``>= n``,
    so the result is always in range)."""
    if not isinstance(n_active, torch.Tensor):
        n_active = torch.tensor(n_active)
    return torch.searchsorted(_caps_tensor(tuple(caps), n_active.device),
                              n_active.to(torch.int64), side="left")


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Capacity-bucket plan for one compacted launch extent.

    The dense target extent being compacted, the source extent every
    launch sweeps, the tile shape and the pass count travel together, so
    evaluators, engines and telemetry agree on what one bucket costs.
    ``caps`` defaults to :func:`capacity_buckets` over ``n_targets``;
    :meth:`restrict` truncates it for a bucket group whose members never
    exceed a known active count.  Tiles are counted in the reference's
    logical (BI, BJ) units, so they compare with the reference's counts.
    """

    n_targets: int
    n_sources: int
    block_i: int
    block_j: int
    n_passes: int = 2
    caps: tuple = ()
    dtype: str = "fp32"
    sources: str = "full"

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(
                f"plan dtype must be one of {DTYPES}, got {self.dtype!r}")
        if self.sources not in SOURCES:
            raise ValueError(
                f"plan sources must be one of {SOURCES}, got {self.sources!r}")
        if not self.caps:
            object.__setattr__(
                self, "caps", capacity_buckets(self.n_targets, self.block_i))

    @property
    def io_bytes_per_element(self) -> int:
        """Bytes per staged element at this plan's dtype (``mixed`` stages
        float32; only the per-pair arithmetic narrows)."""
        return _IO_BYTES[self.dtype]

    @property
    def tile_io_bytes(self) -> int:
        """Bytes one (i, j) tile stages: the (BI, 8) target block and the
        (8, BJ) source block in, the (BI, 8) output block out.  A
        ``sources="neighbor"`` plan also pays the window gather per tile:
        the (8, BJ) source block read from its resident rows and written
        into the target block's gathered window."""
        base = ((2 * self.block_i * 8 + 8 * self.block_j)
                * self.io_bytes_per_element)
        if self.sources == "neighbor":
            base += 2 * 8 * self.block_j * self.io_bytes_per_element
        return base

    @property
    def tiles_by_cap(self) -> tuple:
        """Grid tiles one event enqueues at each capacity (all passes)."""
        j_tiles = -(-self.n_sources // self.block_j)
        return tuple((c // self.block_i) * j_tiles * self.n_passes
                     for c in self.caps)

    @property
    def dense_tiles(self) -> int:
        """Tiles of the masked full-extent launch (``compaction="none"``)."""
        return (nbody_force.grid_tiles(self.n_targets, self.n_sources,
                                       self.block_i, self.block_j)
                * self.n_passes)

    def bucket(self, n_active):
        """Index of the smallest bucket holding ``n_active``."""
        return bucket_index(n_active, self.caps)

    def tiles(self, idx: int) -> int:
        """Tiles one event enqueues at bucket ``idx``."""
        return self.tiles_by_cap[idx]

    # -- the source-extent schedule (the Ahmad-Cohen neighbor windows) -----
    @property
    def source_caps(self) -> tuple:
        """Source-extent schedule in rows: block_j-aligned powers of two up
        to the padded full source extent.  The last bucket is the full
        window, so a neighbor window that outgrows every smaller bucket
        runs the exact all-pairs sweep: overflow falls back to the full
        window, never to truncation."""
        return capacity_buckets(self.n_sources, self.block_j)

    def source_bucket(self, n_src_rows):
        """Index of the smallest source bucket holding ``n_src_rows``
        gathered source rows (an int or an integer tensor)."""
        return bucket_index(n_src_rows, self.source_caps)

    @property
    def window_tiles_by_cap(self) -> tuple:
        """Tiles one neighbor event enqueues at each source-window capacity
        (all passes): every target block sweeps its gathered window of
        ``cap / BJ`` source blocks instead of the full j-extent."""
        i_tiles = -(-self.n_targets // self.block_i)
        return tuple(i_tiles * (c // self.block_j) * self.n_passes
                     for c in self.source_caps)

    def window_tiles(self, idx: int) -> int:
        """Tiles one neighbor event enqueues at source bucket ``idx``."""
        return self.window_tiles_by_cap[idx]

    def shard(self, n_shards: int) -> "CapacityPlan":
        """The per-shard local plan: each shard compacts its own
        ``n_targets / n_shards`` target rows against the same sources (the
        strategies pad N to a shard multiple first, so the split is exact).
        The ring's plan, whose sources are the local extent too and whose
        ``n_passes`` counts every round of every pass, is built directly
        (``core.strategies._shard_plan``)."""
        if self.n_targets % n_shards:
            raise ValueError(
                f"{self.n_targets} targets do not split over "
                f"{n_shards} shards")
        return dataclasses.replace(
            self, n_targets=self.n_targets // n_shards, caps=())

    def restrict(self, ceiling: int) -> "CapacityPlan":
        """Plan truncated to the buckets a member with at most ``ceiling``
        active targets can ever select: its bucket group's schedule.
        ``ceiling`` must lie in ``(0, caps[-1]]``."""
        ceiling = int(ceiling)
        if not 0 < ceiling <= self.caps[-1]:
            raise ValueError(
                f"ceiling={ceiling} outside this plan's capacity range "
                f"(0, {self.caps[-1]}]")
        idx = bisect.bisect_left(self.caps, ceiling)
        return dataclasses.replace(self, caps=self.caps[: idx + 1])

    def admission_cap(self, n_active: int) -> int:
        """Capacity ceiling for admitting a run of ``n_active`` bodies: the
        top bucket of :meth:`restrict`, the smallest pod extent whose
        launch schedule the member can never exceed.  The server keys its
        pods by it, so a pod's bucket groups, and with them its cached
        engine, stay the same under admit, retire and backfill."""
        n_active = int(n_active)
        if not 0 < n_active <= self.caps[-1]:
            raise ValueError(
                f"n_active={n_active} outside this plan's capacity range "
                f"(0, {self.caps[-1]}]")
        return self.restrict(n_active).caps[-1]


def _window(perm, cap: int):
    """The first ``cap`` entries of each row of ``perm`` (all of them when
    ``cap`` exceeds the row count)."""
    return perm[..., : min(cap, perm.shape[-1])]


def _rows_index(idx, x):
    """``idx`` (B?, k) shaped to index the row axis of ``x`` (B?, N, ...)."""
    return idx.reshape(idx.shape + (1,) * (x.dim() - idx.dim())).expand(
        idx.shape + x.shape[idx.dim():])


def compact_targets(perm, cap: int, *rows):
    """Gather the first ``cap`` permuted rows of each per-target array.

    ``perm`` (``(B?, N)``) puts active rows first (a stable argsort of the
    inactive flag), so with ``cap >= n_active`` the gathered buffer holds
    every active target followed by inactive fill rows, whose outputs the
    activity mask zeroes.
    """
    idx = _window(perm, cap)
    dim = idx.dim() - 1
    return tuple(torch.gather(r, dim, _rows_index(idx, r)) for r in rows)


def scatter_outputs(perm, cap: int, n: int, *outs):
    """Scatter compacted kernel outputs back to their particle slots.

    Rows outside the gathered set are exactly zero, as the masked dense
    evaluation leaves inactive targets, so this after
    :func:`compact_targets` is the identity on active rows and zero
    elsewhere.  Each output is a fresh tensor.
    """
    idx = _window(perm, cap)
    dim = idx.dim() - 1
    return tuple(
        o.new_zeros(o.shape[:dim] + (n,) + o.shape[dim + 1:]).scatter(
            dim, _rows_index(idx, o), o)
        for o in outs)


def scatter_sources(perm, cap: int, base, upd, mask_c):
    """Blend compacted pass-1 outputs into a predicted source operand.

    The snap pass needs every source's acceleration at the event time:
    fresh values for the targets the event evaluated, the predicted
    ``base`` rows for everyone else.  Scattering the compacted fresh rows
    (where their compacted mask is set) into a copy of ``base`` gives
    exactly ``where(mask, scatter_outputs(upd), base)``, bit for bit,
    without the dense intermediate.  ``base`` itself is not written.
    """
    idx = _window(perm, cap)
    dim = idx.dim() - 1
    ridx = _rows_index(idx, base)
    m = mask_c[..., None] if upd.dim() > mask_c.dim() else mask_c
    rows = torch.where(m, upd.to(base.dtype), torch.gather(base, dim, ridx))
    return base.scatter(dim, ridx, rows)


def acc_jerk_pot_rect(
    pos_t, vel_t, pos_s, vel_s, mass_s,
    *,
    mask_t=None,
    eps: float = 1e-7,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    dtype: str = "fp32",
):
    """(acc, jerk, pot) of N_t targets due to N_s sources, float32 I/O.

    ``mask_t`` (optional ``(N_t,)`` activity mask) restricts evaluation to
    the active targets; sources stay full and inactive rows return zeros.
    ``dtype="mixed"`` narrows the per-pair arithmetic (see
    :func:`compute_dtype_for`).  Every operand may carry a leading batch
    axis B (``(B, N_t, 3)`` targets against ``(B, N_s, 3)`` sources): the B
    systems then go through one launch per pass.
    """
    compute_dtype = compute_dtype_for(dtype)
    n_t, n_s = pos_t.shape[-2], pos_s.shape[-2]
    tgt = pack_targets(pos_t, vel_t, _round_up(n_t, block_i), mask_t)
    src = pack_sources(pos_s, vel_s, mass_s, _round_up(n_s, block_j))
    out = nbody_force.acc_jerk_pot_packed(
        tgt, src, eps=eps, block_i=block_i, block_j=block_j,
        compute_dtype=compute_dtype)[..., :n_t, :]
    return out[..., 0:3], out[..., 3:6], out[..., 6]


def snap_rect(
    pos_t, vel_t, acc_t, pos_s, vel_s, acc_s, mass_s,
    *,
    mask_t=None,
    eps: float = 1e-7,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    dtype: str = "fp32",
):
    """Snap of N_t targets due to N_s sources (second Hermite pass).

    ``mask_t`` restricts the pass to active targets (see
    :func:`acc_jerk_pot_rect`); ``acc_s`` must then hold the *predicted*
    acceleration of inactive sources (the caller blends evaluated and
    predicted).  A leading batch axis goes through as in
    :func:`acc_jerk_pot_rect`.
    """
    compute_dtype = compute_dtype_for(dtype)
    n_t, n_s = pos_t.shape[-2], pos_s.shape[-2]
    nt_pad = _round_up(n_t, block_i)
    ns_pad = _round_up(n_s, block_j)
    out = nbody_force.snap_packed(
        pack_targets(pos_t, vel_t, nt_pad, mask_t),
        pack_sources(pos_s, vel_s, mass_s, ns_pad),
        pack_acc_targets(acc_t, nt_pad),
        pack_acc_sources(acc_s, ns_pad),
        eps=eps, block_i=block_i, block_j=block_j,
        compute_dtype=compute_dtype)
    return out[..., :n_t, 0:3]


def acc_jerk_pot(pos, vel, mass, **kw):
    """Symmetric all-pairs (targets == sources) convenience wrapper."""
    return acc_jerk_pot_rect(pos, vel, pos, vel, mass, **kw)


def snap(pos, vel, acc, mass, **kw):
    """Symmetric all-pairs snap convenience wrapper."""
    return snap_rect(pos, vel, acc, pos, vel, acc, mass, **kw)
