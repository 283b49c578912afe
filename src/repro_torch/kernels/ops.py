"""Packing wrappers around the N-body force kernels.

Port of the main-path part of ``repro/kernels/ops.py``.  These functions own
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

import torch

from repro_torch.kernels import nbody_force

_PAD_COLS = 8

# The precision axis (--dtype): fp64 = the oracle path in core.evaluate,
# fp32 = the float32 kernels, mixed = float32 I/O with bfloat16-rounded
# per-pair terms and compensated float32 accumulation.
DTYPES = ("fp64", "fp32", "mixed")
_COMPUTE_DTYPE = {"fp32": None, "mixed": "bfloat16"}


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
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[0]))


def pack_targets(pos, vel, n_pad: int, mask=None):
    """(N,3)x2 -> (n_pad, 8) target block [x y z act vx vy vz 0].

    Column 3 carries the target activity mask: 1.0 = evaluate this row,
    0.0 = skip.  ``mask=None`` means all targets active; alignment padding
    rows are always inactive.
    """
    n = pos.shape[0]
    f32 = torch.float32
    act = (torch.ones(n, dtype=f32, device=pos.device) if mask is None
           else mask.to(f32))
    zero = torch.zeros(n, dtype=f32, device=pos.device)
    cols = [pos[:, 0], pos[:, 1], pos[:, 2], act,
            vel[:, 0], vel[:, 1], vel[:, 2], zero]
    tgt = torch.stack([c.to(f32) for c in cols], dim=1)
    return _pad_rows(tgt, n_pad)


def pack_sources(pos, vel, mass, n_pad: int):
    """(N,3)x2 + (N,) -> (8, n_pad) source block [x y z m vx vy vz 0] rows."""
    n = pos.shape[0]
    f32 = torch.float32
    zero = torch.zeros(n, dtype=f32, device=pos.device)
    rows = [pos[:, 0], pos[:, 1], pos[:, 2], mass,
            vel[:, 0], vel[:, 1], vel[:, 2], zero]
    src = torch.stack([r.to(f32) for r in rows], dim=0)
    return torch.nn.functional.pad(src, (0, n_pad - n))


def pack_acc_targets(acc, n_pad: int):
    """(N,3) -> (n_pad, 8) [ax ay az 0...] snap-pass target operand."""
    a = torch.nn.functional.pad(acc.to(torch.float32),
                                (0, _PAD_COLS - 3))
    return _pad_rows(a, n_pad)


def pack_acc_sources(acc, n_pad: int):
    """(N,3) -> (8, n_pad) rows [ax ay az 0...] snap-pass source operand."""
    a = torch.nn.functional.pad(acc.to(torch.float32).T,
                                (0, n_pad - acc.shape[0], 0, _PAD_COLS - 3))
    return a.contiguous()


def _mask_rows(mask_t, *arrays):
    """Zero the rows of each array where the target mask is inactive."""
    m = mask_t.to(arrays[0].dtype)
    return tuple(a * (m[:, None] if a.dim() == 2 else m) for a in arrays)


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
    :func:`compute_dtype_for`).
    """
    compute_dtype = compute_dtype_for(dtype)
    n_t, n_s = pos_t.shape[0], pos_s.shape[0]
    tgt = pack_targets(pos_t, vel_t, _round_up(n_t, block_i), mask_t)
    src = pack_sources(pos_s, vel_s, mass_s, _round_up(n_s, block_j))
    out = nbody_force.acc_jerk_pot_packed(
        tgt, src, eps=eps, block_i=block_i, block_j=block_j,
        compute_dtype=compute_dtype)[:n_t]
    return out[:, 0:3], out[:, 3:6], out[:, 6]


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
    predicted).
    """
    compute_dtype = compute_dtype_for(dtype)
    n_t, n_s = pos_t.shape[0], pos_s.shape[0]
    nt_pad = _round_up(n_t, block_i)
    ns_pad = _round_up(n_s, block_j)
    out = nbody_force.snap_packed(
        pack_targets(pos_t, vel_t, nt_pad, mask_t),
        pack_sources(pos_s, vel_s, mass_s, ns_pad),
        pack_acc_targets(acc_t, nt_pad),
        pack_acc_sources(acc_s, ns_pad),
        eps=eps, block_i=block_i, block_j=block_j,
        compute_dtype=compute_dtype)
    return out[:n_t, 0:3]


def acc_jerk_pot(pos, vel, mass, **kw):
    """Symmetric all-pairs (targets == sources) convenience wrapper."""
    return acc_jerk_pot_rect(pos, vel, pos, vel, mass, **kw)


def snap(pos, vel, acc, mass, **kw):
    """Symmetric all-pairs snap convenience wrapper."""
    return snap_rect(pos, vel, acc, pos, vel, acc, mass, **kw)
