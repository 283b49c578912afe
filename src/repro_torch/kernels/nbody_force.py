"""All-pairs N-body force kernels on packed operands.

Port of ``repro/kernels/nbody_force.py``.  The packed layouts stay those of
the reference, so tests compare like with like:

    tgt     : (N_t, 8)  rows = targets, cols = [x y z act vx vy vz 0]
    src     : (8, N_s)  rows = [x y z m vx vy vz 0], cols = sources
    out     : (N_t, 8)  cols = [ax ay az jx jy jz pot 0]
    tgt_acc : (N_t, 8)  cols = [ax ay az 0...]      (snap pass)
    src_acc : (8, N_s)  rows = [ax ay az 0...]      (snap pass)
    snap    : (N_t, 8)  cols = [sx sy sz 0...]

Column 3 of the targets is the activity mask: each output row is scaled by
it.  An optional leading batch axis (``(B, N_t, 8)`` with ``(B, 8, N_s)``)
evaluates B independent systems in one launch.

The tensor's device picks the path.  A CUDA tensor launches the
hand-written kernel of ``csrc/nbody_force.cu`` on the current stream, or
raises; a CPU tensor runs the plain PyTorch version beside it
(``_acc_jerk_plain`` / ``_snap_plain``), which computes exactly the Pallas
function: per (i-block, j-block) tile a float32 sum over the block's
sources, accumulated across j-blocks, with a two-sum compensation in mixed
mode folded in at the end.  Each wrapper counts its kernel launches in its
``launches`` attribute, and in ``blocks`` (``{CUDA blocks of the grid:
launches}``) the grid size that the kernel's launcher reports.  A ``meta``
tensor (the dry-run, ``launch.dryrun``) launches nothing: the wrapper
reports the kernel's work to the op counter
(``kernels.bounds.meta_launch``) and returns an empty result, or the plain
version run on ``meta`` when the counter asks for it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, bounds

# Logical tile shape of the reference.  The CUDA kernels pick their own
# tiling; BI and BJ remain the units of grid_tiles, of the alignment the
# packed operands carry and of the plain version's accumulation order.
DEFAULT_BLOCK_I = 256
DEFAULT_BLOCK_J = 512

_X, _Y, _Z, _M, _VX, _VY, _VZ = 0, 1, 2, 3, 4, 5, 6
_ACT = _M  # target blocks carry the activity mask in the (unused) mass slot

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16}

#: the most systems one launch takes: the batch rides the grid's y extent
#: (``gridDim.y``); a larger batch fails at launch
MAX_BATCH = 65535

#: pair budget of one row chunk of the plain version (bounds its
#: temporaries to a few hundred MB at N_s = 65536)
_PLAIN_PAIRS = 1 << 22


def grid_tiles(n_t: int, n_s: int, block_i: int, block_j: int) -> int:
    """Number of (i-block, j-block) tiles of one launch over ``n_t`` targets
    and ``n_s`` sources, as the reference counts them."""
    return -(-n_t // block_i) * -(-n_s // block_j)


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the card's kernels are held against them)
# --------------------------------------------------------------------------
def _rounder(compute_dtype):
    if compute_dtype is None:
        return lambda x: x
    cdt = _COMPUTE_DTYPES[compute_dtype]
    return lambda x: x.to(cdt).to(torch.float32)


def _geometry(tgt, src, eps):
    """Pairwise displacement and softened inverse distance of a row chunk."""
    dx, dy, dz = (src[k:k + 1, :] - tgt[:, k:k + 1] for k in (_X, _Y, _Z))
    r2 = dx * dx + dy * dy + dz * dz
    d2 = r2 + torch.tensor(eps, dtype=torch.float32) ** 2
    # self-pairs (r2 == 0) must contribute exactly zero, incl. the potential
    safe = r2 > 0.0
    one = torch.ones_like(d2)
    inv_r = torch.where(safe, torch.rsqrt(torch.where(safe, d2, one)),
                        torch.zeros_like(d2))
    d2s = torch.where(safe, d2, one)
    return dx, dy, dz, d2s, inv_r


def _dv(tgt, src):
    return tuple(src[k:k + 1, :] - tgt[:, k:k + 1] for k in (_VX, _VY, _VZ))


def _block_sums(x, block_j):
    """(R, N_s) per-pair terms -> (R, N_s / BJ) float32 sums per j-block."""
    return x.reshape(x.shape[0], -1, block_j).sum(dim=-1)


def _accumulate(partials, compensated):
    """Sum (R, nJ, 8) j-block partials in j order: plain adds, or two-sums
    whose carried error folds in after the last block."""
    out = torch.zeros_like(partials[:, 0])
    comp = torch.zeros_like(out)
    for k in range(partials.shape[1]):
        c = partials[:, k]
        if not compensated:
            out = out + c
            continue
        s = out + c
        bb = s - out
        comp = comp + ((out - (s - bb)) + (c - bb))
        out = s
    return out + comp if compensated else out


def _row_chunks(n_t, n_s, block_i):
    rows = max(block_i, (_PLAIN_PAIRS // max(n_s, 1)) // block_i * block_i)
    return range(0, n_t, rows), rows


def _acc_jerk_plain(tgt, src, *, eps, block_j, block_i, compute_dtype):
    rnd = _rounder(compute_dtype)
    starts, rows = _row_chunks(tgt.shape[0], src.shape[1], block_i)
    out = []
    for i0 in starts:
        t = tgt[i0:i0 + rows]
        dx, dy, dz, d2, inv_r = _geometry(t, src, eps)
        inv_r3 = inv_r * inv_r * inv_r
        mj = src[_M:_M + 1, :]
        tt = mj * inv_r3

        dvx, dvy, dvz = _dv(t, src)
        rv = dx * dvx + dy * dvy + dz * dvz
        q = (-3.0 * rv) / d2

        def bsum(x):
            return _block_sums(rnd(x), block_j)

        ax, ay, az = bsum(tt * dx), bsum(tt * dy), bsum(tt * dz)
        jx = bsum(tt * (dvx + q * dx))
        jy = bsum(tt * (dvy + q * dy))
        jz = bsum(tt * (dvz + q * dz))
        pot = -bsum(mj * inv_r)
        partial = torch.stack(
            [ax, ay, az, jx, jy, jz, pot, torch.zeros_like(ax)], dim=-1)
        act = t[:, _ACT:_ACT + 1, None]
        out.append(_accumulate(act * partial, compute_dtype is not None))
    return torch.cat(out)


def _snap_plain(tgt, src, tgt_acc, src_acc, *, eps, block_j, block_i,
                compute_dtype):
    rnd = _rounder(compute_dtype)
    starts, rows = _row_chunks(tgt.shape[0], src.shape[1], block_i)
    out = []
    for i0 in starts:
        t, ta = tgt[i0:i0 + rows], tgt_acc[i0:i0 + rows]
        dx, dy, dz, d2, inv_r = _geometry(t, src, eps)
        inv_r3 = inv_r * inv_r * inv_r
        tt = src[_M:_M + 1, :] * inv_r3

        dvx, dvy, dvz = _dv(t, src)
        dax, day, daz = (src_acc[k:k + 1, :] - ta[:, k:k + 1]
                         for k in range(3))

        alpha = (dx * dvx + dy * dvy + dz * dvz) / d2
        beta = (dvx * dvx + dvy * dvy + dvz * dvz
                + dx * dax + dy * day + dz * daz) / d2 + alpha * alpha

        # A0 / A1 / A2 chains, per component (paper Alg. 3 extended to snap)
        a3, b3 = -3.0 * alpha, -3.0 * beta
        px, py, pz = tt * dx, tt * dy, tt * dz
        jx, jy, jz = tt * dvx + a3 * px, tt * dvy + a3 * py, tt * dvz + a3 * pz

        def bsum(x):
            return _block_sums(rnd(x), block_j)

        sx = bsum(tt * dax - 6.0 * alpha * jx + b3 * px)
        sy = bsum(tt * day - 6.0 * alpha * jy + b3 * py)
        sz = bsum(tt * daz - 6.0 * alpha * jz + b3 * pz)
        zero = torch.zeros_like(sx)
        partial = torch.stack([sx, sy, sz] + [zero] * 5, dim=-1)
        act = t[:, _ACT:_ACT + 1, None]
        out.append(_accumulate(act * partial, compute_dtype is not None))
    return torch.cat(out)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
@functools.cache
def _library():
    lib = _build.load("nbody_force")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    blocks = ctypes.POINTER(ctypes.c_int)
    lib.nbody_acc_jerk_pot.argtypes = [ptr, ptr, ptr, i32, i32, i32, f32,
                                       i32, ptr, blocks]
    lib.nbody_acc_jerk_pot.restype = ctypes.c_int
    lib.nbody_snap.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32,
                               i32, ptr, blocks]
    lib.nbody_snap.restype = ctypes.c_int
    return lib


def _check(tgt_like, src_like, block_i, block_j, compute_dtype):
    """Validate packed operands; returns (batch, n_t, n_s), batch 0 for
    unbatched operands."""
    if compute_dtype is not None and compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be None or one of "
                         f"{tuple(_COMPUTE_DTYPES)}; got {compute_dtype!r}")
    t0, s0 = tgt_like[0], src_like[0]
    if t0.dim() not in (2, 3):
        raise ValueError(f"targets must be (N_t, 8) or (B, N_t, 8); got "
                         f"{tuple(t0.shape)}")
    lead = tuple(t0.shape[:-2])
    n_t, n_s = t0.shape[-2], s0.shape[-1]
    for x in tgt_like:
        if tuple(x.shape) != lead + (n_t, 8):
            raise ValueError(f"target operand shape {tuple(x.shape)}, "
                             f"expected {lead + (n_t, 8)}")
    for x in src_like:
        if tuple(x.shape) != lead + (8, n_s):
            raise ValueError(f"source operand shape {tuple(x.shape)}, "
                             f"expected {lead + (8, n_s)}")
    for x in tgt_like + src_like:
        if x.dtype != torch.float32:
            raise TypeError(f"packed operands are float32; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("packed operands must be contiguous")
        if x.device != t0.device:
            raise ValueError(f"operands on {t0.device} and {x.device}")
    if t0.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {t0.device}")
    if n_t % block_i or n_s % block_j:
        raise ValueError(f"N_t={n_t} and N_s={n_s} must be multiples of "
                         f"block_i={block_i} and block_j={block_j}")
    return (lead[0] if lead else 0), n_t, n_s


def _plain(fn, operands, batch, **kw):
    if not batch:
        return fn(*operands, **kw)
    return torch.stack([fn(*(x[b] for x in operands), **kw)
                        for b in range(batch)])


def _raise_on(rc: int, name: str):
    if rc:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def _count(wrapper, blocks: ctypes.c_int):
    """One launch of ``wrapper``'s kernel, on a grid of ``blocks``."""
    wrapper.launches += 1
    wrapper.blocks[blocks.value] = wrapper.blocks.get(blocks.value, 0) + 1


def _meta_launch(name, plain, operands, batch, n_t, n_s, compute_dtype,
                 **kw):
    """The launch's work reported to the op counter (``kernels.bounds``):
    the kernel table's operations, every target row against every source,
    in ``flops`` only; the bytes as the kernel streams them."""
    dtype = "fp32" if compute_dtype is None else "mixed"
    out = bounds.meta_launch(
        name, dot_flops=0,
        flops=bounds.FLOPS_PER_PAIR[(name, dtype)] * max(batch, 1) * n_t * n_s,
        nbytes=bounds.nbody_stream_bytes(name, n_t, n_s, max(batch, 1)),
        plain=lambda: _plain(plain, operands, batch,
                             compute_dtype=compute_dtype, **kw))
    return torch.empty_like(operands[0]) if out is None else out


def acc_jerk_pot_packed(
    tgt,
    src,
    *,
    eps: float = 1e-7,
    block_i: int = DEFAULT_BLOCK_I,
    block_j: int = DEFAULT_BLOCK_J,
    compute_dtype: str | None = None,
):
    """All-pairs acceleration + jerk + potential on packed operands.

    ``tgt``: (N_t, 8) float32, ``src``: (8, N_s) float32 (or both with a
    leading batch axis), N_t a multiple of ``block_i`` and N_s of
    ``block_j`` (``ops.py`` pads).  Returns packed (N_t, 8).
    ``compute_dtype="bfloat16"`` rounds per-pair terms through bfloat16 and
    compensates the accumulation.
    """
    batch, n_t, n_s = _check((tgt,), (src,), block_i, block_j, compute_dtype)
    if tgt.device.type == "cpu":
        return _plain(_acc_jerk_plain, (tgt, src), batch, eps=eps,
                      block_i=block_i, block_j=block_j,
                      compute_dtype=compute_dtype)
    if tgt.device.type == "meta":
        return _meta_launch("acc_jerk_pot", _acc_jerk_plain, (tgt, src),
                            batch, n_t, n_s, compute_dtype, eps=eps,
                            block_i=block_i, block_j=block_j)
    out = torch.empty_like(tgt)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = _library().nbody_acc_jerk_pot(
            tgt.data_ptr(), src.data_ptr(), out.data_ptr(), max(batch, 1),
            n_t, n_s, eps, int(compute_dtype is not None), stream,
            ctypes.byref(blocks))
    _raise_on(rc, "nbody_acc_jerk_pot")
    _count(acc_jerk_pot_packed, blocks)
    return out


acc_jerk_pot_packed.launches = 0
acc_jerk_pot_packed.blocks = {}


def snap_packed(
    tgt,
    src,
    tgt_acc,
    src_acc,
    *,
    eps: float = 1e-7,
    block_i: int = DEFAULT_BLOCK_I,
    block_j: int = DEFAULT_BLOCK_J,
    compute_dtype: str | None = None,
):
    """All-pairs snap pass on packed operands (see the module docstring)."""
    batch, n_t, n_s = _check((tgt, tgt_acc), (src, src_acc), block_i,
                             block_j, compute_dtype)
    if tgt.device.type == "cpu":
        return _plain(_snap_plain, (tgt, src, tgt_acc, src_acc), batch,
                      eps=eps, block_i=block_i, block_j=block_j,
                      compute_dtype=compute_dtype)
    if tgt.device.type == "meta":
        return _meta_launch("snap", _snap_plain,
                            (tgt, src, tgt_acc, src_acc), batch, n_t, n_s,
                            compute_dtype, eps=eps, block_i=block_i,
                            block_j=block_j)
    out = torch.empty_like(tgt)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = _library().nbody_snap(
            tgt.data_ptr(), src.data_ptr(), tgt_acc.data_ptr(),
            src_acc.data_ptr(), out.data_ptr(), max(batch, 1), n_t, n_s,
            eps, int(compute_dtype is not None), stream, ctypes.byref(blocks))
    _raise_on(rc, "nbody_snap")
    _count(snap_packed, blocks)
    return out


snap_packed.launches = 0
snap_packed.blocks = {}
