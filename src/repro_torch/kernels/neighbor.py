"""Neighbor-window construction for the Ahmad-Cohen block scheme.

Port of ``repro/kernels/neighbor.py``, as torch functions on the tensor's
device.  The Ahmad-Cohen split (``sources="neighbor"``) evaluates each
target block's near force against a small gathered window of source
blocks at every event, and refreshes the far remainder on a slower
power-of-two level.  This module builds those windows:

* :func:`block_bounds` / :func:`block_spheres`: the axis-aligned bounding
  box / bounding sphere (validity-masked) of each contiguous index block
  the kernels tile by;
* :func:`build_windows`: source block ``J`` joins target block ``I``'s
  window iff the distance between their boxes is ``<= r``.  The box
  distance lower-bounds every particle-pair distance across the two
  blocks, so no pair inside the radius is ever dropped.  Windows are a
  fixed-shape ``(n_blocks_i, n_blocks_j)`` index table whose first
  ``win_cnt[i]`` entries are the selected source blocks in ascending order
  (a stable argsort of the boolean test);
* :func:`kd_perm`: balanced orthogonal recursive bisection (median split
  on the widest extent), so every aligned ``leaf``-row block is one
  compact spatial cell; :func:`morton_keys` / :func:`morton_perm` are the
  Z-order alternative.

These are set-up and per-refresh work, not kernels: nothing here reaches a
Pallas kernel in the reference, and nothing here launches one of the
port's.  Every function equals the reference's output exactly on the same
inputs (the distance is summed in the reference's order, the sorts are
stable, ties in ``argmax`` go to the first index), and the window
functions take an optional leading batch axis.
"""

from __future__ import annotations

import numpy as np
import torch


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` (int64) to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0xFF0000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Morton (Z-order) key per row: 10 bits per axis, quantized in the
    valid rows' bounding box.  Invalid rows key to ``0xFFFFFFFF`` (all real
    keys fit in 30 bits) so a stable sort keeps them last.  The keys are
    int64 holding the reference's uint32 values."""
    v = valid[:, None]
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    lo = torch.where(v, pos, inf).amin(dim=0)
    hi = torch.where(v, pos, -inf).amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((pos - lo) / span * 1024.0, 0.0, 1023.0).to(torch.int64)
    key = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
           | (_spread_bits(q[:, 2]) << 2))
    return torch.where(valid, key, 0xFFFFFFFF)


def morton_perm(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Permutation that Z-orders the valid rows (invalid rows stay last, in
    their original relative order)."""
    return torch.argsort(morton_keys(pos, valid), stable=True)


def kd_perm(pos: torch.Tensor, valid: torch.Tensor, *,
            leaf: int = 32) -> torch.Tensor:
    """Balanced orthogonal-recursive-bisection (k-d) ordering.

    Recursively halves the row set by the median of its widest coordinate
    extent until every cell holds ``leaf`` rows, and returns the
    permutation that lays the cells out contiguously, so every aligned
    block of ``leaf`` (or a multiple) consecutive rows is one compact
    axis-aligned cell.  Invalid rows key as ``+inf`` at every split, so
    they end as a right-aligned suffix in their original relative order,
    the padding layout the engines expect.  ``leaf`` should divide the
    kernel block sizes that tile the sorted rows.
    """
    n = pos.shape[0]
    depth = 0
    while leaf << depth < n:
        depth += 1
    p2 = leaf << depth
    pp = torch.nn.functional.pad(pos, (0, 0, 0, p2 - n))
    vv = torch.nn.functional.pad(valid, (0, p2 - n))
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    order = torch.arange(p2, device=pos.device)
    for level in range(depth):
        cells = order.reshape(1 << level, -1)
        cp, cv = pp[cells], vv[cells]
        v3 = cv[..., None]
        lo = torch.where(v3, cp, inf).amin(dim=1)
        hi = torch.where(v3, cp, -inf).amax(dim=1)
        ext = torch.where(cv.any(dim=1)[:, None], hi - lo, 0.0)
        dim = torch.argmax(ext, dim=1)
        key = torch.gather(cp, 2, dim[:, None, None].expand(-1, cp.shape[1],
                                                            1))[..., 0]
        key = torch.where(cv, key, inf)
        cperm = torch.argsort(key, dim=1, stable=True)
        order = torch.gather(cells, 1, cperm).reshape(-1)
    return order[:n]


_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _two_sum(a, b):
    """``a + b = s + e`` exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """``a * b = p + e`` exactly (Dekker's split; each torch op rounds on
    its own, so nothing is contracted into a fused multiply-add)."""
    f = _SPLIT[a.dtype]

    def split(x):
        c = f * x
        hi = c - (c - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """``a * b + c`` rounded once, as a fused multiply-add rounds it
    (Boldo and Melquiond's emulation: the error terms summed with
    rounding to odd, then one rounding to nearest)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, ul)
    vh, vl = _two_sum(uh, th)
    w, e = _two_sum(tl, vl)
    even = (w.view(_BITS[w.dtype]) & 1) == 0
    inf = torch.full_like(w, float("inf"))
    w = torch.where((e != 0) & even,
                    torch.nextafter(w, torch.where(e > 0, inf, -inf)), w)
    return vh + w


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  On the card ``torch.sqrt`` is (IEEE
    ``sqrt``/``sqrtf``); on the CPU torch takes it from MKL's vector math,
    which can be one unit in the last place off, so the CPU path takes
    numpy's, which is correctly rounded."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (3) rounded as the reference's
    ``jnp.linalg.norm`` is on the CPU, where XLA sums the squares in axis
    order with fused multiply-adds: ``sqrt(fma(z, z, fma(y, y, x * x)))``.
    A box distance that lands on the radius then rounds the same."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return _sqrt(_fma(x2, x2, _fma(x1, x1, x0 * x0)))


def _blocked(pos, valid, block: int):
    """``(B?, n, 3)`` rows and ``(B?, n)`` validity padded to whole blocks:
    ``(B?, nb, block, 3)`` and ``(B?, nb, block)``."""
    n = pos.shape[-2]
    nb = -(-n // block)
    pad = nb * block - n
    p = torch.nn.functional.pad(pos, (0, 0, 0, pad))
    w = torch.nn.functional.pad(valid, (0, pad))
    return (p.reshape(pos.shape[:-2] + (nb, block, 3)),
            w.reshape(valid.shape[:-1] + (nb, block)))


def block_spheres(pos: torch.Tensor, valid: torch.Tensor, block: int):
    """Bounding sphere of every contiguous ``block``-row index block.

    Centers and radii are weighted by the validity mask; a block with no
    valid rows gets a zero-radius sphere at the origin and count 0.
    Returns ``(centers (nb, 3), radii (nb,), counts (nb,) int32)``.
    """
    p, w = _blocked(pos, valid, block)
    cnt = w.sum(dim=-1).to(torch.int32)
    wf = w[..., None].to(p.dtype)
    c = (p * wf).sum(dim=-2) / torch.clamp(cnt, min=1)[..., None]
    r = torch.where(w, _norm3(p - c[..., None, :]), 0.0).amax(dim=-1)
    return c, r, cnt


def block_bounds(pos: torch.Tensor, valid: torch.Tensor, block: int):
    """Axis-aligned bounding box of every contiguous ``block``-row block.

    Returns ``(lo (nb, 3), hi (nb, 3), counts (nb,) int32)``.  A block with
    no valid rows gets an inverted box (``lo = +inf, hi = -inf``), at
    ``+inf`` distance from anything.
    """
    p, w = _blocked(pos, valid, block)
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    w3 = w[..., None]
    lo = torch.where(w3, p, inf).amin(dim=-2)
    hi = torch.where(w3, p, -inf).amax(dim=-2)
    return lo, hi, w.sum(dim=-1).to(torch.int32)


def build_windows(pos: torch.Tensor, valid: torch.Tensor, *, block_i: int,
                  block_j: int, radius: float):
    """Per-target-block neighbor windows over the source blocks.

    Source block ``J`` is selected for target block ``I`` iff the distance
    between their bounding boxes is ``<= radius``.  Blocks with no valid
    rows are never selected, and an empty target block selects nothing (it
    must not widen the shared capacity bucket).

    Returns ``(win_idx (B?, nbt, nsb) int32, win_cnt (B?, nbt) int32)``:
    ``win_idx[i, :win_cnt[i]]`` are the selected source blocks in ascending
    order; the remaining entries are the unselected blocks, also ascending,
    so every prefix of a row is a valid gather index.
    """
    tlo, thi, tcnt = block_bounds(pos, valid, block_i)
    slo, shi, scnt = block_bounds(pos, valid, block_j)
    gap = torch.clamp(torch.maximum(slo[..., None, :, :] - thi[..., :, None, :],
                                    tlo[..., :, None, :] - shi[..., None, :, :]),
                      min=0.0)
    nbr = _norm3(gap) <= radius
    nbr &= (scnt > 0)[..., None, :] & (tcnt > 0)[..., :, None]
    win_cnt = nbr.sum(dim=-1).to(torch.int32)
    win_idx = torch.argsort((~nbr).to(torch.int8), dim=-1,
                            stable=True).to(torch.int32)
    return win_idx, win_cnt
