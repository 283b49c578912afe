"""Gradient compression: int8 quantization with error feedback.

Port of ``repro/distributed/compression.py``.  One fp32 scale per tensor
(its max |x| / 127) and int8 levels; the error-feedback buffer carries
each round's quantization residual into the next, so the compressed
gradients sum to the true ones over time (Seide et al. 2014; Karimireddy
et al. 2019).  ``compress_tree`` is the in-step form the train step
applies before the optimizer.

The unkeyed path rounds half to even (``torch.round``, as ``jnp.round``)
and divides in float32, so on the CPU it gives the reference's bits.
The keyed path takes a ``torch.Generator`` for its stochastic rounding:
it has the reference's distribution, not its bits.

A ``DTensor`` leaf (a gradient on a device mesh) is quantized block by
block with the scale of the *whole* leaf, as the reference's ``jnp.max``
under its mesh: each rank's largest |x| is reduced to the largest over
the leaf's blocks (``MAX`` over the group of each mesh axis the leaf is
split on; a replicated axis holds the same block on every rank), so
every element gets one device's levels for the same values.
The error buffers of ``zeros_error`` are placed as their parameters.

:func:`compressed_psum` is the reference's int8-on-the-wire all-reduce
(there inside ``shard_map``; nothing in the reference calls it) over a
``torch.distributed`` process group, one rank per shard, as
``distributed.process_mesh`` runs them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import tree as tree_util
from repro_torch.distributed.process_mesh import all_reduce

_LEVELS = 127.0
F32 = torch.float32


def quantize(x, generator: Optional[torch.Generator] = None):
    """x (fp) -> (int8 q, fp32 scale).  Stochastic rounding when
    ``generator`` is given (it must live on x's device; on a DTensor each
    rank draws for its own block).  A DTensor ``x`` gives a DTensor ``q``
    placed as ``x`` and the whole leaf's scale, a plain tensor on every
    rank."""
    xf = x.to(F32)
    if isinstance(xf, DTensor) and any(p.is_partial() for p in xf.placements):
        xf = xf.redistribute(placements=[
            Replicate() if p.is_partial() else p for p in xf.placements])
    local = xf.to_local() if isinstance(xf, DTensor) else xf
    amax = torch.amax(torch.abs(local))
    if isinstance(xf, DTensor):
        for axis, p in enumerate(xf.placements):
            if p.is_shard():
                amax = all_reduce(amax, dist.ReduceOp.MAX,
                                  xf.device_mesh.get_group(axis))
    # divide by a tensor on x's device: a CUDA division by a host scalar
    # multiplies by its reciprocal instead, which is not the eager bits
    levels = torch.full((), _LEVELS, dtype=F32, device=local.device)
    scale = torch.clamp(amax / levels, min=1e-30)
    y = local / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       dtype=F32, device=y.device))
    else:
        y = torch.round(y)
    q = torch.clamp(y, -127, 127).to(torch.int8)
    if isinstance(xf, DTensor):
        q = DTensor.from_local(q, xf.device_mesh, xf.placements,
                               run_check=False)
    return q, scale


def dequantize(q, scale):
    return q.to(F32) * scale


def compress_leaf(g, e):
    """One error-feedback round: returns (g_hat, new_err)."""
    corrected = g.to(F32) + e
    q, s = quantize(corrected)
    g_hat = dequantize(q, s)
    return g_hat, corrected - g_hat


def compress_tree(grads: dict, err: dict):
    """Error-feedback int8 compression leaf by leaf: (g_hat, new_err)."""
    out = tree_util.map(compress_leaf, grads, err)
    return (tree_util.map(lambda t: t[0], out),
            tree_util.map(lambda t: t[1], out))


def zeros_error(params: dict) -> dict:
    """A zero fp32 error buffer per parameter, on its device (on a mesh a
    DTensor placed as the parameter)."""
    return tree_util.map(lambda p: torch.zeros_like(p, dtype=F32), params)


def compressed_psum(x, group=None):
    """int8-on-the-wire all-reduce over ``group`` (default: the whole
    process group): ``x``'s sum over the ranks, each rank's share
    quantized with one shared scale.

    The scale is the ranks' largest ``max |x|`` over 127 (at least
    1e-30); each rank's levels ``clip(round(x / scale), -127, 127)`` are
    int8, widened to int32 and summed exactly (up to ~16M ranks fit), and
    the sum is dequantized as ``float32(total) * scale``.  The reference's
    steps, in its order, so a rank's result is its bits on the same
    inputs.
    """
    xf = x.to(F32)
    amax = all_reduce(torch.amax(torch.abs(xf)), dist.ReduceOp.MAX, group)
    levels = torch.full((), _LEVELS, dtype=F32, device=xf.device)
    scale = torch.clamp(amax / levels, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    return total.to(F32) * scale
