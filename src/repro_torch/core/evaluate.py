"""Evaluator factories: the force-evaluation stage of the Hermite loop.

Port of the main-path part of ``repro/core/evaluate.py``.
``make_block_evaluator`` is the single implementation body: an
active-target evaluator (per-target activity mask, sources stay full).
``make_evaluator``, the lockstep evaluator of the paper's one-chip
configuration, is its all-ones-mask case.  Active-target compaction
(``compaction="gather"``) comes with the block-stepper slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.hermite import Evaluation, Evaluator
from repro_torch.kernels import nbody_force, ops, ref

#: compaction modes of the block evaluator
COMPACTIONS = ("none", "gather")


def _rect_passes(*, eps, block_i, block_j, dtype):
    """The two Hermite passes in rectangular (targets x sources) form with
    the activity mask applied, the only layer that differs between the
    float32 kernels and the float64 oracle; returns ``(cast, rect1, rect2)``.
    """
    if dtype not in ops.DTYPES:
        raise ValueError(f"dtype must be one of {ops.DTYPES}; got {dtype!r}")
    if dtype == "fp64":
        # the golden-reference mode: the oracle at the state's precision,
        # never a kernel

        def cast(x):
            return x

        def rect1(pt, vt, ps, vs, m, mask_c):
            acc, jerk, pot = ref.acc_jerk_pot_rect(pt, vt, ps, vs, m, eps=eps)
            return ops._mask_rows(mask_c, acc, jerk, pot)

        def rect2(pt, vt, at, ps, vs, as_, m, mask_c):
            (snp,) = ops._mask_rows(
                mask_c, ref.snap_rect(pt, vt, at, ps, vs, as_, m, eps=eps))
            return snp

        return cast, rect1, rect2

    kw = dict(eps=eps, block_i=block_i, block_j=block_j, dtype=dtype)

    def cast(x):
        return x.to(torch.float32)

    def rect1(pt, vt, ps, vs, m, mask_c):
        return ops.acc_jerk_pot_rect(pt, vt, ps, vs, m, mask_t=mask_c, **kw)

    def rect2(pt, vt, at, ps, vs, as_, m, mask_c):
        return ops.snap_rect(pt, vt, at, ps, vs, as_, m, mask_t=mask_c, **kw)

    return cast, rect1, rect2


def make_block_evaluator(
    *,
    eps: float = 1e-7,
    order: int = 6,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    compaction: str = "none",
    dtype: str = "fp32",
):
    """Active-target evaluator for the hierarchical block-timestep scheme.

    ``evaluate(pos, vel, acc_pred, mass, mask_t)``: pass 1 computes
    acc/jerk/potential on the active targets only (sources stay full).  The
    snap pass needs the acceleration of every source; inactive sources were
    not evaluated, so their Taylor-predicted ``acc_pred`` substitutes.  With
    an all-ones mask this is the lockstep evaluator.

    ``dtype``: ``"fp32"`` the float32 kernels, ``"mixed"`` bfloat16
    per-pair arithmetic with compensated float32 accumulation, ``"fp64"``
    the golden-reference oracle (``kernels.ref`` at the inputs' precision,
    no kernel).  The evaluator runs on the device of its input tensors.
    """
    if compaction not in COMPACTIONS:
        raise ValueError(
            f"compaction must be one of {COMPACTIONS}; got {compaction!r}")
    if compaction == "gather":
        raise NotImplementedError(
            "compaction='gather' is not ported yet: ROADMAP.md queue 1 "
            "item 5 (block stepper with compaction)")
    cast, rect1, rect2 = _rect_passes(eps=eps, block_i=block_i,
                                      block_j=block_j, dtype=dtype)

    def evaluate(pos, vel, acc_pred, mass, mask_t) -> Evaluation:
        p, v, m = cast(pos), cast(vel), cast(mass)
        acc, jerk, pot = rect1(p, v, p, v, m, mask_t)
        if order >= 6:
            acc_s = torch.where(mask_t[:, None], acc, cast(acc_pred))
            snp = rect2(p, v, acc, p, v, acc_s, m, mask_t)
        else:
            snp = torch.zeros_like(acc)
        return Evaluation(acc=acc, jerk=jerk, snap=snp, pot=pot)

    return evaluate


def make_evaluator(
    *,
    eps: float = 1e-7,
    order: int = 6,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    dtype: str = "fp32",
) -> Evaluator:
    """Single-device lockstep evaluator: the all-ones-mask case of
    :func:`make_block_evaluator`.  The blended snap-source acceleration is
    the fresh pass-1 value everywhere, so the zero ``acc_pred`` placeholder
    is never read."""
    block_eval = make_block_evaluator(
        eps=eps, order=order, block_i=block_i, block_j=block_j, dtype=dtype)

    def evaluate(pos, vel, mass) -> Evaluation:
        mask = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
        return block_eval(pos, vel, torch.zeros_like(pos), mass, mask)

    return evaluate
