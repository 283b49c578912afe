"""Evaluator factories: the force-evaluation stage of the Hermite loop.

Port of ``repro/core/evaluate.py``.  ``make_block_evaluator`` is the
single implementation body:
an active-target evaluator (per-target activity mask, sources stay full)
with an optional compaction layer that gathers the active targets into a
dense, block-aligned buffer before launching the kernels.
``make_evaluator``, the lockstep evaluator of the paper's one-chip
configuration, is its all-ones-mask case.  ``make_neighbor_block_evaluator``
is the near-window pair of the Ahmad-Cohen split.

Every evaluator takes one system (``(N, 3)`` leaves) or a batch of them
(``(B, N, 3)``); a batch goes through one launch per pass.  The reference
lifts its evaluator over members with ``jax.vmap``, which cannot lift a
hand-written kernel, so the batch axis is written out here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hermite import Evaluation, Evaluator
from repro_torch.kernels import nbody_force, ops, ref

#: compaction modes of the block evaluator
COMPACTIONS = ("none", "gather")


def _per_member(fn, *args):
    """``fn`` on one system, or on each member of a batch (the oracle has
    no batch axis; its members go one by one)."""
    if args[0].dim() == 2:
        return fn(*args)
    outs = [fn(*(a[b] for a in args)) for b in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def shared_cap_index(plan: ops.CapacityPlan, bounds) -> torch.Tensor:
    """Capacity-bucket index shared by a group of members.

    One launch serves a whole bucket group, so its capacity must hold every
    member's active count: the bucket of the max of ``bounds`` (any shape),
    clamped to the plan's widest bucket.  Sound because gathered window
    rows past a member's active set are mask-zeroed by the kernels, so the
    scattered result is bit for bit the per-member bucket's; only the
    launch widens.  Returns a 0-d tensor on ``bounds``'s device: the caller
    reads it on the host to size the launch.
    """
    bound = torch.as_tensor(bounds).reshape(-1).max()
    return plan.bucket(torch.clamp(bound, max=plan.caps[-1]))


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

        def one1(pt, vt, ps, vs, m, mask_c):
            acc, jerk, pot = ref.acc_jerk_pot_rect(pt, vt, ps, vs, m, eps=eps)
            return ops._mask_rows(mask_c, acc, jerk, pot)

        def one2(pt, vt, at, ps, vs, as_, m, mask_c):
            (snp,) = ops._mask_rows(
                mask_c, ref.snap_rect(pt, vt, at, ps, vs, as_, m, eps=eps))
            return snp

        def rect1(pt, vt, ps, vs, m, mask_c):
            return _per_member(one1, pt, vt, ps, vs, m, mask_c)

        def rect2(pt, vt, at, ps, vs, as_, m, mask_c):
            return _per_member(one2, pt, vt, at, ps, vs, as_, m, mask_c)

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
    n_caps: Optional[int] = None,
    dtype: str = "fp32",
):
    """Active-target evaluator for the hierarchical block-timestep scheme.

    Pass 1 computes acc/jerk/potential on the active targets only (sources
    stay full).  The snap pass needs the acceleration of every source;
    inactive sources were not evaluated, so their Taylor-predicted
    ``acc_pred`` substitutes.  With an all-ones mask this is the lockstep
    evaluator.

    Signatures by ``compaction``:

    * ``"none"``: ``evaluate(pos, vel, acc_pred, mass, mask_t)``, the dense
      masked launch (blocks with no active target skip their work, but the
      grid covers every target).
    * ``"gather"``: ``evaluate(pos, vel, acc_pred, mass, mask_t, perm,
      cap_idx)``.  ``perm`` orders active targets first (a stable argsort
      of the inactive flag), ``cap_idx`` is a Python int selecting the
      capacity bucket (``ops.capacity_buckets(n, block_i)``), which must
      hold every member's active count.  The kernels launch on the bucket's
      target extent; the output is bit for bit the ``"none"`` result, since
      each target row is a row-local sum over the same sources in the same
      order whatever block it sits in.

    ``n_caps`` (gather only) truncates the schedule to its first ``n_caps``
    buckets, the bucket group of members whose active count never exceeds
    ``caps[n_caps - 1]`` (``ops.CapacityPlan.restrict``); ``cap_idx`` then
    indexes the truncated schedule.

    ``dtype``: ``"fp32"`` the float32 kernels, ``"mixed"`` bfloat16
    per-pair arithmetic with compensated float32 accumulation, ``"fp64"``
    the golden-reference oracle (``kernels.ref`` at the inputs' precision,
    no kernel), through the same gather/scatter path.  The evaluator runs
    on the device of its input tensors.
    """
    if compaction not in COMPACTIONS:
        raise ValueError(
            f"compaction must be one of {COMPACTIONS}; got {compaction!r}")
    cast, rect1, rect2 = _rect_passes(eps=eps, block_i=block_i,
                                      block_j=block_j, dtype=dtype)

    if compaction == "none":

        def evaluate(pos, vel, acc_pred, mass, mask_t) -> Evaluation:
            p, v, m = cast(pos), cast(vel), cast(mass)
            acc, jerk, pot = rect1(p, v, p, v, m, mask_t)
            if order >= 6:
                acc_s = torch.where(mask_t[..., None], acc, cast(acc_pred))
                snp = rect2(p, v, acc, p, v, acc_s, m, mask_t)
            else:
                snp = torch.zeros_like(acc)
            return Evaluation(acc=acc, jerk=jerk, snap=snp, pot=pot)

        return evaluate

    def evaluate_gather(pos, vel, acc_pred, mass, mask_t, perm,
                        cap_idx: int) -> Evaluation:
        n = pos.shape[-2]
        caps = ops.capacity_buckets(n, block_i)
        if n_caps is not None:
            caps = caps[: min(n_caps, len(caps))]
        cap = caps[cap_idx]
        p, v, m, ap = cast(pos), cast(vel), cast(mass), cast(acc_pred)
        p_c, v_c, mask_c = ops.compact_targets(perm, cap, p, v, mask_t)
        acc_c, jerk_c, pot_c = rect1(p_c, v_c, p, v, m, mask_c)
        acc, jerk, pot = ops.scatter_outputs(perm, cap, n, acc_c, jerk_c,
                                             pot_c)
        if order >= 6:
            # source-side compaction: the fresh rows scattered straight
            # into the predicted-acc operand, bit for bit
            # where(mask, acc, ap) without the dense blend
            acc_s = ops.scatter_sources(perm, cap, ap, acc_c, mask_c)
            snp_c = rect2(p_c, v_c, acc_c, p, v, acc_s, m, mask_c)
            (snp,) = ops.scatter_outputs(perm, cap, n, snp_c)
        else:
            snp = torch.zeros_like(acc)
        return Evaluation(acc=acc, jerk=jerk, snap=snp, pot=pot)

    return evaluate_gather


def make_neighbor_block_evaluator(
    *,
    n: int,
    eps: float = 1e-7,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    dtype: str = "fp32",
):
    """Near-window (regular-force) evaluator pair of the Ahmad-Cohen split.

    The source-axis dual of :func:`make_block_evaluator`'s compaction: the
    targets stay dense (every target block launches; the activity mask
    handles inactive rows), but each target block sweeps only its gathered
    window of neighbor source blocks (``kernels.neighbor.build_windows``)
    instead of the full source extent.  Every target block of every member
    is one batch entry of ONE launch per pass: ``B * nbt`` entries of
    ``block_i`` targets against ``w * block_j`` gathered sources, on the
    kernels' ``gridDim.y``.  ``w_idx`` (a Python int; the reference's
    ``lax.switch`` index) picks the window capacity from the plan's
    ``source_caps``; it must bound every live window count.  The last
    bucket is the full padded source extent, so an overflowing window runs
    the exact all-pairs sweep.

    Returns ``(near1, near2)``, each on one system (``(n, 3)`` leaves) or a
    batch (``(B, n, 3)``, windows ``(B, nbt, nsb)``)::

        near1(pos, vel, mass, mask_t, win_idx, win_cnt, w_idx, blocks=None)
            -> (acc, jerk, pot)                     # near field only
        near2(pos, vel, acc_t, acc_s, mass, mask_t, win_idx, win_cnt, w_idx,
              blocks=None) -> snap                  # near field only

    ``blocks=(lo, hi)`` evaluates target blocks ``lo .. hi`` only (a domain
    shard of the fused mesh) and returns their rows, ``lo * block_i ..
    min(hi * block_i, n)``; sources stay the members' full rows.

    ``acc_t`` is the total (near + far) acceleration of the targets and
    ``acc_s`` that of every source row: the snap term depends on both
    particles' full accelerations even where only near pairs are summed.
    Window slots past ``win_cnt`` gather with their mass zeroed, so they
    contribute exactly zero: a wider bucket only appends exact zeros to
    each row's sum.  ``B * nbt`` above :data:`nbody_force.MAX_BATCH` raises
    ``ValueError`` before anything launches.
    """
    cast, rect1, rect2 = _rect_passes(eps=eps, block_i=block_i,
                                      block_j=block_j, dtype=dtype)
    nbt = -(-n // block_i)
    nsb = -(-n // block_j)
    nt_pad, ns_pad = nbt * block_i, nsb * block_j
    # window capacities in source blocks per target block
    w_caps = tuple(c // block_j for c in ops.capacity_buckets(n, block_j))

    def _blocks(x, nb, block, rows):
        """(B, n, ...) rows padded and split into (B, nb, block, ...)."""
        pad = (0, 0) * (x.dim() - 2) + (0, rows - n)
        x = torch.nn.functional.pad(x, pad)
        return x.reshape((x.shape[0], nb, block) + x.shape[2:])

    def _targets(x, lo, hi):
        """(B, n, ...) -> (B * (hi - lo), block_i, ...) target blocks."""
        x = _blocks(x, nbt, block_i, nt_pad)[:, lo:hi]
        return x.reshape((-1,) + x.shape[2:])

    def _unblock(x, b, lo, hi):
        rows = min(hi * block_i, n) - lo * block_i
        return x.reshape((b, (hi - lo) * block_i) + x.shape[2:])[:, :rows]

    def _gather(win_idx, win_cnt, w_idx, sm, *rows):
        """The first ``w`` window entries of every given target block,
        flattened to (B * blocks, w * block_j, ...); slots past ``win_cnt``
        zero their mass."""
        w = w_caps[w_idx]
        b, nb = win_cnt.shape
        if b * nb > nbody_force.MAX_BATCH:
            raise ValueError(
                f"{b} members x {nb} target blocks = {b * nb} batch "
                f"entries exceed the {nbody_force.MAX_BATCH} one launch takes "
                "(gridDim.y)")
        idx = win_idx[:, :, :w].long()
        bidx = torch.arange(b, device=sm.device)[:, None, None]
        val = (torch.arange(w, device=sm.device)[None, None, :]
               < win_cnt[:, :, None])
        gm = torch.where(val[..., None], _blocks(sm, nsb, block_j,
                                                 ns_pad)[bidx, idx], 0.0)
        out = [gm.reshape(b * nb, w * block_j)]
        for x in rows:
            g = _blocks(x, nsb, block_j, ns_pad)[bidx, idx]
            out.append(g.reshape((b * nb, w * block_j) + g.shape[4:]))
        return out

    def _batched(fn):
        """Lift a batch-axis function to also take one unbatched system."""
        def lifted(pos, *args, blocks=None):
            lo, hi = (0, nbt) if blocks is None else blocks
            if pos.dim() == 3:
                return fn(pos, *args, lo=lo, hi=hi)
            out = fn(pos[None], *(a[None] if isinstance(a, torch.Tensor)
                                  else a for a in args), lo=lo, hi=hi)
            if isinstance(out, tuple):
                return tuple(o[0] for o in out)
            return out[0]
        return lifted

    @_batched
    def near1(pos, vel, mass, mask_t, win_idx, win_cnt, w_idx, *, lo, hi):
        b = pos.shape[0]
        p, v, m = cast(pos), cast(vel), cast(mass)
        gm, gp, gv = _gather(win_idx[:, lo:hi], win_cnt[:, lo:hi], w_idx, m,
                             p, v)
        acc, jerk, pot = rect1(_targets(p, lo, hi), _targets(v, lo, hi), gp,
                               gv, gm, _targets(mask_t, lo, hi))
        return tuple(_unblock(x, b, lo, hi) for x in (acc, jerk, pot))

    @_batched
    def near2(pos, vel, acc_t, acc_s, mass, mask_t, win_idx, win_cnt, w_idx,
              *, lo, hi):
        b = pos.shape[0]
        p, v, m = cast(pos), cast(vel), cast(mass)
        gm, gp, gv, ga = _gather(win_idx[:, lo:hi], win_cnt[:, lo:hi], w_idx,
                                 m, p, v, cast(acc_s))
        snp = rect2(_targets(p, lo, hi), _targets(v, lo, hi),
                    _targets(cast(acc_t), lo, hi), gp, gv, ga, gm,
                    _targets(mask_t, lo, hi))
        return _unblock(snp, b, lo, hi)

    return near1, near2


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
        mask = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
        return block_eval(pos, vel, torch.zeros_like(pos), mass, mask)

    return evaluate
