"""Sixth-order Hermite predictor-evaluator-corrector (Nitadori & Makino 2008).

Port of ``repro/core/hermite.py``.  The scheme mirrors the paper's three
stages (§2.1):

* **predict**: positions/velocities extrapolated to t+dt with the Taylor
  series through crackle, at host precision (float64);
* **evaluate**: acc/jerk/snap from direct summation at device precision
  (float32) via an ``Evaluator`` (``repro_torch.core.evaluate``);
* **correct**: the two-point 6th-order Hermite corrector, plus the
  interpolated crackle used by the next prediction.

A 4th-order mode (``order=4``) uses only acc+jerk.  The reference's
``lax.scan`` loop (``evolve_scan``) is a Python loop here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.nbody import ParticleState


class Evaluation(NamedTuple):
    acc: torch.Tensor
    jerk: torch.Tensor
    snap: torch.Tensor
    pot: torch.Tensor


# Evaluator signature: (pos, vel, mass) -> Evaluation (float32 contents).
Evaluator = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Evaluation]


def predict(state: ParticleState, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """Taylor-series prediction of positions and velocities to t + dt.

    ``dt`` may be a scalar (lockstep) or an ``(N, 1)`` column of
    per-particle horizons (block timesteps).
    """
    h = dt
    x, v, a, j, s, c = (
        state.pos, state.vel, state.acc, state.jerk, state.snap, state.crackle
    )
    xp = x + h * (v + h * (a / 2 + h * (j / 6 + h * (s / 24 + h * c / 120))))
    vp = v + h * (a + h * (j / 2 + h * (s / 6 + h * c / 24)))
    return xp, vp


def predict_acc(state: ParticleState, dt) -> torch.Tensor:
    """Taylor-predicted acceleration at t + dt (snap-pass source operand of
    particles that are not re-evaluated under block timesteps)."""
    h = dt
    return state.acc + h * (state.jerk
                            + h * (state.snap / 2 + h * state.crackle / 6))


def correct(state: ParticleState, ev: Evaluation, dt, *, order: int = 6):
    """Two-point Hermite corrector; returns (pos, vel, crackle_at_t1).

    Like :func:`predict`, ``dt`` may be scalar or an ``(N, 1)`` column.
    """
    h = dt
    a0, j0, s0 = state.acc, state.jerk, state.snap
    a1 = ev.acc.to(state.dtype)
    j1 = ev.jerk.to(state.dtype)
    s1 = ev.snap.to(state.dtype)

    if order == 4:
        # classic 4th-order Hermite corrector (acc+jerk only)
        v1 = state.vel + h / 2 * (a0 + a1) + h * h / 12 * (j0 - j1)
        x1 = state.pos + h / 2 * (state.vel + v1) + h * h / 12 * (a0 - a1)
        return x1, v1, torch.zeros_like(a1)

    # 6th-order corrector (Nitadori & Makino 2008, eqs. 5-6)
    v1 = state.vel + h / 2 * (a0 + a1) + h**2 / 10 * (j0 - j1) \
        + h**3 / 120 * (s0 + s1)
    x1 = state.pos + h / 2 * (state.vel + v1) + h**2 / 10 * (a0 - a1) \
        + h**3 / 120 * (j0 + j1)

    # crackle at t1 from the 5th-degree interpolating polynomial of a(t)
    big_a = a1 - a0 - h * j0 - h * h / 2 * s0
    big_j = j1 - j0 - h * s0
    big_s = s1 - s0
    crackle = (60.0 * big_a - 36.0 * h * big_j + 9.0 * h * h * big_s) / h**3
    return x1, v1, crackle


def step(
    state: ParticleState,
    dt,
    evaluator: Evaluator,
    *,
    order: int = 6,
) -> ParticleState:
    """One full P-E-C Hermite step at fixed dt."""
    xp, vp = predict(state, dt)
    ev = evaluator(xp, vp, state.mass)
    x1, v1, crackle = correct(state, ev, dt, order=order)
    return ParticleState(
        pos=x1, vel=v1,
        acc=ev.acc.to(state.dtype),
        jerk=ev.jerk.to(state.dtype),
        snap=ev.snap.to(state.dtype),
        crackle=crackle,
        mass=state.mass,
        pot=ev.pot.to(state.mass.dtype),
        time=state.time + dt,
    )


def initialize(state: ParticleState, evaluator: Evaluator) -> ParticleState:
    """Bootstrap derivatives at t=0 (crackle starts at zero)."""
    ev = evaluator(state.pos, state.vel, state.mass)
    return dataclasses.replace(
        state,
        acc=ev.acc.to(state.dtype),
        jerk=ev.jerk.to(state.dtype),
        snap=ev.snap.to(state.dtype),
        crackle=torch.zeros_like(state.pos),
        pot=ev.pot.to(state.mass.dtype),
    )


def aarseth_dt_particles(state: ParticleState, *, eta: float = 0.02,
                         dt_max=0.0625, use_crackle: bool = False):
    """Per-particle Aarseth timestep criterion: the ``(N,)`` vector.

    ``use_crackle=False`` (default) drops the 5th-derivative term: the
    crackle is reconstructed from differences of float32 accelerations
    divided by h^3, so at small h it is noise-dominated.  Particles with
    zero derivatives (``num == 0``, e.g. zero-mass padding rows) take
    ``dt_max``, so they never tighten a shared step nor deepen a level.
    """
    tiny = torch.tensor(1e-30, dtype=state.dtype, device=state.device)

    def norm(x):
        return torch.sqrt(torch.sum(x * x, dim=1))

    a, j, s = norm(state.acc), norm(state.jerk), norm(state.snap)
    num = a * s + j * j
    den = s * s
    if use_crackle:
        den = den + j * norm(state.crackle)
    dt_i = eta * torch.sqrt(num / torch.maximum(den, tiny))
    dt_max_t = torch.tensor(dt_max, dtype=state.dtype, device=state.device)
    dt_i = torch.where(num > 0, dt_i, dt_max_t)
    return torch.minimum(dt_i, dt_max_t)


def aarseth_dt(state: ParticleState, *, eta: float = 0.02, dt_max=0.0625,
               use_crackle: bool = False):
    """Shared adaptive timestep (Aarseth criterion, min over particles)."""
    return torch.min(aarseth_dt_particles(state, eta=eta, dt_max=dt_max,
                                          use_crackle=use_crackle))


def quantize_block_levels(dt_i, *, dt_max, n_levels: int):
    """Quantize per-particle timesteps onto the power-of-two block hierarchy.

    Level ``l`` steps at ``dt_max / 2**l``; a particle gets the coarsest
    level whose step does not exceed its ``dt_i``
    (``l = ceil(log2(dt_max / dt_i))``), clipped to ``[0, n_levels - 1]``.
    """
    dt_i = torch.clamp(dt_i, min=torch.finfo(dt_i.dtype).tiny)
    lev = torch.ceil(torch.log2(dt_max / dt_i))
    return torch.clamp(lev, 0, n_levels - 1).to(torch.int32)


def block_level_dt(levels, dt_max, dtype=None):
    """The step size ``dt_max / 2**level`` of each particle's block level.

    The result dtype is ``dt_max``'s (a tensor's own, a Python float's
    torch default) or an explicit ``dtype``.
    """
    dt_max = torch.as_tensor(dt_max, dtype=dtype, device=levels.device)
    return dt_max * torch.exp2(-levels.to(dt_max.dtype))


def block_level_occupancy(levels, *, n_levels: int, mask=None):
    """Per-level occupancy bound: entry ``t`` counts particles at levels
    >= t, the largest active set any tick with threshold level ``t`` can
    see.  ``mask`` (optional bool ``(N,)``) restricts the count to real
    particles."""
    thresholds = torch.arange(n_levels, dtype=levels.dtype,
                              device=levels.device)
    lev = levels[None, :] >= thresholds[:, None]
    if mask is not None:
        lev = lev & mask[None, :]
    return torch.sum(lev, dim=1).to(torch.int32)


def tick_threshold_level(tick, *, n_levels: int):
    """Threshold level of a block-schedule tick:
    ``n_levels - 1 - trailing_zeros(tick)``; the macro-boundary tick
    ``2**(n_levels - 1)`` maps to threshold 0."""
    t = torch.as_tensor(tick, dtype=torch.int32)
    pows = torch.tensor([2 ** k for k in range(1, n_levels)],
                        dtype=torch.int32, device=t.device)
    tz = torch.sum((t % pows) == 0).to(torch.int32)
    return (n_levels - 1) - tz


def auto_n_levels(dt_i, *, dt_max, max_levels: int = 8):
    """Hierarchy depth that resolves the tightest of the given Aarseth
    timesteps, clamped to ``[1, max_levels]``."""
    lev = quantize_block_levels(dt_i, dt_max=dt_max, n_levels=max_levels)
    return torch.max(lev) + 1


def block_active_mask(levels, k, *, n_levels: int):
    """Active set at fine-substep ``k`` (1-based) of one ``dt_max``
    macro-step: a particle at level ``l`` is active when ``k`` is a multiple
    of its period ``2**(n_levels-1-l)``."""
    period = (2 ** (n_levels - 1)) >> levels
    return (k % period) == 0


def evolve(
    state: ParticleState,
    evaluator: Evaluator,
    *,
    t_end: float,
    dt: Optional[float] = None,
    eta: float = 0.02,
    order: int = 6,
    max_steps: int = 100_000,
) -> ParticleState:
    """Evolve to ``t_end`` with fixed (``dt``) or shared-adaptive timestep.

    The host drives the device kernels each step, the paper's
    host/accelerator split.
    """
    state = initialize(state, evaluator)
    steps = 0
    h_prev = None
    while float(state.time) < t_end and steps < max_steps:
        if dt is not None:
            h = dt
        else:
            h = float(aarseth_dt(state, eta=eta))
            if h_prev is not None:
                # rate-limit dt changes (noise robustness, standard practice)
                h = min(max(h, 0.5 * h_prev), 2.0 * h_prev)
            h_prev = h
        h = min(h, t_end - float(state.time))
        state = step(state, h, evaluator, order=order)
        steps += 1
    return state


def evolve_scan(
    state: ParticleState,
    evaluator: Evaluator,
    *,
    n_steps: int,
    dt: float,
    order: int = 6,
) -> ParticleState:
    """Fixed-dt evolution over ``n_steps`` steps."""
    state = initialize(state, evaluator)
    for _ in range(n_steps):
        state = step(state, dt, evaluator, order=order)
    return state
