"""N-body system state, initial conditions and energy diagnostics.

Port of ``repro/core/nbody.py``.  The state keeps the reference's split:
dynamical quantities at host precision (float64 by default), force
evaluation delegated to the float32 kernels (``repro_torch.kernels``).
Initial conditions are drawn from numpy generators in the reference's
order, so they equal the reference's bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing ``cuda`` when no card is present.

    Entry points default to ``cuda``; a caller without a card passes
    ``device="cpu"`` explicitly instead of being moved there silently.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """Full Hermite-6 integrator state (all (N,3) except mass (N,))."""

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    jerk: torch.Tensor
    snap: torch.Tensor
    crackle: torch.Tensor
    mass: torch.Tensor
    pot: torch.Tensor                   # per-particle potential (diagnostics)
    time: torch.Tensor                  # scalar

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device


FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState))


def zeros_like_state(pos, vel, mass) -> ParticleState:
    z = torch.zeros_like(pos)
    return ParticleState(
        pos=pos, vel=vel, acc=z, jerk=z, snap=z, crackle=z,
        mass=mass, pot=torch.zeros_like(mass),
        time=torch.zeros((), dtype=pos.dtype, device=pos.device),
    )


def state_from_numpy(arrays: Mapping[str, np.ndarray], *,
                     device) -> ParticleState:
    """The port's state from the reference state's fields as numpy arrays.

    ``arrays`` maps every :class:`ParticleState` field name to the numpy
    value of that field (``np.asarray(getattr(jax_state, name))``); dtypes
    are kept, so a float64 reference state arrives bitwise.
    """
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {missing}")
    dev = resolve_device(device)
    return ParticleState(**{
        f: torch.from_numpy(np.array(arrays[f], copy=True)).to(dev)
        for f in FIELDS})


def plummer(
    n: int,
    *,
    seed: int = 0,
    total_mass: float = 1.0,
    dtype: torch.dtype = torch.float64,
    cutoff: float = 22.8042468,  # standard 99%-mass radius cut (Aarseth 1974)
    device="cuda",
) -> ParticleState:
    """Plummer-sphere initial conditions in standard N-body units.

    Uses the Aarseth, Henon & Wielen (1974) recipe with von Neumann rejection
    for the velocity sampling; positions/velocities are centred and rescaled
    to virial equilibrium (E = -1/4, G = M = 1).  The draws follow
    ``repro.core.nbody.plummer`` call for call.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = np.full(n, total_mass / n)

    # radii from the cumulative mass profile, with an outer cutoff
    x1 = rng.uniform(0.0, 1.0, size=n)
    frac = cutoff / np.sqrt(1.0 + cutoff**2)
    x1 = x1 * frac**3  # restrict to the mass fraction inside the cutoff
    r = (x1 ** (-2.0 / 3.0) - 1.0) ** (-0.5)

    def iso(rr):
        u = rng.uniform(-1.0, 1.0, size=rr.shape[0])
        phi = rng.uniform(0.0, 2 * np.pi, size=rr.shape[0])
        st = np.sqrt(1.0 - u * u)
        return rr[:, None] * np.stack(
            [st * np.cos(phi), st * np.sin(phi), u], axis=1
        )

    pos = iso(r)

    # velocity: q = v/v_esc with g(q) = q^2 (1-q^2)^{7/2}, rejection sampling
    q = np.zeros(n)
    todo = np.ones(n, dtype=bool)
    while todo.any():
        k = int(todo.sum())
        x2 = rng.uniform(0.0, 1.0, size=k)
        x3 = rng.uniform(0.0, 0.1, size=k)
        ok = x3 < x2**2 * (1.0 - x2**2) ** 3.5
        idx = np.flatnonzero(todo)[ok]
        q[idx] = x2[ok]
        todo[idx] = False
    v_esc = np.sqrt(2.0) * (1.0 + r * r) ** (-0.25)
    vel = iso(q * v_esc)

    # centre of mass / momentum frame
    pos -= (m[:, None] * pos).sum(0) / m.sum()
    vel -= (m[:, None] * vel).sum(0) / m.sum()

    # rescale to standard units: E = -1/4 (scale factor 16/(3*pi))
    pos *= 3.0 * np.pi / 16.0
    vel *= np.sqrt(16.0 / (3.0 * np.pi))

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return zeros_like_state(t(pos), t(vel), t(m))


def two_body_circular(dtype: torch.dtype = torch.float64,
                      device="cuda") -> ParticleState:
    """Equal-mass circular binary (G = M = 1, separation 1, period 2*pi)."""
    dev = resolve_device(device)
    pos = torch.tensor([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]], dtype=dtype,
                       device=dev)
    vel = torch.tensor([[0.0, 0.5, 0.0], [0.0, -0.5, 0.0]], dtype=dtype,
                       device=dev)
    mass = torch.tensor([0.5, 0.5], dtype=dtype, device=dev)
    return zeros_like_state(pos, vel, mass)


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.mass * torch.sum(state.vel**2, dim=1))


def potential_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.mass * state.pot)


def total_energy(state: ParticleState) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state)


def particle_energies(state: ParticleState) -> torch.Tensor:
    """Per-particle specific energies (paper Fig. 4 distribution)."""
    return 0.5 * torch.sum(state.vel**2, dim=1) + state.pot
