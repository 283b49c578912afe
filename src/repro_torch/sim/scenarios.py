"""Scenario library: named initial-condition generators behind a registry.

Port of ``repro/sim/scenarios.py``.  Every generator produces
``(pos, vel, mass)`` as float64 numpy arrays in a self-consistent unit
system; :func:`build` then recentres to the centre-of-mass frame,
(optionally) rescales bound systems to standard N-body units
(G = M = 1, E = -1/4) while preserving the generated virial ratio, and runs
construction-time diagnostics before handing back a ``ParticleState`` on
the requested device.  The generators are the reference's numpy code, draw
for draw, so the initial states equal the reference's bitwise.

The registry holds the seed's two initial conditions (Plummer, the circular
binary) and King models (W0-parameterised concentration), cold
uniform-sphere collapse, two-cluster mergers, binary-rich clusters and a
Keplerian disk.

Heterogeneous mixes: :func:`build_padded` stacks scenarios of different N
(and different generators) into one rectangular ``(B, N_max, ...)`` batch by
padding each member with zero-mass particles, returning the per-run
``n_active`` vector that the ensemble engine's mask honours (see
:func:`pad_state` for the mask contract).

Entry points that return a state (:func:`build`, :func:`make`,
:func:`build_padded` and the ``build`` methods) take ``device=`` and
default to ``cuda``; without a card they raise unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.core import nbody
from repro_torch.core.nbody import (FIELDS, ParticleState, resolve_device,
                                    zeros_like_state)

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]
Generator = Callable[..., Arrays]

#: Virial-ratio window accepted for equilibrium models (T/|U| should be 0.5;
#: finite-N sampling noise widens it).
VIRIAL_TOL = 0.15
#: threads of the blocked O(N^2) potential (each holds a few (1024, N)
#: float64 blocks: 0.6 GB at N = 16384)
_POTENTIAL_THREADS = min(8, os.cpu_count() or 1)


class ScenarioError(ValueError):
    """A generated initial condition failed its construction diagnostics."""


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScenarioDef:
    """Registry entry: the generator plus its validation contract."""

    name: str
    generator: Generator
    equilibrium: bool           # expect T/|U| ~ 0.5 at construction
    rescale: bool               # rescale to standard units (E = -1/4)
    description: str
    defaults: Mapping[str, Any]
    min_n: int = 2


SCENARIOS: Dict[str, ScenarioDef] = {}


def register(name: str, *, equilibrium: bool, rescale: bool = True,
             description: str = "", min_n: int = 2, **defaults):
    def deco(fn: Generator) -> Generator:
        SCENARIOS[name] = ScenarioDef(
            name=name, generator=fn, equilibrium=equilibrium,
            rescale=rescale, description=description, defaults=dict(defaults),
            min_n=min_n)
        return fn
    return deco


def available() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


def get_spec(name: str) -> ScenarioDef:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ScenarioError(
            f"unknown scenario {name!r}; available: {available()}") from None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A fully specified initial condition: registry name + parameters."""

    name: str
    n: int
    seed: int = 0
    dtype: Any = torch.float64
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, *, validate: bool = True, device="cuda") -> ParticleState:
        return build(self, validate=validate, device=device)

    def describe(self) -> dict:
        return {"scenario": self.name, "n": self.n, "seed": self.seed,
                "params": dict(self.params)}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A validated scenario *request*: registry name + size (+ seed/params).

    The typed replacement for the stringly ``name[:N]`` CLI tokens —
    :meth:`parse` / :meth:`format` round-trip exactly, and :meth:`validate`
    raises a :class:`ScenarioError` that names the offending field
    (``ScenarioSpec.name: ...``, ``ScenarioSpec.n: ...``), so a bad request
    fails at the admission boundary (CLI flag parsing, server submit) instead
    of deep inside a generator.  ``n=None`` means "caller's default N"; fill
    it with :meth:`with_n` before building.
    """

    name: str
    n: Optional[int] = None
    seed: int = 0
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, token: str, *, seed: int = 0) -> "ScenarioSpec":
        """Parse ``name[:N]`` (e.g. ``"king:256"``) into a validated spec."""
        name, sep, count = str(token).partition(":")
        n: Optional[int] = None
        if sep:
            try:
                n = int(count)
            except ValueError:
                raise ScenarioError(
                    f"ScenarioSpec.n: {count!r} (from token {token!r}) "
                    "is not an integer N") from None
        return cls(name=name, n=n, seed=seed).validate()

    def format(self) -> str:
        """Inverse of :meth:`parse`: ``"king:256"``, or ``"king"`` (n=None)."""
        return self.name if self.n is None else f"{self.name}:{self.n}"

    def validate(self) -> "ScenarioSpec":
        """Check every field against the registry; return ``self``.

        Errors name the bad field so callers (CLI, server admission) can
        surface them without reverse-engineering the message.
        """
        if not isinstance(self.name, str) or not self.name:
            raise ScenarioError(
                f"ScenarioSpec.name: expected a non-empty scenario name, "
                f"got {self.name!r}")
        spec = SCENARIOS.get(self.name)
        if spec is None:
            raise ScenarioError(
                f"ScenarioSpec.name: unknown scenario {self.name!r}; "
                f"available: {available()}")
        if self.n is not None:
            if not isinstance(self.n, int) or isinstance(self.n, bool):
                raise ScenarioError(
                    f"ScenarioSpec.n: expected an int (or None), "
                    f"got {self.n!r}")
            if self.n < spec.min_n:
                raise ScenarioError(
                    f"ScenarioSpec.n: n={self.n} below {self.name!r}'s "
                    f"minimum {spec.min_n}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool) \
                or self.seed < 0:
            raise ScenarioError(
                f"ScenarioSpec.seed: expected a non-negative int, "
                f"got {self.seed!r}")
        unknown = set(self.params) - set(spec.defaults)
        if unknown:
            raise ScenarioError(
                f"ScenarioSpec.params: unknown parameter(s) "
                f"{sorted(unknown)} for {self.name!r}; "
                f"accepts {sorted(spec.defaults)}")
        return self

    def with_n(self, default_n: int) -> "ScenarioSpec":
        """Fill an unset ``n`` with the caller's default."""
        if self.n is not None:
            return self
        return dataclasses.replace(self, n=default_n)

    def scenario(self, *, dtype=torch.float64) -> Scenario:
        """Lower to a buildable :class:`Scenario` (requires ``n`` set)."""
        if self.n is None:
            raise ScenarioError(
                "ScenarioSpec.n: unset; call with_n(default) before building")
        return Scenario(name=self.name, n=self.n, seed=self.seed,
                        dtype=dtype, params=dict(self.params))

    def build(self, *, dtype=torch.float64, validate: bool = True,
              device="cuda") -> ParticleState:
        self.validate()
        return build(self.scenario(dtype=dtype), validate=validate,
                     device=device)


# --------------------------------------------------------------------------
# diagnostics (pure numpy; FP64 host precision, blocked O(N^2) potential)
# --------------------------------------------------------------------------
def _block_potential(pos: np.ndarray, mass: np.ndarray, lo: int,
                     hi: int) -> float:
    """Rows ``lo:hi``'s share of the potential, summed as the reference
    sums one block."""
    # the reference's sum over the (dx, dy, dz) axis, one component at a
    # time in place: the same bits without the (block, n, 3) temporary,
    # about three times faster at n = 16384
    r = np.subtract.outer(pos[lo:hi, 0], pos[:, 0])
    r *= r
    for k in (1, 2):
        dk = np.subtract.outer(pos[lo:hi, k], pos[:, k])
        dk *= dk
        r += dk
    np.sqrt(r, out=r)
    inv = np.zeros_like(r)
    np.divide(1.0, r, out=inv, where=r > 0)
    del r
    mm = np.multiply.outer(mass[lo:hi], mass)
    mm *= inv
    return 0.5 * mm.sum()


def _pairwise_potential(pos: np.ndarray, mass: np.ndarray,
                        block: int = 1024) -> float:
    """Total potential energy, blocked so N~10^4 stays in memory.  The
    blocks run on up to ``_POTENTIAL_THREADS`` threads (numpy lets go of
    the GIL in each array operation); their shares are added in block
    order, so the bits are those of the serial loop."""
    n = pos.shape[0]
    spans = [(lo, min(lo + block, n)) for lo in range(0, n, block)]
    workers = min(len(spans), _POTENTIAL_THREADS)
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            shares = list(pool.map(
                lambda span: _block_potential(pos, mass, *span), spans))
    else:
        shares = [_block_potential(pos, mass, *span) for span in spans]
    u = 0.0
    for share in shares:
        u -= share
    return float(u)


def diagnostics(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray) -> dict:
    """COM frame, kinetic/potential energy and virial ratio T/|U|."""
    m = mass.sum()
    com_pos = (mass[:, None] * pos).sum(0) / m
    com_vel = (mass[:, None] * vel).sum(0) / m
    t = 0.5 * float((mass * (vel * vel).sum(-1)).sum())
    u = _pairwise_potential(pos, mass)
    return {
        "com_pos": float(np.abs(com_pos).max()),
        "com_vel": float(np.abs(com_vel).max()),
        "kinetic": t,
        "potential": u,
        "energy": t + u,
        "virial_ratio": t / abs(u) if u != 0.0 else math.inf,
        "total_mass": float(m),
    }


def _numpy64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def state_diagnostics(state: ParticleState) -> dict:
    return diagnostics(_numpy64(state.pos), _numpy64(state.vel),
                       _numpy64(state.mass))


def _validate(spec: ScenarioDef, diag: dict) -> None:
    for key in ("kinetic", "potential", "energy"):
        if not math.isfinite(diag[key]):
            raise ScenarioError(f"{spec.name}: non-finite {key}: {diag[key]}")
    if diag["com_pos"] > 1e-8 or diag["com_vel"] > 1e-8:
        raise ScenarioError(
            f"{spec.name}: not in the centre-of-mass frame "
            f"(|com|={diag['com_pos']:.2e}, |vcom|={diag['com_vel']:.2e})")
    if spec.equilibrium:
        q = diag["virial_ratio"]
        if abs(q - 0.5) > VIRIAL_TOL:
            raise ScenarioError(
                f"{spec.name}: virial ratio {q:.3f} outside "
                f"0.5 +/- {VIRIAL_TOL} for an equilibrium model")


# --------------------------------------------------------------------------
# unit handling
# --------------------------------------------------------------------------
def _recenter(pos, vel, mass) -> Tuple[np.ndarray, np.ndarray]:
    m = mass.sum()
    return (pos - (mass[:, None] * pos).sum(0) / m,
            vel - (mass[:, None] * vel).sum(0) / m)


def to_standard_units(pos, vel, mass, q_target: float = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Rescale a bound system to E = -1/4 at virial ratio ``q_target``.

    With T' = Q|U'| and E' = T' + U' = -(1-Q)|U'| = -1/4, the target energies
    are fixed by Q alone; positions scale by |U|/|U'| and velocities by
    sqrt(T'/T).  ``q_target=None`` preserves the measured ratio; equilibrium
    models pass Q = 0.5, which also absorbs any inconsistency between the
    generator's raw length and velocity units (e.g. the King sample's core
    radius vs sigma).  Q = 0 (cold) degenerates to a pure position rescale.
    """
    t = 0.5 * float((mass * (vel * vel).sum(-1)).sum())
    u = _pairwise_potential(pos, mass)
    if u >= 0:
        raise ScenarioError(f"cannot rescale an unbound system (U={u:.3e})")
    q = t / abs(u) if q_target is None else q_target
    if q >= 1.0:
        raise ScenarioError(f"cannot rescale: virial ratio {q:.3f} >= 1")
    u_target = 1.0 / (4.0 * (1.0 - q))        # |U'|
    t_target = q * u_target                   # T'
    pos = pos * (abs(u) / u_target)
    if t > 0:
        vel = vel * math.sqrt(t_target / t)
    return pos, vel


def _iso_dirs(rng: np.random.Generator, n: int) -> np.ndarray:
    u = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    st = np.sqrt(1.0 - u * u)
    return np.stack([st * np.cos(phi), st * np.sin(phi), u], axis=1)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------
def build(scenario: Scenario, *, validate: bool = True,
          device="cuda") -> ParticleState:
    """Generate, recentre, rescale and validate one scenario; the state
    lands on ``device``."""
    dev = resolve_device(device)
    spec = get_spec(scenario.name)
    if scenario.n < spec.min_n:
        raise ScenarioError(
            f"{scenario.name}: n={scenario.n} below minimum {spec.min_n}")
    unknown = set(scenario.params) - set(spec.defaults)
    if unknown:
        raise ScenarioError(
            f"{scenario.name}: unknown parameter(s) {sorted(unknown)}; "
            f"accepts {sorted(spec.defaults)}")
    params = {**spec.defaults, **dict(scenario.params)}
    rng = np.random.default_rng(scenario.seed)
    pos, vel, mass = spec.generator(scenario.n, rng, **params)
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    mass = np.asarray(mass, np.float64)
    pos, vel = _recenter(pos, vel, mass)
    if spec.rescale:  # scaling preserves the COM frame
        pos, vel = to_standard_units(
            pos, vel, mass, q_target=0.5 if spec.equilibrium else None)
    if validate:
        _validate(spec, diagnostics(pos, vel, mass))
    def t(x):
        return torch.as_tensor(x, dtype=scenario.dtype, device=dev)

    return zeros_like_state(t(pos), t(vel), t(mass))


def make(name: str, n: int, *, seed: int = 0, dtype=torch.float64,
         validate: bool = True, device="cuda", **params) -> ParticleState:
    """Convenience one-shot: ``make("king", 256, w0=6.0)``."""
    return build(Scenario(name=name, n=n, seed=seed, dtype=dtype,
                          params=params), validate=validate, device=device)


# --------------------------------------------------------------------------
# padded packing: heterogeneous scenarios into one rectangular batch
# --------------------------------------------------------------------------
def pad_state(state: ParticleState, n_max: int) -> ParticleState:
    """Pad a state with zero-mass particles up to ``n_max`` rows.

    Mask contract (tested by ``tests/test_padding_invariance.py``): a padding
    row carries zero mass, zero velocity and zero derivatives, so it is

    * **invisible as a source** — the kernels guarantee m = 0 rows contribute
      exactly zero force, jerk, snap and potential to every other particle;
    * **inert as a target** — the ensemble engine's mask zeroes its evaluated
      derivatives, so it stays frozen at its (arbitrary) padding position and
      never influences the shared-adaptive timestep;
    * **invisible to diagnostics** — kinetic, potential and virial accounting
      are mass-weighted, so energy drift counts only active particles.
    """
    n = state.pos.shape[0]
    if n > n_max:
        raise ScenarioError(f"cannot pad n={n} down to n_max={n_max}")

    def pad(x):
        if x.dim() == 0:                      # the scalar time leaf
            return x
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (0, n_max - n))

    return ParticleState(**{f: pad(getattr(state, f)) for f in FIELDS})


def build_padded(specs: Sequence[Scenario], n_max: Optional[int] = None, *,
                 validate: bool = True, device="cuda"
                 ) -> Tuple[ParticleState, torch.Tensor]:
    """Pack heterogeneous scenario specs into one ``(B, N_max, ...)`` batch.

    Each spec is built independently (its own generator, N and seed), padded
    with zero-mass particles to ``n_max`` (default: the largest member's N)
    and stacked on a new leading batch axis.  Returns ``(batched, n_active)``
    where ``n_active`` is the ``(B,)`` int32 vector of real particle counts —
    the mask the ensemble engine and telemetry honour (see :func:`pad_state`
    for the full contract).  Both land on ``device``.
    """
    dev = resolve_device(device)
    specs = list(specs)
    if not specs:
        raise ScenarioError("build_padded needs at least one scenario spec")
    states = [build(s, validate=validate, device=dev) for s in specs]
    ns = [int(s.pos.shape[0]) for s in states]
    if n_max is None:
        n_max = max(ns)
    if n_max < max(ns):
        raise ScenarioError(
            f"n_max={n_max} below the largest member N={max(ns)}")
    padded = [pad_state(s, n_max) for s in states]
    batched = ParticleState(**{
        f: torch.stack([getattr(p, f) for p in padded]) for f in FIELDS})
    return batched, torch.tensor(ns, dtype=torch.int32, device=dev)


def parse_mix_token(token: str) -> Tuple[str, Optional[int]]:
    """Parse one CLI scenario token ``name[:N]`` -> ``(name, n_or_None)``.

    ``"king:256"`` -> ``("king", 256)``; a bare ``"king"`` leaves N to the
    caller's ``--n`` default.  The name is validated against the registry.
    Thin tuple view over :meth:`ScenarioSpec.parse` (the typed surface).
    """
    spec = ScenarioSpec.parse(token)
    return spec.name, spec.n


def make_mix(mix: Sequence[Tuple[str, int]], *, seed: int = 0,
             repeat: int = 1, dtype=torch.float64,
             params: Optional[Mapping[str, Any]] = None) -> List[Scenario]:
    """Expand ``[(name, n), ...]`` into Scenario specs with distinct seeds.

    ``repeat`` tiles the whole mix (seeds keep incrementing), so a 3-scenario
    mix with ``repeat=2`` yields a B=6 padded batch.  Per-scenario ``params``
    are looked up by name in ``params`` (a mapping name -> kwargs) when given.
    """
    specs: List[Scenario] = []
    i = 0
    for _ in range(max(1, repeat)):
        for name, n in mix:
            kw = dict((params or {}).get(name, {}))
            specs.append(Scenario(name=name, n=n, seed=seed + i, dtype=dtype,
                                  params=kw))
            i += 1
    return specs


# --------------------------------------------------------------------------
# adapters for the seed's initial conditions (``repro_torch.core.nbody``)
# --------------------------------------------------------------------------
@register("plummer", equilibrium=True, rescale=False,
          description="Plummer sphere (seed recipe, already standard units)")
def _plummer(n: int, rng: np.random.Generator) -> Arrays:
    state = nbody.plummer(n, seed=int(rng.integers(0, 2**31 - 1)),
                          device="cpu")
    return _numpy64(state.pos), _numpy64(state.vel), _numpy64(state.mass)


@register("two_body", equilibrium=True, rescale=False, min_n=2,
          description="equal-mass circular binary (analytic test case)")
def _two_body(n: int, rng: np.random.Generator) -> Arrays:
    del rng  # fixed analytic configuration
    if n != 2:
        raise ScenarioError(f"two_body is exactly 2 bodies; got n={n} "
                            "(telemetry would misreport the particle count)")
    state = nbody.two_body_circular(device="cpu")
    return _numpy64(state.pos), _numpy64(state.vel), _numpy64(state.mass)


# --------------------------------------------------------------------------
# King model (lowered isothermal sphere, W0-parameterised)
# --------------------------------------------------------------------------
_erf = np.vectorize(math.erf)


def _king_density(w: np.ndarray) -> np.ndarray:
    """Dimensionless King DF density rho(W) (zero for W <= 0)."""
    w = np.maximum(w, 0.0)
    rho = np.exp(w) * _erf(np.sqrt(w)) \
        - np.sqrt(4.0 * w / np.pi) * (1.0 + 2.0 * w / 3.0)
    return np.maximum(rho, 0.0)


def _king_profile(w0: float, dx: float = 2e-3, x_max: float = 1e3):
    """Integrate the King ODE outward; returns (x, W(x), M(x)) grids.

    (1/x^2) d/dx (x^2 dW/dx) = -9 rho(W)/rho(W0), W(0)=W0, W'(0)=0;
    the enclosed mass is M(x) = -x^2 W'(x) up to a constant factor.
    """
    rho0 = float(_king_density(np.asarray([w0]))[0])

    def rhs(x, y):
        w, dw = y
        rho = float(_king_density(np.asarray([w]))[0]) / rho0
        return np.asarray([dw, -9.0 * rho - 2.0 * dw / x])

    # series start (W ~ W0 - 1.5 x^2 near the centre)
    x = 1e-4
    y = np.asarray([w0 - 1.5 * x * x, -3.0 * x])
    xs, ws, ms = [x], [y[0]], [-x * x * y[1]]
    while y[0] > 0.0 and x < x_max:
        h = min(dx * max(x, 1.0), 0.25)
        k1 = rhs(x, y)
        k2 = rhs(x + h / 2, y + h / 2 * k1)
        k3 = rhs(x + h / 2, y + h / 2 * k2)
        k4 = rhs(x + h, y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        x += h
        xs.append(x)
        ws.append(max(float(y[0]), 0.0))
        ms.append(-x * x * float(y[1]))
    return np.asarray(xs), np.asarray(ws), np.asarray(ms)


@register("king", equilibrium=True, w0=6.0,
          description="King model; w0 sets the concentration")
def _king(n: int, rng: np.random.Generator, *, w0: float = 6.0) -> Arrays:
    if not 0.5 <= w0 <= 16.0:
        raise ScenarioError(f"king: w0={w0} outside the supported (0.5, 16)")
    xs, ws, ms = _king_profile(float(w0))

    # radii from the cumulative mass profile (inverse-CDF interpolation)
    u = rng.uniform(0.0, ms[-1], n)
    r = np.interp(u, ms, xs)
    w_r = np.interp(r, xs, ws)
    pos = r[:, None] * _iso_dirs(rng, n)

    # speeds from f(v) ~ v^2 (exp(W - v^2/2) - 1), v in [0, sqrt(2W)],
    # rejection-sampled under a per-particle numerical envelope
    vmax = np.sqrt(2.0 * np.maximum(w_r, 1e-12))
    grid = np.linspace(0.0, 1.0, 64)[None, :] * vmax[:, None]
    g = grid**2 * (np.exp(w_r[:, None] - grid**2 / 2.0) - 1.0)
    envelope = 1.05 * np.maximum(g.max(axis=1), 1e-300)
    v = np.zeros(n)
    todo = np.ones(n, bool)
    while todo.any():
        idx = np.flatnonzero(todo)
        cand = rng.uniform(0.0, vmax[idx])
        gval = cand**2 * (np.exp(w_r[idx] - cand**2 / 2.0) - 1.0)
        ok = rng.uniform(0.0, envelope[idx]) < gval
        v[idx[ok]] = cand[ok]
        todo[idx[ok]] = False
    vel = v[:, None] * _iso_dirs(rng, n)
    mass = np.full(n, 1.0 / n)
    return pos, vel, mass


# --------------------------------------------------------------------------
# cold uniform-sphere collapse
# --------------------------------------------------------------------------
@register("cold_collapse", equilibrium=False, virial_ratio=0.0,
          description="uniform sphere with (near-)zero initial kinetic energy")
def _cold_collapse(n: int, rng: np.random.Generator, *,
                   virial_ratio: float = 0.0) -> Arrays:
    if not 0.0 <= virial_ratio < 1.0:
        raise ScenarioError(
            f"cold_collapse: virial_ratio={virial_ratio} outside [0, 1)")
    r = rng.uniform(0.0, 1.0, n) ** (1.0 / 3.0)   # uniform in the ball
    pos = r[:, None] * _iso_dirs(rng, n)
    vel = rng.standard_normal((n, 3))
    mass = np.full(n, 1.0 / n)
    # scale the velocity field so T/|U| hits the requested (sub-virial) ratio
    u = abs(_pairwise_potential(pos, mass))
    t = 0.5 * float((mass * (vel * vel).sum(-1)).sum())
    target_t = virial_ratio * u
    vel *= 0.0 if target_t == 0.0 else math.sqrt(target_t / t)
    return pos, vel, mass


# --------------------------------------------------------------------------
# two-cluster merger (offset Plummer spheres on an approach orbit)
# --------------------------------------------------------------------------
@register("merger", equilibrium=False, rescale=False, min_n=16,
          separation=4.0, impact_parameter=0.5, v_scale=1.0,
          description="two Plummer spheres on a (near-)parabolic approach")
def _merger(n: int, rng: np.random.Generator, *, separation: float = 4.0,
            impact_parameter: float = 0.5, v_scale: float = 1.0) -> Arrays:
    """Each half is an internally virialised Plummer sphere of mass 1/2
    (mass m -> m/2 keeps equilibrium when v -> v/sqrt(2)); the halves
    approach with v_scale x the parabolic two-point-mass speed."""
    if separation <= 0:
        raise ScenarioError(f"merger: separation={separation} must be > 0")
    n_a = n // 2
    halves = []
    for n_h in (n_a, n - n_a):
        s = nbody.plummer(n_h, seed=int(rng.integers(0, 2**31 - 1)),
                          device="cpu")
        halves.append((_numpy64(s.pos), _numpy64(s.vel) / math.sqrt(2.0),
                       _numpy64(s.mass) / 2.0))
    d = math.hypot(separation, impact_parameter)
    v_par = v_scale * math.sqrt(2.0 * 1.0 / d)    # G * (M_a + M_b) = 1
    offset = np.asarray([separation / 2.0, impact_parameter / 2.0, 0.0])
    approach = np.asarray([v_par / 2.0, 0.0, 0.0])
    (pa, va, ma), (pb, vb, mb) = halves
    pos = np.concatenate([pa + offset, pb - offset])
    vel = np.concatenate([va - approach, vb + approach])
    mass = np.concatenate([ma, mb])
    return pos, vel, mass


# --------------------------------------------------------------------------
# binary-rich Plummer sphere
# --------------------------------------------------------------------------
@register("binary_plummer", equilibrium=True, rescale=False, min_n=16,
          binary_frac=0.1, sma=0.02,
          description="Plummer sphere with a fraction of stars in tight "
                      "circular binaries")
def _binary_plummer(n: int, rng: np.random.Generator, *,
                    binary_frac: float = 0.1, sma: float = 0.02) -> Arrays:
    """k centres of a Plummer model are each split into an equal-mass
    circular binary of semi-major axis ``sma``; a circular binary satisfies
    2T = |U| instantaneously, so the global virial ratio stays ~0.5."""
    if not 0.0 <= binary_frac <= 1.0:
        raise ScenarioError(f"binary_plummer: binary_frac={binary_frac}")
    k = int(round(binary_frac * n / 2.0))
    k = min(k, n // 2)
    base = nbody.plummer(n - k, seed=int(rng.integers(0, 2**31 - 1)),
                         device="cpu")
    pos, vel, mass = _numpy64(base.pos), _numpy64(base.vel), \
        _numpy64(base.mass)
    if k == 0:
        return pos, vel, mass
    centres = rng.choice(n - k, size=k, replace=False)
    sep = _iso_dirs(rng, k)
    # orbit direction: any unit vector orthogonal to the separation axis
    tmp = _iso_dirs(rng, k)
    orb = np.cross(sep, tmp)
    orb /= np.linalg.norm(orb, axis=1, keepdims=True)
    m_c = mass[centres]
    v_orb = 0.5 * np.sqrt(m_c / sma)   # each component about the binary COM
    pos_a = pos[centres] + 0.5 * sma * sep
    pos_b = pos[centres] - 0.5 * sma * sep
    vel_a = vel[centres] + v_orb[:, None] * orb
    vel_b = vel[centres] - v_orb[:, None] * orb
    keep = np.setdiff1d(np.arange(n - k), centres)
    pos = np.concatenate([pos[keep], pos_a, pos_b])
    vel = np.concatenate([vel[keep], vel_a, vel_b])
    mass = np.concatenate([mass[keep], m_c / 2.0, m_c / 2.0])
    return pos, vel, mass


# --------------------------------------------------------------------------
# Keplerian disk around a dominant central mass
# --------------------------------------------------------------------------
@register("kepler_disk", equilibrium=True, rescale=False, min_n=8,
          m_central=0.99, r_in=0.1, r_out=1.0, aspect=0.02,
          description="near-circular Keplerian disk around a central mass")
def _kepler_disk(n: int, rng: np.random.Generator, *, m_central: float = 0.99,
                 r_in: float = 0.1, r_out: float = 1.0,
                 aspect: float = 0.02) -> Arrays:
    """Central point mass + (n-1)-particle disk, surface density ~ 1/r
    (uniform in radius), on circular orbits with small vertical structure.
    Every circular orbit satisfies 2T = |U| in the dominant potential, so
    the disk as a whole sits at virial ratio ~0.5."""
    if not 0.5 <= m_central < 1.0:
        raise ScenarioError(f"kepler_disk: m_central={m_central} not in "
                            "[0.5, 1)")
    if not 0.0 < r_in < r_out:
        raise ScenarioError(f"kepler_disk: need 0 < r_in < r_out, got "
                            f"({r_in}, {r_out})")
    n_d = n - 1
    m_disk = (1.0 - m_central) / n_d
    r = rng.uniform(r_in, r_out, n_d)            # Sigma ~ 1/r
    phi = rng.uniform(0.0, 2.0 * np.pi, n_d)
    z = aspect * r * rng.standard_normal(n_d)
    pos_d = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
    # circular speed in the monopole field of everything interior
    order = np.argsort(r)
    m_enc = np.empty(n_d)
    m_enc[order] = m_central + m_disk * np.arange(n_d)
    v_c = np.sqrt(m_enc / r)
    vel_d = np.stack([-v_c * np.sin(phi), v_c * np.cos(phi),
                      np.zeros(n_d)], axis=1)
    pos = np.concatenate([np.zeros((1, 3)), pos_d])
    vel = np.concatenate([np.zeros((1, 3)), vel_d])
    mass = np.concatenate([[m_central], np.full(n_d, m_disk)])
    return pos, vel, mass
