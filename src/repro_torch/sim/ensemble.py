"""Batched ensemble engine: B independent simulations advanced together.

Port of ``repro/sim/ensemble.py``.  Independent runs are
stacked on a leading batch axis of every ``ParticleState`` leaf and
advanced in lockstep.  The reference lifts the Hermite step over members
with ``jax.vmap``; ``torch.vmap`` cannot lift a hand-written kernel, so the
batch axis is written out here and reaches the kernels as their own
leading axis (``gridDim.y``): one launch per pass for the whole batch, or
per bucket group under compaction, never one per member.  The reference's
``lax.scan`` loops are Python loops.

**Steppers.** Fixed dt (:func:`ensemble_run`), per-member shared-adaptive
Aarseth lockstep (:func:`ensemble_run_adaptive`, each member with its own
step and no host read inside the step loop) and hierarchical block
timesteps (:func:`ensemble_run_block`): per-particle power-of-two levels
inside each member, only the active block evaluated at each event.  The
block stepper's ``compaction="gather"`` gathers each event's active
targets into a dense buffer of one of a few capacities, so the kernels
launch on the bucket's target extent instead of masking the full one:
bit-for-bit the same physics, fewer tiles.  A CUDA launch needs its
extent on the host, so each gather event reads every bucket group's
capacity index (and whether any member is still live) in one
device-to-host copy; ``compaction="none"`` reads nothing per event.
``ensemble_run_block.host_syncs`` counts the block path's reads.

**The Ahmad-Cohen neighbor scheme.** ``sources="neighbor"`` splits the
block stepper's force into a near sum over each target block's gathered
window of neighbor source blocks (``kernels.neighbor``) and a far field
Taylor-predicted between refreshes (:class:`NeighborCarry`).  Every target
block of every member is one batch entry of one K1 (K2) launch per pass.
The reference picks the window bucket and the refresh branch on the device
(``lax.switch``/``lax.cond``); a launch needs its extent on the host, so a
neighbor event reads ``[any refresh, window bucket, any live]`` in one
copy, and a refresh event reads the new windows' bucket once more.
:func:`block_admit_member` splices a new member into a running batch.

**Engines.** Each stepper's engine (its evaluators, and for the block
stepper the bucket groups' device tables) is built once per configuration,
bucket groups and device and cached, as the reference caches its jitted
engines; every build ticks ``engine.cache_miss`` (and
``engine.cache_miss.{fixed,adaptive,block}``) in the current metrics
registry (``repro_torch.obs.metrics``), a gather build also
``engine.bucket_branches``.

**Masking (ragged batches).** Heterogeneous mixes are packed by
``repro_torch.sim.scenarios.build_padded`` into a ``(B, N_max, ...)``
batch plus a per-run ``n_active`` vector.  Rows ``>= n_active[b]`` are
padding: zero mass makes them invisible as sources (a kernel invariant),
and the engine's per-member mask zeroes their evaluated derivatives so
they stay frozen as targets and never tighten a timestep.

**One run under a distribution strategy.** :func:`strategy_run_block` /
:func:`evolve_strategy_block` run the block stepper on one unbatched run
whose force evaluation is sharded over a device mesh by one of the paper's
strategies (``core.strategies``), each shard compacting its own active
targets; the event schedule is the ensemble engine's.  A strategy label on
a batch only tags it, as in the reference: its members are independent.

**Batch layouts.** ``devices=`` (a device list, one slot each, or a count)
shards a batch by member over the 1-D ``("batch",)`` mesh
(``strategies.make_batch_mesh``): B is padded to a multiple of the slots
by repeating the first run (:func:`_pad_batch`) and slot i takes the i-th
member chunk.  The fixed-dt and adaptive engines run whole on each slot;
the block engine keeps one event schedule and one host read per event over
the whole batch, so whatever the reference shares across its vmapped batch
(a bucket group's capacity, the neighbor window bucket) stays shared
across slots, and each slot launches its members at those capacities.
``mesh=(bdev, p)`` lays the batch on the fused ``("batch", "dev")`` grid:
with full sources the block engine shards each member's target rows
``p`` ways (one launch per slot and pass over the slot's members, a
capacity bucket per slot), with neighbor sources it splits each member's
target blocks over its row's slots.  Either way the bits
are those of the unsharded batch.

**Over processes.**  ``devices=`` may instead be this rank's
``distributed.process_mesh.ProcessMesh`` (one process per slot over
``torch.distributed``), with or without ``mesh=(bdev, p)``; every rank
calls with the whole batch.  On the 1-D view a rank holds and steps only
its member chunk, on the fused grid its batch row's members (evaluating
their ``k``-th of ``p`` row chunks); the outputs come back whole on every
rank.  What one process decides over the whole batch with one host read
per event (a bucket group's capacity, whether any member is live, the
neighbor window bucket) every rank reads from one small collective
(``ProcessMesh.agree``, the max over ranks) instead, so every rank keeps
the one schedule and the one capacity a group launches at.
:func:`strategy_run_block` / :func:`evolve_strategy_block` take the rank's
mesh as ``mesh=``: each rank holds the whole run, so each reads the same
bounds.  The tensors' device picks
the kernels or their plain versions, so the engines take no ``impl``:
``dtype="fp64"`` is the oracle.  The reference's ``impl``/``kernel``
labels are resolved for the API by :func:`resolve_eval_impl` and checked
against the device by :func:`check_impl`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import hermite
from repro_torch.core.evaluate import (COMPACTIONS, make_block_evaluator,
                                       make_evaluator,
                                       make_neighbor_block_evaluator,
                                       shared_cap_index)
from repro_torch.core.hermite import Evaluation
from repro_torch.core.nbody import FIELDS, ParticleState
from repro_torch.core.strategies import (STRATEGIES, DeviceMesh,
                                         _pad_rows, make_batch_mesh,
                                         make_fused_block_evaluator,
                                         make_fused_mesh,
                                         make_strategy_block_evaluator,
                                         make_strategy_evaluator,
                                         mesh_devices)
from repro_torch.distributed.process_mesh import ProcessMesh
from repro_torch.kernels import nbody_force, neighbor, ops
from repro_torch.obs import metrics as obs_metrics

#: the source axis: every launch over all sources, or the Ahmad-Cohen
#: neighbor windows
SOURCES = ops.SOURCES
#: per-member capacity-bucket dispatch modes of the block engine
BUCKET_MODES = ("member", "shared")
#: strategy labels: on a batch every label computes the same thing (its
#: members are independent); one run under a distribution strategy goes
#: through :func:`strategy_run_block`
STRATEGY_LABELS = ("single",) + STRATEGIES
#: the reference's evaluation paths; here labels checked against the device
ENSEMBLE_IMPLS = ("xla", "fp64", "pallas", "pallas_interpret")
#: user-facing force-kernel switch: "ref" (all-pairs op) | "pallas"
KERNELS = ("ref", "pallas")
#: stepper modes of the ensemble engine
STEPPERS = ("fixed", "adaptive", "block")
#: labels of the reference's XLA op and interpreted kernel: the plain
#: versions, which run on the CPU only
_PLAIN_IMPLS = ("xla", "pallas_interpret")


def resolve_kernel(kernel: Optional[str]) -> str:
    """Map the user-facing ``kernel`` switch to an evaluation ``impl``.

    ``"ref"`` is the reference's all-pairs op (``"xla"``), ``"pallas"`` its
    tiled kernel.  On the port a CUDA tensor always goes through the
    hand-written kernels and a CPU tensor through their plain versions;
    :func:`check_impl` refuses ``"xla"`` on the card.
    """
    if kernel in (None, "ref"):
        return "xla"
    if kernel == "pallas":
        return "pallas"
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def resolve_eval_impl(impl: Optional[str], kernel: Optional[str], *,
                      default: Optional[str] = None) -> Optional[str]:
    """Resolve the (``impl``, ``kernel``) pair to one evaluation impl.

    The user-facing ``kernel`` switch and the low-level ``impl`` are
    mutually exclusive when both are explicit: silently preferring one
    could e.g. turn a requested ``impl="fp64"`` golden-reference run into
    FP32 with no trace in the report.  The default is None, the device's
    own path (the reference defaults to its XLA op).
    """
    if kernel is not None:
        if impl is not None:
            raise ValueError(
                f"pass either impl={impl!r} or kernel={kernel!r}, not both")
        return resolve_kernel(kernel)
    return impl if impl is not None else default


def check_impl(impl: Optional[str], device) -> Optional[str]:
    """Hold a resolved impl to what ``device`` runs; returns it.

    ``None`` and ``"pallas"`` are the kernels on ``cuda`` and their plain
    versions on ``cpu``; ``"fp64"`` is the oracle anywhere; ``"xla"`` and
    ``"pallas_interpret"`` name plain versions, so ``cuda`` refuses them:
    the card runs the kernels only.
    """
    if impl is not None and impl not in ENSEMBLE_IMPLS:
        raise ValueError(
            f"unknown impl {impl!r}; one of {ENSEMBLE_IMPLS}")
    if impl in _PLAIN_IMPLS and torch.device(device).type == "cuda":
        raise ValueError(
            f"impl={impl!r} names a plain version; on cuda the force "
            "evaluation runs the hand-written kernels only (pass impl=None "
            "or 'pallas', or run with device='cpu')")
    return impl


def _count_engine_build(kind: str) -> None:
    """Emit one ``engine.cache_miss`` tick into the current metrics registry.

    Every engine constructor below is ``lru_cache``d, so its body only runs
    when a (configuration, bucket groups, device) key has never been built
    before: the counter is the engine build count.
    """
    reg = obs_metrics.registry()
    reg.counter("engine.cache_miss", unit="builds",
                help="engine constructions (evaluators, device tables)").inc()
    reg.counter(f"engine.cache_miss.{kind}", unit="builds").inc()


def _mesh_list(devices, device) -> list:
    """A strategy engine's device list: a sequence as given, an int count
    or None resolved by ``strategies.mesh_devices`` for tensors on
    ``device`` (None: every visible card, or one CPU slot)."""
    if devices is None or isinstance(devices, int):
        return mesh_devices(devices, device)
    return list(devices)


def _check_labels(*, strategy: str = "single", sources: str = "full"):
    """A strategy label only tags a batch; both must be known."""
    if strategy not in STRATEGY_LABELS:
        raise ValueError(f"unknown strategy {strategy!r}; one of "
                         f"{STRATEGY_LABELS}")
    if sources not in SOURCES:
        raise ValueError(
            f"sources must be one of {SOURCES}; got {sources!r}")


# --------------------------------------------------------------------------
# batch layouts over devices
# --------------------------------------------------------------------------
def _layout(devices, mesh, device):
    """The batch's layout for tensors on ``device``: None for one slot (the
    batch's own device), the 1-D batch mesh over ``devices`` of more than
    one, or with ``mesh=(bdev, p)`` the fused grid over them.  ``devices``
    is a device list, an int count or None (``_mesh_list``), or this
    rank's ``ProcessMesh`` (viewed as the batch layout); on ``cuda`` a
    count or a list naming more cards than are visible raises
    ``ValueError``."""
    ranks = isinstance(devices, ProcessMesh)
    if mesh is not None:
        return make_fused_mesh(
            devices if ranks else _mesh_list(devices, device),
            mesh_shape=tuple(int(e) for e in mesh))
    if devices is None:
        return None
    devs = devices if ranks else DeviceMesh(_mesh_list(devices, device))
    return make_batch_mesh(devs) if devs.size > 1 else None


def _batch_extent(layout: Optional[DeviceMesh]) -> int:
    """How many ways the batch is sharded (the :func:`_pad_batch` multiple)."""
    return 1 if layout is None else layout.shape[0]


def _row_devices(layout: DeviceMesh) -> list:
    """Each batch row's first slot: where a row's member chunk runs what is
    not split along ``dev``."""
    p = layout.size // layout.shape[0]
    return [layout.devices[i * p] for i in range(layout.shape[0])]


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a ParticleState, a (named) tuple of them,
    or None, leaf by leaf across ``tree`` and ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, ParticleState):
        return ParticleState(**{f: fn(getattr(tree, f),
                                      *(getattr(r, f) for r in rest))
                                for f in FIELDS})
    items = [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, ParticleState):
        return tree.pos
    return next(_first_leaf(x) for x in tree if x is not None)


def _pad_batch(tree, extent: int):
    """Pad B to a multiple of ``extent`` by repeating the first run, on
    every leaf of ``tree`` (a state, carries, or a tuple of them); returns
    ``(padded, b)``."""
    b = _first_leaf(tree).shape[0]
    if extent <= 1 or b % extent == 0:
        return tree, b
    pad = extent - b % extent
    return _tree_map(lambda x: torch.cat([x] + [x[:1]] * pad), tree), b


def _take(tree, b: int):
    """The first ``b`` members of every leaf (undoes :func:`_pad_batch`)."""
    if _first_leaf(tree).shape[0] == b:
        return tree
    return _tree_map(lambda x: x[:b], tree)


def _is_tree(x) -> bool:
    return isinstance(x, (torch.Tensor, ParticleState, tuple))


def _by_rank(layout, fn, *args):
    """On a rank's mesh, ``fn`` on this rank's member chunk of ``args``
    (every tensor, state or carry holds the whole padded batch), its
    outputs brought back whole; otherwise ``fn`` on everything."""
    if not isinstance(layout, ProcessMesh):
        return fn(*args)
    out = fn(*(_tree_map(layout.local_rows, a) if _is_tree(a) else a
               for a in args))
    return _tree_map(layout.gather_rows, out)


def _on_rows(layout, fn, *args, members=None, batch: Optional[int] = None):
    """``fn`` on each batch row's share of ``args`` (the leading entries of
    every tensor, state or carry) on the row's device, the outputs
    concatenated back in member order on the arguments' device; other
    arguments pass whole, and a row with nothing to do is skipped.  The
    arguments hold every member of the padded batch (equal chunks per
    row), or ``members``, global indices in order of a ``batch``-member
    batch.  ``None`` runs ``fn`` once on everything; a rank's mesh runs it
    on the rank's own row (:func:`_by_rank`)."""
    if layout is None or isinstance(layout, ProcessMesh):
        return _by_rank(layout, fn, *args)
    rows = layout.shape[0]
    dev = _first_leaf(next(a for a in args if _is_tree(a))).device
    if members is None:
        b = _first_leaf(next(a for a in args if _is_tree(a))).shape[0]
        counts = [b // rows] * rows
    else:
        bl = batch // rows
        counts = [sum(1 for m in members if m // bl == i)
                  for i in range(rows)]
    outs, lo = [], 0
    for d, c in zip(_row_devices(layout), counts):
        if c:
            outs.append(fn(*(_tree_map(lambda x: x[lo:lo + c].to(d), a)
                             if _is_tree(a) else a for a in args)))
        lo += c
    return _tree_map(lambda *xs: xs[0].to(dev) if len(xs) == 1
                     else torch.cat([x.to(dev) for x in xs]), *outs)


# --------------------------------------------------------------------------
# batch packing
# --------------------------------------------------------------------------
def stack_states(states: Sequence[ParticleState]) -> ParticleState:
    """Pack independent runs (same N) into one leading-batch-axis state."""
    if not states:
        raise ValueError("need at least one state")
    ns = {s.pos.shape[0] for s in states}
    if len(ns) != 1:
        raise ValueError(f"all ensemble members must share N; got {ns}")
    return ParticleState(**{
        f: torch.stack([getattr(s, f) for s in states]) for f in FIELDS})


def unstack_states(batched: ParticleState) -> List[ParticleState]:
    return [ParticleState(**{f: getattr(batched, f)[i] for f in FIELDS})
            for i in range(batch_size(batched))]


def batch_size(batched: ParticleState) -> int:
    return batched.pos.shape[0]


def _kinetic(batched: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(batched.mass * torch.sum(batched.vel ** 2, dim=-1),
                           dim=-1)


def _potential(batched: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(batched.mass * batched.pot, dim=-1)


def batched_total_energy(batched: ParticleState) -> torch.Tensor:
    """(B,) total energy per member; mass-weighted, so zero-mass padding
    rows contribute nothing."""
    return _kinetic(batched) + _potential(batched)


def batched_virial_ratio(batched: ParticleState) -> torch.Tensor:
    """(B,) virial ratio T/|U| per member (mass-weighted: padding-blind)."""
    t, u = _kinetic(batched), _potential(batched)
    tiny = torch.finfo(t.dtype).tiny
    return t / torch.clamp(torch.abs(u), min=tiny)


def _select(live, new: ParticleState, old: ParticleState) -> ParticleState:
    """Per member: ``new`` where ``live``, else ``old`` (a frozen member)."""

    def one(a, b):
        return torch.where(live.reshape(live.shape + (1,) * (a.dim() - 1)),
                           a, b)

    return ParticleState(**{f: one(getattr(new, f), getattr(old, f))
                            for f in FIELDS})


# --------------------------------------------------------------------------
# fixed and adaptive lockstep
# --------------------------------------------------------------------------
def _mask_evaluator(ev, n_active):
    """Zero the evaluated derivatives of padding rows (>= ``n_active``).

    Sources with m = 0 already contribute zero force (kernel invariant);
    masking the outputs also freezes padding rows as targets.  With
    ``n_active == N`` the mask is all ones and the multiply is exact.
    """

    def evaluate(pos, vel, mass) -> Evaluation:
        out = ev(pos, vel, mass)
        active = (torch.arange(pos.shape[-2], device=pos.device)
                  < n_active[..., None])
        m3 = active.to(out.acc.dtype)[..., None]
        return Evaluation(acc=out.acc * m3, jerk=out.jerk * m3,
                          snap=out.snap * m3,
                          pot=out.pot * active.to(out.pot.dtype))

    return evaluate


def _as_n_active(batched: ParticleState, n_active) -> torch.Tensor:
    """``n_active`` as a (B,) int32 tensor on the batch's device (default:
    every row active)."""
    b, n = batched.pos.shape[0], batched.pos.shape[1]
    if n_active is None:
        return torch.full((b,), n, dtype=torch.int32, device=batched.device)
    n_active = torch.as_tensor(n_active, dtype=torch.int32,
                               device=batched.device)
    if tuple(n_active.shape) != (b,):
        raise ValueError(
            f"n_active must have shape ({b},) for a B={b} batch; "
            f"got {tuple(n_active.shape)}")
    return n_active


def _as_t_end(batched: ParticleState, t_end) -> torch.Tensor:
    """``t_end`` as a (B,) tensor in the state dtype: a scalar broadcasts
    to every member, a vector gives each member its own deadline."""
    b = batch_size(batched)
    t = torch.as_tensor(t_end, dtype=batched.dtype, device=batched.device)
    if t.dim() == 0:
        return t.expand(b).clone()
    if tuple(t.shape) != (b,):
        raise ValueError(
            f"t_end must be a scalar or shape ({b},) for a B={b} batch; "
            f"got {tuple(t.shape)}")
    return t


@functools.lru_cache(maxsize=64)
def _engine(order: int, eps: float, dtype: str, device: torch.device):
    """Fixed-dt lockstep engine: ``(init, run)`` over one evaluator."""
    _count_engine_build("fixed")
    ev = make_evaluator(order=order, eps=eps, dtype=dtype)

    def init(batched: ParticleState, na) -> ParticleState:
        return hermite.initialize(batched, _mask_evaluator(ev, na))

    def run(batched: ParticleState, na, dt, n_steps: int) -> ParticleState:
        mev = _mask_evaluator(ev, na)
        for _ in range(n_steps):
            batched = hermite.step(batched, dt, mev, order=order)
        return batched

    return init, run


def ensemble_initialize(
    batched: ParticleState,
    *,
    n_active=None,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    devices=None,
    mesh=None,
) -> ParticleState:
    """Bootstrap derivatives for every member (one batched t=0 pass per
    slot).  ``devices``/``mesh`` lay the batch out as
    :func:`ensemble_run_block` does; under a mesh each batch row
    bootstraps its members on its first slot (the evaluation is row-local,
    so the bits are the unsharded batch's)."""
    layout = _layout(devices, mesh, batched.device)
    (padded, na), b = _pad_batch((batched, _as_n_active(batched, n_active)),
                                 _batch_extent(layout))

    def init(s, a):
        return _engine(order, eps, dtype, s.device)[0](s, a)

    return _take(_on_rows(layout, init, padded, na), b)


def ensemble_run(
    batched: ParticleState,
    *,
    n_steps: int,
    dt: float,
    n_active=None,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    devices=None,
) -> ParticleState:
    """Advance an initialized batch by ``n_steps`` fixed-dt steps: the
    arithmetic of ``hermite.evolve_scan`` on every member at once.  Over
    ``devices`` of more than one, each slot runs its member chunk."""
    layout = _layout(devices, None, batched.device)
    (padded, na), b = _pad_batch((batched, _as_n_active(batched, n_active)),
                                 _batch_extent(layout))

    def run(s, a):
        return _engine(order, eps, dtype, s.device)[1](s, a, dt, n_steps)

    return _take(_on_rows(layout, run, padded, na), b)


def _step_members(s: ParticleState, h, ev, order: int) -> ParticleState:
    """One P-E-C step with a per-member step ``h`` of shape (B,)."""
    h3 = h[:, None, None]
    xp, vp = hermite.predict(s, h3)
    out = ev(xp, vp, s.mass)
    x1, v1, crackle = hermite.correct(s, out, h3, order=order)
    return ParticleState(
        pos=x1, vel=v1, acc=out.acc.to(s.dtype), jerk=out.jerk.to(s.dtype),
        snap=out.snap.to(s.dtype), crackle=crackle, mass=s.mass,
        pot=out.pot.to(s.mass.dtype), time=s.time + h)


@functools.lru_cache(maxsize=64)
def _adaptive_engine(order: int, eps: float, eta: float, dt_max: float,
                     dtype: str, device: torch.device):
    """Per-member shared-adaptive (Aarseth) lockstep engine."""
    _count_engine_build("adaptive")
    ev = make_evaluator(order=order, eps=eps, dtype=dtype)

    def run(s, hp, cnt, na, t_end_, n_steps: int):
        mev = _mask_evaluator(ev, na)
        for _ in range(n_steps):
            remaining = t_end_ - s.time
            active = remaining > 0.0
            # padding rows carry zero derivatives, so they fall into
            # aarseth_dt's num > 0 guard and never tighten the step
            h = hermite.aarseth_dt_particles(s, eta=eta,
                                             dt_max=dt_max).amin(-1)
            h = torch.where(hp > 0.0, torch.minimum(torch.maximum(
                h, 0.5 * hp), 2.0 * hp), h)
            h = torch.minimum(h, torch.clamp(remaining, min=1e-12))
            # the corrector divides by h^3
            h_safe = torch.where(active, h, torch.ones_like(h))
            s = _select(active, _step_members(s, h_safe, mev, order), s)
            hp = torch.where(active, h, hp)
            cnt = cnt + active.to(cnt.dtype)
        return s, hp, cnt

    return run


def ensemble_run_adaptive(
    batched: ParticleState,
    *,
    t_end,
    n_steps: int,
    h_prev: Optional[torch.Tensor] = None,
    n_taken: Optional[torch.Tensor] = None,
    n_active=None,
    eta: float = 0.02,
    dt_max: float = 0.0625,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    devices=None,
):
    """Advance an initialized batch by up to ``n_steps`` adaptive steps each.

    Each member carries its own step: the Aarseth criterion over its own
    particles, rate-limited against its previous step (``h_prev <= 0``
    marks the first), clamped to its remaining time.  Members past
    ``t_end`` keep stepping in lockstep but their state is frozen by a
    per-member select.  Nothing is read back to the host inside the loop.

    Returns ``(batched, h_prev, n_taken)``; call again with the returned
    carries until ``batched.time.min() >= t_end``.  ``n_taken`` counts the
    productive steps per member.  ``t_end`` is a scalar or a (B,) vector.
    Over ``devices`` of more than one, each slot runs its member chunk.
    """
    layout = _layout(devices, None, batched.device)
    b = batch_size(batched)
    if h_prev is None:
        h_prev = torch.zeros(b, dtype=batched.dtype, device=batched.device)
    if n_taken is None:
        n_taken = torch.zeros(b, dtype=torch.int32, device=batched.device)
    carry, b = _pad_batch((batched, h_prev, n_taken,
                           _as_n_active(batched, n_active),
                           _as_t_end(batched, t_end)), _batch_extent(layout))

    def run(s, hp, cnt, na, te):
        return _adaptive_engine(order, eps, eta, dt_max, dtype, s.device)(
            s, hp, cnt, na, te, n_steps)

    return _take(_on_rows(layout, run, *carry), b)


def evolve_ensemble(
    states,
    *,
    n_steps: int,
    dt: float,
    n_active=None,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    devices=None,
    strategy: str = "single",
) -> ParticleState:
    """One-shot convenience: stack (if needed), initialize, evolve."""
    _check_labels(strategy=strategy)
    batched = states if isinstance(states, ParticleState) else \
        stack_states(list(states))
    kw = dict(n_active=n_active, order=order, eps=eps, dtype=dtype,
              devices=devices)
    batched = ensemble_initialize(batched, **kw)
    return ensemble_run(batched, n_steps=n_steps, dt=dt, **kw)


# --------------------------------------------------------------------------
# hierarchical block-timestep engine (per-particle power-of-two levels)
# --------------------------------------------------------------------------
class NeighborCarry(NamedTuple):
    """Per-batch carry of the Ahmad-Cohen neighbor scheme.

    ``win_idx``/``win_cnt`` are the current windows (``(B, nbt, nsb)`` and
    ``(B, nbt)`` int32, ``kernels.neighbor.build_windows``);
    ``acc_far``/``jerk_far``/``snap_far``/``pot_far`` the far-field Taylor
    coefficients captured at the last refresh (``far = full - near`` at the
    refresh anchor, predicted between refreshes as ``a_far(h) = A + h J +
    h^2/2 S``); ``t_ref`` the ``(B,)`` refresh anchor tick (``-1``: never
    refreshed, which forces a refresh at the member's next event);
    ``n_refresh``/``n_overflow`` count refresh events and window-overflow
    fallbacks (a refresh whose widest window fit no bucket below the full
    extent).
    """

    win_idx: torch.Tensor
    win_cnt: torch.Tensor
    acc_far: torch.Tensor
    jerk_far: torch.Tensor
    snap_far: torch.Tensor
    pot_far: torch.Tensor
    t_ref: torch.Tensor
    n_refresh: torch.Tensor
    n_overflow: torch.Tensor


class BlockCarry(NamedTuple):
    """Per-batch carry of the block engine (pass back unchanged).

    ``t_last``/``levels`` are ``(B, N)`` int32 ticks / block levels,
    ``dt_macro`` the ``(B,)`` current macro length, ``n_pairs`` the ``(B,)``
    accumulated pairwise force evaluations (per Hermite pass), ``n_events``
    the ``(B,)`` int32 productive event count, ``n_tiles`` the ``(B,)``
    kernel grid tiles launched (both passes, in the reference's logical
    (BI, BJ) tiles): the count compaction shrinks while ``n_pairs`` stays.
    ``bucket_hits`` is ``(B, n_caps)``: how often each member's event
    dispatched each bucket of the full capacity schedule (all zeros
    without compaction).  The float counters are float64, as the
    reference keeps them under x64: exact integer adds far past float32's
    2**24.  ``nbr`` is the :class:`NeighborCarry` under
    ``sources="neighbor"`` and None under full sources.
    """

    t_last: torch.Tensor
    levels: torch.Tensor
    dt_macro: torch.Tensor
    n_pairs: torch.Tensor
    n_events: torch.Tensor
    n_tiles: torch.Tensor
    bucket_hits: torch.Tensor
    nbr: Optional[NeighborCarry] = None


def neighbor_carry(b: int, n: int, block_i: int, block_j: int, dtype,
                   device) -> NeighborCarry:
    """The zeroed :class:`NeighborCarry` of a ``(b, n)`` batch.  ``t_ref =
    -1`` forces a refresh at every member's first event, so the zeroed
    windows and coefficients are never consumed."""
    sd = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    nbt, nsb = -(-n // block_i), -(-n // block_j)
    return NeighborCarry(
        win_idx=torch.zeros((b, nbt, nsb), **i32),
        win_cnt=torch.zeros((b, nbt), **i32),
        acc_far=torch.zeros((b, n, 3), **sd),
        jerk_far=torch.zeros((b, n, 3), **sd),
        snap_far=torch.zeros((b, n, 3), **sd),
        pot_far=torch.zeros((b, n), **sd),
        t_ref=torch.full((b,), -1, **i32),
        n_refresh=torch.zeros(b, **i32),
        n_overflow=torch.zeros(b, **i32))


def _window_pairs(mask, win_cnt, block_i: int, block_j: int):
    """(B,) float64 gathered interaction rows of one neighbor event: each
    masked target sweeps its block's ``win_cnt * block_j`` gathered source
    rows, the ``n_pairs`` cost the scheme shrinks from ``active * N``."""
    b, n = mask.shape
    nbt = win_cnt.shape[1]
    per_block = torch.nn.functional.pad(mask, (0, nbt * block_i - n)).reshape(
        b, nbt, block_i).sum(dim=2)
    return (per_block * win_cnt).sum(dim=1).to(torch.float64) * block_j


def spatial_sort_state(state: ParticleState, n_active=None, *,
                       leaf: int = 32) -> ParticleState:
    """Spatial sort of one run's rows (padding rows stay last).

    The neighbor scheme windows contiguous index blocks, so spatial
    locality of adjacent rows is what keeps the blocks' boxes, and with
    them the gathered windows, tight.  Rows are laid out by balanced
    orthogonal recursive bisection (``kernels.neighbor.kd_perm``; ``leaf``
    should divide the kernel block sizes).  The physics is
    permutation-invariant; entry points sort once at build or admission and
    never mid-run.
    """
    n = state.pos.shape[0]
    valid = (torch.arange(n, device=state.device)
             < (n if n_active is None else int(n_active)))
    perm = neighbor.kd_perm(state.pos, valid, leaf=leaf)
    return ParticleState(**{
        f: (x[perm] if x.dim() >= 1 else x)
        for f, x in ((f, getattr(state, f)) for f in FIELDS)})


def spatial_sort_batched(batched: ParticleState, n_active=None, *,
                         leaf: int = 32) -> ParticleState:
    """Per-member :func:`spatial_sort_state` over a batched state."""
    na = _as_n_active(batched, n_active).tolist()
    return stack_states([spatial_sort_state(m, a, leaf=leaf)
                         for m, a in zip(unstack_states(batched), na)])


def _macro_levels(s, dt_macro, *, eta, n_levels: int):
    """Fresh levels for members synchronized at their macro start
    (``dt_macro`` is (B,))."""
    col = dt_macro[:, None]
    dt_i = hermite.aarseth_dt_particles(s, eta=eta, dt_max=col)
    return hermite.quantize_block_levels(dt_i, dt_max=col, n_levels=n_levels)


def _macro_length(remaining, dt_max):
    return torch.minimum(torch.full_like(remaining, dt_max),
                         torch.clamp(remaining, min=1e-12))


def _event_init(s, t_end, *, eta, dt_max, n_levels: int):
    dt_macro = _macro_length(t_end - s.time, dt_max)
    levels = _macro_levels(s, dt_macro, eta=eta, n_levels=n_levels)
    t_last = torch.zeros(s.pos.shape[:-1], dtype=torch.int32,
                         device=s.device)
    return t_last, levels, dt_macro


def _period(levels, n_sub: int):
    return torch.bitwise_right_shift(n_sub, levels)


# One event is split in two stages around the force evaluation, so the
# compaction layer can pick its capacity buckets between them.
def _event_pre(s, t_last, levels, dt_macro, na, t_end, *, n_sub: int):
    live = (t_end - s.time) > 0.0
    real = (torch.arange(s.pos.shape[-2], device=s.device)[None, :]
            < na[:, None])
    cand = t_last + _period(levels, n_sub)
    t_next = torch.where(real, cand, n_sub).amin(dim=-1)
    active = real & (cand == t_next[:, None])
    dt_fine = dt_macro / n_sub
    h = ((t_next[:, None] - t_last).to(s.dtype) * dt_fine[:, None])[..., None]
    xp, vp = hermite.predict(s, h)
    ap = hermite.predict_acc(s, h)
    return live, t_next, active, h, xp, vp, ap


def _event_post(s, ev, live, t_next, active, h, t_last, levels, dt_macro,
                na, t_end, *, n_sub: int, eta, dt_max, n_levels: int,
                order: int):
    dtype = s.dtype
    period = _period(levels, n_sub)
    # an active particle last corrected exactly its own step ago, so the
    # prediction horizon is the corrector interval
    x1, v1, crk = hermite.correct(s, ev, h, order=order)
    m3 = active[..., None]
    st1 = ParticleState(
        pos=torch.where(m3, x1, s.pos),
        vel=torch.where(m3, v1, s.vel),
        acc=torch.where(m3, ev.acc.to(dtype), s.acc),
        jerk=torch.where(m3, ev.jerk.to(dtype), s.jerk),
        snap=torch.where(m3, ev.snap.to(dtype), s.snap),
        crackle=torch.where(m3, crk, s.crackle),
        mass=s.mass,
        pot=torch.where(active, ev.pot.to(s.mass.dtype), s.pot),
        time=s.time,
    )
    t_last1 = torch.where(active, t_next[:, None], t_last)

    # level update from the freshly corrected derivatives: finer at will
    # (always commensurate), coarser one level at doubled-period ticks
    col = dt_macro[:, None]
    dt_i = hermite.aarseth_dt_particles(st1, eta=eta, dt_max=col)
    want = hermite.quantize_block_levels(dt_i, dt_max=col, n_levels=n_levels)
    can_coarsen = (t_next[:, None] % (period << 1)) == 0
    lev1 = torch.where(active & (want > levels), want,
                       torch.where(active & (want < levels) & can_coarsen,
                                   levels - 1, levels))

    # macro boundary: advance member time, requantize, reset the grid
    sync = t_next == n_sub
    time1 = torch.where(sync, s.time + dt_macro, s.time)
    st1 = dataclasses.replace(st1, time=time1)
    dt_macro1 = torch.where(sync, _macro_length(t_end - time1, dt_max),
                            dt_macro)
    lev1 = torch.where(sync[:, None],
                       _macro_levels(st1, dt_macro1, eta=eta,
                                     n_levels=n_levels), lev1)
    t_last1 = torch.where(sync[:, None], 0, t_last1)

    # members past t_end freeze whole (the batch stays rectangular)
    st1 = _select(live, st1, s)
    t_last1 = torch.where(live[:, None], t_last1, t_last)
    lev1 = torch.where(live[:, None], lev1, levels)
    dt_macro1 = torch.where(live, dt_macro1, dt_macro)
    dp = torch.where(live, active.sum(-1).to(dtype) * na, 0.0)
    return st1, t_last1, lev1, dt_macro1, dp


def _bucket_groups(n: int, n_active: Sequence[int], block_i: int,
                   block_j: int, compaction: str, bucket_mode: str) -> tuple:
    """Bucket groups of a (possibly mixed) batch.

    Members are grouped by the ceiling bucket of their ``n_active``, the
    bucket a member's per-event active count can never exceed; each group
    launches once per pass per event over a capacity schedule truncated at
    that ceiling (``ops.CapacityPlan.restrict``), so a small member in a
    mixed batch never launches the widest member's buckets.  Returns
    ``(member_indices, n_caps)`` pairs partitioning ``range(B)``; with
    ``bucket_mode="shared"`` (or without compaction) the whole batch is
    one group over the full schedule.
    """
    if bucket_mode not in BUCKET_MODES:
        raise ValueError(
            f"bucket_mode must be one of {BUCKET_MODES}; got {bucket_mode!r}")
    plan = ops.CapacityPlan(n, n, block_i, block_j)
    if compaction != "gather" or bucket_mode == "shared":
        return ((tuple(range(len(n_active))), len(plan.caps)),)
    by: dict = {}
    for member, a in enumerate(n_active):
        by.setdefault(len(plan.restrict(int(a)).caps), []).append(member)
    return tuple(sorted((tuple(ms), n_caps) for n_caps, ms in by.items()))


class _BlockEngine:
    """The block-timestep event loop for one configuration.

    Time runs in macro-steps of ``dt_macro = min(dt_max, remaining)``, each
    an integer grid of ``2**(n_levels-1)`` fine ticks; a particle at level
    ``l`` steps every ``2**(n_levels-1-l)`` ticks.  Each event jumps to
    the next occupied tick, predicts everyone there, evaluates the active
    block (sources full, inactive sources' accelerations predicted) and
    corrects it; after correction a particle may move to a finer level at
    once or one level coarser at a doubled-period tick.  The macro boundary
    synchronizes every particle and requantizes the levels.

    ``layout`` (optional, see :func:`_layout`) spreads the launches over
    devices while the event schedule, the bounds and the one host read per
    event stay the whole batch's: under the 1-D batch mesh each slot
    launches its member chunk at the capacity the batch's bucket group
    chose.  On the fused ``(batch, dev)`` grid every full evaluation is ONE
    pass of ``strategies.make_fused_block_evaluator``: each member's target
    rows sharded ``p`` ways, each slot launching once per pass for its
    members.  With gather its capacity buckets are sized on the host from
    each member's per-shard analytic bound (:meth:`_bound`), ``n_tiles``
    sums the shards' tiles and ``bucket_hits`` stays untouched (the switch
    lives inside the shards), as in the reference's fused engine.  Neighbor
    sources on the grid send each batch row's members to its slots with
    their target blocks split ``p`` ways (:meth:`_near`).

    On a rank's ``ProcessMesh`` (``self.ranks``) the engine runs on the
    rank's own members (:func:`_by_rank` cuts them out and brings them
    back): ``batch`` members in all, this rank's ``lo .. lo + bl``.  Its
    bucket groups are the whole batch's, each restricted to the members
    the rank holds, and each event's decisions come from one collective
    over every rank (:meth:`_read`) where one process reads them to the
    host.
    """

    def __init__(self, *, order, eps, eta, dt_max, n_levels, compaction,
                 block_i, block_j, groups, dtype, n, device, sources="full",
                 radius=0.25, refresh_levels=2, layout=None):
        self.layout = layout
        self.ranks = isinstance(layout, ProcessMesh)
        self.order, self.eta, self.dt_max = order, eta, dt_max
        self.n_levels, self.n_sub = n_levels, 2 ** (n_levels - 1)
        self.compaction, self.sources = compaction, sources
        self.block_i, self.block_j = block_i, block_j
        self.batch = sum(len(m) for m, _ in groups)
        self.bl = self.batch // layout.shape[0] if self.ranks else self.batch
        self.lo = layout.row * self.bl if self.ranks else 0
        n_passes = 2 if order >= 6 else 1
        kw = dict(order=order, eps=eps, block_i=block_i, block_j=block_j,
                  dtype=dtype)
        plan = ops.CapacityPlan(n, n, block_i, block_j, n_passes=n_passes,
                                dtype=dtype)
        self.n_caps = len(plan.caps)
        self.fused = None
        if layout is not None and len(layout.shape) == 2:
            self.fused = make_fused_block_evaluator(
                layout.shape, mesh=layout, compaction=compaction, **kw)
        # the members of each bucket group this engine holds, in its own
        # indices (every member in one process)
        self.members = [[m - self.lo for m in ms
                         if self.lo <= m < self.lo + self.bl]
                        for ms, _ in groups]
        if compaction != "gather":
            self.bev = make_block_evaluator(**kw)
            # the masked dense launch covers the full grid, however many
            # blocks skip their work
            self.full_tiles = plan.dense_tiles
        elif self.fused is None:
            # the grid sizes its buckets inside the shards (:meth:`_bound`)
            self.groups = []
            for (_, n_caps), mine in zip(groups, self.members):
                gplan = plan.restrict(plan.caps[min(n_caps, self.n_caps) - 1])
                idx = torch.tensor(mine, dtype=torch.int64, device=device)
                self.groups.append((
                    None if len(groups) == 1 else idx, gplan,
                    make_block_evaluator(compaction="gather",
                                         n_caps=n_caps, **kw)))
            order_ = torch.tensor(sum(self.members, []), dtype=torch.int64)
            self.inv = torch.argsort(order_).to(device)
            self.tiles_table = torch.tensor(plan.tiles_by_cap,
                                            dtype=torch.float64,
                                            device=device)
            self.cap_range = torch.arange(self.n_caps, device=device)
        if sources == "neighbor":
            self.near1, self.near2 = make_neighbor_block_evaluator(
                n=n, eps=eps, block_i=block_i, block_j=block_j, dtype=dtype)
            self.near_dtype = torch.float64 if dtype == "fp64" \
                else torch.float32
            self.nplan = dataclasses.replace(plan, sources="neighbor")
            self.refresh_period = max(1, self.n_sub >> refresh_levels)
            self.radius = radius

    # -- where the launches go -----------------------------------------------
    def _read(self, x: torch.Tensor) -> list:
        """One event's integer decisions on the host: one read of ``x``, or
        on a rank's mesh their max over every rank, in one collective."""
        ensemble_run_block.host_syncs += 1
        return self.layout.agree(x) if self.ranks else x.tolist()

    def _rows(self, fn, *args, **kw):
        """``fn`` per batch row over the layout (:func:`_on_rows`); on a
        rank's mesh on the rank's own members, which it holds already."""
        if self.ranks:
            return fn(*args)
        return _on_rows(self.layout, fn, *args, **kw)

    def _full(self, xp, vp, ap, mass, mask) -> Evaluation:
        """The masked dense evaluation over the layout: per batch row, or
        domain-sharded on the fused grid."""
        if self.fused is not None:
            return self.fused(xp, vp, ap, mass, mask)[0]
        return self._rows(self.bev, xp, vp, ap, mass, mask)

    def _near(self, fn, *args):
        """A near pass (``near1``/``near2``) over the layout: per batch row
        under the 1-D mesh; on the fused grid slot ``(i, k)`` takes row
        ``i``'s members and the ``k``-th of ``p`` chunks of their target
        blocks, gathering its own windows from their full source rows."""
        layout = self.layout
        if layout is None:
            return fn(*args)
        b = args[0].shape[0]
        if len(layout.shape) == 1:
            return self._rows(fn, *args)
        bdev, p = layout.shape
        n = args[0].shape[1]
        nbt = -(-n // self.block_i)
        step = -(-nbt // p)
        if self.ranks:
            return self._near_rank(fn, args, nbt, step)
        bl = b // bdev
        dev = args[0].device
        rows = []
        for i in range(bdev):
            cols = []
            for k in range(p):
                lo, hi = k * step, min(nbt, (k + 1) * step)
                if lo >= hi:
                    continue
                d = layout.devices[i * p + k]
                out = fn(*(a[i * bl:(i + 1) * bl].to(d)
                           if isinstance(a, torch.Tensor) else a
                           for a in args), blocks=(lo, hi))
                cols.append(out if isinstance(out, tuple) else (out,))
            rows.append(tuple(torch.cat([c[j].to(dev) for c in cols], dim=1)
                              for j in range(len(cols[0]))))
        out = tuple(torch.cat(parts) for parts in zip(*rows))
        return out if len(out) > 1 else out[0]

    def _near_rank(self, fn, args, nbt: int, step: int):
        """:meth:`_near` on a rank of the fused grid: this slot's chunk of
        target blocks (zero rows where its chunk is empty), each output
        padded to a chunk's ``step * block_i`` rows and gathered along the
        row's slots, so every slot of the row holds its members whole."""
        layout = self.layout
        k = layout.rank % layout.shape[1]
        b, n = args[0].shape[0], args[0].shape[1]
        lo, hi = k * step, min(nbt, (k + 1) * step)
        width = step * self.block_i
        if lo < hi:
            out = fn(*args, blocks=(lo, hi))
            out = out if isinstance(out, tuple) else (out,)
            out = tuple(_pad_rows(o, width, dim=1) for o in out)
        else:
            tails = ((3,), (3,), ()) if fn is self.near1 else ((3,),)
            out = tuple(torch.zeros((b, width) + t, dtype=self.near_dtype,
                                    device=args[0].device) for t in tails)
        out = tuple(o[:, :n] for o in layout.all_gather_dev([out])[0])
        return out if len(out) > 1 else out[0]

    def init(self, batched, t_end) -> BlockCarry:
        t_last, levels, dt_macro = _event_init(
            batched, t_end, eta=self.eta, dt_max=self.dt_max,
            n_levels=self.n_levels)
        b, n = batched.pos.shape[0], batched.pos.shape[1]
        dev = batched.device
        f64 = dict(dtype=torch.float64, device=dev)
        nbr = None
        if self.sources == "neighbor":
            nbr = neighbor_carry(b, n, self.block_i, self.block_j,
                                 batched.dtype, dev)
        return BlockCarry(
            t_last=t_last, levels=levels, dt_macro=dt_macro,
            n_pairs=torch.zeros(b, **f64),
            n_events=torch.zeros(b, dtype=torch.int32, device=dev),
            n_tiles=torch.zeros(b, **f64),
            bucket_hits=torch.zeros((b, self.n_caps), **f64), nbr=nbr)

    def _gather_eval(self, xp, vp, ap, mass, act, live):
        """The gathered evaluation of one event, one launch per pass per
        bucket group; returns ``(ev, tiles, hits)``, or None when no
        member is live.  The one host read of the event is here: a group's
        capacity index is that of its members' largest bound, on a rank's
        mesh over every rank's members of the group."""
        bound = torch.where(live, act.sum(-1), 0)
        zero = torch.zeros((), dtype=torch.int64, device=xp.device)
        idx = [shared_cap_index(gplan, bound if sel is None else bound[sel])
               if mine else zero
               for (sel, gplan, _), mine in zip(self.groups, self.members)]
        host = self._read(torch.stack(idx + [live.any().to(torch.int64)]))
        if not host[-1]:
            return None
        perm = torch.argsort((~act).to(torch.int32), dim=-1, stable=True)
        evs, caps = [], []
        for (sel, _, gbev), ci, mine in zip(self.groups, host, self.members):
            if not mine:
                continue
            ops_ = (xp, vp, ap, mass, act, perm)
            if sel is not None:
                ops_ = tuple(x[sel] for x in ops_)
            # every slot launches its members at the group's one capacity
            evs.append(self._rows(
                lambda *a, ci=ci, gbev=gbev: gbev(*a, ci), *ops_,
                members=mine, batch=self.bl))
            caps.append(torch.full((len(mine),), ci, dtype=torch.int64,
                                   device=xp.device))
        cap_idx = torch.cat(caps)
        if len(self.groups) == 1:
            ev = evs[0]
        else:
            ev = Evaluation(*(torch.cat(parts)[self.inv]
                              for parts in zip(*evs)))
            cap_idx = cap_idx[self.inv]
        hits = cap_idx[:, None] == self.cap_range
        return ev, self.tiles_table[cap_idx], hits.to(torch.float64)

    def _bound(self, levels, na, t_next, live):
        """The fused grid's gather bounds: each member's per-shard analytic
        ``hermite.block_level_occupancy`` of its contiguous ``N/p`` level
        chunks at the tick's threshold level, padding rows masked out and
        dead members at 0, as ``(B, p)`` host lists read with the live flag
        in one copy of ``B*p + 1`` counts; None when no member is live (the
        one host read of the event).  On a rank every rank's row fills its
        place among the ``B*p`` counts of the one collective, and the rank
        keeps its own members'."""
        b, n = levels.shape
        p = self.layout.shape[1]
        n_pad = -(-n // p) * p
        thr = hermite.tick_threshold_level(t_next, n_levels=self.n_levels)
        real = torch.arange(n_pad, device=levels.device)[None, :] \
            < na[:, None]
        lev = torch.nn.functional.pad(levels, (0, n_pad - n))
        occ = hermite.block_level_occupancy(
            lev.reshape(b, p, -1), n_levels=self.n_levels,
            mask=real.reshape(b, p, -1))
        bound = occ.gather(-1, thr.long()[:, None, None].expand(b, p, 1))
        bound = torch.where(live[:, None], bound[..., 0], 0).reshape(-1)
        bound = torch.nn.functional.pad(
            bound, (self.lo * p, (self.batch - self.lo - b) * p))
        host = self._read(torch.cat([bound, live.any().to(bound.dtype)[None]]))
        if not host[-1]:
            return None
        return [host[m * p:(m + 1) * p] for m in range(self.lo, self.lo + b)]

    def _near_total(self, pre, nb: NeighborCarry, dt_macro, mass, mask,
                    win_idx, win_cnt, w_idx: int) -> Evaluation:
        """Near force over the given windows plus the far field predicted
        from the last refresh anchor, for every member.  The anchor does not
        move inside the event, so one prediction serves both the snap
        pass's accelerations and the returned evaluation."""
        t_next, xp, vp, ap = pre
        sd = xp.dtype
        a_n, j_n, p_n = self._near(self.near1, xp, vp, mass, mask, win_idx,
                                   win_cnt, w_idx)
        hf = ((t_next - torch.clamp(nb.t_ref, min=0)).to(sd) * dt_macro
              / self.n_sub)
        h1 = hf[:, None, None]
        a_far = nb.acc_far + h1 * nb.jerk_far + (0.5 * h1 * h1) * nb.snap_far
        acc_t = a_n.to(sd) + a_far
        if self.order >= 6:
            acc_s = torch.where(mask[..., None], acc_t, ap)
            s_n = self._near(self.near2, xp, vp, acc_t, acc_s, mass, mask,
                             win_idx, win_cnt, w_idx)
            snp = s_n.to(sd) + nb.snap_far
        else:
            snp = torch.zeros_like(acc_t)
        return Evaluation(acc=acc_t,
                          jerk=j_n.to(sd) + nb.jerk_far + h1 * nb.snap_far,
                          snap=snp, pot=p_n.to(sd) + nb.pot_far)

    def _neighbor_event(self, s, c: BlockCarry, na, t_end):
        """One Ahmad-Cohen event (the reference's ``neighbor_body``).

        Members whose refresh is due (``refresh_levels`` irregular levels
        since their anchor, every macro boundary, and their first event)
        take the full evaluation itself and re-anchor their far field on
        fresh windows; the others take the near force over their windows
        plus the predicted far field.  A refresh event does all the
        reference's launches: the near passes over the old windows for the
        members that keep their anchor, the full evaluation and the near
        passes over the new windows; rows whose results an event discards
        go to the kernels inactive.  Returns ``(state, carry)``, or None
        when no member is live.
        """
        bi, bj, nplan = self.block_i, self.block_j, self.nplan
        nb = c.nbr
        live, t_next, active, h, xp, vp, ap = _event_pre(
            s, c.t_last, c.levels, c.dt_macro, na, t_end, n_sub=self.n_sub)
        b, n = active.shape
        sd = s.dtype
        need = live & ((nb.t_ref < 0)
                       | (t_next - nb.t_ref >= self.refresh_period)
                       | (t_next == self.n_sub))
        keep = live & ~need
        real = torch.arange(n, device=s.device)[None, :] < na[:, None]
        act = active & live[:, None]
        nbt = nb.win_cnt.shape[1]
        # the window of one event is shared by every launched target block,
        # so it is sized over the blocks that hold active targets
        act_blk = torch.nn.functional.pad(act, (0, nbt * bi - n)).reshape(
            b, nbt, bi).any(dim=2)
        # the widest window over the members that keep their anchor when any
        # member refreshes, else over every live member
        refresh, w_keep, w_live, any_live = self._read(torch.stack([
            need.any().long()] + [
            torch.where(sized[:, None] & act_blk, nb.win_cnt, 0).amax().long()
            for sized in (keep, live)] + [live.any().long()]))
        if not any_live:
            return None
        w_old = int(nplan.source_bucket((w_keep if refresh else w_live) * bj))
        pre = (t_next, xp, vp, ap)
        tiles_old = live.to(torch.float64) * nplan.window_tiles(w_old)
        pairs_old = torch.where(live, _window_pairs(active, nb.win_cnt, bi,
                                                    bj), 0.0)
        if not refresh:
            ev = self._near_total(pre, nb, c.dt_macro, s.mass, act,
                                  nb.win_idx, nb.win_cnt, w_old)
            nbr, dp, tiles = nb, pairs_old, tiles_old
        else:
            ev_o = self._near_total(pre, nb, c.dt_macro, s.mass,
                                    act & keep[:, None], nb.win_idx,
                                    nb.win_cnt, w_old)
            # the refresh anchor: the full force at the event's predicted
            # positions, new windows from the same positions, far = full -
            # near with the same acc operands in both
            fresh = real & need[:, None]
            ev_f = self._full(xp, vp, ap, s.mass, fresh)
            win_idx_n, win_cnt_n = self._rows(
                lambda x, r: neighbor.build_windows(
                    x, r, block_i=bi, block_j=bj, radius=self.radius),
                xp, real)
            (wmax_n,) = self._read(
                torch.where(need[:, None], win_cnt_n, 0).amax()[None])
            w_new = int(nplan.source_bucket(wmax_n * bj))
            a_nn, j_nn, p_nn = self._near(self.near1, xp, vp, s.mass, fresh,
                                          win_idx_n, win_cnt_n, w_new)
            af, jf, pf = ev_f.acc.to(sd), ev_f.jerk.to(sd), ev_f.pot.to(sd)
            sel3, sel2 = need[:, None, None], need[:, None]
            if self.order >= 6:
                acc_s = torch.where(real[..., None], af, ap)
                s_nn = self._near(self.near2, xp, vp, af, acc_s, s.mass,
                                  fresh, win_idx_n, win_cnt_n, w_new)
                sf = ev_f.snap.to(sd)
                snapf_n = sf - s_nn.to(sd)
                snap_ev = torch.where(sel3, sf, ev_o.snap)
            else:
                snapf_n = snap_ev = torch.zeros_like(af)
            ev = Evaluation(acc=torch.where(sel3, af, ev_o.acc),
                            jerk=torch.where(sel3, jf, ev_o.jerk),
                            snap=snap_ev,
                            pot=torch.where(sel2, pf, ev_o.pot))
            src_caps = nplan.source_caps
            if len(src_caps) > 1:
                rows = win_cnt_n.amax(dim=1) * bj
                dov = (need & (rows > src_caps[-2])).to(torch.int32)
            else:
                dov = torch.zeros_like(nb.n_overflow)  # one bucket: full
            na_f = na.to(torch.float64)
            # need implies live
            dp = torch.where(
                need, na_f * na_f + _window_pairs(real, win_cnt_n, bi, bj),
                pairs_old)
            tiles = torch.where(need, torch.full_like(
                tiles_old, self.full_tiles + nplan.window_tiles(w_new)),
                tiles_old)
            nbr = NeighborCarry(
                win_idx=torch.where(sel3, win_idx_n, nb.win_idx),
                win_cnt=torch.where(sel2, win_cnt_n, nb.win_cnt),
                acc_far=torch.where(sel3, af - a_nn.to(sd), nb.acc_far),
                jerk_far=torch.where(sel3, jf - j_nn.to(sd), nb.jerk_far),
                snap_far=torch.where(sel3, snapf_n, nb.snap_far),
                pot_far=torch.where(sel2, pf - p_nn.to(sd), nb.pot_far),
                t_ref=torch.where(
                    need, torch.where(t_next == self.n_sub, 0, t_next),
                    nb.t_ref),
                n_refresh=nb.n_refresh + need.to(torch.int32),
                n_overflow=nb.n_overflow + dov)
        s1, t_last, levels, dt_macro, _ = _event_post(
            s, ev, live, t_next, active, h, c.t_last, c.levels, c.dt_macro,
            na, t_end, n_sub=self.n_sub, eta=self.eta, dt_max=self.dt_max,
            n_levels=self.n_levels, order=self.order)
        return s1, BlockCarry(
            t_last=t_last, levels=levels, dt_macro=dt_macro,
            n_pairs=c.n_pairs + dp,
            n_events=c.n_events + live.to(torch.int32),
            n_tiles=c.n_tiles + tiles, bucket_hits=c.bucket_hits, nbr=nbr)

    def run(self, s, c: BlockCarry, na, t_end, n_events: int):
        if self.sources == "neighbor":
            for _ in range(n_events):
                out = self._neighbor_event(s, c, na, t_end)
                if out is None:
                    break  # every member is past t_end
                s, c = out
            return s, c
        for _ in range(n_events):
            live, t_next, active, h, xp, vp, ap = _event_pre(
                s, c.t_last, c.levels, c.dt_macro, na, t_end,
                n_sub=self.n_sub)
            # a finished member's outputs are discarded, so its targets go
            # to the kernels inactive and their blocks skip their work
            act = active & live[:, None]
            hits = None
            if self.fused is not None:
                bound = None
                if self.compaction == "gather":
                    bound = self._bound(c.levels, na, t_next, live)
                    if bound is None:
                        break  # every member is past t_end
                ev, tiles = self.fused(xp, vp, ap, s.mass, act, bound)
                tiles = tiles.sum(dim=1).to(torch.float64)
            elif self.compaction == "gather":
                out = self._gather_eval(xp, vp, ap, s.mass, act, live)
                if out is None:
                    break  # every member is past t_end
                ev, tiles, hits = out
            else:
                ev = self._full(xp, vp, ap, s.mass, act)
                tiles = torch.full_like(c.n_tiles, self.full_tiles)
            s1, t_last, levels, dt_macro, dp = _event_post(
                s, ev, live, t_next, active, h, c.t_last, c.levels,
                c.dt_macro, na, t_end, n_sub=self.n_sub, eta=self.eta,
                dt_max=self.dt_max, n_levels=self.n_levels,
                order=self.order)
            c = BlockCarry(
                t_last=t_last, levels=levels, dt_macro=dt_macro,
                n_pairs=c.n_pairs + dp,
                n_events=c.n_events + live.to(torch.int32),
                n_tiles=c.n_tiles + torch.where(live, tiles, 0.0),
                bucket_hits=c.bucket_hits if hits is None else
                c.bucket_hits + torch.where(live[:, None], hits, 0.0))
            s = s1
        return s, c


@functools.lru_cache(maxsize=64)
def _block_engine(order: int, eps: float, eta: float, dt_max: float,
                  n_levels: int, compaction: str, block_i: int, block_j: int,
                  groups: tuple, dtype: str, n: int, device: torch.device,
                  sources: str = "full", radius: float = 0.25,
                  refresh_levels: int = 2,
                  layout: Optional[DeviceMesh] = None) -> _BlockEngine:
    """The cached :class:`_BlockEngine` of one configuration, bucket groups,
    device and batch layout (:func:`_layout`): its evaluators and device
    tables are built once.  The neighbor knobs are part of the key
    under either source mode, as in the reference.  A full-source engine
    on the fused grid counts as a ``block_fused`` build and has no bucket
    branches of its own (they live inside the shards)."""
    fused = layout is not None and len(layout.shape) == 2 \
        and sources == "full"
    _count_engine_build("block_fused" if fused else "block")
    if compaction == "gather" and not fused:
        # capacity buckets across the bucket groups: the denominator of the
        # build accounting (engine.cache_miss ticks once per build)
        obs_metrics.registry().counter(
            "engine.bucket_branches", unit="branches",
            help="capacity buckets across the bucket groups built"
        ).inc(sum(n_caps for _, n_caps in groups))
    return _BlockEngine(order=order, eps=eps, eta=eta, dt_max=dt_max,
                        n_levels=n_levels, compaction=compaction,
                        block_i=block_i, block_j=block_j, groups=groups,
                        dtype=dtype, n=n, device=device, sources=sources,
                        radius=radius, refresh_levels=refresh_levels,
                        layout=layout)


def ensemble_run_block(
    batched: ParticleState,
    *,
    t_end,
    n_events: int = 64,
    dt_max: float = 0.0625,
    n_levels: int = 8,
    carry: Optional[BlockCarry] = None,
    n_active=None,
    eta: float = 0.02,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    compaction: str = "none",
    bucket_mode: str = "member",
    block_i: Optional[int] = None,
    block_j: Optional[int] = None,
    sources: str = "full",
    neighbor_radius: float = 0.25,
    refresh_levels: int = 2,
    devices=None,
    mesh=None,
):
    """Advance an initialized batch by up to ``n_events`` block events each.

    Returns ``(batched, carry)``; call again with the returned carry until
    ``batched.time.min() >= t_end`` (a member's time advances at its macro
    boundaries).  ``t_end`` is a scalar or a (B,) vector; a member past its
    deadline freezes whole while its batch-mates go on.  The carry counts
    pairs, events, tiles and bucket hits per member (:class:`BlockCarry`).

    ``compaction="gather"`` launches the kernels on the event's capacity
    bucket (bit for bit the ``"none"`` result, fewer tiles).
    ``bucket_mode="member"`` groups members by their ``n_active`` ceiling
    (:func:`_bucket_groups`), ``"shared"`` puts the whole batch in one
    group; both give the same physics.  ``block_i``/``block_j`` set the
    logical tile (default the kernels'): the capacity schedule's step and
    the unit of the tile counts.  A gather or neighbor run stops early once
    no member is live; a full-sources ``"none"`` run always does its
    ``n_events`` iterations.

    ``sources="neighbor"`` switches the force evaluation to the Ahmad-Cohen
    near/far split (:meth:`_BlockEngine._neighbor_event`):
    ``neighbor_radius`` is the window radius in simulation length units,
    ``refresh_levels`` how many levels below the macro step the far-field
    refresh cadence sits (a refresh every ``n_sub >> refresh_levels``
    ticks).  The batch should be spatially sorted first
    (:func:`spatial_sort_batched`; the convenience entry points do it).
    ``sources="full"`` ignores the two knobs.

    ``devices`` (a device list, a count, None for the batch's own
    device, or this rank's ``ProcessMesh``) shards the batch by member
    over the 1-D batch mesh;
    ``mesh=(bdev, p)`` over ``bdev * p`` devices fuses batch and domain
    sharding (full sources: each member's target rows split over its
    row's slots, where ``bucket_mode`` does not apply; neighbor sources:
    its target blocks split over them).  A batch
    that is not a multiple of the batch extent is padded by repeating its
    first run and sliced back.  Every layout gives the unsharded batch's
    bits and counts, except that the fused engine counts its shards' tiles
    and no bucket hits.
    """
    if n_levels < 1:
        raise ValueError(f"n_levels={n_levels} must be >= 1")
    _check_labels(sources=sources)
    if sources == "neighbor" and compaction != "none":
        raise ValueError(
            "sources='neighbor' gathers its own per-block source windows; "
            "it composes with compaction='none' only")
    if refresh_levels < 0:
        raise ValueError(f"refresh_levels={refresh_levels} must be >= 0")
    if compaction not in COMPACTIONS:
        raise ValueError(
            f"compaction must be one of {COMPACTIONS}; got {compaction!r}")
    layout = _layout(devices, mesh, batched.device)
    (batched, na, t_end_, carry), b = _pad_batch(
        (batched, _as_n_active(batched, n_active),
         _as_t_end(batched, t_end), carry), _batch_extent(layout))
    bi = block_i or nbody_force.DEFAULT_BLOCK_I
    bj = block_j or nbody_force.DEFAULT_BLOCK_J
    n = batched.pos.shape[1]
    # groups come from the padded batch: a padding member repeats the first
    # run, so it lands in that run's group; on the fused grid with full
    # sources the buckets live inside the shards and the batch is one group
    if mesh is not None and sources == "full":
        bucket_mode = "shared"
    if compaction == "gather" and bucket_mode == "member":
        counts = na.tolist()
        ensemble_run_block.host_syncs += 1
    else:
        counts = [n] * batch_size(batched)
    groups = _bucket_groups(n, counts, bi, bj, compaction, bucket_mode)
    engine = _block_engine(order, eps, eta, dt_max, n_levels, compaction,
                           bi, bj, groups, dtype, n, batched.device,
                           sources, float(neighbor_radius), refresh_levels,
                           layout)
    if carry is None:
        carry = engine.init(batched, t_end_)
    return _take(_by_rank(
        layout, lambda s, c, a, t: engine.run(s, c, a, t, n_events),
        batched, carry, na, t_end_), b)


def block_admit_member(carry: BlockCarry, member: ParticleState, slot: int,
                       t_end, *, eta: float = 0.02, dt_max: float = 0.0625,
                       n_levels: int = 8) -> BlockCarry:
    """Splice a freshly admitted member's block carry into ``slot``.

    The serving layer backfills a retired slot by writing the new member's
    initialized ``(N,)`` state into the batch and resetting that slot's
    carry: fresh levels and ticks from the member's own Aarseth step
    distribution (:func:`_event_init`, the bootstrap ``init`` runs
    batch-wide) and zeroed counters, so the retiring run's telemetry never
    bleeds into its successor's.  The carry's tensors are written in place
    at ``slot`` (the batch's shapes, and with them the cached engine, stay
    as they are); every other slot is untouched, so batch-mates stay bit
    for bit the same.  ``eta``/``dt_max``/``n_levels`` must match the
    engine the batch runs.  Returns ``carry``.
    """
    m1 = ParticleState(**{f: getattr(member, f)[None] for f in FIELDS})
    t_end_ = torch.full((1,), float(t_end), dtype=member.dtype,
                        device=member.device)
    t_last, levels, dt_macro = _event_init(m1, t_end_, eta=eta,
                                           dt_max=dt_max, n_levels=n_levels)
    carry.t_last[slot] = t_last[0]
    carry.levels[slot] = levels[0]
    carry.dt_macro[slot] = dt_macro[0]
    for x in (carry.n_pairs, carry.n_events, carry.n_tiles,
              carry.bucket_hits):
        x[slot] = 0
    if carry.nbr is not None:
        # t_ref = -1 forces the new member to refresh, and build its
        # windows, at its first event
        for x in carry.nbr:
            x[slot] = 0
        carry.nbr.t_ref[slot] = -1
    return carry


#: device-to-host reads made by the block path (per gather event, per
#: chunk for the bucket groups and the end-of-chunk time check)
ensemble_run_block.host_syncs = 0


def evolve_ensemble_block(
    states,
    *,
    t_end: float,
    dt_max: float = 0.0625,
    n_levels: int = 8,
    n_active=None,
    eta: float = 0.02,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    compaction: str = "none",
    bucket_mode: str = "member",
    block_i: Optional[int] = None,
    block_j: Optional[int] = None,
    sources: str = "full",
    neighbor_radius: float = 0.25,
    refresh_levels: int = 2,
    devices=None,
    mesh=None,
    n_events: int = 256,
    max_chunks: int = 100_000,
    initialized: bool = False,
):
    """One-shot block-timestep convenience: stack, initialize, evolve to
    ``t_end`` in chunks of ``n_events``.  Returns ``(batched, carry)``
    (see :func:`ensemble_run_block`).  ``initialized=True`` takes
    ``states`` as a batch that :func:`ensemble_initialize` has already
    bootstrapped and runs no bootstrap evaluation.  ``sources="neighbor"``
    sorts the batch spatially (:func:`spatial_sort_batched`) before the
    bootstrap; the returned batch is in that sorted order.
    ``devices``/``mesh`` lay the batch out as :func:`ensemble_run_block`
    does, the bootstrap included."""
    _check_labels(sources=sources)
    batched = states if isinstance(states, ParticleState) else \
        stack_states(list(states))
    if sources == "neighbor":
        batched = spatial_sort_batched(
            batched, n_active,
            leaf=math.gcd(block_i or nbody_force.DEFAULT_BLOCK_I,
                          block_j or nbody_force.DEFAULT_BLOCK_J))
    kw = dict(n_active=n_active, order=order, eps=eps, dtype=dtype,
              devices=devices, mesh=mesh)
    if not initialized:
        batched = ensemble_initialize(batched, **kw)
    carry = None
    for _ in range(max_chunks):
        batched, carry = ensemble_run_block(
            batched, t_end=t_end, n_events=n_events, dt_max=dt_max,
            n_levels=n_levels, carry=carry, eta=eta, compaction=compaction,
            bucket_mode=bucket_mode, block_i=block_i, block_j=block_j,
            sources=sources, neighbor_radius=neighbor_radius,
            refresh_levels=refresh_levels, **kw)
        done = float(torch.min(batched.time)) >= t_end
        ensemble_run_block.host_syncs += 1
        if done:
            break
    return batched, carry


# --------------------------------------------------------------------------
# single-run block stepper under a multi-device distribution strategy
# --------------------------------------------------------------------------
def _batch1(state: ParticleState) -> ParticleState:
    """One unbatched run as a B = 1 batch (views)."""
    return ParticleState(**{f: getattr(state, f)[None] for f in FIELDS})


def _unbatch1(batched: ParticleState) -> ParticleState:
    return ParticleState(**{f: getattr(batched, f)[0] for f in FIELDS})


class _StrategyBlockEngine:
    """Block-timestep engine whose force evaluation is distributed over a
    device mesh instead of batched: one run, its domain sharded by one of
    the paper's strategies, each shard compacting its own local active
    targets (``core.strategies.make_strategy_block_evaluator``).
    ``slots`` is the in-process mesh's device tuple, or this rank's
    ``ProcessMesh``: every rank then holds the whole run and its levels,
    so every rank reads the same bounds and leaves the loop at the same
    event, with no collective of its own.

    The event logic is the ensemble engine's own (:func:`_event_init`,
    :func:`_event_pre`, :func:`_event_post` on the run as a B = 1 batch),
    so the event schedule, and with it the committed block golden, is the
    same; only the evaluator and the per-shard tile counts differ.

    The capacity buckets are sized on the host: each gather event's
    per-shard bound is ``hermite.block_level_occupancy`` at the tick's
    threshold level over each shard's contiguous row chunk (padding rows
    at level -1), read to the host with the event's live flag in one copy
    of ``p + 1`` counts.  A particle at level ``l`` steps at exactly the
    multiples of its period, so the tick's active set is ``{level >=
    threshold}`` and the bound is the measured count: the same buckets,
    tiles and physics as measuring.  ``compaction="none"`` reads nothing
    per event.
    """

    def __init__(self, *, strategy, slots, chips_per_card, order, eps,
                 eta, dt_max, n_levels, compaction, block_i, block_j, dtype,
                 sources, ring_mode):
        ranks = isinstance(slots, ProcessMesh)
        self.p = slots.size if ranks else len(slots)
        self.order, self.eta, self.dt_max = order, eta, dt_max
        self.n_levels, self.n_sub = n_levels, 2 ** (n_levels - 1)
        self.compaction = compaction
        self.bev = make_strategy_block_evaluator(
            strategy, devices=None if ranks else slots,
            mesh=slots if ranks else None, chips_per_card=chips_per_card,
            eps=eps, order=order, block_i=block_i, block_j=block_j,
            compaction=compaction, dtype=dtype, sources=sources,
            ring_mode=ring_mode)

    def init(self, state: ParticleState, t_end) -> BlockCarry:
        t_last, levels, dt_macro = _event_init(
            _batch1(state), t_end.reshape(1), eta=self.eta,
            dt_max=self.dt_max, n_levels=self.n_levels)
        f64 = dict(dtype=torch.float64, device=state.device)
        return BlockCarry(
            t_last=t_last[0], levels=levels[0], dt_macro=dt_macro[0],
            n_pairs=torch.zeros((), **f64),
            n_events=torch.zeros((), dtype=torch.int32, device=state.device),
            n_tiles=torch.zeros(self.p, **f64),
            # the per-shard buckets live inside the shards; there is no
            # batch-level bucket distribution to report
            bucket_hits=torch.zeros((0,), **f64))

    def _bound(self, levels, t_next, live):
        """The event's per-shard bucket bounds and live flag, read to the
        host in one copy; None when the run is past ``t_end``."""
        n = levels.shape[-1]
        n_pad = -(-n // self.p) * self.p
        thr = hermite.tick_threshold_level(t_next, n_levels=self.n_levels)
        lev = torch.nn.functional.pad(levels, (0, n_pad - n), value=-1)
        occ = torch.stack([
            hermite.block_level_occupancy(lv, n_levels=self.n_levels)
            for lv in lev.reshape(self.p, -1)])
        host = torch.cat([occ[:, thr], live.to(torch.int32)]).tolist()
        ensemble_run_block.host_syncs += 1
        return host[:-1] if host[-1] else None

    def run(self, state: ParticleState, c: BlockCarry, t_end,
            n_events: int):
        s = _batch1(state)
        na = torch.full((1,), state.pos.shape[0], dtype=torch.int32,
                        device=state.device)
        t_end_ = t_end.reshape(1)
        t_last, levels, dt_macro = c.t_last[None], c.levels[None], \
            c.dt_macro[None]
        n_pairs, n_ev, n_tiles = c.n_pairs, c.n_events, c.n_tiles
        for _ in range(n_events):
            live, t_next, active, h, xp, vp, ap = _event_pre(
                s, t_last, levels, dt_macro, na, t_end_, n_sub=self.n_sub)
            bound = None
            if self.compaction == "gather":
                bound = self._bound(levels[0], t_next[0], live)
                if bound is None:
                    break  # the run is past t_end
            # past t_end the outputs are discarded, so the targets go to
            # the kernels inactive and their blocks skip their work
            act = (active & live[:, None])[0]
            ev, tiles = self.bev(xp[0], vp[0], ap[0], s.mass[0], act, bound)
            s, t_last, levels, dt_macro, dp = _event_post(
                s, Evaluation(*(x[None] for x in ev)), live, t_next, active,
                h, t_last, levels, dt_macro, na, t_end_, n_sub=self.n_sub,
                eta=self.eta, dt_max=self.dt_max, n_levels=self.n_levels,
                order=self.order)
            n_pairs = n_pairs + dp[0]
            n_ev = n_ev + live[0].to(torch.int32)
            n_tiles = n_tiles + torch.where(live[0], tiles.to(torch.float64),
                                            0.0)
        return _unbatch1(s), BlockCarry(
            t_last=t_last[0], levels=levels[0], dt_macro=dt_macro[0],
            n_pairs=n_pairs, n_events=n_ev, n_tiles=n_tiles,
            bucket_hits=c.bucket_hits)


@functools.lru_cache(maxsize=64)
def _strategy_block_engine(strategy: str, slots, chips_per_card: int,
                           order: int, eps: float, eta: float, dt_max: float,
                           n_levels: int, compaction: str, block_i: int,
                           block_j: int, dtype: str, sources: str = "full",
                           ring_mode: str = "overlap"
                           ) -> _StrategyBlockEngine:
    """The cached :class:`_StrategyBlockEngine` of one configuration and
    device tuple or rank's ``ProcessMesh`` (a mesh keys by identity: an
    engine is never handed to a mesh of another process group)."""
    _count_engine_build("block_strategy")
    return _StrategyBlockEngine(
        strategy=strategy, slots=slots, chips_per_card=chips_per_card,
        order=order, eps=eps, eta=eta, dt_max=dt_max, n_levels=n_levels,
        compaction=compaction, block_i=block_i, block_j=block_j, dtype=dtype,
        sources=sources, ring_mode=ring_mode)


def strategy_run_block(
    state: ParticleState,
    *,
    t_end: float,
    n_events: int = 64,
    dt_max: float = 0.0625,
    n_levels: int = 8,
    carry: Optional[BlockCarry] = None,
    eta: float = 0.02,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    strategy: str = "replicated",
    chips_per_card: int = 2,
    compaction: str = "none",
    block_i: Optional[int] = None,
    block_j: Optional[int] = None,
    sources: str = "full",
    devices=None,
    ring_mode: str = "overlap",
    mesh=None,
):
    """Advance ONE initialized run by up to ``n_events`` block events, the
    force evaluation distributed by ``strategy`` over ``devices`` (a device
    sequence, an int count or None, resolved by
    ``core.strategies.mesh_devices`` for the state's device), or over
    ``mesh``, this rank's ``ProcessMesh`` (exclusive with ``devices``;
    every rank calls with the whole run and gets it back whole).
    ``sources`` is validated by the strategy evaluator: the sharded
    strategies evaluate full sources only.

    Returns ``(state, carry)`` like :func:`ensemble_run_block`, except that
    the carry's leaves are unbatched and ``carry.n_tiles`` is the ``(P,)``
    vector of kernel grid tiles *each shard* enqueued.  A gather run stops
    early once the run is past ``t_end``.
    """
    if n_levels < 1:
        raise ValueError(f"n_levels={n_levels} must be >= 1")
    if compaction not in COMPACTIONS:
        raise ValueError(
            f"compaction must be one of {COMPACTIONS}; got {compaction!r}")
    engine = _strategy_block_engine(
        strategy, _slots(devices, mesh, state.device), chips_per_card,
        order, eps, eta, dt_max, n_levels, compaction,
        block_i or nbody_force.DEFAULT_BLOCK_I,
        block_j or nbody_force.DEFAULT_BLOCK_J, dtype, sources, ring_mode)
    t_end_ = torch.as_tensor(t_end, dtype=state.dtype, device=state.device)
    if carry is None:
        carry = engine.init(state, t_end_)
    return engine.run(state, carry, t_end_, n_events)


def _slots(devices, mesh, device):
    """A strategy run's shards: this rank's ``ProcessMesh``, or the device
    tuple of ``devices`` (``_mesh_list``)."""
    if mesh is not None:
        if devices is not None:
            raise ValueError("name the devices or a ready mesh, not both")
        return mesh
    return tuple(_mesh_list(devices, device))


def evolve_strategy_block(
    state: ParticleState,
    *,
    t_end: float,
    strategy: str = "replicated",
    dt_max: float = 0.0625,
    n_levels: int = 8,
    eta: float = 0.02,
    order: int = 6,
    eps: float = 1e-7,
    dtype: str = "fp32",
    chips_per_card: int = 2,
    compaction: str = "none",
    block_i: Optional[int] = None,
    block_j: Optional[int] = None,
    devices=None,
    ring_mode: str = "overlap",
    n_events: int = 64,
    max_chunks: int = 100_000,
    mesh=None,
):
    """One-shot strategy-distributed block run: initialize with the same
    strategy's lockstep evaluator (at the same tile shape), evolve to
    ``t_end``.  Returns ``(state, carry)`` (see
    :func:`strategy_run_block`; ``mesh`` is this rank's ``ProcessMesh``)."""
    slots = _slots(devices, mesh, state.device)
    ranks = isinstance(slots, ProcessMesh)
    ev = make_strategy_evaluator(
        strategy, devices=None if ranks else list(slots),
        mesh=slots if ranks else None, chips_per_card=chips_per_card, eps=eps,
        order=order, block_i=block_i or nbody_force.DEFAULT_BLOCK_I,
        block_j=block_j or nbody_force.DEFAULT_BLOCK_J, dtype=dtype,
        ring_mode=ring_mode)
    state = hermite.initialize(state, ev)
    carry = None
    for _ in range(max_chunks):
        state, carry = strategy_run_block(
            state, t_end=t_end, n_events=n_events, dt_max=dt_max,
            n_levels=n_levels, carry=carry, eta=eta, order=order, eps=eps,
            dtype=dtype, strategy=strategy, chips_per_card=chips_per_card,
            compaction=compaction, block_i=block_i, block_j=block_j,
            devices=None if ranks else slots, mesh=slots if ranks else None,
            ring_mode=ring_mode)
        done = float(state.time) >= t_end
        ensemble_run_block.host_syncs += 1
        if done:
            break
    return state, carry
