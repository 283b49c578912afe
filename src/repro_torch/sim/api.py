"""Public simulation API: composable build -> step -> collect runners.

Port of ``repro/sim/api.py``: the same :class:`SimConfig`, validation,
runner registry and telemetry, so a configuration the reference takes runs
here and answers with a :class:`~repro_torch.sim.telemetry.RunReport` of the
reference's schema.  Each registered :class:`Runner` splits its run into
three composable calls:

* ``build(cfg) -> RunHandle`` — construct initial conditions, evaluator and
  telemetry recorder, bootstrap derivatives, record the t=0 snapshot;
* ``step(handle) -> bool`` — advance one diagnostics chunk (the engine's
  macro-step boundary); returns True once the run has finished;
* ``collect(handle) -> RunReport`` — final diagnostics and the versioned
  telemetry report.

:func:`run` recomposes the three into the one-shot entry the CLI
(``repro_torch.launch.sim_run``) calls.  Dispatch is data-driven:
:data:`RUNNERS` maps a kind name to its runner, and :func:`resolve_kind`
picks the first registered runner whose ``matches`` accepts the config
(registration order is the priority order, as in the reference).

**Device.** ``SimConfig.device`` (default ``cuda``, which raises without a
card) is where the run's tensors live; it picks the hand-written kernels
or, on ``cpu``, their plain versions.  It stays out of :meth:`SimConfig.meta`,
so the two packages' reports carry the same keys.  ``impl``/``kernel`` keep
the reference's names and conflicts (``ensemble.resolve_eval_impl``);
``ensemble.check_impl`` refuses a plain-version label on the card.

**Devices.** ``SimConfig.devices`` is the shard count of a run under a
distribution strategy (``core.strategies``): on the CPU ``[cpu] *
devices`` slots, as the reference's launcher fakes host devices, on
``cuda`` the first ``devices`` cards, and ``ValueError`` naming the visible
count when fewer are there (no fallback).  A single run under a strategy
(``SingleRunner``) and a block run under one (``BlockStrategyRunner``)
shard the run's domain; a strategy label on a batched run only tags the
report, as in the reference.  A batched run over ``devices`` > 1 shards
its members over the slots (``sim.ensemble``'s batch layout), and
``SimConfig.mesh=(B, P)`` puts a block run on the fused ``(batch, dev)``
grid of ``B * P`` slots.

**A ready mesh.**  :func:`run` and every ``Runner.build`` take ``mesh``: an
in-process ``DeviceMesh`` (its slots in place of the first ``devices``
cards, e.g. four slots of one card) or this rank's ``ProcessMesh`` (one
process per shard over ``torch.distributed``: every rank calls ``run``
with the same config and gets the same report, whose ``devices`` is the
world size).  It is not a :class:`SimConfig` field, so the report's keys
stay the reference's; its size must equal ``SimConfig.devices``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import hermite, nbody
from repro_torch.core.evaluate import make_evaluator
from repro_torch.core.strategies import (STRATEGIES, make_strategy_evaluator,
                                         mesh_devices)
from repro_torch.distributed.process_mesh import ProcessMesh
from repro_torch.kernels import nbody_force, ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios, telemetry
from repro_torch.sim.telemetry import RunReport

MAX_STEPS = 200_000


@dataclasses.dataclass(frozen=True)
class SimConfig:
    scenario: str = "plummer"
    n: int = 256
    seed: int = 0
    ensemble: int = 1
    t_end: float = 1.0
    dt: Optional[float] = None       # fixed step (stepper="fixed")
    stepper: Optional[str] = None    # "fixed" | "adaptive" | "block"
    #   (None infers: "fixed" when dt is given, else "adaptive")
    dt_max: float = 0.0625           # coarsest step (adaptive + block)
    n_levels: Optional[int] = 8      # block hierarchy depth (None => auto:
    #   per-member from the initial Aarseth dt distribution, clamped [1, 8])
    compaction: str = "none"         # "none" | "gather" (block stepper only)
    bucket_mode: str = "member"      # "member" (per-member capacity bucket
    #   groups) | "shared" (batch-shared bucket baseline); gather mode only
    block_i: Optional[int] = None    # kernel tile shape override (block
    block_j: Optional[int] = None    #   stepper; None => kernel defaults)
    sources: str = "full"            # "full" | "neighbor" (Ahmad-Cohen
    #   near/far split; block stepper)
    mesh: Optional[Tuple[int, int]] = None  # fused (batch, domain) device
    #   grid (block stepper; product must equal devices — --mesh BxP)
    neighbor_radius: float = 0.25    # AC window radius (simulation length)
    refresh_levels: int = 2          # far-field refresh: levels below macro
    eta: float = 0.02
    order: int = 6
    strategy: str = "single"
    devices: int = 1
    impl: Optional[str] = None
    kernel: Optional[str] = None     # "ref" | "pallas" (excludes impl)
    dtype: str = "fp32"              # "fp64" | "fp32" | "mixed" precision axis
    mix: Optional[Tuple[Tuple[str, int], ...]] = None  # heterogeneous batch
    pad: Optional[int] = None        # padded N_max (None => auto = max N)
    eps: float = 1e-7
    diag_every: int = 16             # steps between diagnostics snapshots
    scenario_params: Mapping[str, Any] = \
        dataclasses.field(default_factory=dict)
    validate_ic: bool = True
    out: Optional[str] = None        # JSON report path (None => don't write)
    trace: Optional[str] = None      # Chrome-trace/Perfetto JSON path
    #   (None => zero-overhead NullTracer; see repro_torch.obs.trace)
    metrics_interval: int = 0        # chunks between in-run metrics-registry
    #   snapshots attached to the diagnostics series (0 => final only)
    device: str = "cuda"             # where the run's tensors live; not in
    #   meta(), so the two packages' reports carry the same keys

    def resolved_stepper(self) -> str:
        """Resolve (stepper, dt) to one of ``ensemble.STEPPERS``.

        An explicit ``stepper`` must be consistent with ``dt``: fixed mode
        needs a step, the adaptive/block modes choose their own (``dt_max``
        caps them) — a silently ignored ``dt`` would misreport the run.
        """
        stepper = self.stepper or ("fixed" if self.dt is not None
                                   else "adaptive")
        if stepper not in ens.STEPPERS:
            raise ValueError(
                f"unknown stepper {stepper!r}; one of {ens.STEPPERS}")
        if stepper == "fixed" and self.dt is None:
            raise ValueError("stepper='fixed' needs an explicit dt")
        if stepper != "fixed" and self.dt is not None:
            raise ValueError(
                f"stepper={stepper!r} chooses its own timestep; dt={self.dt} "
                "would be ignored (use dt_max to cap it)")
        if self.compaction != "none" and stepper != "block":
            raise ValueError(
                f"compaction={self.compaction!r} only applies to the block "
                "stepper (the lockstep modes evaluate every target)")
        if self.bucket_mode not in ens.BUCKET_MODES:
            raise ValueError(
                f"bucket_mode must be one of {ens.BUCKET_MODES}; "
                f"got {self.bucket_mode!r}")
        if self.bucket_mode != "member" and self.compaction != "gather":
            raise ValueError(
                f"bucket_mode={self.bucket_mode!r} selects the capacity-"
                "bucket dispatch of compaction='gather'; without gather "
                "there are no buckets to share")
        if (self.block_i or self.block_j) and stepper != "block":
            raise ValueError(
                "block_i/block_j tile overrides only reach the block "
                f"stepper's kernels; stepper={stepper!r} would silently "
                "run at the kernel defaults")
        if self.sources not in ens.SOURCES:
            raise ValueError(
                f"sources must be one of {ens.SOURCES}; "
                f"got {self.sources!r}")
        if self.sources == "neighbor":
            if stepper != "block":
                raise ValueError(
                    "sources='neighbor' is the Ahmad-Cohen split of the "
                    f"block stepper's event loop; stepper={stepper!r} has "
                    "no regular/irregular levels to split")
            if self.compaction != "none":
                raise ValueError(
                    "sources='neighbor' gathers its own per-block source "
                    "windows; it composes with compaction='none' only")
            if self.strategy != "single":
                raise ValueError(
                    "sources='neighbor' runs on the vmapped batch engine "
                    f"only; strategy={self.strategy!r} shards full sources "
                    "(see docs/ensembles.md)")
            if self.mix is not None:
                raise ValueError(
                    "sources='neighbor' shares one window-capacity bucket "
                    "across the batch; a mixed-N ensemble would let its "
                    "widest member size every member's gather")
        if self.refresh_levels < 0:
            raise ValueError(
                f"refresh_levels={self.refresh_levels} must be >= 0")
        if self.mesh is not None:
            if stepper != "block":
                raise ValueError(
                    "mesh=(B, P) fuses batch and domain sharding of the "
                    f"block engine; stepper={stepper!r} has no domain-"
                    "sharded force pass to fuse")
            if len(self.mesh) != 2 or any(int(e) < 1 for e in self.mesh):
                raise ValueError(
                    f"mesh={self.mesh!r} must be two positive extents "
                    "(B_shards, P_shards)")
            if self.mesh[0] * self.mesh[1] != self.devices:
                raise ValueError(
                    f"mesh={tuple(self.mesh)} covers "
                    f"{self.mesh[0] * self.mesh[1]} devices; --devices says "
                    f"{self.devices} (the fused grid must tile the device "
                    "list exactly)")
            if self.strategy != "single":
                raise ValueError(
                    "mesh=(B, P) supplies the domain sharding itself; "
                    f"strategy={self.strategy!r} would shard the same axis "
                    "twice")
            if self.bucket_mode != "member":
                raise ValueError(
                    "the fused mesh engine sizes one capacity bucket per "
                    f"(batch, domain) shard; bucket_mode="
                    f"{self.bucket_mode!r} selects the vmapped engine's "
                    "dispatch and would be silently ignored")
        if self.n_levels is None and stepper != "block":
            raise ValueError(
                "n_levels=None (--levels auto) sizes the block hierarchy; "
                f"stepper={stepper!r} has no levels to size")
        return stepper

    def meta(self) -> Dict[str, Any]:
        meta = {
            "scenario": self.scenario, "n": self.n, "seed": self.seed,
            "ensemble": self.ensemble, "strategy": self.strategy,
            "t_end": self.t_end, "dt": self.dt, "order": self.order,
            "stepper": self.resolved_stepper(),
            "dtype": self.dtype,
            "params": dict(self.scenario_params),
        }
        if meta["stepper"] == "block":
            meta["dt_max"] = self.dt_max
            meta["n_levels"] = self.n_levels    # None until auto-resolved
            meta["compaction"] = self.compaction
            if self.compaction == "gather":
                meta["bucket_mode"] = self.bucket_mode
            meta["sources"] = self.sources
            if self.mesh is not None:
                meta["mesh"] = list(self.mesh)
            if self.sources == "neighbor":
                meta["neighbor_radius"] = self.neighbor_radius
                meta["refresh_levels"] = self.refresh_levels
        if meta["stepper"] == "adaptive":
            meta["dt_max"] = self.dt_max
        if self.mix is not None:
            meta["scenario"] = "mixed"
            meta["mix"] = [list(m) for m in self.mix]
            meta["pad"] = self.pad
            # the dataclass default n is meaningless for a mix; report the
            # requested N_max so meta agrees with the batch's n_bodies
            meta["n"] = self.pad if self.pad is not None \
                else max(n for _, n in self.mix)
        if self.kernel is not None:
            meta["kernel"] = self.kernel
        return meta


def validate_config(cfg: SimConfig) -> str:
    """Cross-field validation shared by :func:`run` and every ``build``.

    Returns the resolved stepper (the last check, so the error precedence
    matches the reference exactly).
    """
    if cfg.ensemble < 1:
        raise ValueError(f"ensemble={cfg.ensemble} must be >= 1")
    if cfg.metrics_interval < 0:
        raise ValueError(
            f"metrics_interval={cfg.metrics_interval} must be >= 0")
    if cfg.dtype not in ops.DTYPES:
        raise ValueError(
            f"dtype must be one of {ops.DTYPES}; got {cfg.dtype!r}")
    if cfg.dtype == "fp64" and (cfg.kernel is not None
                                or cfg.impl not in (None, "fp64")):
        raise ValueError(
            "dtype='fp64' runs the pure-jnp oracle (no kernel); an explicit "
            f"kernel={cfg.kernel!r}/impl={cfg.impl!r} would be silently "
            "ignored")
    if cfg.impl == "fp64" and cfg.dtype == "mixed":
        raise ValueError(
            "impl='fp64' (golden reference) conflicts with dtype='mixed' "
            "(reduced-precision kernel mode)")
    return cfg.resolved_stepper()


def _device_list(cfg: SimConfig) -> list:
    """The run's devices, one per shard (``strategies.mesh_devices``):
    ``[cpu] * devices`` on the CPU, the first ``devices`` cards on
    ``cuda``, ``ValueError`` naming the visible count when fewer are
    there."""
    return mesh_devices(cfg.devices, cfg.device)


def _slots(cfg: SimConfig, mesh) -> Any:
    """The run's shards: ``mesh``'s (a ``DeviceMesh``'s device list, or
    this rank's ``ProcessMesh`` as it is), else :func:`_device_list`."""
    if mesh is None:
        return _device_list(cfg)
    if mesh.size != cfg.devices:
        raise ValueError(f"the mesh has {mesh.size} shards; devices="
                         f"{cfg.devices} (they must agree)")
    return mesh if isinstance(mesh, ProcessMesh) else list(mesh.devices)


def _sharded(slots) -> bool:
    return (slots.size if isinstance(slots, ProcessMesh) else len(slots)) > 1


def _over(slots) -> Dict[str, Any]:
    """The strategy entry points' keyword for ``slots``: ``mesh`` for a
    rank's ``ProcessMesh``, ``devices`` for a device list."""
    return {"mesh": slots} if isinstance(slots, ProcessMesh) \
        else {"devices": slots}


def _eval_dtype(cfg: SimConfig, impl: Optional[str]) -> str:
    """The engines' precision: ``impl="fp64"`` is the oracle, a precision
    rather than a kernel, as in the reference."""
    return "fp64" if impl == "fp64" else cfg.dtype


def _sync(x: torch.Tensor) -> None:
    """Wait for the card (the reference's ``block_until_ready``)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _build_states(cfg: SimConfig):
    return [
        scenarios.make(cfg.scenario, cfg.n, seed=cfg.seed + i,
                       validate=cfg.validate_ic, device=cfg.device,
                       **dict(cfg.scenario_params))
        for i in range(cfg.ensemble)
    ]


def _chunk_spans(tracer, t0_us: float, dur_us: float, *, chunk: int,
                 events: int, tiles: Optional[float] = None,
                 max_children: int = 256) -> None:
    """One measured ``macro-step`` span per engine chunk, synthetically
    subdivided into ``event`` -> ``kernel-launch`` children.

    The events of a chunk run inside the engine's loop, untimed one by one
    from here, so the chunk aggregate (wall, event count, launched tiles)
    is *measured* and only the even subdivision is synthetic, flagged
    ``{"synthetic": true}`` on every reconstructed child.
    """
    if not tracer.enabled:
        return
    args = {"chunk": chunk, "events": int(events)}
    if tiles is not None:
        args["tiles"] = float(tiles)
    tracer.add_span("macro-step", t0_us, dur_us, args=args)
    n = min(int(events), max_children)
    if n <= 0:
        return
    child = dur_us / n
    per = {"synthetic": True, "events": int(events) // n}
    if tiles is not None:
        per["tiles"] = float(tiles) / n
    for i in range(n):
        s = t0_us + i * child
        tracer.add_span("event", s, child * 0.999, args=per)
        if tiles is not None:
            tracer.add_span("kernel-launch", s + 0.1 * child, 0.8 * child,
                            args=per)


def _mix_params(cfg: SimConfig) -> Dict[str, Dict[str, Any]]:
    """Distribute flat CLI params over the mix: each scenario takes the keys
    its registry spec accepts; a key no scenario accepts raises (same
    contract as the homogeneous path, where build() rejects it)."""
    flat = dict(cfg.scenario_params)
    out: Dict[str, Dict[str, Any]] = {}
    claimed = set()
    for name, _ in cfg.mix:
        spec = scenarios.get_spec(name)
        kw = {k: v for k, v in flat.items() if k in spec.defaults}
        claimed.update(kw)
        if kw:
            out[name] = kw
    orphans = set(flat) - claimed
    if orphans:
        raise scenarios.ScenarioError(
            f"parameter(s) {sorted(orphans)} not accepted by any scenario "
            f"in the mix {[name for name, _ in cfg.mix]}")
    return out


def _auto_levels(cfg: SimConfig, batched) -> list:
    """Per-member block hierarchy depth from the initial (post-initialize)
    Aarseth dt distribution, clamped to [1, 8] (``--levels auto``)."""
    dt_i = hermite.aarseth_dt_particles(batched, eta=cfg.eta,
                                        dt_max=cfg.dt_max)
    depth = torch.stack([hermite.auto_n_levels(d, dt_max=cfg.dt_max)
                         for d in dt_i])
    return [int(d) for d in depth.tolist()]


# --------------------------------------------------------------------------
# runner surface
# --------------------------------------------------------------------------
class RunHandle:
    """Mutable in-flight state of one run between :meth:`Runner.step` calls.

    Owned by the runner that built it; runners attach whatever stepper state
    they carry between chunks (engine carries, counters, the recorder) as
    plain attributes.  ``finished`` flips once the run needs no more steps.
    """

    def __init__(self, cfg: SimConfig, kind: str):
        self.cfg = cfg
        self.kind = kind
        self.recorder: Optional[telemetry.TelemetryRecorder] = None
        self.finished = False


class Runner:
    """One run mode: the build/step/collect triple behind a registry kind."""

    kind: str = ""

    def matches(self, cfg: SimConfig) -> bool:
        raise NotImplementedError

    def build(self, cfg: SimConfig, mesh=None) -> RunHandle:
        """``mesh``: a ready mesh for the run's shards (module
        docstring)."""
        raise NotImplementedError

    def step(self, handle: RunHandle) -> bool:
        raise NotImplementedError

    def collect(self, handle: RunHandle) -> RunReport:
        raise NotImplementedError


RUNNERS: Dict[str, Runner] = {}


def register_runner(runner: Runner) -> Runner:
    """Register a runner under its ``kind``; registration order is the
    dispatch priority order of :func:`resolve_kind`."""
    if not runner.kind:
        raise ValueError("runner needs a non-empty kind")
    RUNNERS[runner.kind] = runner
    return runner


def resolve_kind(cfg: SimConfig) -> str:
    """Pick the registered kind for a config (first ``matches`` wins)."""
    validate_config(cfg)
    for kind, runner in RUNNERS.items():
        if runner.matches(cfg):
            return kind
    raise ValueError(f"no registered runner accepts {cfg!r}")


def get_runner(kind: str) -> Runner:
    try:
        return RUNNERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown runner kind {kind!r}; "
            f"registered: {tuple(RUNNERS)}") from None


# --------------------------------------------------------------------------
# single run (per-step telemetry, adaptive or fixed dt)
# --------------------------------------------------------------------------
class SingleRunner(Runner):
    """One run stepped by the host as ``hermite.evolve`` steps it: the same
    loop, with the reference's per-step host syncs and telemetry, its
    force evaluation single-device or sharded by ``cfg.strategy``."""

    kind = "single"

    def matches(self, cfg: SimConfig) -> bool:
        return cfg.mix is None and cfg.ensemble == 1 \
            and cfg.resolved_stepper() != "block"

    def build(self, cfg: SimConfig, mesh=None) -> RunHandle:
        validate_config(cfg)
        h = RunHandle(cfg, self.kind)
        impl = ens.resolve_eval_impl(cfg.impl, cfg.kernel, default=None)
        if cfg.strategy in STRATEGIES:
            if impl == "fp64" or cfg.dtype == "fp64":
                raise ValueError(
                    "fp64 (golden reference) only runs under "
                    "strategy='single'")
        elif cfg.strategy != "single":
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        elif mesh is not None:
            raise ValueError("strategy='single' on one run shards nothing; "
                             "a mesh needs a strategy or a batch")
        devices = _slots(cfg, mesh)
        dev = nbody.resolve_device(cfg.device)
        ens.check_impl(impl, dev)
        state = _build_states(cfg)[0]
        if cfg.strategy == "single":
            evaluator = make_evaluator(order=cfg.order, eps=cfg.eps,
                                       dtype=_eval_dtype(cfg, impl))
        else:
            evaluator = make_strategy_evaluator(
                cfg.strategy, order=cfg.order, eps=cfg.eps, dtype=cfg.dtype,
                **_over(devices))

        h.recorder = telemetry.TelemetryRecorder(cfg.meta())
        state = hermite.initialize(state, evaluator)
        _sync(state.pos)
        h.e0 = float(nbody.total_energy(state))
        h.recorder.record_snapshot(0, 0.0, energy=h.e0, de_rel=0.0)
        h.state, h.evaluator = state, evaluator
        h.steps, h.h_prev = 0, None
        return h

    def step(self, h: RunHandle) -> bool:
        if h.finished:
            return True
        cfg, state = h.cfg, h.state
        if not (float(state.time) < cfg.t_end and h.steps < MAX_STEPS):
            h.finished = True
            return True
        if cfg.dt is not None:
            dt = cfg.dt
        else:
            dt = float(hermite.aarseth_dt(state, eta=cfg.eta,
                                          dt_max=cfg.dt_max))
            if h.h_prev is not None:  # rate-limit dt changes (robustness)
                dt = min(max(dt, 0.5 * h.h_prev), 2.0 * h.h_prev)
            h.h_prev = dt
        dt = min(dt, cfg.t_end - float(state.time))
        t0 = time.perf_counter()
        with obs_trace.get_tracer().span("macro-step", step=h.steps + 1,
                                         dt=dt):
            state = hermite.step(state, dt, h.evaluator, order=cfg.order)
            _sync(state.pos)
        h.state = state
        h.steps += 1
        obs_metrics.registry().counter(
            "sim.events", unit="events",
            help="productive member-events (lockstep: member-steps)").inc()
        h.recorder.record_step(h.steps, float(state.time),
                               time.perf_counter() - t0)
        if h.steps % cfg.diag_every == 0:
            e = float(nbody.total_energy(state))
            h.recorder.record_snapshot(h.steps, float(state.time), energy=e,
                                       de_rel=abs((e - h.e0) / h.e0))
        return False

    def collect(self, h: RunHandle) -> RunReport:
        cfg = h.cfg
        e1 = float(nbody.total_energy(h.state))
        return h.recorder.finalize(
            n_bodies=cfg.n, ensemble=1,
            n_devices=cfg.devices if cfg.strategy != "single" else 1,
            per_run_pairs=[float(h.steps) * cfg.n * cfg.n],
            metrics=obs_metrics.registry().snapshot(),
            extra={"e0": h.e0, "e1": e1,
                   "de_rel": abs((e1 - h.e0) / h.e0),
                   "t_final": float(h.state.time)})


# --------------------------------------------------------------------------
# single block run under a distribution strategy (shard-local compaction)
# --------------------------------------------------------------------------
class BlockStrategyRunner(Runner):
    """One run, its force evaluation sharded by ``cfg.strategy``: each shard
    compacts its own local active targets (``compaction="gather"``) and the
    report carries the per-shard launched tiles as ``grid_tiles_per_shard``.
    """

    kind = "block_strategy"

    def matches(self, cfg: SimConfig) -> bool:
        # a single block run under a distribution strategy shards the
        # *domain*; batched block runs shard the batch axis instead, where
        # the strategy label only tags the report
        return cfg.mix is None and cfg.resolved_stepper() == "block" \
            and cfg.ensemble == 1 and cfg.strategy != "single"

    def build(self, cfg: SimConfig, mesh=None) -> RunHandle:
        validate_config(cfg)
        if cfg.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        h = RunHandle(cfg, self.kind)
        impl = ens.resolve_eval_impl(cfg.impl, cfg.kernel)
        if impl == "fp64" or cfg.dtype == "fp64":
            raise ValueError(
                "fp64 (golden reference) only runs under strategy='single'")
        devices = _slots(cfg, mesh)
        ens.check_impl(impl, nbody.resolve_device(cfg.device))
        state = _build_states(cfg)[0]
        # same tile shape for the bootstrap pass as for the event loop, so a
        # CLI run is bit for bit ens.evolve_strategy_block's
        evaluator = make_strategy_evaluator(
            cfg.strategy, order=cfg.order, eps=cfg.eps, dtype=cfg.dtype,
            block_i=cfg.block_i or nbody_force.DEFAULT_BLOCK_I,
            block_j=cfg.block_j or nbody_force.DEFAULT_BLOCK_J,
            **_over(devices))

        h.recorder = telemetry.TelemetryRecorder(cfg.meta())
        state = hermite.initialize(state, evaluator)
        _sync(state.pos)
        h.e0 = float(nbody.total_energy(state))
        h.recorder.record_snapshot(0, 0.0, energy=h.e0, de_rel=0.0)

        n_levels = cfg.n_levels
        if n_levels is None:  # --levels auto, from the initial dt spread
            dt_i = hermite.aarseth_dt_particles(state, eta=cfg.eta,
                                                dt_max=cfg.dt_max)
            n_levels = int(hermite.auto_n_levels(dt_i, dt_max=cfg.dt_max))
            h.recorder.meta["n_levels"] = n_levels
            h.recorder.meta["n_levels_auto"] = [n_levels]
        h.state, h.devices, h.n_levels = state, devices, n_levels
        h.carry = None
        h.done = 0
        h.ev_prev = h.tiles_prev = 0.0
        return h

    def step(self, h: RunHandle) -> bool:
        if h.finished:
            return True
        cfg = h.cfg
        if not h.done * cfg.diag_every < MAX_STEPS:
            h.finished = True
            return True
        tracer = obs_trace.get_tracer()
        reg = obs_metrics.registry()
        t0 = time.perf_counter()
        t0_us = tracer.now_us()
        h.state, h.carry = ens.strategy_run_block(
            h.state, t_end=cfg.t_end, n_events=cfg.diag_every,
            dt_max=cfg.dt_max, n_levels=h.n_levels, carry=h.carry,
            eta=cfg.eta, order=cfg.order, eps=cfg.eps,
            strategy=cfg.strategy, compaction=cfg.compaction,
            block_i=cfg.block_i, block_j=cfg.block_j, dtype=cfg.dtype,
            **_over(h.devices))
        _sync(h.state.pos)
        h.done += 1
        ev_now = float(h.carry.n_events)
        per_shard_now = h.carry.n_tiles.tolist()
        tiles_now = float(sum(per_shard_now))
        _chunk_spans(tracer, t0_us, tracer.now_us() - t0_us, chunk=h.done,
                     events=int(ev_now - h.ev_prev),
                     tiles=tiles_now - h.tiles_prev)
        reg.counter("sim.events", unit="events").inc(ev_now - h.ev_prev)
        reg.counter("sim.tiles_launched", unit="tiles").inc(
            tiles_now - h.tiles_prev)
        mean = tiles_now / len(per_shard_now)
        if mean > 0:
            reg.gauge(
                "sim.shard_imbalance", unit="ratio",
                help="max/mean per-shard launched tiles").set(
                max(per_shard_now) / mean)
        h.ev_prev, h.tiles_prev = ev_now, tiles_now
        e = float(nbody.total_energy(h.state))
        h.recorder.record_step(int(h.carry.n_events), float(h.state.time),
                               time.perf_counter() - t0)
        h.recorder.record_snapshot(
            int(h.carry.n_events), float(h.state.time), energy=e,
            de_rel=abs((e - h.e0) / h.e0),
            **({"metrics": reg.snapshot()}
               if cfg.metrics_interval
               and h.done % cfg.metrics_interval == 0 else {}))
        if float(h.state.time) >= cfg.t_end:
            h.finished = True
        return h.finished

    def collect(self, h: RunHandle) -> RunReport:
        cfg = h.cfg
        e1 = float(nbody.total_energy(h.state))
        per_shard = [float(t) for t in h.carry.n_tiles.tolist()]
        return h.recorder.finalize(
            n_bodies=cfg.n, ensemble=1, n_devices=cfg.devices,
            per_run_steps=[int(h.carry.n_events)],
            per_run_pairs=[float(h.carry.n_pairs)],
            per_run_tiles=[sum(per_shard)], per_shard_tiles=per_shard,
            metrics=obs_metrics.registry().snapshot(),
            extra={"e0": h.e0, "e1": e1,
                   "de_rel": abs((e1 - h.e0) / h.e0),
                   "t_final": float(h.state.time)})


# --------------------------------------------------------------------------
# batched ensembles (lockstep; fixed dt or per-run shared-adaptive dt)
# --------------------------------------------------------------------------
class EnsembleRunner(Runner):
    """Homogeneous ensemble: B copies of one scenario, seeds seed..seed+B-1,
    advanced by the shared lockstep loop (mask-aware engine calls, per-run
    diagnostics and n_active-honest telemetry)."""

    kind = "ensemble"

    def matches(self, cfg: SimConfig) -> bool:
        # the block engine lives in the batched ensemble path; a single
        # block run is just a B=1 batch
        return cfg.mix is None and (cfg.ensemble > 1
                                    or cfg.resolved_stepper() == "block")

    def _batch(self, cfg: SimConfig):
        batched = ens.stack_states(_build_states(cfg))
        n_active = [cfg.n] * cfg.ensemble
        runs_meta = [{"run": i, "scenario": cfg.scenario, "n": cfg.n,
                      "seed": cfg.seed + i} for i in range(cfg.ensemble)]
        return batched, n_active, runs_meta

    def build(self, cfg: SimConfig, mesh=None) -> RunHandle:
        validate_config(cfg)
        if cfg.strategy not in ens.STRATEGY_LABELS:
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        devices = _slots(cfg, mesh)
        dev = nbody.resolve_device(cfg.device)
        impl = ens.check_impl(ens.resolve_eval_impl(cfg.impl, cfg.kernel),
                              dev)
        h = RunHandle(cfg, self.kind)
        batched, n_active, runs_meta = self._batch(cfg)
        if cfg.resolved_stepper() == "block" and cfg.sources == "neighbor":
            # sort once at build (row order is carry-aligned for the whole
            # run) so contiguous index blocks are compact spatial cells and
            # the gathered neighbor windows stay tight
            batched = ens.spatial_sort_batched(
                batched, n_active,
                leaf=math.gcd(cfg.block_i or nbody_force.DEFAULT_BLOCK_I,
                              cfg.block_j or nbody_force.DEFAULT_BLOCK_J))
        h.b = ens.batch_size(batched)
        h.n_max = batched.pos.shape[1]
        h.n_active, h.runs_meta = n_active, runs_meta

        h.recorder = telemetry.TelemetryRecorder(cfg.meta())
        reg = obs_metrics.registry()
        reg.gauge("sim.pad_waste", unit="fraction",
                  help="zero-mass padded slot fraction of the batch").set(
            1.0 - float(sum(n_active)) / (h.b * h.n_max))
        na = torch.as_tensor(n_active, dtype=torch.int32, device=dev)
        h.kw = dict(n_active=na, order=cfg.order, eps=cfg.eps,
                    dtype=_eval_dtype(cfg, impl),
                    devices=devices if _sharded(devices) else None)
        if cfg.mesh is not None:
            # validated block-only, so the lockstep entry points (which
            # take no mesh) never see the key
            h.kw["mesh"] = tuple(int(e) for e in cfg.mesh)
            h.kw["devices"] = devices
        batched = ens.ensemble_initialize(batched, **h.kw)
        _sync(batched.pos)
        h.batched = batched
        h.e0 = ens.batched_total_energy(batched).tolist()
        h.recorder.record_snapshot(0, 0.0, energy=h.e0, de_rel=0.0)
        h.chunks_done = 0

        h.stepper = cfg.resolved_stepper()
        h.per_run_steps = h.per_run_tiles = None
        if h.stepper == "fixed":
            h.n_steps = max(1, int(round(cfg.t_end / cfg.dt)))
            h.done = 0
        elif h.stepper == "adaptive":
            # per-run shared-adaptive dt: each member steps at its own
            # Aarseth criterion; finished members freeze until the whole
            # batch is done
            h.h_prev = h.n_taken = None
            h.done = 0
            h.ev_prev = 0.0
        else:
            # hierarchical block timesteps: each member's active block is
            # evaluated per event; the engine *measures* its pairwise work
            # and the kernel grid tiles it launched (what compaction shrinks)
            n_levels = cfg.n_levels
            if n_levels is None:  # auto: size each member's hierarchy from
                # its initial Aarseth dt distribution, run at the deepest
                per_member = _auto_levels(cfg, batched)
                n_levels = max(per_member)
                h.recorder.meta["n_levels"] = n_levels
                h.recorder.meta["n_levels_auto"] = per_member
            h.n_levels = n_levels
            h.plan = ops.CapacityPlan(
                h.n_max, h.n_max, cfg.block_i or nbody_force.DEFAULT_BLOCK_I,
                cfg.block_j or nbody_force.DEFAULT_BLOCK_J, dtype=cfg.dtype)
            h.mask = (torch.arange(h.n_max, device=dev)[None, :]
                      < na[:, None])
            h.carry = None
            h.done = 0
            h.ev_prev = [0.0] * h.b
            h.tiles_prev = [0.0] * h.b
            h.pairs_prev = [0.0] * h.b
            h.bound_total = 0.0
            h.nref_prev = h.nov_prev = 0.0
        return h

    def _snapshot(self, h: RunHandle, done, t_sim, wall) -> None:
        # one wall sample per chunk: lockstep ensembles sync at chunk ends
        cfg = h.cfg
        h.chunks_done += 1
        h.recorder.record_step(done, t_sim, wall)
        e = ens.batched_total_energy(h.batched).tolist()
        h.recorder.record_snapshot(
            done, t_sim, energy=e,
            de_rel=max(abs((x - x0) / x0) for x, x0 in zip(e, h.e0)),
            **({"metrics": obs_metrics.registry().snapshot()}
               if cfg.metrics_interval
               and h.chunks_done % cfg.metrics_interval == 0 else {}))

    def step(self, h: RunHandle) -> bool:
        if h.finished:
            return True
        step_fn = {"fixed": self._step_fixed, "adaptive": self._step_adaptive,
                   "block": self._step_block}[h.stepper]
        return step_fn(h)

    def _step_fixed(self, h: RunHandle) -> bool:
        cfg = h.cfg
        tracer = obs_trace.get_tracer()
        chunk = min(cfg.diag_every, h.n_steps - h.done)
        t0 = time.perf_counter()
        t0_us = tracer.now_us()
        h.batched = ens.ensemble_run(h.batched, n_steps=chunk, dt=cfg.dt,
                                     **h.kw)
        _sync(h.batched.pos)
        h.done += chunk
        _chunk_spans(tracer, t0_us, tracer.now_us() - t0_us,
                     chunk=h.chunks_done + 1, events=chunk * h.b)
        obs_metrics.registry().counter(
            "sim.events", unit="events").inc(chunk * h.b)
        self._snapshot(h, h.done, h.done * cfg.dt, time.perf_counter() - t0)
        h.finished = h.done >= h.n_steps
        return h.finished

    def _step_adaptive(self, h: RunHandle) -> bool:
        cfg = h.cfg
        tracer = obs_trace.get_tracer()
        t0 = time.perf_counter()
        t0_us = tracer.now_us()
        h.batched, h.h_prev, h.n_taken = ens.ensemble_run_adaptive(
            h.batched, t_end=cfg.t_end, n_steps=cfg.diag_every,
            h_prev=h.h_prev, n_taken=h.n_taken, eta=cfg.eta,
            dt_max=cfg.dt_max, **h.kw)
        _sync(h.batched.pos)
        h.done += 1
        taken = h.n_taken.tolist()
        ev_now = float(sum(taken))
        _chunk_spans(tracer, t0_us, tracer.now_us() - t0_us,
                     chunk=h.done, events=int(ev_now - h.ev_prev))
        obs_metrics.registry().counter(
            "sim.events", unit="events").inc(ev_now - h.ev_prev)
        h.ev_prev = ev_now
        t_min = float(torch.min(h.batched.time))
        self._snapshot(h, max(taken), t_min, time.perf_counter() - t0)
        h.finished = (t_min >= cfg.t_end
                      or h.done * cfg.diag_every >= MAX_STEPS)
        return h.finished

    def _step_block(self, h: RunHandle) -> bool:
        cfg = h.cfg
        tracer = obs_trace.get_tracer()
        reg = obs_metrics.registry()
        t0 = time.perf_counter()
        t0_us = tracer.now_us()
        h.batched, h.carry = ens.ensemble_run_block(
            h.batched, t_end=cfg.t_end, n_events=cfg.diag_every,
            dt_max=cfg.dt_max, n_levels=h.n_levels, carry=h.carry,
            eta=cfg.eta, compaction=cfg.compaction,
            bucket_mode=cfg.bucket_mode,
            block_i=cfg.block_i, block_j=cfg.block_j,
            sources=cfg.sources, neighbor_radius=cfg.neighbor_radius,
            refresh_levels=cfg.refresh_levels, **h.kw)
        _sync(h.batched.pos)
        h.done += 1
        ev = [float(x) for x in h.carry.n_events.tolist()]
        tiles = h.carry.n_tiles.tolist()
        pairs = h.carry.n_pairs.tolist()
        ev_d = [a - b for a, b in zip(ev, h.ev_prev)]
        tiles_d = [a - b for a, b in zip(tiles, h.tiles_prev)]
        pairs_d = [a - b for a, b in zip(pairs, h.pairs_prev)]
        _chunk_spans(tracer, t0_us, tracer.now_us() - t0_us, chunk=h.done,
                     events=int(sum(ev_d)), tiles=float(sum(tiles_d)))
        reg.counter("sim.events", unit="events").inc(float(sum(ev_d)))
        reg.counter("sim.tiles_launched", unit="tiles").inc(
            float(sum(tiles_d)))
        reg.counter(
            "sim.tiles_dense_baseline", unit="tiles",
            help="what compaction='none' would have enqueued").inc(
            float(sum(ev_d)) * h.plan.dense_tiles)
        # analytic a-priori tile bound: occupancy entry 0 (every real
        # particle) is the largest active set any tick of the block
        # schedule can see, so per member and event the launch can
        # never exceed the tiles of occ[0]'s capacity bucket.  The
        # full-N bound does not transfer to the fused mesh, whose launches
        # are sized by p shard-local plans
        if cfg.mesh is None:
            occ0 = hermite.block_level_occupancy(
                h.carry.levels, n_levels=h.n_levels, mask=h.mask)[:, 0]
            for i, o in enumerate(occ0.tolist()):
                per_event = (int(h.plan.tiles(int(h.plan.bucket(o))))
                             if cfg.compaction == "gather"
                             else h.plan.dense_tiles)
                h.bound_total += ev_d[i] * per_event
            reg.gauge("sim.tiles_occupancy_bound", unit="tiles",
                      help="analytic bound; launched <= bound").set(
                h.bound_total)
        for i in range(h.b):
            if ev_d[i] > 0 and h.n_active[i] > 0:
                reg.histogram(
                    "sim.active_fraction", unit="fraction",
                    help="per-chunk mean active-target fraction"
                ).observe(pairs_d[i]
                          / (ev_d[i] * float(h.n_active[i]) ** 2))
        # the fused mesh's capacity switch lives inside the shards (one
        # bucket per slot): there is no batch-level hit distribution
        if cfg.compaction == "gather" and cfg.mesh is None:
            reg.gauge(
                "sim.bucket_hits", unit="hits",
                help="capacity-bucket switch hit counts (full "
                     "schedule, summed over members)").set(
                h.carry.bucket_hits.sum(dim=0).tolist())
        if h.carry.nbr is not None:
            nbr = h.carry.nbr
            nref = float(nbr.n_refresh.sum())
            nov = float(nbr.n_overflow.sum())
            reg.counter(
                "sim.neighbor_refreshes", unit="refreshes",
                help="Ahmad-Cohen window rebuilds (far-field "
                     "re-anchors, summed over members)").inc(
                nref - h.nref_prev)
            reg.counter(
                "sim.neighbor_overflow", unit="fallbacks",
                help="refreshes whose widest active window fit no "
                     "bucket below the full source extent").inc(
                nov - h.nov_prev)
            h.nref_prev, h.nov_prev = nref, nov
            wc = nbr.win_cnt.cpu().to(torch.float64)
            nsb = nbr.win_idx.shape[-1]
            blk_valid = (torch.arange(wc.shape[1])[None, :]
                         * h.plan.block_i) < torch.tensor(h.n_active)[:, None]
            occ_hist = reg.histogram(
                "sim.neighbor_occupancy", unit="fraction",
                help="per-target-block neighbor window fraction of "
                     "the full source extent (sampled per chunk)")
            for v in (wc[blk_valid] / nsb).tolist():
                occ_hist.observe(v)
        h.ev_prev, h.tiles_prev, h.pairs_prev = ev, tiles, pairs
        t_min = float(torch.min(h.batched.time))
        self._snapshot(h, int(max(ev)), t_min, time.perf_counter() - t0)
        h.finished = (t_min >= cfg.t_end
                      or h.done * cfg.diag_every >= MAX_STEPS)
        return h.finished

    def collect(self, h: RunHandle) -> RunReport:
        cfg = h.cfg
        if h.stepper == "fixed":
            t_final = h.n_steps * cfg.dt
            per_run_pairs = [float(h.n_steps) * a * a for a in h.n_active]
            per_run_steps = per_run_tiles = None
        elif h.stepper == "adaptive":
            per_run_steps = [int(c) for c in h.n_taken.tolist()]
            t_final = float(torch.min(h.batched.time))
            per_run_pairs = [float(s) * a * a
                             for s, a in zip(per_run_steps, h.n_active)]
            per_run_tiles = None
        else:
            per_run_steps = [int(c) for c in h.carry.n_events.tolist()]
            t_final = float(torch.min(h.batched.time))
            per_run_pairs = [float(p) for p in h.carry.n_pairs.tolist()]
            per_run_tiles = [float(t) for t in h.carry.n_tiles.tolist()]

        e1 = ens.batched_total_energy(h.batched).tolist()
        de = [abs((x - x0) / x0) for x, x0 in zip(e1, h.e0)]
        virial = ens.batched_virial_ratio(h.batched).tolist()
        runs = [{**h.runs_meta[i], "e0": h.e0[i], "e1": e1[i],
                 "de_rel": de[i], "virial_ratio": virial[i],
                 "force_evals": per_run_pairs[i],
                 **({"steps": per_run_steps[i]} if per_run_steps else {}),
                 **({"grid_tiles": per_run_tiles[i]}
                    if per_run_tiles else {})}
                for i in range(h.b)]
        extra = {"e0": list(h.e0), "e1": e1,
                 "de_rel": max(de), "t_final": t_final,
                 "runs": runs}
        if h.stepper == "block" and h.carry.nbr is not None:
            nref = h.carry.nbr.n_refresh.tolist()
            nov = h.carry.nbr.n_overflow.tolist()
            for i, r in enumerate(runs):
                r["neighbor_refreshes"] = int(nref[i])
                r["neighbor_overflows"] = int(nov[i])
            extra["neighbor_refreshes"] = int(sum(nref))
            extra["neighbor_overflows"] = int(sum(nov))
        return h.recorder.finalize(
            n_bodies=h.n_max, ensemble=h.b, n_devices=max(cfg.devices, 1),
            n_active=h.n_active, per_run_steps=per_run_steps,
            per_run_pairs=per_run_pairs, per_run_tiles=per_run_tiles,
            metrics=obs_metrics.registry().snapshot(),
            extra=extra)


class MixedRunner(EnsembleRunner):
    """Heterogeneous padded ensemble: one rectangular (B, N_max, ...) batch
    of different scenarios/N, zero-mass padding, per-run n_active mask."""

    kind = "mixed"

    def matches(self, cfg: SimConfig) -> bool:
        return cfg.mix is not None

    def _batch(self, cfg: SimConfig):
        specs = scenarios.make_mix(cfg.mix, seed=cfg.seed,
                                   repeat=cfg.ensemble,
                                   params=_mix_params(cfg))
        batched, n_active = scenarios.build_padded(
            specs, n_max=cfg.pad, validate=cfg.validate_ic,
            device=cfg.device)
        runs_meta = [{"run": i, "scenario": s.name, "n": s.n, "seed": s.seed}
                     for i, s in enumerate(specs)]
        return batched, [int(a) for a in n_active.tolist()], runs_meta


# registration order IS the dispatch priority (as in the reference)
register_runner(MixedRunner())
register_runner(BlockStrategyRunner())
register_runner(EnsembleRunner())
register_runner(SingleRunner())


# --------------------------------------------------------------------------
# the recomposed one-shot entry
# --------------------------------------------------------------------------
def run(cfg: SimConfig, mesh=None) -> RunReport:
    """Run one configuration end-to-end and return its telemetry report.
    ``mesh`` is a ready mesh for its shards (module docstring).

    The monolithic convenience over the composable surface: resolve the
    runner, ``build``, drive ``step`` to completion, ``collect``.  Each run
    gets its own :class:`repro_torch.obs.metrics.MetricsRegistry` (scoped
    as the module-current registry so the engine layer's emissions land in
    it) whose snapshot rides in the report under ``metrics``; with
    ``cfg.trace`` a live :class:`repro_torch.obs.trace.SpanTracer` is
    installed and the Chrome-trace JSON exported on completion
    (``trace_path`` in the report).
    """
    validate_config(cfg)
    tracer = obs_trace.SpanTracer() if cfg.trace else obs_trace.NullTracer()
    prev_tracer = obs_trace.set_tracer(tracer)
    try:
        with obs_metrics.use():
            obs_metrics.registry().gauge(
                "sim.dtype", unit="enum",
                help="precision axis of the run's force kernels").set(
                cfg.dtype)
            obs_metrics.registry().gauge(
                "sim.sources", unit="enum",
                help="force-source mode (full all-pairs vs Ahmad-Cohen "
                     "neighbor windows)").set(cfg.sources)
            runner = get_runner(resolve_kind(cfg))
            handle = runner.build(cfg, mesh=mesh)
            while not runner.step(handle):
                pass
            report = runner.collect(handle)
    finally:
        obs_trace.set_tracer(prev_tracer)
    if cfg.trace:
        report["trace_path"] = tracer.export(cfg.trace)
    if cfg.out:
        telemetry.write_report(report, cfg.out)
        report["report_path"] = cfg.out
    return report
