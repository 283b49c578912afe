"""Continuous-batching simulation server: admit, advance, retire, backfill.

Port of ``repro/serve/sim_engine.py``.  A :class:`SimServer`
holds a queue of :class:`SimRequest`\\ s (a validated ``ScenarioSpec``, a
stepper and a ``t_end``) and a set of pods, padded ``(B, cap)`` ensembles
advanced in lockstep, and on every scheduler tick:

1. admits queued requests into free pod slots (bucket packing, below),
   bootstrapping each member's derivatives with the shared
   ``ensemble_initialize`` engine;
2. advances every pod by one engine chunk (``chunk_events`` events or
   steps; membership changes only between chunks);
3. retires members whose simulated time reached their deadline, with a
   :class:`~repro_torch.sim.telemetry.RunReport` each;
4. backfills the freed slots from the queue.

**Admission (bucket packing).**  Pods are keyed by ``(stepper, capacity
ceiling)``, the ceiling being ``ops.CapacityPlan.admission_cap(n)``, the
top capacity bucket a request of ``n`` bodies can ever select.  Every
member of a pod shares one bucket-group signature, so the cached engines
stay the same under admit, retire and backfill: after
:meth:`SimServer.warmup` a steady-state trace builds no engine
(``engine.cache_miss`` stays put) and no kernel.

**Device state.**  A pod's state, deadlines, active counts and stepper
carries are tensors on ``ServerConfig.device`` (default ``cuda``, which
raises without a card), shaped ``(B, cap)`` once at the pod's creation.
Admission writes the new member into its slot in place; the engines touch
members independently, so batch-mates stay bit for bit the same across a
neighbour's retire and backfill.  The bookkeeping (queue, slots, reports)
is plain Python on the host.

**Retirement freezing.**  A retired slot keeps its ``n_active`` (so the
bucket groups never change) and a deadline at or below its time (so the
engine freezes the member whole).

**Suspend/resume.**  :meth:`SimServer.suspend` checkpoints every pod's
tensors through ``repro_torch.checkpoint.store`` plus a JSON manifest of
the queue and slots; :meth:`SimServer.resume` rebuilds a server that
continues bit for bit (dtype-strict restore).

**Devices.**  ``devices`` > 1 shards every pod's batch over that many
slots (``sim.ensemble``'s batch layout) and ``mesh=(B, P)`` puts block pods
on the fused ``(batch, dev)`` grid; ``slots_per_pod`` must be a multiple
of the batch extent.  The slots are the first ``devices`` cards
(``ServerConfig.slots``).  A pod's state stays whole on ``device``, so
checkpoints keep the reference's unsharded leaves; admission bootstraps
each member on one slot.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import store
from repro_torch.core import nbody
from repro_torch.core.strategies import mesh_devices
from repro_torch.core.nbody import FIELDS, ParticleState, zeros_like_state
from repro_torch.kernels import nbody_force, ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios, telemetry
from repro_torch.sim.scenarios import ScenarioError, ScenarioSpec
from repro_torch.sim.telemetry import RunReport

#: steppers with per-member deadline semantics (the fixed-dt mode shares one
#: global step count and cannot freeze a retired member mid-batch)
SERVABLE_STEPPERS = ("adaptive", "block")

SERVER_META = "server_meta.json"


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Engine profile shared by every pod of one server."""

    slots_per_pod: int = 4           # B of each padded ensemble
    n_max: int = 1024                # largest admissible request N
    chunk_events: int = 16           # engine chunk per scheduler tick
    order: int = 6
    eps: float = 1e-7
    dtype: str = "fp32"              # kernel precision axis (state is f64)
    eta: float = 0.02
    dt_max: float = 0.0625
    n_levels: int = 8                # block pods
    compaction: str = "none"         # block pods ("none" | "gather")
    block_i: Optional[int] = None
    block_j: Optional[int] = None
    sources: str = "full"            # block pods ("full" | "neighbor")
    neighbor_radius: float = 0.25
    refresh_levels: int = 2
    devices: int = 1
    mesh: Optional[Tuple[int, int]] = None  # fused (batch, domain) grid for
    #   block pods; product must equal devices (JSON manifests round-trip
    #   it as a 2-list, so compare via tuple())
    device: str = "cuda"             # where every pod's tensors live

    def validate(self) -> "ServerConfig":
        if self.slots_per_pod < 1:
            raise ValueError(
                f"slots_per_pod={self.slots_per_pod} must be >= 1")
        if self.mesh is not None:
            if len(self.mesh) != 2 or any(int(e) < 1 for e in self.mesh):
                raise ValueError(
                    f"mesh={self.mesh!r} must be two positive extents "
                    "(B_shards, P_shards)")
            if self.mesh[0] * self.mesh[1] != self.devices:
                raise ValueError(
                    f"mesh={tuple(self.mesh)} covers "
                    f"{self.mesh[0] * self.mesh[1]} devices; devices says "
                    f"{self.devices}")
        # the batch axis pads to the mesh's batch extent (all of `devices`
        # without a fused mesh)
        batch_extent = self.mesh[0] if self.mesh is not None else self.devices
        if batch_extent >= 1 and self.slots_per_pod % batch_extent:
            raise ValueError(
                f"slots_per_pod={self.slots_per_pod} must be a multiple of "
                f"the batch extent {batch_extent} (the batch axis shards "
                "evenly)")
        if self.chunk_events < 1:
            raise ValueError(
                f"chunk_events={self.chunk_events} must be >= 1")
        if self.dtype not in ops.DTYPES:
            raise ValueError(
                f"dtype must be one of {ops.DTYPES}; got {self.dtype!r}")
        if self.sources not in ops.SOURCES:
            raise ValueError(
                f"sources must be one of {ops.SOURCES}; got {self.sources!r}")
        if self.sources == "neighbor" and self.compaction != "none":
            raise ValueError(
                "sources='neighbor' gathers its own per-block source "
                "windows; it composes with compaction='none' only")
        if self.refresh_levels < 0:
            raise ValueError(
                f"refresh_levels={self.refresh_levels} must be >= 0")
        plan = self.plan()
        if self.n_max != plan.caps[-1]:
            raise ValueError(
                f"n_max={self.n_max} must be block_i-aligned "
                f"(next aligned value: {plan.caps[-1]})")
        nbody.resolve_device(self.device)
        self.slots()
        return self

    def slots(self) -> Optional[list]:
        """The engines' device list: None for one slot, else the first
        ``devices`` cards or ``devices`` CPU slots
        (``strategies.mesh_devices``: ``ValueError`` above the visible
        cards)."""
        if self.devices <= 1 and self.mesh is None:
            return None
        return mesh_devices(self.devices, self.device)

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return (self.block_i or nbody_force.DEFAULT_BLOCK_I,
                self.block_j or nbody_force.DEFAULT_BLOCK_J)

    def plan(self) -> ops.CapacityPlan:
        """The full admission plan (the FIFO baseline's launch schedule)."""
        bi, bj = self.tile_shape
        return ops.CapacityPlan(self.n_max, self.n_max, bi, bj,
                                dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One scenario run to serve: what, how, and until when."""

    spec: ScenarioSpec
    stepper: str = "adaptive"
    t_end: float = 0.25

    def validate(self, cfg: ServerConfig) -> "SimRequest":
        self.spec.validate()
        if self.spec.n is None:
            raise ScenarioError(
                "SimRequest.spec.n: unset; the server admits fully sized "
                "requests (call spec.with_n(...))")
        if self.spec.n > cfg.n_max:
            raise ValueError(
                f"SimRequest.spec.n: n={self.spec.n} exceeds the server's "
                f"n_max={cfg.n_max}")
        if self.stepper not in SERVABLE_STEPPERS:
            raise ValueError(
                f"SimRequest.stepper: {self.stepper!r} not servable; one of "
                f"{SERVABLE_STEPPERS} (fixed-dt runs share one global step "
                "count and cannot freeze at a per-member deadline)")
        if not self.t_end > 0.0:
            raise ValueError(
                f"SimRequest.t_end: {self.t_end} must be > 0")
        return self

    def describe(self) -> Dict[str, Any]:
        return {"scenario": self.spec.format(), "seed": self.spec.seed,
                "params": dict(self.spec.params), "stepper": self.stepper,
                "t_end": self.t_end}


# --------------------------------------------------------------------------
# admission policy (pure host math)
# --------------------------------------------------------------------------
def packed_event_tiles(plan: ops.CapacityPlan, n: int) -> int:
    """Worst-case per-event kernel tiles for ``n`` bodies in its bucket pod.

    The pod's source extent is the request's capacity ceiling, so both grid
    axes shrink with the request; compare :func:`fifo_event_tiles`, where
    the source axis stays at ``n_max``.
    """
    cap = plan.admission_cap(n)
    pod = ops.CapacityPlan(cap, cap, plan.block_i, plan.block_j,
                           n_passes=plan.n_passes, dtype=plan.dtype)
    return int(pod.tiles_by_cap[len(pod.restrict(n).caps) - 1])


def fifo_event_tiles(plan: ops.CapacityPlan, n: int) -> int:
    """Worst-case per-event tiles for ``n`` bodies under FIFO admission into
    one shared ``n_max``-sized pod (the naive policy's launch schedule)."""
    return int(plan.tiles_by_cap[len(plan.restrict(n).caps) - 1])


@dataclasses.dataclass
class _Pending:
    request_id: int
    request: SimRequest
    t_submit: float


@dataclasses.dataclass
class _Slot:
    request_id: int
    request: SimRequest
    t_submit: float
    t_admit: float
    e0: float
    recorder: telemetry.TelemetryRecorder


class Pod:
    """One padded ``(B, cap)`` lockstep ensemble with per-slot deadlines.

    Free slots hold frozen placeholders: their ``n_active`` keeps the last
    occupant's value (bucket groups stay the same) and their deadline sits
    at or below their simulated time (the engine freezes them whole).
    """

    def __init__(self, cfg: ServerConfig, stepper: str, cap: int):
        self.cfg, self.stepper, self.cap = cfg, stepper, cap
        self.device = nbody.resolve_device(cfg.device)
        b = cfg.slots_per_pod
        f64 = dict(dtype=torch.float64, device=self.device)
        zero = zeros_like_state(torch.zeros((cap, 3), **f64),
                                torch.zeros((cap, 3), **f64),
                                torch.zeros((cap,), **f64))
        self.batched: ParticleState = ens.stack_states([zero] * b)
        self.state_dtype = self.batched.dtype
        self.n_active = torch.full((b,), cap, dtype=torch.int32,
                                   device=self.device)
        self.t_end = torch.zeros(b, **f64)          # all frozen at t=0
        self.slots: List[Optional[_Slot]] = [None] * b
        self.h_prev = torch.zeros(b, **f64)         # adaptive carry
        self.n_taken = torch.zeros(b, dtype=torch.int32, device=self.device)
        self.carry: Optional[ens.BlockCarry] = None  # block carry

    # ------------------------------------------------------------- geometry
    @property
    def size(self) -> int:
        return self.cfg.slots_per_pod

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def occupied(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _devices(self) -> Optional[list]:
        """The engines' device list (None: the pod's own device)."""
        return self.cfg.slots()

    def _engine_kw(self) -> Dict[str, Any]:
        cfg = self.cfg
        return dict(order=cfg.order, eps=cfg.eps, dtype=cfg.dtype)

    # ------------------------------------------------------------ lifecycle
    def init_member(self, request: SimRequest
                    ) -> Tuple[ParticleState, float]:
        """Build, pad and bootstrap one member; returns ``(state, e0)``.

        Runs through the same ``ensemble_initialize`` engine as a fresh
        batch, at the pod's padded width, so an admitted member's
        derivatives are bit for bit a cold ``(1, cap)`` start's.
        """
        member = request.spec.build(dtype=self.state_dtype,
                                    device=self.device)
        if self.stepper == "block" and self.cfg.sources == "neighbor":
            # sort once at admission (row order is carry-aligned and never
            # changes mid-run) so contiguous index blocks are compact
            # spatial cells and the member's neighbor windows stay tight
            member = ens.spatial_sort_state(
                member, leaf=math.gcd(*self.cfg.tile_shape))
        b1 = ens.stack_states([scenarios.pad_state(member, self.cap)])
        b1 = ens.ensemble_initialize(
            b1, n_active=[request.spec.n], devices=None,
            **self._engine_kw())
        e0 = float(ens.batched_total_energy(b1)[0])
        return ParticleState(**{f: getattr(b1, f)[0] for f in FIELDS}), e0

    def admit(self, pending: _Pending, slot: int, now: float) -> _Slot:
        cfg, req = self.cfg, pending.request
        member, e0 = self.init_member(req)
        for f in FIELDS:
            getattr(self.batched, f)[slot] = getattr(member, f)
        self.n_active[slot] = req.spec.n
        self.t_end[slot] = req.t_end
        if self.stepper == "adaptive":
            self.h_prev[slot] = 0.0   # the "first step" mark
            self.n_taken[slot] = 0
        elif self.carry is not None:
            # a never-advanced pod has no carry yet: the batch-wide init at
            # its first advance bootstraps every member, this one included
            ens.block_admit_member(
                self.carry, member, slot, req.t_end, eta=cfg.eta,
                dt_max=cfg.dt_max, n_levels=cfg.n_levels)
        recorder = telemetry.TelemetryRecorder({
            **req.describe(), "request_id": pending.request_id,
            "n": req.spec.n, "pod_cap": self.cap, "dtype": cfg.dtype})
        recorder.record_snapshot(0, 0.0, energy=e0, de_rel=0.0)
        s = _Slot(request_id=pending.request_id, request=req,
                  t_submit=pending.t_submit, t_admit=now, e0=e0,
                  recorder=recorder)
        self.slots[slot] = s
        return s

    def advance(self) -> float:
        """One engine chunk; returns the chunk wall seconds (0.0 if idle)."""
        if not self.occupied():
            return 0.0
        cfg = self.cfg
        kw = dict(n_active=self.n_active, devices=self._devices(),
                  **self._engine_kw())
        t0 = time.perf_counter()
        if self.stepper == "adaptive":
            self.batched, self.h_prev, self.n_taken = \
                ens.ensemble_run_adaptive(
                    self.batched, t_end=self.t_end,
                    n_steps=cfg.chunk_events, h_prev=self.h_prev,
                    n_taken=self.n_taken, eta=cfg.eta, dt_max=cfg.dt_max,
                    **kw)
        else:
            self.batched, self.carry = ens.ensemble_run_block(
                self.batched, t_end=self.t_end, n_events=cfg.chunk_events,
                dt_max=cfg.dt_max, n_levels=cfg.n_levels, carry=self.carry,
                eta=cfg.eta, compaction=cfg.compaction,
                block_i=cfg.block_i, block_j=cfg.block_j,
                sources=cfg.sources, neighbor_radius=cfg.neighbor_radius,
                refresh_levels=cfg.refresh_levels,
                mesh=tuple(cfg.mesh) if cfg.mesh is not None else None,
                **kw)
        times = self.batched.time.tolist()
        wall = time.perf_counter() - t0
        steps = self._per_slot_steps()
        for i in self.occupied():
            self.slots[i].recorder.record_step(int(steps[i]), times[i],
                                               wall)
        return wall

    def _per_slot_steps(self) -> List[int]:
        if self.stepper == "adaptive":
            return self.n_taken.tolist()
        if self.carry is None:
            return [0] * self.size
        return self.carry.n_events.tolist()

    def finished_slots(self) -> List[int]:
        times, t_end = torch.stack([self.batched.time, self.t_end]).tolist()
        return [i for i in self.occupied() if times[i] >= t_end[i]]

    def retire(self, slot: int, now: float) -> RunReport:
        """Finalize one finished member's report and free its slot.

        The member's rows stay in place, frozen: ``n_active`` keeps its
        value and ``time >= t_end`` keeps the engine's freeze until a
        backfill overwrites the rows.
        """
        cfg, s = self.cfg, self.slots[slot]
        n = s.request.spec.n
        e1 = float(ens.batched_total_energy(self.batched)[slot])
        t_final = float(self.batched.time[slot])
        steps = int(self._per_slot_steps()[slot])
        if self.stepper == "adaptive":
            pairs = [float(steps) * n * n]
            tiles = None
        else:
            pairs = [float(self.carry.n_pairs[slot])]
            tiles = [float(self.carry.n_tiles[slot])]
        de_rel = abs(e1 - s.e0) / max(abs(s.e0), torch.finfo(
            torch.float64).tiny)
        s.recorder.record_snapshot(steps, t_final, energy=e1, de_rel=de_rel)
        extra = {"e0": s.e0, "e1": e1, "de_rel": de_rel,
                 "t_final": t_final, "request_id": s.request_id,
                 "pod_cap": self.cap,
                 "admission_latency_s": s.t_admit - s.t_submit,
                 "turnaround_s": now - s.t_submit}
        if self.carry is not None and self.carry.nbr is not None:
            extra["neighbor_refreshes"] = int(self.carry.nbr.n_refresh[slot])
            extra["neighbor_overflows"] = int(
                self.carry.nbr.n_overflow[slot])
        report = s.recorder.finalize(
            n_bodies=self.cap, ensemble=1, n_devices=max(cfg.devices, 1),
            n_active=[n], per_run_steps=[steps], per_run_pairs=pairs,
            per_run_tiles=tiles, extra=extra)
        self.slots[slot] = None
        return report

    # ----------------------------------------------------- suspend / resume
    def state_tree(self) -> Dict[str, Any]:
        """The pod's tensors as one checkpointable tree (the reference's
        leaf names)."""
        tree: Dict[str, Any] = {"state": self.batched,
                                "n_active": self.n_active,
                                "t_end": self.t_end}
        if self.stepper == "adaptive":
            tree["h_prev"] = self.h_prev
            tree["n_taken"] = self.n_taken
        elif self.carry is not None:
            tree["carry"] = self.carry
        return tree

    def carry_template(self) -> ens.BlockCarry:
        """A zeros :class:`~repro_torch.sim.ensemble.BlockCarry` with this
        pod's exact shapes and dtypes (the template of a dtype-strict
        restore)."""
        b, cap, cfg = self.size, self.cap, self.cfg
        bi, bj = cfg.tile_shape
        sd = dict(dtype=self.state_dtype, device=self.device)
        f64 = dict(dtype=torch.float64, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        n_caps = len(ops.CapacityPlan(cap, cap, bi, bj).caps)
        nbr = None
        if self.stepper == "block" and cfg.sources == "neighbor":
            nbr = ens.neighbor_carry(b, cap, bi, bj, self.state_dtype,
                                     self.device)
        return ens.BlockCarry(
            t_last=torch.zeros((b, cap), **i32),
            levels=torch.zeros((b, cap), **i32),
            dt_macro=torch.zeros(b, **sd),
            n_pairs=torch.zeros(b, **f64),
            n_events=torch.zeros(b, **i32),
            n_tiles=torch.zeros(b, **f64),
            bucket_hits=torch.zeros((b, n_caps), **f64),
            nbr=nbr)

    def load_tree(self, tree: Dict[str, Any]) -> None:
        self.batched = tree["state"]
        self.n_active = tree["n_active"]
        self.t_end = tree["t_end"]
        if self.stepper == "adaptive":
            self.h_prev = tree["h_prev"]
            self.n_taken = tree["n_taken"]
        else:
            self.carry = tree.get("carry")


class SimServer:
    """The long-lived scheduler over a queue and a dict of pods.

    All engine work runs under this server's own metrics registry, so
    ``serve.*`` gauges and the ``engine.cache_miss`` build counter are
    attributable to the service (snapshot via :meth:`metrics_snapshot`).
    """

    def __init__(self, cfg: Optional[ServerConfig] = None):
        self.cfg = (cfg or ServerConfig()).validate()
        self.plan = self.cfg.plan()
        self.registry = obs_metrics.MetricsRegistry()
        self.queue: Deque[_Pending] = collections.deque()
        self.pods: Dict[Tuple[str, int], Pod] = {}
        self.reports: List[RunReport] = []
        self._next_id = 0

    # ------------------------------------------------------------ submission
    def submit(self, request: SimRequest,
               now: Optional[float] = None) -> int:
        """Queue one validated request; returns its request id."""
        request.validate(self.cfg)
        self.plan.admission_cap(request.spec.n)   # range check
        rid = self._next_id
        self._next_id += 1
        self.queue.append(_Pending(request_id=rid, request=request,
                                   t_submit=self._now(now)))
        self._set_gauges()
        return rid

    def _now(self, now: Optional[float] = None) -> float:
        return time.perf_counter() if now is None else now

    def pod_for(self, request: SimRequest) -> Pod:
        """Get or create the ``(stepper, capacity ceiling)`` pod."""
        key = (request.stepper, self.plan.admission_cap(request.spec.n))
        pod = self.pods.get(key)
        if pod is None:
            pod = self.pods[key] = Pod(self.cfg, key[0], key[1])
        return pod

    # ------------------------------------------------------------- scheduler
    def _admit(self, now: float) -> int:
        """Bucket-packing admission: any queued request whose pod has a free
        slot is admitted (FIFO within each bucket); a request whose pod is
        full never blocks another bucket's backfill."""
        admitted = 0
        remaining: Deque[_Pending] = collections.deque()
        while self.queue:
            p = self.queue.popleft()
            pod = self.pod_for(p.request)
            slot = pod.free_slot()
            if slot is None:
                remaining.append(p)
                continue
            pod.admit(p, slot, now)
            admitted += 1
            self.registry.counter(
                "serve.requests_admitted", unit="requests").inc()
            self.registry.histogram(
                "serve.admission_latency_s", unit="s",
                help="submit -> admit wait").observe(now - p.t_submit)
        self.queue = remaining
        return admitted

    def step(self, now: Optional[float] = None) -> List[RunReport]:
        """One scheduler tick: admit, advance all pods one chunk, retire
        finished members, backfill the freed slots.  Returns the reports of
        the members retired this tick (also appended to ``self.reports``)."""
        now = self._now(now)
        retired: List[RunReport] = []
        with obs_metrics.use(self.registry):
            self._admit(now)
            for pod in self.pods.values():
                pod.advance()
            for pod in self.pods.values():
                for slot in pod.finished_slots():
                    report = pod.retire(slot, self._now())
                    self.registry.counter(
                        "serve.requests_retired", unit="requests").inc()
                    self.registry.histogram(
                        "serve.turnaround_s", unit="s",
                        help="submit -> retire latency").observe(
                        report["turnaround_s"])
                    retired.append(report)
            self._admit(self._now())   # backfill freed slots at once
        self._set_gauges()
        self.reports.extend(retired)
        return retired

    def busy(self) -> bool:
        return bool(self.queue) or any(p.occupied()
                                       for p in self.pods.values())

    def run_until_drained(self, max_ticks: int = 100_000
                          ) -> List[RunReport]:
        """Tick until queue and pods are empty; returns the new reports."""
        out: List[RunReport] = []
        ticks = 0
        while self.busy():
            if ticks >= max_ticks:
                raise RuntimeError(
                    f"server not drained after {max_ticks} ticks "
                    f"(queue={len(self.queue)})")
            out.extend(self.step())
            ticks += 1
        return out

    def _set_gauges(self) -> None:
        slots = sum(p.size for p in self.pods.values()) or 1
        live = sum(len(p.occupied()) for p in self.pods.values())
        self.registry.gauge(
            "serve.queue_depth", unit="requests",
            help="requests waiting for a slot").set(float(len(self.queue)))
        self.registry.gauge(
            "serve.slot_occupancy", unit="fraction",
            help="live-slot fraction across pods").set(live / slots)

    # -------------------------------------------------------------- warmup
    def warmup(self, requests: List[SimRequest]) -> float:
        """Build every engine a request mix will touch.

        For each distinct ``(stepper, cap)`` the mix maps to, builds the
        pod, bootstraps a throwaway member (the ``(1, cap)`` admission
        path) and advances one chunk (the ``(B, cap)`` engines and the
        energy diagnostics).  A steady state after this builds no engine;
        returns the ``engine.cache_miss`` count the warmup itself spent.
        """
        before = self.cache_misses()
        seen = set()
        with obs_metrics.use(self.registry):
            for req in requests:
                req.validate(self.cfg)
                key = (req.stepper, self.plan.admission_cap(req.spec.n))
                if key in seen:
                    continue
                seen.add(key)
                pod = self.pod_for(req)
                slot = pod.free_slot()
                warm = _Pending(request_id=-1, request=req,
                                t_submit=self._now())
                pod.admit(warm, slot, self._now())     # (1, cap) admission
                pod.advance()                          # (B, cap) engines
                pod.retire(slot, self._now())          # diagnostics, report
                pod.t_end[slot] = 0.0                  # freeze the rows
        return self.cache_misses() - before

    def cache_misses(self) -> float:
        """Engine builds charged to this server."""
        metric = self.registry._metrics.get("engine.cache_miss")
        return float(metric.value) if metric is not None else 0.0

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()

    # ----------------------------------------------------- suspend / resume
    def _pod_dir(self, root: str, key: Tuple[str, int]) -> str:
        return os.path.join(root, f"pod_{key[0]}_{key[1]}")

    def suspend(self, ckpt_dir: str, step: int = 0) -> str:
        """Checkpoint every pod's tensors and the scheduler bookkeeping."""
        os.makedirs(ckpt_dir, exist_ok=True)
        pods_meta = {}
        for key, pod in self.pods.items():
            store.save(self._pod_dir(ckpt_dir, key), step, pod.state_tree())
            pods_meta["/".join(map(str, key))] = {
                "stepper": pod.stepper, "cap": pod.cap,
                "has_carry": pod.stepper == "block"
                and pod.carry is not None,
                "slots": [None if s is None else {
                    "request_id": s.request_id,
                    "request": s.request.describe(),
                    "t_submit": s.t_submit, "t_admit": s.t_admit,
                    "e0": s.e0,
                    "meta": s.recorder.meta,
                    "steps": [dataclasses.asdict(x)
                              for x in s.recorder.steps],
                    "snapshots": s.recorder.snapshots,
                } for s in pod.slots],
            }
        meta = {
            "config": dataclasses.asdict(self.cfg),
            "next_id": self._next_id,
            "step": step,
            "queue": [{"request_id": p.request_id,
                       "request": p.request.describe(),
                       "t_submit": p.t_submit} for p in self.queue],
            "pods": pods_meta,
        }
        path = os.path.join(ckpt_dir, SERVER_META)
        with open(path, "w") as f:
            json.dump(meta, f, indent=1)
        return path

    @staticmethod
    def _request_from_meta(d: Dict[str, Any]) -> SimRequest:
        spec = ScenarioSpec.parse(d["scenario"], seed=int(d["seed"]))
        spec = dataclasses.replace(spec, params=dict(d.get("params") or {}))
        return SimRequest(spec=spec, stepper=d["stepper"],
                          t_end=float(d["t_end"]))

    @classmethod
    def resume(cls, ckpt_dir: str) -> "SimServer":
        """Rebuild a suspended server; pods continue bit for bit."""
        with open(os.path.join(ckpt_dir, SERVER_META)) as f:
            meta = json.load(f)
        cfg = ServerConfig(**meta["config"])
        server = cls(cfg)
        server._next_id = int(meta["next_id"])
        for p in meta["queue"]:
            server.queue.append(_Pending(
                request_id=int(p["request_id"]),
                request=cls._request_from_meta(p["request"]),
                t_submit=float(p["t_submit"])))
        for key_s, pm in meta["pods"].items():
            stepper, cap = pm["stepper"], int(pm["cap"])
            pod = Pod(server.cfg, stepper, cap)
            like = pod.state_tree()
            if pm.get("has_carry"):
                like["carry"] = pod.carry_template()
            _, tree = store.restore_latest(
                server._pod_dir(ckpt_dir, (stepper, cap)), like)
            if tree is None:
                raise FileNotFoundError(
                    f"no checkpoint for pod {key_s} under {ckpt_dir}")
            pod.load_tree(tree)
            for i, sm in enumerate(pm["slots"]):
                if sm is None:
                    continue
                recorder = telemetry.TelemetryRecorder(sm["meta"])
                recorder.steps = [telemetry.StepSample(**x)
                                  for x in sm["steps"]]
                recorder.snapshots = list(sm["snapshots"])
                pod.slots[i] = _Slot(
                    request_id=int(sm["request_id"]),
                    request=cls._request_from_meta(sm["request"]),
                    t_submit=float(sm["t_submit"]),
                    t_admit=float(sm["t_admit"]),
                    e0=float(sm["e0"]), recorder=recorder)
            server.pods[(stepper, cap)] = pod
        server._set_gauges()
        return server
