"""Distribution strategies for the N-body force evaluation.

Port of ``repro/core/strategies.py``: the paper's three scaling
configurations (§3, Fig. 3) and the beyond-paper ring, each as an
``Evaluator`` and as a block evaluator with shard-local compaction:

* ``replicated``   — targets sharded over the devices, the full source set
  all-gathered onto every device once per evaluation;
* ``two_level``    — the same math, the gather staged over a
  ``("card", "chip")`` view: across the chips of a card first, then across
  cards;
* ``mesh_sharded`` — the body names placements only ("sharded" targets,
  "replicated" sources) and the mesh makes the copies, as XLA's
  ``with_sharding_constraint`` and TT-NN's ``MeshDevice`` do;
* ``ring``         — a systolic ring: each device keeps N/P sources and
  meets every other shard's window in turn, O(N/P) memory instead of O(N).

**The device mesh.**  The reference is single-controller: one process drives
``p`` devices through ``shard_map``.  The port keeps that shape with an
in-process :class:`DeviceMesh`, an ordered list of ``torch.device``s, one per
shard, whose collectives are explicit cross-device copies (``all_gather``,
the two-stage ``all_gather2``, ``place`` for mesh_sharded and ``ppermute``
for the ring).  A list may name one card several times: each slot then runs
on that card, in shard order on its stream, and a copy to the same device is
no copy at all.  That is how one card runs 2 or 4 shards, as XLA's
placeholder host devices run them on the CPU.  On several cards the same code
makes peer copies.  The tensors' device picks the kernels or their plain
versions, as everywhere in the port; there is no ``impl`` switch.

All strategies agree with the single-device evaluation within float32
rounding (the sum over sources runs in another order), and inside each
strategy the port keeps the reference's bitwise contracts: the ring's
``overlap`` schedule equals ``sync`` bit for bit, and each block evaluator's
``compaction="gather"`` equals ``"none"`` bit for bit.

**The process mesh.**  :class:`ProcessMesh` (``distributed.process_mesh``)
is the same interface as one OS process per shard over
``torch.distributed``, the reference's SPMD form: each rank holds only its
own slot (per-slot lists of one entry) and the collectives are
``torch.distributed`` calls.  The evaluators below take either mesh
(``mesh=``); a list that names every shard (the gather bounds) reaches the
per-slot code through ``mesh.local``, which picks this rank's entry there
and is the identity on a ``DeviceMesh``.  Each rank takes the whole
``(N, ...)`` inputs and returns the whole ``Evaluation``, so a rank's
result is the in-process mesh's, bit for bit.

**The batch axis.**  :func:`make_batch_mesh` is the 1-D ``("batch",)``
view an ensemble shards its members over (``sim.ensemble``), and
:func:`make_fused_mesh` the 2-D ``("batch", "dev")`` grid of
:func:`make_fused_block_evaluator`: slot ``(i, k)`` holds members ``i*B/bdev
.. (i+1)*B/bdev`` and target rows ``k*N/p .. (k+1)*N/p`` of each of them,
gathers sources along ``dev`` only (members stay independent) and runs ONE
K1 (then one K2) launch per pass over its local members.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from repro_torch.core.evaluate import shared_cap_index
from repro_torch.core.hermite import Evaluation, Evaluator
from repro_torch.core.nbody import resolve_device
from repro_torch.distributed.process_mesh import ProcessMesh
from repro_torch.kernels import nbody_force, ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import named_scope

STRATEGIES = ("replicated", "two_level", "mesh_sharded", "ring")
#: compaction modes of the strategy block evaluators (mirrors core.evaluate)
COMPACTIONS = ("none", "gather")
#: ring source-shift schedules: "overlap" puts the next window in flight
#: before each round's kernels (exactly p - 1 shift rounds per pass);
#: "sync" shifts after computing, p rounds per pass, the last one dead
RING_MODES = ("overlap", "sync")
#: placements the mesh_sharded strategy names
PLACEMENTS = ("sharded", "replicated")
#: the precisions a strategy runs: float32 state and collectives, the
#: per-pair arithmetic narrowed in mixed mode (fp64 is the single path's
#: oracle)
_KERNEL_DTYPES = ("fp32", "mixed")


def mesh_devices(count: Optional[int] = None, device="cuda") -> list:
    """The device list of a ``count``-shard mesh for tensors on ``device``.

    On the CPU, ``count`` slots on the CPU (``None``: one), as the
    reference's launcher fakes host devices.  On ``cuda``, the first
    ``count`` cards (``None``: every visible card); fewer visible cards
    raise ``ValueError`` naming the visible count, and no card raises as
    ``nbody.resolve_device`` does.  A list naming one card several times is
    built by the caller.
    """
    dev = resolve_device(device)
    if count is not None and int(count) < 1:
        raise ValueError(f"a mesh needs at least one device; got {count}")
    if dev.type == "cpu":
        return [dev] * (1 if count is None else int(count))
    visible = torch.cuda.device_count()
    count = visible if count is None else int(count)
    if count > visible:
        raise ValueError(
            f"requested {count} devices, only {visible} visible (a card "
            "named several times in a device list runs several shards on "
            "it)")
    return [torch.device("cuda", i) for i in range(count)]


class DeviceMesh:
    """An ordered list of devices, one per shard.

    ``shape`` views the list as a 1-D ``("dev",)`` mesh or, for two_level,
    a ``("card", "chip")`` grid (device ``card * chips + chip``).  Per-shard
    values travel as lists with one tensor per slot, the tensor on its
    slot's device; every collective below is a copy between slots.  A
    gather onto a device that several slots share is made once and handed
    to each of them (it is read only).
    """

    def __init__(self, devices: Sequence, shape: Optional[tuple] = None,
                 axis_names: tuple = ("dev",)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            if d.type == "cuda" and d.index is not None \
                    and d.index >= torch.cuda.device_count():
                raise ValueError(
                    f"{d} named, only {torch.cuda.device_count()} cards "
                    "visible (a card named several times in a device list "
                    "runs several shards on it)")
        self.shape = tuple(shape) if shape else (len(self.devices),)
        self.axis_names = tuple(axis_names)
        prod = 1
        for e in self.shape:
            prod *= e
        if prod != len(self.devices) or len(self.shape) != len(axis_names):
            raise ValueError(f"mesh shape {self.shape} over "
                             f"{self.axis_names} does not tile "
                             f"{len(self.devices)} devices")

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and (
            self.devices, self.shape, self.axis_names) == (
            other.devices, other.shape, other.axis_names)

    def __hash__(self) -> int:
        # a mesh keys the engine caches by value
        return hash((self.devices, self.shape, self.axis_names))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def named(self) -> int:
        """How many shards a per-shard list names: every slot (a
        :class:`ProcessMesh` rank on the fused view names its row's)."""
        return len(self.devices)

    def reshape(self, shape: tuple, axis_names: tuple) -> "DeviceMesh":
        """The same slots under another view."""
        return DeviceMesh(self.devices, shape, axis_names)

    def local(self, seq: Sequence) -> Sequence:
        """The per-slot entries of a list that names every shard: all of
        them (a :class:`ProcessMesh` rank holds one)."""
        return seq

    def shard(self, x: torch.Tensor) -> list:
        """``x``'s rows split into ``size`` equal blocks, block i on slot i
        (the row count must be a multiple of the mesh size)."""
        return [part.to(d) for part, d in zip(x.chunk(self.size),
                                               self.devices)]

    def unshard(self, parts: Sequence, device) -> torch.Tensor:
        """The slots' blocks concatenated in slot order on ``device`` (per
        entry, where each slot's block is a tuple of tensors)."""
        return _cat(parts, device)

    @staticmethod
    def _gather_group(parts, devices, dim: int = 0) -> list:
        """``parts`` concatenated in order (along ``dim``) onto each of
        ``devices`` (per entry, where the parts are tuples)."""
        whole = {}
        for d in devices:
            if d not in whole:
                whole[d] = _cat(parts, d, dim)
        return [whole[d] for d in devices]

    # -- the ("batch", "dev") grid: slot (i, k) is device i * p + k --------
    def shard2(self, x: torch.Tensor) -> list:
        """``x`` (``(B, N, ...)``) split into the grid's blocks: slot ``(i,
        k)`` holds member chunk ``i`` of ``bdev`` and row chunk ``k`` of
        ``p`` (B and N must be multiples of the extents)."""
        bdev, p = self.shape
        return [r.to(self.devices[i * p + k])
                for i, xb in enumerate(x.chunk(bdev))
                for k, r in enumerate(xb.chunk(p, dim=1))]

    def unshard2(self, parts: Sequence, device) -> torch.Tensor:
        """The grid's blocks reassembled as one ``(B, N, ...)`` tensor on
        ``device``."""
        bdev, p = self.shape
        return _cat([_cat(parts[i * p:(i + 1) * p], device, dim=1)
                     for i in range(bdev)], device)

    def all_gather_dev(self, parts: Sequence) -> list:
        """All-gather along ``dev`` only: every slot of batch row ``i``
        receives the row's blocks concatenated along the particle axis;
        nothing crosses ``batch``."""
        bdev, p = self.shape
        with named_scope("collective.all_gather_dev"):
            out = []
            for i in range(bdev):
                idx = range(i * p, (i + 1) * p)
                out += self._gather_group([parts[j] for j in idx],
                                          [self.devices[j] for j in idx],
                                          dim=1)
            return out

    def all_gather(self, parts: Sequence) -> list:
        """Tiled all-gather over the whole mesh: every slot receives every
        slot's block, in slot order."""
        with named_scope("collective.all_gather"):
            return self._gather_group(parts, self.devices)

    def all_gather2(self, parts: Sequence) -> list:
        """Two-stage gather over the ``("card", "chip")`` view: within each
        card first, then across cards.  The source order is the 1-D
        gather's, as in the reference."""
        cards, chips = self.shape
        with named_scope("collective.all_gather2"):
            stage = [None] * self.size
            for c in range(cards):
                idx = range(c * chips, (c + 1) * chips)
                for i, g in zip(idx, self._gather_group(
                        [parts[i] for i in idx],
                        [self.devices[i] for i in idx])):
                    stage[i] = g
            out = [None] * self.size
            for k in range(chips):
                idx = range(k, self.size, chips)
                for i, g in zip(idx, self._gather_group(
                        [stage[i] for i in idx],
                        [self.devices[i] for i in idx])):
                    out[i] = g
            return out

    def place(self, x, placement: str) -> list:
        """``x`` laid out as ``placement`` names it: ``"sharded"``, slot i
        holds row block i; ``"replicated"``, every slot holds the whole.
        ``x`` is a whole tensor or the per-slot blocks of a sharded one;
        the mesh makes whatever copies the layout needs (a sharded value
        replicated is an all-gather)."""
        if placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}; got {placement!r}")
        if placement == "sharded":
            if isinstance(x, torch.Tensor):
                return self.shard(x)
            return [q.to(d) for q, d in zip(x, self.devices)]
        with named_scope("collective.replicate"):
            if isinstance(x, torch.Tensor):
                return [x.to(d) for d in self.devices]
            return self._gather_group(x, self.devices)

    def ppermute(self, window: Sequence) -> list:
        """One ring round: slot i receives slot ``(i - 1) mod p``'s window
        (a tuple of tensors per slot)."""
        p = self.size
        with named_scope("collective.ppermute"):
            return [tuple(a.to(self.devices[i]) for a in window[(i - 1) % p])
                    for i in range(p)]


def _cat(parts: Sequence, device, dim: int = 0):
    """``parts`` concatenated (along ``dim``) on ``device``; parts that are
    tuples of tensors concatenate entry by entry into a tuple (a mesh moves
    several tensors in one collective)."""
    if isinstance(parts[0], tuple):
        return tuple(_cat(ps, device, dim) for ps in zip(*parts))
    return torch.cat([q.to(device) for q in parts], dim=dim)


def _as_mesh(devices):
    """A ready mesh as it is, a device list as a :class:`DeviceMesh`."""
    return devices if isinstance(devices, (DeviceMesh, ProcessMesh)) \
        else DeviceMesh(devices)


def make_batch_mesh(devices):
    """1-D ``("batch",)`` mesh over ``devices`` (a device list or a ready
    mesh, viewed anew as the same kind) for ensembles sharded by member:
    slot i holds the i-th of ``size`` equal member chunks (``sim.ensemble``
    pads the batch to a multiple)."""
    mesh = _as_mesh(devices)
    return mesh.reshape((mesh.size,), ("batch",))


def make_fused_mesh(devices, *, mesh_shape: Sequence[int]):
    """2-D ``("batch", "dev")`` mesh fusing ensemble and domain
    parallelism over ``devices`` (a device list or a ready mesh, viewed
    anew as the same kind): ``mesh_shape = (bdev, p)``, slot ``i * p + k``
    holding member chunk ``i`` and row chunk ``k``.  The slot count must
    equal ``bdev * p`` exactly: a remainder would drop devices silently."""
    bdev, p = (int(x) for x in mesh_shape)
    if bdev < 1 or p < 1:
        raise ValueError(f"mesh_shape extents must be >= 1; got {mesh_shape}")
    mesh = _as_mesh(devices)
    if bdev * p != mesh.size:
        raise ValueError(f"mesh_shape {bdev}x{p} needs {bdev * p} devices; "
                         f"got {mesh.size}")
    return mesh.reshape((bdev, p), ("batch", "dev"))


def make_mesh(strategy: str, devices, chips_per_card: int = 2):
    """The strategy's view of ``devices``, a device list or a ready mesh (a
    :class:`DeviceMesh` or a :class:`ProcessMesh`, viewed anew as the same
    kind): ``("card", "chip")`` for two_level (``ValueError`` when the
    count is not a multiple of ``chips_per_card``), 1-D ``("dev",)``
    otherwise."""
    mesh = _as_mesh(devices)
    p = mesh.size
    if strategy == "two_level":
        if p % chips_per_card:
            raise ValueError(f"{p} devices not divisible by {chips_per_card=}")
        return mesh.reshape((p // chips_per_card, chips_per_card),
                            ("card", "chip"))
    return mesh.reshape((p,), ("dev",))


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows(x, n_pad: int, value=0, dim: int = 0):
    """``x`` with rows appended along ``dim`` up to ``n_pad`` (filled with
    ``value``)."""
    extra = n_pad - x.shape[dim]
    return torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 1 - dim) + (0, extra), value=value)


def _pad_particles(pos, vel, mass, n_pad: int):
    # zero mass => zero contribution as a source
    return _pad_rows(pos, n_pad), _pad_rows(vel, n_pad), _pad_rows(mass, n_pad)


def _force_kw(block_i, block_j, eps, dtype):
    # passed straight into the ops rect wrappers, so the precision axis
    # rides with the tile shape and softening everywhere a strategy
    # launches a kernel
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"the strategies run dtype 'fp32' or 'mixed' (fp64, the golden "
            f"oracle, runs under strategy='single' only); got {dtype!r}")
    return dict(eps=eps, block_i=block_i, block_j=block_j, dtype=dtype)


def _unzip(per_slot) -> tuple:
    """Per-slot tuples -> a tuple of per-slot lists."""
    return tuple(list(x) for x in zip(*per_slot))


def _check_args(strategy, ring_mode):
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    if ring_mode not in RING_MODES:
        raise ValueError(
            f"ring_mode must be one of {RING_MODES}; got {ring_mode!r}")


def make_strategy_evaluator(
    strategy: str,
    *,
    devices: Optional[Sequence] = None,
    mesh=None,
    chips_per_card: int = 2,
    eps: float = 1e-7,
    order: int = 6,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    dtype: str = "fp32",
    ring_mode: str = "overlap",
) -> Evaluator:
    """Build an ``Evaluator`` that distributes the evaluation over devices.

    ``devices`` is the mesh's device list, one per shard (``None``: every
    visible card, :func:`mesh_devices`); a card may appear several times.
    ``mesh`` is a ready :class:`DeviceMesh` or :class:`ProcessMesh`
    instead (exclusive with ``devices``).  The evaluator takes whole (N,
    ...) tensors on any device, shards them over the mesh and returns the
    whole float32 ``Evaluation`` on the inputs' device (on every rank of a
    process mesh).

    ``dtype`` is the kernel precision axis (``"fp32"`` or ``"mixed"``); the
    strategies keep float32 state and collectives either way.
    ``ring_mode`` selects the ring's shift schedule (:data:`RING_MODES`);
    both give the same bits.

    It is the all-ones-mask case of :func:`make_strategy_block_evaluator`
    (``compaction="none"``), as ``core.evaluate.make_evaluator`` is of the
    single-device block evaluator: the blended snap-source acceleration is
    the fresh pass-1 value everywhere, so the zero ``acc_pred`` is never
    read.
    """
    block_eval = make_strategy_block_evaluator(
        strategy, devices=devices, mesh=mesh,
        chips_per_card=chips_per_card, eps=eps,
        order=order, block_i=block_i, block_j=block_j, dtype=dtype,
        ring_mode=ring_mode)

    def evaluate(pos, vel, mass) -> Evaluation:
        mask = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
        ev, _ = block_eval(pos, vel, torch.zeros_like(pos), mass, mask)
        return ev

    return evaluate


# --------------------------------------------------------------------------
# the ring's systolic source shifts
# --------------------------------------------------------------------------
def _ring_shift(mesh: DeviceMesh):
    """One systolic shift round of every slot's source window, counted in
    the ``ring.shifts_issued`` metric of the current registry: the count of
    rounds issued, which pins the schedule (``2 (p - 1)`` per overlap
    evaluation, ``2 p`` per sync one)."""

    def shift(window):
        obs_metrics.registry().counter(
            "ring.shifts_issued", unit="rounds",
            help="source-shift ppermute rounds issued by the ring",
        ).inc()
        return mesh.ppermute(window)

    return shift


def _ring_sweep(p, shift, ring_mode, init, src, compute):
    """Accumulate ``compute(window)`` over the ``p`` ring positions of the
    source window ``src`` (per slot a tuple of tensors, hopping one slot a
    round); returns the per-slot accumulated output tuples.

    Slot i meets source shard ``(i - k) mod p`` at round ``k``, and the
    round outputs are added in round order, in float32 (in mixed mode each
    launch has already folded its own compensation).  ``overlap`` puts
    round ``k + 1``'s window in flight before round ``k``'s kernels and
    issues no shift after the last round: ``p - 1`` rounds per pass.
    ``sync`` shifts after computing, ``p`` rounds per pass, the last
    shifted window never read.  The additions are the same, so the two
    give the same bits.
    """

    def add(acc, out):
        return [tuple(x + o for x, o in zip(a, b)) for a, b in zip(acc, out)]

    acc, win = init, src
    if ring_mode == "sync":
        for _ in range(p):
            acc = add(acc, compute(win))
            win = shift(win)
        return acc
    for k in range(p):
        nxt = shift(win) if k + 1 < p else None
        acc = add(acc, compute(win))
        if nxt is not None:
            win = nxt
    return acc


# --------------------------------------------------------------------------
# compaction-aware block evaluators (shard-local active-target gathering)
# --------------------------------------------------------------------------
# Each shard holds N/P target rows and an activity mask over them; with
# compaction="gather" it gathers its *local* active targets into a dense
# block-aligned window and launches ceil(cap_local/BI) x N/BJ tiles instead
# of (N/P)/BI x N/BJ.  The reference picks each shard's capacity bucket on
# the device with lax.switch and hoists every collective out of the switch,
# so shards may take different buckets while running one collective
# sequence.  A CUDA launch needs its extent on the host, so here the bucket
# comes from a host-side per-shard bound (the engine's analytic occupancy
# bound, or one read of the measured counts); the collectives stay outside
# the per-shard launches all the same.
#
# The reference's invariant is kept as it is: the window of the LARGEST
# local capacity is gathered once, the kernels run on the chosen cap's
# prefix of it and their outputs are zero-padded back to the window, and one
# scatter follows.  Rows past the chosen cap are inactive whenever the bound
# holds the active count, so their output is exactly the masked result.
#
# Every helper below takes one shard's rows ((n_local, ...) leaves) or a
# shard's local members ((b, n_local, ...) leaves, the fused mesh): the
# members then go through one launch per pass, on the kernels' batch axis.


def _shard_plan(n_local: int, n_sources: int, kw, n_passes: int):
    """The local plan a shard builds from its own shapes: equal to
    ``global_plan.shard(P)`` of the host-side plan."""
    return ops.CapacityPlan(n_local, n_sources, kw["block_i"], kw["block_j"],
                            n_passes=n_passes, dtype=kw["dtype"])


def _plan_tiles(plan, compaction: str, bounds: Sequence) -> list:
    """The tiles every shard enqueues, from the host-side bounds alone (no
    collective): the gather bucket's, or the dense extent's."""
    if compaction == "gather":
        return [plan.tiles(_shard_bucket(plan, b)) for b in bounds]
    return [plan.dense_tiles] * len(bounds)


def _shard_bucket(plan, bound) -> int:
    """Bucket index from a shard's host-side active-count bound: one int,
    or the bounds of the shard's local members, which share one launch and
    so the bucket of their max (``evaluate.shared_cap_index`` on host
    ints).  Clamped to the local extent: an over-wide bound lands on the
    full-window bucket."""
    return int(shared_cap_index(plan, bound))


def _window_launch(cap: int, launch, window, extra=()):
    """``launch`` on the first ``cap`` rows of the pre-gathered ``window``,
    each output zero-padded back to the window's extent (the reference's
    ``_window_switch`` with the branch chosen on the host).  The row axis
    is the positions' second to last."""
    ax = window[0].dim() - 2
    w = window[0].shape[ax]
    c = min(cap, w)
    outs = launch(tuple(x.narrow(ax, 0, c) for x in window), *extra)
    if not isinstance(outs, tuple):
        outs = (outs,)
    padded = tuple(_pad_rows(o, w, dim=ax) for o in outs)
    return padded if len(padded) > 1 else padded[0]


def _local_perm(mask):
    """Active rows first, in row order (a stable argsort of the inactive
    flag)."""
    return torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)


def _shard_pass1(pos, vel, ap, mask, perm, cap, plan, kw, src, order):
    """Pass 1 on the compacted local targets; returns the scattered (acc,
    jerk, pot) and the blended snap source operand (fresh acc on active
    rows, predicted elsewhere), blended through the window only."""
    n_local = pos.shape[-2]
    cap_max = plan.caps[-1]
    window = ops.compact_targets(perm, cap_max, pos, vel, mask)
    m_w = window[2]

    def launch(win, gp, gv, gm):
        p_c, v_c, m_c = win
        return ops.acc_jerk_pot_rect(p_c, v_c, gp, gv, gm, mask_t=m_c, **kw)

    a_w, j_w, pt_w = _window_launch(cap, launch, window, src)
    acc, jerk, pot = ops.scatter_outputs(perm, cap_max, n_local,
                                         a_w, j_w, pt_w)
    acc_s = ops.scatter_sources(perm, cap_max, ap, a_w, m_w) \
        if order >= 6 else ap
    return acc, jerk, pot, acc_s


def _shard_pass2(pos, vel, acc, mask, perm, cap, plan, kw, src, ga):
    """Snap pass on the compacted local targets (pass 1's bucket); ``ga``
    is the gathered blended source acceleration."""
    gp, gv, gm = src
    n_local = pos.shape[-2]
    cap_max = plan.caps[-1]
    window = ops.compact_targets(perm, cap_max, pos, vel, acc, mask)

    def launch(win, gp, gv, ga, gm):
        p_c, v_c, a_c, m_c = win
        return ops.snap_rect(p_c, v_c, a_c, gp, gv, ga, gm,
                             mask_t=m_c, **kw)

    s_w = _window_launch(cap, launch, window, (gp, gv, ga, gm))
    (snp,) = ops.scatter_outputs(perm, cap_max, n_local, s_w)
    return snp


def _dense_pass1(pos, vel, ap, mask, kw, src, order):
    """The ``compaction="none"`` baseline: the masked full-local-extent
    launch (blocks with no active target skip their work)."""
    gp, gv, gm = src
    acc, jerk, pot = ops.acc_jerk_pot_rect(pos, vel, gp, gv, gm,
                                           mask_t=mask, **kw)
    acc_s = torch.where(mask[..., None], acc, ap) if order >= 6 else ap
    return acc, jerk, pot, acc_s


def _shard_block_body(pos, vel, ap, mask, bound, src, *, kw, order,
                      compaction, n_passes):
    """Pass 1 of one shard against resident sources.

    ``bound`` is the shard's host-side active-count bound, or its local
    members' bounds (gather only).  Returns ``(acc, jerk, pot, acc_s,
    compacted)`` in the local layout: ``compacted`` carries pass 1's
    permutation and bucket to the snap pass (:func:`_resident_snap`).
    """
    plan = _shard_plan(pos.shape[-2], src[0].shape[-2], kw, n_passes)
    if compaction == "gather":
        perm = _local_perm(mask)
        cap = plan.caps[_shard_bucket(plan, bound)]
        acc, jerk, pot, acc_s = _shard_pass1(pos, vel, ap, mask, perm, cap,
                                             plan, kw, src, order)
        return acc, jerk, pot, acc_s, (perm, cap, plan)
    acc, jerk, pot, acc_s = _dense_pass1(pos, vel, ap, mask, kw, src, order)
    return acc, jerk, pot, acc_s, None


def _resident_snap(pos, vel, acc, mask, src, ga, compacted, kw):
    """The snap pass for strategies with resident full sources."""
    if compacted is not None:
        perm, cap, plan = compacted
        return _shard_pass2(pos, vel, acc, mask, perm, cap, plan, kw, src, ga)
    gp, gv, gm = src
    return ops.snap_rect(pos, vel, acc, gp, gv, ga, gm, mask_t=mask, **kw)


@functools.lru_cache(maxsize=256)
def _tiles_tensor(tiles: tuple, device) -> torch.Tensor:
    """Per-shard tile counts as an int64 tensor on ``device``, made once
    per distinct vector (a tensor made from host data is a copy)."""
    return torch.tensor(tiles, dtype=torch.int64, device=device)


def _wrap_block(mesh: DeviceMesh, compaction: str, eval_padded):
    """Pad N (and the activity mask and predicted acc) to a device multiple,
    evaluate, slice back.  Padding rows carry mask False (never gathered as
    targets) and m = 0 (invisible as sources).

    ``n_bound`` (optional, ``P`` host ints or a ``(P,)`` tensor) bounds each
    shard's active count for the gather bucket: the block engine passes the
    analytic ``hermite.block_level_occupancy`` bound over each shard's
    contiguous row chunk.  ``None`` measures the per-shard mask sums in one
    read to the host, which picks the same bucket (the bound is exact for a
    schedule-consistent carry).  ``compaction="none"`` reads nothing."""
    p = mesh.size

    def evaluate(pos, vel, acc_pred, mass, mask_t, n_bound=None):
        n = pos.shape[0]
        n_pad = _round_up(n, p)
        f32 = torch.float32
        pp, vp, mp = _pad_particles(pos.to(f32), vel.to(f32), mass.to(f32),
                                    n_pad)
        app = _pad_rows(acc_pred.to(f32), n_pad)
        mk = _pad_rows(mask_t.to(torch.bool), n_pad, value=False)
        bound = None
        if compaction == "gather":
            if n_bound is None:
                bound = mk.reshape(p, -1).sum(dim=1).tolist()
            else:
                bound = [int(b) for b in (
                    n_bound.tolist() if isinstance(n_bound, torch.Tensor)
                    else n_bound)]
                if len(bound) != p:
                    raise ValueError(f"n_bound has {len(bound)} entries for "
                                     f"a {p}-device mesh")
        acc, jerk, snp, pot, tiles = eval_padded(pp, vp, app, mp, mk, bound)
        ev = Evaluation(*(o[:n] for o in mesh.unshard(
            list(zip(acc, jerk, snp, pot)), pos.device)))
        return ev, _tiles_tensor(tuple(int(t) for t in tiles), pos.device)

    return evaluate


def make_strategy_block_evaluator(
    strategy: str,
    *,
    devices: Optional[Sequence] = None,
    mesh=None,
    chips_per_card: int = 2,
    eps: float = 1e-7,
    order: int = 6,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    compaction: str = "none",
    dtype: str = "fp32",
    sources: str = "full",
    ring_mode: str = "overlap",
):
    """Distributed active-target evaluator for the block-timestep scheme.

    Signature of the returned callable::

        evaluate(pos, vel, acc_pred, mass, mask_t, n_bound=None) \
            -> (Evaluation, tiles)

    ``mask_t`` is the (N,) target-activity mask; ``acc_pred`` the predicted
    acceleration of every particle (the snap pass's source operand for
    inactive rows).  ``n_bound`` bounds each shard's active count for the
    gather bucket (see :func:`_wrap_block`).  ``tiles`` is the ``(P,)``
    int64 vector of the kernel grid tiles each shard enqueued (both
    passes), on the inputs' device; a process mesh's rank computes every
    shard's from the bounds, which every rank holds.  ``devices`` and
    ``mesh`` are :func:`make_strategy_evaluator`'s.

    With an all-ones mask and ``compaction="none"`` this is the lockstep
    :func:`make_strategy_evaluator` math; ``"gather"`` gives the masked
    dense result of the same strategy bit for bit (each target row is a
    row-local sum over the same source blocks in the same order, whatever
    block it sits in).
    """
    _check_args(strategy, ring_mode)
    if compaction not in COMPACTIONS:
        raise ValueError(
            f"compaction must be one of {COMPACTIONS}; got {compaction!r}")
    if sources not in ("full", "neighbor"):
        raise ValueError(f"sources must be one of ('full', 'neighbor'); "
                         f"got {sources!r}")
    if sources == "neighbor":
        raise ValueError(
            "sources='neighbor' runs on the vmapped ensemble block engine "
            "(strategy='single'); the sharded strategies evaluate full "
            "sources only")
    kw = _force_kw(block_i, block_j, eps, dtype)
    n_passes = 2 if order >= 6 else 1
    if mesh is not None and devices is not None:
        raise ValueError("name the devices or a ready mesh, not both")
    if mesh is None:
        mesh = mesh_devices() if devices is None else list(devices)
    mesh = make_mesh(strategy, mesh, chips_per_card)
    if strategy == "replicated":
        body = _gathered_block(mesh, order, kw, compaction, n_passes,
                               mesh.all_gather)
    elif strategy == "two_level":
        body = _gathered_block(mesh, order, kw, compaction, n_passes,
                               mesh.all_gather2)
    elif strategy == "mesh_sharded":
        body = _mesh_sharded_block(mesh, order, kw, compaction, n_passes)
    else:
        body = _ring_block(mesh, order, kw, compaction, n_passes, ring_mode)
    return _wrap_block(mesh, compaction, body)


def _resident_block(mesh, order, kw, compaction, n_passes, targets, src,
                    gather_acc, ap, bound):
    """Shared body of the resident-source strategies: per-shard pass 1,
    the gather of the blended acc (the one collective between the passes),
    per-shard snap.  ``targets`` is the per-slot (pos, vel, mask) and
    ``src`` the per-slot (gp, gv, gm); ``bound`` names every shard."""
    bounds = bound if bound is not None else [None] * mesh.named
    body = [_shard_block_body(pt, vt, a, mk, b, s, kw=kw, order=order,
                              compaction=compaction, n_passes=n_passes)
            for (pt, vt, mk), a, b, s
            in zip(targets, ap, mesh.local(bounds), src, strict=True)]
    acc, jerk, pot, acc_s, compacted = _unzip(body)
    tiles = _plan_tiles(_shard_plan(targets[0][0].shape[-2],
                                    src[0][0].shape[-2], kw, n_passes),
                        compaction, bounds)
    if order >= 6:
        ga = gather_acc(acc_s)
        snp = [_resident_snap(pt, vt, at, mk, s, g, c, kw)
               for (pt, vt, mk), at, s, g, c
               in zip(targets, acc, src, ga, compacted)]
    else:
        snp = [torch.zeros_like(a) for a in acc]
    return acc, jerk, snp, pot, tiles


def _gathered_block(mesh, order, kw, compaction, n_passes, gather):
    """replicated / two_level: explicit source gathers."""

    def eval_padded(pos, vel, ap, mass, mask, bound):
        pos, vel, ap, mass, mask = (mesh.shard(x)
                                    for x in (pos, vel, ap, mass, mask))
        src = gather(list(zip(pos, vel, mass)))
        return _resident_block(mesh, order, kw, compaction, n_passes,
                               list(zip(pos, vel, mask)), src, gather, ap,
                               bound)

    return eval_padded


def _mesh_sharded_block(mesh, order, kw, compaction, n_passes):
    """Placements only: targets sharded, sources (and the blended acc)
    replicated; the mesh inserts the gathers."""

    def replicate(x):
        return mesh.place(x, "replicated")

    def eval_padded(pos, vel, ap, mass, mask, bound):
        targets = list(zip(*(mesh.place(x, "sharded")
                             for x in (pos, vel, mask))))
        src = list(zip(*(replicate(x) for x in (pos, vel, mass))))
        return _resident_block(mesh, order, kw, compaction, n_passes,
                               targets, src, replicate,
                               mesh.place(ap, "sharded"), bound)

    return eval_padded


def _ring_block(mesh, order, kw, compaction, n_passes, ring_mode):
    """Systolic ring with shard-local compaction: the compacted local
    target window meets every streamed source shard; the per-shard launch
    choice happens inside each round, the shifts outside it."""
    p = mesh.size
    shift = _ring_shift(mesh)

    def eval_padded(pos, vel, ap, mass, mask, bound):
        pos, vel, ap, mass, mask = (mesh.shard(x)
                                    for x in (pos, vel, ap, mass, mask))
        n_local = pos[0].shape[0]
        # each of the n_passes sweeps launches once per streamed shard
        plan = _shard_plan(n_local, n_local, kw, n_passes * p)
        src1 = list(zip(pos, vel, mass))

        if compaction == "gather":
            # the window is gathered ONCE, outside the source loop: the
            # stream rotates sources, the compacted target block stays, and
            # partial sums accumulate in the window layout
            cap_max = plan.caps[-1]
            caps = [plan.caps[_shard_bucket(plan, b)]
                    for b in mesh.local(bound)]
            tiles = _plan_tiles(plan, compaction, bound)
            perm = [_local_perm(mk) for mk in mask]
            window = [ops.compact_targets(pe, cap_max, pt, vt, mk)
                      for pe, pt, vt, mk in zip(perm, pos, vel, mask)]
            zw = [(torch.zeros_like(w[0]), torch.zeros_like(w[0]),
                   torch.zeros_like(w[0][:, 0])) for w in window]

            def launch1(win, sp, sv, sm):
                p_c, v_c, m_c = win
                return ops.acc_jerk_pot_rect(p_c, v_c, sp, sv, sm,
                                             mask_t=m_c, **kw)

            def compute1(srcs):
                return [_window_launch(c, launch1, w, s)
                        for c, w, s in zip(caps, window, srcs, strict=True)]

            a_w, j_w, pt_w = _unzip(_ring_sweep(p, shift, ring_mode, zw,
                                                src1, compute1))
            acc, jerk, pot = _unzip(
                ops.scatter_outputs(pe, cap_max, n_local, a, j, t)
                for pe, a, j, t in zip(perm, a_w, j_w, pt_w))
            if order >= 6:
                # the blended snap-source operand through the window;
                # a_w already holds the summed fresh acc
                acc_s = [ops.scatter_sources(pe, cap_max, a0, a, w[2])
                         for pe, a0, a, w in zip(perm, ap, a_w, window)]
                snap_window = [w[:2] + (a, w[2]) for w, a in zip(window, a_w)]

                def launch2(win, sp, sv, sa, sm):
                    p_c, v_c, a_c, m_c = win
                    return ops.snap_rect(p_c, v_c, a_c, sp, sv, sa, sm,
                                         mask_t=m_c, **kw)

                def compute2(srcs):
                    return [(_window_launch(c, launch2, w, s),)
                            for c, w, s in zip(caps, snap_window, srcs)]

                (s_w,) = _unzip(_ring_sweep(
                    p, shift, ring_mode, [(z[0],) for z in zw],
                    list(zip(pos, vel, acc_s, mass)), compute2))
                snp = [ops.scatter_outputs(pe, cap_max, n_local, s)[0]
                       for pe, s in zip(perm, s_w)]
            else:
                snp = [torch.zeros_like(x) for x in pos]
            return acc, jerk, snp, pot, tiles

        tiles = [plan.dense_tiles] * p
        init = [(torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(m))
                for x, m in zip(pos, mass)]

        def aj(srcs):
            return [ops.acc_jerk_pot_rect(pt, vt, *s, mask_t=mk, **kw)
                    for pt, vt, mk, s in zip(pos, vel, mask, srcs)]

        acc, jerk, pot = _unzip(_ring_sweep(p, shift, ring_mode, init, src1,
                                            aj))
        if order >= 6:
            acc_s = [torch.where(mk[:, None], a, a0)
                     for mk, a, a0 in zip(mask, acc, ap)]

            def sn(srcs):
                return [(ops.snap_rect(pt, vt, at, *s, mask_t=mk, **kw),)
                        for pt, vt, at, mk, s in zip(pos, vel, acc, mask,
                                                     srcs)]

            (snp,) = _unzip(_ring_sweep(
                p, shift, ring_mode, [(torch.zeros_like(x),) for x in pos],
                list(zip(pos, vel, acc_s, mass)), sn))
        else:
            snp = [torch.zeros_like(x) for x in pos]
        return acc, jerk, snp, pot, tiles

    return eval_padded


# --------------------------------------------------------------------------
# fused (batch, dev) block evaluator: B ensemble members x P domain shards
# --------------------------------------------------------------------------
def _wrap_fused_block(mesh: DeviceMesh, compaction: str, eval_padded):
    """Pad each member's N to a shard multiple, evaluate, slice back.

    The batch axis is the engine's to pad (``sim.ensemble._pad_batch``
    repeats the first run): a batch that is not a multiple of the batch
    extent is the caller's fault here and raises, it is never padded over
    with duplicated physics.  ``n_bound`` (optional, ``(B, P)`` host ints
    or a tensor) bounds each member's active count on each domain shard
    (the engine's analytic occupancy bound); ``None`` measures the masks in
    one read to the host.  Returns ``(Evaluation, tiles)``, ``tiles`` the
    ``(B, P)`` int64 tiles each member enqueued on each domain shard (both
    passes; the shard's local members share its launches).

    On a :class:`ProcessMesh` rank the operands, the bounds, the outputs
    and the tiles are those of this rank's batch row only: the members it
    holds."""
    bdev, p = mesh.shape
    rows = mesh.named // p   # the batch rows the caller holds

    def evaluate(pos, vel, acc_pred, mass, mask_t, n_bound=None):
        b, n = pos.shape[0], pos.shape[1]
        if b % rows:
            raise ValueError(
                f"batch size {b} not divisible by the mesh's batch extent "
                f"{rows}; pad the batch first (sim.ensemble._pad_batch)")
        bl = b // rows
        if bl > nbody_force.MAX_BATCH:
            raise ValueError(
                f"{bl} members per shard exceed the {nbody_force.MAX_BATCH} "
                "one launch takes (gridDim.y)")
        n_pad = _round_up(n, p)
        f32 = torch.float32
        pp, vp, app = (_pad_rows(x.to(f32), n_pad, dim=1)
                       for x in (pos, vel, acc_pred))
        mp = _pad_rows(mass.to(f32), n_pad, dim=1)
        mk = _pad_rows(mask_t.to(torch.bool), n_pad, value=False, dim=1)
        bound = None
        if compaction == "gather":
            if n_bound is None:
                counts = mk.reshape(b, p, -1).sum(dim=2).tolist()
            else:
                counts = (n_bound.tolist()
                          if isinstance(n_bound, torch.Tensor)
                          else [list(r) for r in n_bound])
                if len(counts) != b or any(len(r) != p for r in counts):
                    raise ValueError(
                        f"n_bound must be ({b}, {p}) for a {b}-member batch "
                        f"on a {bdev}x{p} mesh")
            # slot (i, k): the bounds of its local members on shard k
            bound = [[int(counts[m][k]) for m in range(i * bl, (i + 1) * bl)]
                     for i in range(rows) for k in range(p)]
        acc, jerk, snp, pot, tiles = eval_padded(pp, vp, app, mp, mk, bound)
        ev = Evaluation(*(o[:, :n] for o in mesh.unshard2(
            list(zip(acc, jerk, snp, pot)), pos.device)))
        per_member = tuple(tuple(int(tiles[i * p + k]) for k in range(p))
                           for i in range(rows) for _ in range(bl))
        return ev, _tiles_tensor(per_member, pos.device)

    return evaluate


def _fused_block(mesh: DeviceMesh, order, kw, compaction, n_passes):
    """The fused mesh's body: each slot holds its local members' ``N/p``
    target rows and sweeps their full source sets, gathered along ``dev``
    (the mesh_sharded placements of one batch row; nothing crosses
    ``batch``).  Per slot and pass ONE launch serves the local members, and
    under gather they share one capacity bucket (:func:`_shard_bucket` over
    their bounds); the blended snap-source acceleration is the one
    collective between the passes, as in :func:`_resident_block`."""

    def eval_padded(pos, vel, ap, mass, mask, bound):
        pos, vel, ap, mass, mask = (mesh.shard2(x)
                                    for x in (pos, vel, ap, mass, mask))
        src = mesh.all_gather_dev(list(zip(pos, vel, mass)))
        return _resident_block(mesh, order, kw, compaction, n_passes,
                               list(zip(pos, vel, mask)), src,
                               mesh.all_gather_dev, ap, bound)

    return eval_padded


def make_fused_block_evaluator(
    mesh_shape: Sequence[int],
    *,
    devices: Optional[Sequence] = None,
    mesh=None,
    eps: float = 1e-7,
    order: int = 6,
    block_i: int = nbody_force.DEFAULT_BLOCK_I,
    block_j: int = nbody_force.DEFAULT_BLOCK_J,
    compaction: str = "none",
    dtype: str = "fp32",
):
    """Batched active-target evaluator over a fused ``(batch, dev)`` mesh.

    ``mesh_shape = (bdev, p)`` over ``devices`` (``bdev * p`` of them; a
    card may appear several times, ``None``: every visible card): the
    batch is sharded ``bdev`` ways and each member's particle domain ``p``
    ways, the 2-D composition of the ensemble's batch layout with the
    ``mesh_sharded`` strategy, which lets a serving pod hold several
    large-N members on one device group.  ``mesh`` is a ready
    :class:`DeviceMesh` or this rank's :class:`ProcessMesh` instead
    (exclusive with ``devices``); on a rank the evaluator takes and gives
    the members of the rank's batch row.

    Signature of the returned callable::

        evaluate(pos, vel, acc_pred, mass, mask_t, n_bound=None) \\
            -> (Evaluation, tiles)

    Every operand carries the leading ``(B,)`` batch axis; ``n_bound`` and
    ``tiles`` are ``(B, P)`` (see :func:`_wrap_fused_block`).  Each target
    row is a row-local sum over its member's full source set in source
    order, whatever slot or launch it sits in, so the result equals the
    member's 1-D batch layout evaluation and its ``mesh_sharded`` strategy
    evaluation; ``compaction="gather"`` gives ``"none"``'s bits.
    """
    if compaction not in COMPACTIONS:
        raise ValueError(
            f"compaction must be one of {COMPACTIONS}; got {compaction!r}")
    kw = _force_kw(block_i, block_j, eps, dtype)
    n_passes = 2 if order >= 6 else 1
    if mesh is not None and devices is not None:
        raise ValueError("name the devices or a ready mesh, not both")
    if mesh is None:
        mesh = mesh_devices() if devices is None else list(devices)
    mesh = make_fused_mesh(mesh, mesh_shape=mesh_shape)
    return _wrap_fused_block(mesh, compaction,
                             _fused_block(mesh, order, kw, compaction,
                                          n_passes))
