"""A device mesh of processes: one OS process per shard over
``torch.distributed``.

The reference's strategies are SPMD programs: ``shard_map`` runs one body
per device and the devices meet in ``all_gather``, ``ppermute`` and
``psum``.  :class:`repro_torch.core.strategies.DeviceMesh` keeps the
reference's single controller, one process making every cross-device copy.
:class:`ProcessMesh` is the SPMD form: each rank runs the same program and
holds only its own slot, and the collectives are ``torch.distributed``
calls.  It has ``DeviceMesh``'s interface, so the strategies' evaluators
run on either unchanged, and a rank's result equals the in-process mesh's
bit for bit: every collective only moves blocks, and the blocks meet in
slot order.

Per-slot lists hold one entry, this rank's slot; :meth:`ProcessMesh.local`
picks this rank's entry of a list that names every shard (the gather
bounds of a block evaluation), where ``DeviceMesh.local`` is the identity.

**The batch views.**  An ensemble's layouts view the ranks as the 1-D
``("batch",)`` mesh (rank r holds member chunk r of the padded batch) or
the fused ``("batch", "dev")`` grid (rank ``i * p + k`` is slot ``(i, k)``:
it holds batch row i's members and evaluates their k-th of p row chunks).
A rank holds only its own row's members: ``shard2``/``unshard2``/
``all_gather_dev`` take and give that row's ``(b, N, ...)`` tensors and
meet the row's ranks only, and a per-shard list on the fused view names the
row's p shards.  :meth:`ProcessMesh.local_rows` and
:meth:`ProcessMesh.gather_rows` cut a whole batch to this rank's rows and
bring the rows back whole; :meth:`ProcessMesh.agree` is the one small
collective that stands where one process reads a decision to the host.

**The backend is the caller's to name; the mesh never picks one.**

* ``nccl`` sends CUDA tensors directly and needs one card per rank (rank r
  on ``cuda:r``): a world larger than the visible cards raises
  ``ValueError`` before ``init_process_group`` (NCCL refuses two ranks on
  one card).
* ``gloo`` sends CPU tensors as they are.  CUDA tensors it stages through
  host memory here, in the mesh's own code: each is copied to the host,
  sent, and copied back to its card (gloo's point-to-point calls do not
  take device memory).  That is how several ranks share one card.  The
  functional all-gather that ``DTensor`` issues crashes its rank on CUDA
  tensors under gloo (torch 2.11 on the H100 machine, where the plain
  ``all_gather_into_tensor`` works); :func:`stage_functional_all_gather`
  replaces its CUDA kernel by the same staging.

:func:`spawn` starts the ranks (``torch.multiprocessing``, a ``file://``
store in a fresh temporary directory: no port is fixed, so concurrent
runs cannot collide) and rank 0 prints the transport.  A rank function
must be importable by name, as every spawned child imports it afresh.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.nbody import resolve_device
from repro_torch.obs.trace import named_scope

BACKENDS = ("nccl", "gloo")
#: a collective that waits this long raises in its rank (a rank that died
#: leaves its peers waiting); ``spawn`` and ``single_rank_group`` take
#: another per call
TIMEOUT_S = 600.0


def transport(backend: str, device) -> str:
    """How a collective's bytes travel for ``backend`` and tensors on
    ``device``."""
    dev = torch.device(device)
    if backend == "nccl":
        return "nccl, card to card"
    if dev.type == "cuda":
        return f"gloo, staged through host memory from {dev}"
    return "gloo, host memory"


def check_backend(backend: str, world: int, device) -> None:
    """Refuse a backend that cannot serve ``world`` ranks on ``device``,
    before any process group exists; ``cuda`` without a card raises as
    ``nbody.resolve_device`` does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if int(world) < 1:
        raise ValueError(f"a mesh needs at least one rank; got {world}")
    dev = torch.device(device)
    if backend != "nccl":
        resolve_device(dev)
        return
    if dev.type != "cuda":
        raise ValueError(f"nccl sends CUDA tensors; got device {dev} (name "
                         "gloo for ranks on the CPU)")
    visible = torch.cuda.device_count()
    if world > visible:
        raise ValueError(
            f"nccl needs one card per rank: {world} ranks, {visible} cards "
            "visible (NCCL refuses two ranks on one card; name gloo to run "
            "several ranks on one card through host memory)")
    if dev.index is not None and world > 1:
        raise ValueError(f"nccl puts rank r on cuda:r; name the device "
                         f"'cuda', not {dev}")


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cpu`` as named; ``cuda`` without an index
    is card ``rank mod visible`` (``cuda:r`` under nccl, every rank on
    ``cuda:0`` of a one-card host under gloo); ``cuda:i`` pins every rank
    to card i."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class ProcessMesh:
    """This rank's view of a mesh of ``world`` processes, one slot each.

    Built after ``init_process_group``; ``backend`` must be the group's.
    ``shape`` views the ranks as a 1-D mesh (``("dev",)``, or the batch
    layout's ``("batch",)``) or a 2-D grid: two_level's ``("card",
    "chip")`` or the fused ``("batch", "dev")``, rank ``row * cols + col``.
    A grid's sub-groups are made here, every group on every rank in one
    order, as ``dist.new_group`` requires: the rows' (a card's chips, a
    batch row's domain shards) and the columns'.  ``device`` is where this
    rank's slot lives.  Views of one mesh (:meth:`reshape`) are made once
    and shared, so a view is one object however often it is asked for.
    A mesh hashes by identity: an engine cached under it is never handed
    to a mesh of another process group.

    ``ProcessMesh.collectives`` counts the collectives this process issued
    (each ``torch.distributed`` call), for a reading per event.
    """

    collectives = 0

    def __init__(self, backend: str, *, shape: Optional[tuple] = None,
                 axis_names: tuple = ("dev",), device, _views=None):
        if not dist.is_initialized():
            raise RuntimeError("a ProcessMesh is built after "
                               "torch.distributed.init_process_group")
        if backend != dist.get_backend():
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()!r}, not {backend!r}")
        self.backend = backend
        self.device = torch.device(device)
        check_backend(backend, 1, self.device)
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.shape = tuple(shape) if shape else (self.size,)
        self.axis_names = tuple(axis_names)
        prod = 1
        for e in self.shape:
            prod *= e
        if prod != self.size or len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} over "
                             f"{self.axis_names} does not tile "
                             f"{self.size} ranks")
        self.transport = transport(backend, self.device)
        # host staging: gloo's send/recv would read a device pointer as
        # host memory
        self._staged = backend == "gloo" and self.device.type == "cuda"
        self._cols = self.shape[1] if len(self.shape) == 2 else 1
        self._row = self._col = None
        if len(self.shape) == 2:
            rows, cols = self.shape
            row_groups = [dist.new_group(list(range(r * cols, (r + 1) * cols)))
                          for r in range(rows)]
            col_groups = [dist.new_group(list(range(k, self.size, cols)))
                          for k in range(cols)]
            self._row = row_groups[self.rank // cols]
            self._col = col_groups[self.rank % cols]
        self._views = {} if _views is None else _views
        self._views.setdefault((self.shape, self.axis_names), self)

    def reshape(self, shape: tuple, axis_names: tuple) -> "ProcessMesh":
        """The same ranks under another view, made once per view (a
        collective when it makes sub-groups: every rank calls it)."""
        key = (tuple(shape), tuple(axis_names))
        if key not in self._views:
            ProcessMesh(self.backend, shape=shape, axis_names=axis_names,
                        device=self.device, _views=self._views)
        return self._views[key]

    @property
    def fused(self) -> bool:
        return self.axis_names == ("batch", "dev")

    @property
    def named(self) -> int:
        """How many shards a per-shard list names: every rank, or on the
        fused view this rank's batch row's ``p``."""
        return self._cols if self.fused else self.size

    def local(self, seq: Sequence) -> list:
        """This rank's entry of a per-shard list (:attr:`named` entries)."""
        if len(seq) != self.named:
            raise ValueError(f"{len(seq)} entries for the {self.named} "
                             f"shards of a {self.shape} mesh")
        return [seq[self.rank % self._cols if self.fused else self.rank]]

    # -- the batch rows of the ("batch",) and ("batch", "dev") views -------
    @property
    def row(self) -> int:
        """The batch row (member chunk) this rank holds."""
        return self.rank // self._cols

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's member chunk of a whole batch (B a multiple of the
        batch extent)."""
        return x.chunk(self.shape[0])[self.row]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every row's member chunk concatenated in batch order on this
        rank's device: over every rank on the 1-D view, over this rank's
        column (one rank of each row) on the fused one."""
        return self._gather(x, self._col)

    # -- the wire ----------------------------------------------------------
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        return (x.cpu() if self._staged else x).contiguous()

    def _gather(self, x, group=None, dim: int = 0):
        """``x`` of every rank of ``group`` concatenated in rank order
        (along ``dim``) on this rank's device.  ``x`` may be a tuple of
        tensors: they travel packed, in one collective (and one staging
        copy each way), and come back as a tuple."""
        xs = x if isinstance(x, tuple) else (x,)
        w = self._wire(_pack(xs))
        world = dist.get_world_size(group)
        parts = [torch.empty_like(w) for _ in range(world)]
        dist.all_gather(parts, w, group=group)
        ProcessMesh.collectives += 1
        got = [_unpack(q, xs) for q in torch.cat(parts).to(
            self.device).chunk(world)]
        out = tuple(torch.cat(ts, dim=dim) for ts in zip(*got))
        return out if isinstance(x, tuple) else out[0]

    def agree(self, x: torch.Tensor) -> list:
        """The elementwise max of the integer vector ``x`` over every rank,
        on the host: one all-reduce, where one process reads its decisions
        with one copy to the host (a rank that decided alone would leave
        its peers waiting, or launch at another extent)."""
        w = x.detach().reshape(-1).to(
            "cpu" if self.backend == "gloo" else x.device, torch.int64,
            copy=True)
        dist.all_reduce(w, op=dist.ReduceOp.MAX)
        ProcessMesh.collectives += 1
        return w.tolist()

    # -- DeviceMesh's interface -------------------------------------------
    def shard(self, x: torch.Tensor) -> list:
        """This rank's block of ``x``'s rows (``size`` equal blocks)."""
        return [x.chunk(self.size)[self.rank].to(self.device)]

    def unshard(self, parts: Sequence, device) -> torch.Tensor:
        """Every rank's block concatenated in slot order on ``device``."""
        (part,) = parts
        return _to(self._gather(part), device)

    def all_gather(self, parts: Sequence) -> list:
        """Tiled all-gather over the whole mesh."""
        (part,) = parts
        with named_scope("collective.all_gather"):
            return [self._gather(part)]

    def all_gather2(self, parts: Sequence) -> list:
        """Two-stage gather over the ``("card", "chip")`` view: within this
        rank's card first, then across cards among the ranks of its chip
        index; the source order is the 1-D gather's."""
        if self._row is None:
            raise ValueError("all_gather2 needs a ('card', 'chip') mesh")
        (part,) = parts
        with named_scope("collective.all_gather2"):
            return [self._gather(self._gather(part, self._row), self._col)]

    # -- the fused ("batch", "dev") grid: this rank's batch row only --------
    def shard2(self, x: torch.Tensor) -> list:
        """This slot's block of its row's members ``x`` (``(b, N, ...)``):
        row chunk ``k`` of ``p``."""
        return [x.chunk(self._cols, dim=1)[self.rank % self._cols].to(
            self.device)]

    def unshard2(self, parts: Sequence, device) -> torch.Tensor:
        """The row's blocks reassembled along the particle axis: the row's
        members whole, on ``device``."""
        (part,) = parts
        return _to(self._gather(part, self._row, dim=1), device)

    def all_gather_dev(self, parts: Sequence) -> list:
        """All-gather along ``dev`` only: the row's blocks concatenated
        along the particle axis; nothing crosses ``batch``."""
        (part,) = parts
        with named_scope("collective.all_gather_dev"):
            return [self._gather(part, self._row, dim=1)]

    def place(self, x, placement: str) -> list:
        """``x`` (the whole tensor, or this rank's block of a sharded one)
        laid out as ``placement`` names it: ``"sharded"``, this rank's row
        block; ``"replicated"``, the whole, gathered when ``x`` is a
        block."""
        if placement not in ("sharded", "replicated"):
            raise ValueError(f"placement must be 'sharded' or 'replicated'; "
                             f"got {placement!r}")
        if placement == "sharded":
            if isinstance(x, torch.Tensor):
                return self.shard(x)
            return [q.to(self.device) for q in x]
        with named_scope("collective.replicate"):
            if isinstance(x, torch.Tensor):
                return [x.to(self.device)]
            (part,) = x
            return [self._gather(part)]

    def ppermute(self, window: Sequence) -> list:
        """One ring round: this rank sends its window (a tuple of tensors)
        to rank ``r + 1`` and receives rank ``r - 1``'s, all sends and
        receives posted in one batch (blocking pairs around a ring
        deadlock)."""
        (win,) = window
        p = self.size
        with named_scope("collective.ppermute"):
            if p == 1:
                return [tuple(a.to(self.device) for a in win)]
            # the window travels packed: one message and one staging copy
            # each way
            send = self._wire(_pack(win))
            recv = torch.empty_like(send)
            nxt, prv = (self.rank + 1) % p, (self.rank - 1) % p
            ops = [dist.P2POp(dist.isend, send, nxt),
                   dist.P2POp(dist.irecv, recv, prv)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            ProcessMesh.collectives += 1
            return [tuple(_unpack(recv.to(self.device), win))]


def _to(x, device):
    """A tensor, or each of a tuple's, on ``device``."""
    return tuple(t.to(device) for t in x) if isinstance(x, tuple) \
        else x.to(device)


def _pack(xs) -> torch.Tensor:
    """The tensors ``xs`` as one byte buffer on their device, each one's
    bytes padded to a multiple of 8 so that every view :func:`_unpack`
    takes keeps its alignment."""
    out = []
    for t in xs:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        out.append(torch.nn.functional.pad(b, (0, -b.numel() % 8)))
    return torch.cat(out)


def _unpack(buf: torch.Tensor, like) -> list:
    """:func:`_pack`'s inverse: views of ``buf`` with the dtypes and shapes
    of the tensors ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf.narrow(0, off, n).view(t.dtype).view(t.shape))
        off += n + (-n % 8)
    return out


_STAGED: dict = {}


def _all_gather_staged(inp, group_size, group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name)
    host = inp.cpu().contiguous()
    out = host.new_empty((group_size * host.shape[0],) + host.shape[1:])
    dist.all_gather_into_tensor(out, host, group=group)
    _all_gather_staged.calls += 1
    return out.to(inp.device)


_all_gather_staged.calls = 0


def stage_functional_all_gather(dispatch_key: str = "CUDA") -> None:
    """Route ``_c10d_functional.all_gather_into_tensor`` on CUDA tensors
    (what ``DTensor`` gathers a shard with) through host memory and the
    plain gloo all-gather, for ranks that share a card under gloo.  The
    result is complete when the op returns; its ``wait_tensor`` finds no
    work to wait for.  Process-wide, once per process and key: the CPU
    tests and ``gloo_cuda_probe.py`` register it for ``"CPU"`` to run the
    same code on the CPU."""
    if dispatch_key in _STAGED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather_staged, dispatch_key)
    _STAGED[dispatch_key] = lib   # the kernel lives as long as the library


def all_reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` with ``op``, returned on ``x``'s device
    (through host memory for CUDA tensors under gloo, as the mesh
    stages them)."""
    if dist.get_backend(group) == "gloo" and x.device.type == "cuda":
        w = x.cpu()
        dist.all_reduce(w, op=op, group=group)
        return w.to(x.device)
    w = x.contiguous().clone()
    dist.all_reduce(w, op=op, group=group)
    return w


# --------------------------------------------------------------------------
# the rank launcher
# --------------------------------------------------------------------------
def spawn(fn, world: int, backend: str, device, *args,
          timeout: float = TIMEOUT_S) -> None:
    """Run ``fn(device, *args)`` in ``world`` new processes, one rank each,
    with the default process group initialized over ``backend``.

    ``device`` is resolved per rank by :func:`rank_device`.  Each rank on
    the CPU runs one torch thread.  ``fn`` must be importable by name.  A
    rank that raises makes this raise (the others are stopped); a
    collective that waits longer than ``timeout`` seconds raises in its
    rank, so ranks that disagree on their collectives fail instead of
    hanging.
    """
    check_backend(backend, world, device)
    with tempfile.TemporaryDirectory(prefix="process_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        # the arguments go through a file: a start's pickle larger than a
        # pipe's buffer (64 KB) blocks the parent until that child has
        # imported its main module, so the ranks would start one by one
        path = os.path.join(tmp, "args.pt")
        torch.save(args, path)
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, int(world), backend, str(device), init,
                              path, float(timeout)),
            nprocs=int(world), join=True)


@contextlib.contextmanager
def single_rank_group(backend: str, device, timeout: float = TIMEOUT_S):
    """A process group of this process alone (world 1, rank 0) over
    ``backend``, destroyed on exit: a mesh of one device without a spawn.
    ``device`` is checked as ``spawn`` checks it; ``timeout`` is its
    collectives' limit in seconds."""
    check_backend(backend, 1, device)
    if dist.is_initialized():
        raise RuntimeError("a process group exists already in this process")
    dev = torch.device(device)
    kw = {"device_id": rank_device(dev, 0)} if backend == "nccl" else {}
    with tempfile.TemporaryDirectory(prefix="process_mesh_") as tmp:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank, fn, world, backend, device, init, args_path, timeout):
    args = torch.load(args_path, weights_only=False)
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)
    try:
        if rank == 0:
            print(f"[process_mesh] world={world} backend={backend} "
                  f"transport: {transport(backend, dev)}", flush=True)
        fn(dev, *args)
    finally:
        dist.destroy_process_group()
