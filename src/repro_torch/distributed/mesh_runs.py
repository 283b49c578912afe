"""The strategies' runs on a mesh of processes and, the same code, on the
in-process mesh, for holding one against the other.

A *job* is a plain dict (it crosses into spawned ranks):

* ``{"kind": "lockstep", "strategy", "n", ...}``: Plummer(``n``, ``seed``)
  bootstrapped and stepped ``steps`` times at a fixed ``dt`` through
  ``hermite`` under the strategy's evaluator; gives the bootstrap
  ``Evaluation`` (``boot.*``) and the final state (``state.*``);
* ``{"kind": "block", "strategy", "compaction", "inputs": (pos, vel,
  acc_pred, mass, mask)}``: one evaluation of the strategy's block
  evaluator; gives ``eval.*`` and the per-shard ``tiles``;
* ``{"kind": "psum", "x": (world, m)}``: ``compressed_psum`` of row
  ``rank`` (process mesh only); gives ``sum``.

Optional keys: ``dtype`` (``"fp32"``), ``ring_mode`` (``"overlap"``),
``chips_per_card`` (2), ``block_i`` and ``block_j`` (the kernels'
defaults), ``seed`` (0), ``steps`` (2), ``dt`` (1e-3).

:func:`run_job` returns ``{"tensors": {name: CPU tensor}, "counts":
{"acc_jerk_pot", "snap": launches, "shifts": ring rounds}, "times":
{...}}``; :func:`strategy_rank` is the rank function for
``process_mesh.spawn``: it writes each rank's results to ``out_dir`` as
``rank{r}.pt``, with a SHA-256 digest per tensor, and the tensors
themselves when ``keep`` (a full-size run keeps digests only).
"""

from __future__ import annotations

import hashlib
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import hermite, nbody, strategies
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.process_mesh import ProcessMesh
from repro_torch.kernels import nbody_force
from repro_torch.obs import metrics as obs_metrics

EVAL_FIELDS = ("acc", "jerk", "snap", "pot")
KERNELS = {"acc_jerk_pot": nbody_force.acc_jerk_pot_packed,
           "snap": nbody_force.snap_packed}


def digest(t: torch.Tensor) -> str:
    """A tensor's dtype, shape and bytes, hashed: equal digests are equal
    bits."""
    t = t.detach().cpu().contiguous()
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _evaluator_kw(job):
    kw = {k: job[k] for k in ("block_i", "block_j") if k in job}
    return dict(dtype=job.get("dtype", "fp32"),
                ring_mode=job.get("ring_mode", "overlap"),
                chips_per_card=job.get("chips_per_card", 2), **kw)


def _lockstep(mesh, device, job):
    ev = strategies.make_strategy_evaluator(job["strategy"], mesh=mesh,
                                            **_evaluator_kw(job))
    state = nbody.plummer(job["n"], seed=job.get("seed", 0), device=device)
    steps, dt = job.get("steps", 2), job.get("dt", 1e-3)
    boot = []

    def first(pos, vel, mass):
        boot.append(ev(pos, vel, mass))
        return boot[-1]

    _sync(device)
    t0 = time.perf_counter()
    state = hermite.initialize(state, first)
    _sync(device)
    t1 = time.perf_counter()
    for _ in range(steps):
        state = hermite.step(state, dt, ev)
    _sync(device)
    t2 = time.perf_counter()
    out = {f"boot.{f}": getattr(boot[0], f) for f in EVAL_FIELDS}
    out.update({f"state.{f}": getattr(state, f) for f in nbody.FIELDS})
    return out, {"boot_s": t1 - t0, "step_s": (t2 - t1) / max(steps, 1)}


def _block(mesh, device, job):
    bev = strategies.make_strategy_block_evaluator(
        job["strategy"], mesh=mesh, compaction=job["compaction"],
        **_evaluator_kw(job))
    inputs = [x.to(device) for x in job["inputs"]]
    _sync(device)
    t0 = time.perf_counter()
    ev, tiles = bev(*inputs)
    _sync(device)
    out = {f"eval.{f}": getattr(ev, f) for f in EVAL_FIELDS}
    out["tiles"] = tiles
    return out, {"eval_s": time.perf_counter() - t0}


def run_job(mesh, device, job) -> dict:
    """One job on ``mesh`` (a ``DeviceMesh`` or this rank's
    ``ProcessMesh``) with its inputs on ``device``; the launch counts are
    zeroed just before and read just after."""
    for k in KERNELS.values():
        k.launches = 0
    with obs_metrics.use() as reg:
        if job["kind"] == "lockstep":
            out, times = _lockstep(mesh, device, job)
        elif job["kind"] == "block":
            out, times = _block(mesh, device, job)
        elif job["kind"] == "psum":
            out = {"sum": compressed_psum(job["x"][dist.get_rank()].to(
                device))}
            times = {}
        else:
            raise ValueError(f"unknown job kind {job['kind']!r}")
        shifts = reg.counter("ring.shifts_issued").value
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts["shifts"] = int(shifts)
    return {"tensors": {k: v.detach().cpu() for k, v in out.items()},
            "counts": counts, "times": times}


def in_process(devices, jobs) -> list:
    """Each job on the in-process ``DeviceMesh`` over ``devices`` (one
    slot each), inputs on the first slot's device."""
    mesh = strategies.DeviceMesh(devices)
    return [run_job(mesh, mesh.devices[0], job) for job in jobs]


def strategy_rank(device, jobs, out_dir: str, keep: bool = True) -> None:
    """Rank function for ``process_mesh.spawn``: every job on this rank's
    slot of a 1-D ``ProcessMesh``, written to ``out_dir/rank{r}.pt``."""
    mesh = ProcessMesh(dist.get_backend(), device=device)
    results = []
    for job in jobs:
        r = run_job(mesh, device, job)
        r["digests"] = {k: digest(v) for k, v in r["tensors"].items()}
        if not keep:
            del r["tensors"]
        results.append(r)
    torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def load_ranks(out_dir: str, world: int) -> list:
    """The results :func:`strategy_rank` wrote, by rank."""
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
