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

The engines' jobs (the block-timestep runs that carry a run across
events):

* ``{"kind": "strategy_block", "strategy", "compaction", "scenario", "n",
  "run": {...}}``: ``scenario``(``n``, ``seed``) through
  ``ensemble.evolve_strategy_block`` with the ``run`` keywords (``t_end``,
  ``dt_max``, ``n_levels``, ...); gives ``state.*``, ``carry.*`` and
  ``bounds``, the ``(events, p)`` per-shard gather bounds its engine read
  (empty without gather);
* ``{"kind": "layout", "stepper", "mix": [(name, n), ...], "run": {...}}``:
  the batch ``scenarios.build_padded(make_mix(mix, seed, repeat))``
  (``validate`` False) through the batch layout over the mesh
  (``devices=``; a job's ``mesh`` (bdev, p) takes the fused grid):
  ``fixed``, ``evolve_ensemble``; ``adaptive``, ``ensemble_initialize``
  then one ``ensemble_run_adaptive``; ``block``, ``evolve_ensemble_block``
  (``run`` may hold ``n_events`` and ``max_chunks``); gives ``state.*``,
  ``carry.*`` (``nbr.*`` under neighbor sources) or ``h_prev``/``n_taken``;
* ``{"kind": "api", "cfg": {...}}``: ``sim.api.run`` of ``SimConfig(**cfg)``
  on the mesh (the engine caches emptied first, so every run builds its
  engines); gives the report under ``info["report"]``.

Optional keys: ``dtype`` (``"fp32"``), ``ring_mode`` (``"overlap"``),
``chips_per_card`` (2), ``block_i`` and ``block_j`` (the kernels'
defaults), ``seed`` (0), ``steps`` (2), ``dt`` (1e-3); ``repeat`` (1) for
a layout job.

:func:`run_job` returns ``{"tensors": {name: CPU tensor}, "counts":
{"acc_jerk_pot", "snap": launches, "shifts": ring rounds, "host_syncs":
the block path's reads, "collectives": the process mesh's}, "times":
{...}, "info": {...}}``, an engine job's times with ``events`` and
``ms_per_event``; :func:`strategy_rank` is the rank function for
``process_mesh.spawn``: it writes each rank's results to ``out_dir`` as
``rank{r}.pt``, with a SHA-256 digest per tensor, and the tensors
themselves when ``keep`` (a full-size run keeps digests only).

The LM's counterpart is :func:`lm_rank`: serve, train (the ``Trainer``,
with the job's ``accum``), step (``make_train_step`` with ``accum`` and
``grad_compression``), gradient, restore, placement, flash and
collective-probe jobs (``run_lm_job``) on one rank of a real device
mesh (``launch.mesh.make_device_mesh`` over the job's ``mesh`` shape,
axes ("data", "model"), the reference's ``DEFAULT_RULES``); the same jobs
run in one process with ``mesh=None`` (:func:`in_process_lm`), the
single-device rules, which gives the comparison baseline.  A serve or
grads job carries a vlm's ``patches`` or an audio batch's ``frames`` with
its tokens (a train job's batches carry them too); a serve job's
``repeat`` more prefills are held against the first bit for bit, and
each MoE layer's experts, dropped entries and router probabilities are
recorded (``layers.recording_routes``); a train, step or grads job with
``against_one`` brings its trees whole to rank 0 only (full-width runs),
and rank 0 then runs it on one device and holds the two leaf by leaf
itself (``_against_one``), so that no whole tree leaves the rank.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree as tree_util
from repro_torch.core import hermite, nbody, strategies
from repro_torch.distributed import process_mesh
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.process_mesh import ProcessMesh
from repro_torch.distributed.shardings import MeshRules, full, gather_to_first
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import nbody_force
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios

EVAL_FIELDS = ("acc", "jerk", "snap", "pot")
CARRY_FIELDS = ("t_last", "levels", "dt_macro", "n_pairs", "n_events",
                "n_tiles", "bucket_hits")
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


def _slots(mesh):
    """The engines' keyword for ``mesh``: a rank's ``ProcessMesh`` as it
    is, an in-process mesh as its device list (one slot: None)."""
    if isinstance(mesh, ProcessMesh):
        return mesh
    return list(mesh.devices) if mesh.size > 1 else None


@contextlib.contextmanager
def _recording_bounds():
    """Every per-shard gather bound the strategy engine reads, event by
    event, appended to the yielded list."""
    seen, read = [], ens._StrategyBlockEngine._bound

    def record(self, *args):
        b = read(self, *args)
        if b is not None:
            seen.append(b)
        return b

    ens._StrategyBlockEngine._bound = record
    try:
        yield seen
    finally:
        ens._StrategyBlockEngine._bound = read


def _timed(device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _carry(carry) -> dict:
    out = {f"carry.{k}": getattr(carry, k) for k in CARRY_FIELDS}
    if carry.nbr is not None:
        out.update({f"nbr.{k}": v for k, v in carry.nbr._asdict().items()})
    return out


def _strategy_block(mesh, device, job):
    st = scenarios.make(job["scenario"], job["n"], seed=job.get("seed", 0),
                        device=device, validate=False)
    kw = dict(job["run"], strategy=job["strategy"],
              compaction=job["compaction"], **_evaluator_kw(job))
    kw.update({"mesh": mesh} if isinstance(mesh, ProcessMesh)
              else {"devices": list(mesh.devices)})
    with _recording_bounds() as bounds:
        (s, carry), wall = _timed(
            device, lambda: ens.evolve_strategy_block(st, **kw))
    out = {f"state.{f}": getattr(s, f) for f in nbody.FIELDS}
    out.update(_carry(carry))
    out["bounds"] = torch.tensor(bounds, dtype=torch.int64).reshape(
        len(bounds), -1 if bounds else 0)
    events = int(carry.n_events)
    return out, {"wall_s": wall, "events": events,
                 "ms_per_event": 1e3 * wall / max(events, 1)}


def _layout(mesh, device, job):
    batched, na = scenarios.build_padded(
        scenarios.make_mix([tuple(m) for m in job["mix"]],
                           seed=job.get("seed", 0),
                           repeat=job.get("repeat", 1)),
        validate=False, device=device)
    run = dict(job["run"])
    kw = dict(n_active=na, devices=_slots(mesh), dtype=job.get("dtype",
                                                               "fp32"))
    if job.get("mesh") is not None:
        kw.update(mesh=tuple(job["mesh"]),
                  devices=mesh if isinstance(mesh, ProcessMesh)
                  else list(mesh.devices))
    stepper = job["stepper"]
    if stepper == "fixed":
        s, wall = _timed(device, lambda: ens.evolve_ensemble(
            batched, **run, **kw))
        out, events = {}, run["n_steps"]
    elif stepper == "adaptive":
        def adaptive():
            init = ens.ensemble_initialize(batched, **kw)
            return ens.ensemble_run_adaptive(init, **run, **kw)
        (s, h_prev, n_taken), wall = _timed(device, adaptive)
        out = {"h_prev": h_prev, "n_taken": n_taken}
        events = int(n_taken.max())
    else:
        (s, carry), wall = _timed(device, lambda: ens.evolve_ensemble_block(
            batched, **run, **kw))
        out = _carry(carry)
        events = int(carry.n_events.max())
    out.update({f"state.{f}": getattr(s, f) for f in nbody.FIELDS})
    return out, {"wall_s": wall, "events": events,
                 "ms_per_event": 1e3 * wall / max(events, 1)}


def _api(mesh, device, job):
    from repro_torch.sim import api
    for cache in (ens._engine, ens._adaptive_engine, ens._block_engine,
                  ens._strategy_block_engine):
        cache.cache_clear()
    cfg = api.SimConfig(**dict(job["cfg"], device=str(device)))
    report, wall = _timed(device, lambda: api.run(
        cfg, mesh=mesh if mesh.size > 1 or isinstance(mesh, ProcessMesh)
        else None))
    events = int(report["steps"])
    return {}, {"wall_s": wall, "events": events,
                "ms_per_event": 1e3 * wall / max(events, 1)}, \
        {"report": json.loads(json.dumps(report, default=float))}


#: the engines' job kinds, each ``(mesh, device, job) -> (tensors, times)``
#: or ``(tensors, times, info)``
ENGINE_KINDS = {"strategy_block": _strategy_block, "layout": _layout,
                "api": _api}


def run_job(mesh, device, job) -> dict:
    """One job on ``mesh`` (a ``DeviceMesh`` or this rank's
    ``ProcessMesh``) with its inputs on ``device``; the launch counts, the
    block path's host reads and the process mesh's collectives are zeroed
    just before and read just after."""
    for k in KERNELS.values():
        k.launches = 0
    ens.ensemble_run_block.host_syncs = 0
    ProcessMesh.collectives = 0
    info = {}
    with obs_metrics.use() as reg:
        if job["kind"] == "lockstep":
            out, times = _lockstep(mesh, device, job)
        elif job["kind"] == "block":
            out, times = _block(mesh, device, job)
        elif job["kind"] == "psum":
            out = {"sum": compressed_psum(job["x"][dist.get_rank()].to(
                device))}
            times = {}
        elif job["kind"] in ENGINE_KINDS:
            out, times, *rest = ENGINE_KINDS[job["kind"]](mesh, device, job)
            info = rest[0] if rest else {}
        else:
            raise ValueError(f"unknown job kind {job['kind']!r}")
        shifts = reg.counter("ring.shifts_issued").value
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts["shifts"] = int(shifts)
    counts["host_syncs"] = ens.ensemble_run_block.host_syncs
    counts["collectives"] = ProcessMesh.collectives
    return {"tensors": {k: v.detach().cpu() for k, v in out.items()},
            "counts": counts, "times": times, "info": info}


def in_process(devices, jobs) -> list:
    """Each job on the in-process ``DeviceMesh`` over ``devices`` (one
    slot each; one device is the engines' one-slot run), inputs on the
    first slot's device."""
    mesh = strategies.DeviceMesh(devices)
    return [run_job(mesh, mesh.devices[0], job) for job in jobs]


def strategy_rank(device, jobs, out_dir: str, keep: bool = True) -> None:
    """Rank function for ``process_mesh.spawn``: every job on this rank's
    slot of a 1-D ``ProcessMesh``, written to ``out_dir/rank{r}.pt``, as
    :func:`lm_rank` runs a strategy job.  A job's own ``keep`` overrides
    ``keep``."""
    lm_rank(device, [dict(j, keep=j.get("keep", keep)) for j in jobs],
            out_dir)


def load_ranks(out_dir: str, world: int) -> list:
    """The results :func:`strategy_rank` wrote, by rank."""
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# --------------------------------------------------------------------------
# the LM stack over a device mesh
# --------------------------------------------------------------------------
#: the axes of an LM job's mesh, as the reference's (data, model) mesh
LM_AXES = ("data", "model")


def probe_collectives(mesh) -> dict:
    """The four collectives DTensor issues, each on a known 8 x 8 value on
    the rank's device: all-gather (Shard -> Replicate), reduce-scatter
    (Partial -> Shard), all-reduce (Partial -> Replicate) and all-to-all
    (Shard(0) -> Shard(1)).  Raises where a result is wrong; a collective
    the backend refuses raises or ends the rank.  Returns {name: True}."""
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    x = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
    n = mesh.size()
    checks = {
        "all_gather": (DTensor.from_local(
            x.chunk(mesh.size(0))[mesh.get_coordinate()[0]].contiguous(),
            mesh, [Shard(0), Replicate()]), [Replicate(), Replicate()], x),
        "reduce_scatter": (DTensor.from_local(x, mesh, [Partial(), Partial()]),
                           [Shard(0), Shard(1)], n * x),
        "all_reduce": (DTensor.from_local(x, mesh, [Replicate(), Partial()]),
                       [Replicate(), Replicate()], mesh.size(1) * x),
        "all_to_all": (DTensor.from_local(
            x.chunk(mesh.size(1))[mesh.get_coordinate()[1]].contiguous(),
            mesh, [Replicate(), Shard(0)]), [Replicate(), Shard(1)], x),
    }
    out = {}
    for name, (d, placements, want) in checks.items():
        got = d.redistribute(mesh, placements).full_tensor()
        if not torch.equal(got, want):
            raise RuntimeError(f"{name} over {mesh}: wrong result")
        out[name] = True
    return out


def _lm_rules(job, meshes, device) -> MeshRules:
    shape = job.get("mesh")
    if shape is None:
        return MeshRules.single_device()
    shape = tuple(shape)
    if shape not in meshes:
        from repro_torch.launch.mesh import make_device_mesh
        meshes[shape] = make_device_mesh(shape, LM_AXES,
                                         torch.device(device).type)
    return MeshRules.for_mesh(meshes[shape])


def _lm_params(job, rules, device):
    from repro_torch.models import params as P
    cfg = job["cfg"]
    if "params" in job:
        return P.params_from_jax(job["params"], device, rules, cfg=cfg)
    gen = torch.Generator(device).manual_seed(job.get("seed", 0))
    return P.init_params(cfg, gen, device=device, rules=rules)


def _layout(tree) -> dict:
    """Each leaf's placements and local shape ({path: (str, tuple)});
    a plain tensor's placements are empty."""
    flat = {}

    def walk(node, prefix):
        for k in sorted(node):
            x, path = node[k], f"{prefix}/{k}" if prefix else k
            if isinstance(x, dict):
                walk(x, path)
            elif isinstance(x, DTensor):
                flat[path] = (tuple(str(p) for p in x.placements),
                              tuple(x.to_local().shape))
            else:
                flat[path] = ((), tuple(x.shape))
    walk(tree, "")
    return flat


def _full_tree(tree) -> dict:
    return tree_util.map(lambda x: full(x).detach().cpu(), tree)


def _whole(tree, job, rules) -> dict:
    """The tree's leaves whole, flat ({path: tensor}): on one device where
    they are (``run_lm_job`` brings them to the host); on a real mesh on
    the host of every rank (``full``), or, for a job ``against_one``, of
    rank 0 only (``gather_to_first``: each rank sends its block once,
    rather than every rank gathering every leaf), the other ranks getting
    none."""
    if not rules.is_real:
        return _flat(tree_util.map(lambda x: x.detach(), tree))
    if not job.get("against_one"):
        return _flat(_full_tree(tree))
    out = {k: gather_to_first(x) for k, x in _flat(tree).items()}
    return out if dist.get_rank() == 0 else {}


def _sync_dev(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


#: a serve or grads job's frontend inputs, passed with its tokens
FRONTENDS = ("patches", "frames")


def _lm_batch(job, device, data=None) -> dict:
    """The job's tokens (or ``data``, one training batch) with the vlm's
    ``patches`` or the audio family's ``frames`` where the job has them, as
    whole tensors on ``device``."""
    batch = dict(data) if data is not None else {"tokens": job["tokens"]}
    if data is None:
        batch.update({k: job[k] for k in FRONTENDS if k in job})
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _prefills(job, params, batch, rules, device) -> list:
    """``1 + job["repeat"]`` prefills of ``batch``, each recorded: its
    logits and cache, its seconds (synchronised before and after), K3's
    launches in it, and each MoE layer's routing on the local sequences
    (``layers.recording_routes``, brought to the host after the clock
    stops: the experts as int16)."""
    from repro_torch.models import layers, model
    runs = []
    for _ in range(1 + job.get("repeat", 0)):
        flash.flash_attention.launches = 0
        _sync_dev(device)
        t0 = time.perf_counter()
        with layers.recording_routes() as routes:
            logits, cache = model.prefill(job["cfg"], params, batch,
                                          max_len=job["max_len"], rules=rules)
        _sync_dev(device)
        runs.append(dict(logits=logits, cache=cache, len=cache["len"],
                         seconds=time.perf_counter() - t0,
                         launches=flash.flash_attention.launches,
                         routes=[(_local(i).to(torch.int16).cpu(),
                                  _local(d).cpu(), _local(p).cpu())
                                 for i, d, p in routes]))
    return runs


def _serve(job, rules, device):
    """``Engine.generate`` for ``job["gen"]`` tokens, then ``_prefills``
    of the same batch, warm; the ``repeat`` ones are held against the
    first bit for bit: the rank's blocks of the logits, of every cache
    leaf over the prompt's span, and the dropped entries.  The prefill's
    seconds are the last one's."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = job["cfg"]
    eng = Engine(cfg, _lm_params(job, rules, device),
                 ServeConfig(max_len=job["max_len"]), rules=rules)
    batch = _lm_batch(job, device)
    toks, stats = eng.generate(batch, job["gen"])
    runs = _prefills(job, eng.params, batch, rules, device)
    first, cache, seconds = runs[0], runs[0]["cache"], runs[-1]["seconds"]
    same = all(
        torch.equal(_local(r["logits"]), _local(first["logits"]))
        and all(torch.equal(a, b_) for a, b_ in zip(
            _prompt_span(r["cache"], r["len"]),
            _prompt_span(cache, first["len"])))
        and all(torch.equal(a[1], b_[1])
                for a, b_ in zip(r["routes"], first["routes"]))
        for r in runs[1:])
    tally = first["routes"]
    out = {"logits": full(first["logits"]), "tokens": toks}
    del runs
    if job.get("step_logits"):
        out["step_logits"] = _step_logits(cfg, eng.params, batch, toks, job,
                                          rules)
    info = {"flash_per_prefill": first["launches"],
            # the engine's cast weights (FP32_LEAVES in fp32) as placed
            "layout": _layout(eng.params),
            "cache_layout": _layout(cache.get("layers", cache.get("attn", {}))),
            "cache_leaves": _layout(_cache_tensors(cache)),
            # per MoE layer, the entries dropped in each local sequence
            "dropped": (torch.stack([d.sum(dim=(1, 2)) for _, d, _ in tally])
                        if tally else None),
            "routes": tally or None,
            "coord": (tuple(rules.mesh.get_coordinate()) if rules.is_real
                      else None),
            "prefills_equal": same if job.get("repeat") else None}
    return out, {"prefill_s": seconds,
                 "decode_step_s": stats["decode_s"] / max(job["gen"], 1)}, info


def _prompt_span(cache, n) -> list:
    """The rank's blocks of the cache's tensors: the stacked (L, B,
    max_len, ...) kv entries (a dict's leaves: the KV, MLA's latents, the
    hybrid family's shared-block KV) over their first ``n`` positions, any
    other leaf whole: the audio memory, and the recurrent states, carries
    and conv cache of the hybrid and ssm families, which have no sequence
    axis."""
    out = []
    for v in _cache_tensors(cache).values():
        for t in tree_util.leaves(v) if isinstance(v, dict) else (v,):
            t = _local(t)
            out.append(t[:, :, :n] if isinstance(v, dict) else t)
    return out


def _cache_tensors(cache) -> dict:
    """The cache's tensor leaves (``len`` and ``offset`` are ints)."""
    return {k: _cache_tensors(v) if isinstance(v, dict) else v
            for k, v in cache.items() if not isinstance(v, int)}


def _step_logits(cfg, params, batch, toks, job, rules):
    """The logits each greedy token of ``toks`` was picked from: the prefill
    and then each decode step fed the tokens before it, (n, B, V)."""
    from repro_torch.models import model
    logits, cache = model.prefill(cfg, params, batch, max_len=job["max_len"],
                                  rules=rules)
    out = [full(logits)]
    for j in range(toks.shape[1] - 1):
        logits, cache = model.decode_step(cfg, params, cache,
                                          toks[:, j:j + 1], rules=rules)
        out.append(full(logits))
    return torch.stack(out)


def _trainer(job, rules, device, data=None, batch_shardings=None):
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(steps=job.get("steps", 0), ckpt_every=10 ** 9,
                         ckpt_dir=job.get("ckpt_dir"), log_every=1,
                         seed=job.get("seed", 0), accum=job.get("accum", 1))
    return Trainer(job["cfg"], AdamW(**job.get("opt", {})), data, tcfg,
                   device=device, rules=rules, log=lambda _m: None,
                   batch_shardings=batch_shardings)


def _train(job, rules, device):
    """``job["steps"]`` Trainer steps over ``job["data"]``, each batch
    placed per ``step.batch_shardings`` (tokens and labels on ("batch",
    "seq"), patches and frames on ("batch", "seq", "d_model")), from the
    job's parameters."""
    from repro_torch.train.step import batch_shardings
    batches = job["data"]
    tr = _trainer(job, rules, device, data=lambda step: batches[step],
                  batch_shardings=batch_shardings(rules, batches[0]))
    params = _lm_params(job, rules, device)
    params, opt_state, hist = tr.run(start_params=params,
                                     start_opt=tr.opt.init(params))
    out = {f"params.{k}": v for k, v in _whole(params, job, rules).items()}
    if job.get("moments"):
        out.update({f"m.{k}": v
                    for k, v in _whole(opt_state.m, job, rules).items()})
    out["loss"] = torch.tensor([h["loss"] for h in hist], dtype=torch.float64)
    times = {"step_s": [h["step_time"] for h in hist]}
    return out, times, {"layout": _layout(params),
                        "opt_layout": _layout(opt_state.m)}


def _step(job, rules, device):
    """``job["steps"]`` calls of ``train.step.make_train_step`` with the
    job's ``accum`` and ``grad_compression`` (int8 with its error buffers
    from ``compression.zeros_error``) over ``job["data"]``, each batch
    placed per ``batch_shardings``, from the job's parameters: the
    parameters (with ``moments``, AdamW's m too), the losses and, under
    int8, the error buffers whole; with ``ckpt_dir`` the state is saved
    there as the Trainer saves it."""
    from repro_torch.distributed.compression import zeros_error
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import batch_shardings, make_train_step
    comp = job.get("grad_compression", "none")
    opt = AdamW(**job.get("opt", {}))
    step = make_train_step(job["cfg"], opt, rules=rules,
                           accum=job.get("accum", 1), grad_compression=comp)
    params = _lm_params(job, rules, device)
    opt_state = opt.init(params)
    err = zeros_error(params) if comp == "int8" else None
    sh = batch_shardings(rules, job["data"][0])
    losses, times = [], []
    for data in job["data"][:job.get("steps", len(job["data"]))]:
        batch = {k: sh[k].place(v) if k in sh else v
                 for k, v in _lm_batch(job, device, data).items()}
        _sync_dev(device)
        t0 = time.perf_counter()
        if err is None:
            params, opt_state, met = step(params, opt_state, batch)
        else:
            params, opt_state, met, err = step(params, opt_state, batch, err)
        _sync_dev(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    if job.get("ckpt_dir"):
        from repro_torch.checkpoint import store
        store.save(job["ckpt_dir"], len(times),
                   {"params": params, "opt": opt_state})
    out = {f"params.{k}": v for k, v in _whole(params, job, rules).items()}
    if job.get("moments"):
        out.update({f"m.{k}": v
                    for k, v in _whole(opt_state.m, job, rules).items()})
    info = {"layout": _layout(params), "opt_layout": _layout(opt_state.m)}
    if err is not None:
        info["err_layout"] = _layout(err)
        if not job.get("against_one"):   # rank 0 holds the parameters only
            out.update({f"err.{k}": v
                        for k, v in _whole(err, job, rules).items()})
    out["loss"] = torch.tensor(losses, dtype=torch.float64)
    return out, {"step_s": times}, info


def _grads(job, rules, device):
    """``train.step._value_and_grad`` once: the loss and every gradient
    whole, and the gradients' layout."""
    from repro_torch.train.step import _value_and_grad
    batch = _lm_batch(job, device, job["data"][0])
    params = _lm_params(job, rules, device)
    _sync_dev(device)
    t0 = time.perf_counter()
    loss, terms, grads = _value_and_grad(job["cfg"], params, batch,
                                         rules=rules)
    _sync_dev(device)
    t = time.perf_counter() - t0
    out = {f"grad.{k}": v for k, v in _whole(grads, job, rules).items()}
    out["loss"] = loss
    out.update({f"term.{k}": v for k, v in terms.items()})
    return out, {"grads_s": t}, {"layout": _layout(grads)}


def _restore(job, rules, device):
    tr = _trainer(job, rules, device)
    step, params, opt_state = tr.restore_or_init()
    out = {f"params.{k}": v for k, v in _flat(_full_tree(params)).items()}
    out.update({f"m.{k}": v for k, v in _flat(_full_tree(opt_state.m)).items()})
    return out, {}, {"step": step, "layout": _layout(params),
                     "opt_layout": _layout(opt_state.m)}


def _placements(job, rules, device):
    """Every leaf's placements and local shape, with what the rules say
    they must be, and ``param_specs`` for each of ``job["spec_cfgs"]``."""
    from repro_torch.models import params as P
    cfg = job["cfg"]
    params = _lm_params(job, rules, device)
    defs = _flat(P.param_defs(cfg))
    want = {k: (tuple(str(p) for p in rules.placements(d.shape, d.logical))
                if rules.is_real else (), rules.local_shape(d.shape, d.logical))
            for k, d in defs.items()}
    specs = {c.name: _flat(P.param_specs(c, rules))
             for c in job.get("spec_cfgs", ())}
    return {}, {}, {"layout": _layout(params), "want": want, "specs": specs}


def _flash(job, rules, device):
    """The flash wrapper on DTensors: q, k, v (numpy, whole) placed on
    ("batch", None, "heads" / "kv_heads", None); gives the output whole,
    and ``layers._attn_dispatch``'s for ``job["cfg"]`` where given."""
    from repro_torch.models import layers
    place = {"q": "heads", "k": "kv_heads", "v": "kv_heads"}
    x = {n: rules.put(torch.as_tensor(job[n], device=device), "batch", None,
                      ax, None) for n, ax in place.items()}
    flash.flash_attention.launches = 0
    out = flash.flash_attention(x["q"], x["k"], x["v"], causal=job["causal"],
                                block_q=job["block"], block_k=job["block"])
    res = {"out": full(out)}
    if "cfg" in job:
        res["dispatch"] = full(layers._attn_dispatch(
            job["cfg"], x["q"], x["k"], x["v"], causal=job["causal"],
            rules=rules))
    return res, {}, {
        "launches": flash.flash_attention.launches,
        "placements": tuple(str(p) for p in getattr(out, "placements", ()))}


def _flat(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _against_one(job, device, out) -> tuple:
    """Rank 0, after a meshed train or grads job whose trees it holds
    whole: the same job on one device in this
    process, and the two held leaf by leaf in fp32 on the card (the
    difference of two fp32 values this close is exact).  Train: per leaf
    the elements outside ``|mesh - one| <= atol + rtol |one|``
    (``job["against_one"]``'s bounds), the largest excess over it, and the
    update-norm gap ``|mesh - one| / |one - start|``, over all of the
    leaf's elements and (``leaf_kept``) over those within the bounds (an
    int8 step's flips, an element whose gradient lies within noise of a
    level's midpoint taking the other level, are the elements outside
    them); grads: per leaf
    ``max |mesh - one| / max |one|``; both the losses' largest relative
    difference.  Returns (stats, the one-device run's times)."""
    one, times, _ = LM_KINDS[job["kind"]](dict(job, mesh=None),
                                          MeshRules.single_device(), device)
    bound = job["against_one"]
    start = (_flat(_lm_params(job, MeshRules.single_device(), device))
             if job["kind"] != "grads" else {})
    stats = {"loss_rel": float((out["loss"].double().cpu()
                                - one["loss"].double().cpu()).abs().max()
                               / one["loss"].double().abs().max()),
             "n": 0, "n_out": 0, "worst_excess": float("-inf"), "leaf": {},
             "leaf_kept": {}, "leaf_out": {}}
    for name, w in one.items():
        if not name.startswith(("params.", "grad.")):
            continue
        g = out[name].to(device)
        if not w.numel():
            continue
        if job["kind"] == "grads":
            stats["leaf"][name] = float((g - w).abs().max()
                                        / w.abs().max().clamp(min=1e-30))
            continue
        excess = (g - w).abs() - (bound["atol"] + bound["rtol"] * w.abs())
        stats["n"] += excess.numel()
        stats["n_out"] += int((excess > 0).sum())
        stats["leaf_out"][name] = int((excess > 0).sum())
        stats["worst_excess"] = max(stats["worst_excess"],
                                    float(excess.max()))
        p0 = start[name[len("params."):]]
        stats["leaf"][name] = float((g - w).norm()
                                    / (w - p0).norm().clamp(min=1e-30))
        kept = excess <= 0
        stats["leaf_kept"][name] = float(
            (g - w)[kept].norm() / (w - p0)[kept].norm().clamp(min=1e-30))
    return stats, times


LM_KINDS = {"serve": _serve, "train": _train, "step": _step,
            "grads": _grads, "restore": _restore, "placements": _placements,
            "flash": _flash}


def run_lm_job(job, device, meshes) -> dict:
    """One LM job with its tensors on ``device``, on the job's mesh (built
    once per shape in ``meshes``) or, with ``mesh`` None, on one device.
    Returns {"tensors": {name: CPU tensor}, "digests": {name: digest},
    "times": {...}, "info": {...}}; a job with ``keep`` (a tuple of name
    prefixes) keeps only those tensors, and only on rank 0.  A ``probe``
    job gives the collectives' checks in "info"."""
    t0 = time.perf_counter()
    rules = _lm_rules(job, meshes, device)
    if job["kind"] == "probe":
        if "stage" in job:   # the staged all-gather on this dispatch key
            process_mesh.stage_functional_all_gather(job["stage"])
        staged = process_mesh._all_gather_staged.calls
        info = probe_collectives(rules.mesh)
        info["staged_gathers"] = process_mesh._all_gather_staged.calls - staged
        return {"tensors": {}, "info": info,
                "times": {"job_s": time.perf_counter() - t0}}
    if job["kind"] not in LM_KINDS:
        raise ValueError(f"unknown LM job kind {job['kind']!r}")
    out, times, info = LM_KINDS[job["kind"]](job, rules, device)
    _sync_dev(device)
    times["job_s"] = time.perf_counter() - t0
    if job.get("against_one") and rules.is_real and dist.get_rank() == 0:
        info["against_one"], times["one"] = _against_one(job, device, out)
        # the trees are held: keep the losses and terms
        out = {k: v for k, v in out.items()
               if "." not in k or k.startswith("term.")}
    tensors = {k: v.detach().cpu() for k, v in out.items()}
    del out
    if torch.device(device).type == "cuda":
        # the job's blocks go back to the card: the ranks share it
        torch.cuda.empty_cache()
    # the trees an against_one job brings to rank 0 exist there only:
    # no digest to compare
    trees = (("params.", "m.", "grad.", "err.") if job.get("against_one")
             else ())
    res = {"tensors": tensors, "times": times, "info": info,
           "digests": {k: digest(v) for k, v in tensors.items()
                       if not k.startswith(trees)}}
    keep = job.get("keep", True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if keep is not True:
        # a full-size run keeps digests, and rank 0 the tensors named
        res["tensors"] = {k: v for k, v in tensors.items()
                          if rank == 0 and k.startswith(tuple(keep))}
    return res


#: the strategies' and the engines' job kinds (``run_job``), which
#: ``lm_rank`` runs too
STRATEGY_KINDS = ("lockstep", "block", "psum") + tuple(ENGINE_KINDS)


def lm_rank(device, jobs, out_dir: str) -> None:
    """Rank function for ``process_mesh.spawn``: every LM job on this
    rank, written to ``out_dir/rank{r}.pt``.  A strategy job
    (``STRATEGY_KINDS``) runs through :func:`run_job` on a ``ProcessMesh``
    of the same ranks, its digests taken and its tensors kept only with
    the job's ``keep``, so that one spawn serves both.  Each result's
    ``times["done_at"]`` is the host clock (``time.time``) at its end, and
    the first's ``times["rank_start_at"]`` the rank's own start, for a
    spawn's breakdown."""
    meshes: dict = {}
    start = time.time()
    results, pm = [], None
    for job in jobs:
        if job["kind"] in STRATEGY_KINDS:
            pm = pm or ProcessMesh(dist.get_backend(), device=device)
            r = run_job(pm, device, job)
            r["digests"] = {k: digest(v) for k, v in r["tensors"].items()}
            if not job.get("keep", False):
                del r["tensors"]
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()   # the ranks share the card
        else:
            r = run_lm_job(job, device, meshes)
        results.append(r)
        r["times"]["done_at"] = time.time()
    results[0]["times"]["rank_start_at"] = start
    torch.save(results, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def in_process_lm(device, jobs) -> list:
    """The same jobs on one device (each job's ``mesh`` taken as None)."""
    return [run_lm_job(dict(job, mesh=None), device, {}) for job in jobs]
