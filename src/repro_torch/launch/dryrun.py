"""Dry-run: each (architecture x input shape) cell's per-device roofline on
the production meshes, without a card.

Port of ``repro/launch/dryrun.py``, as an analogue: the reference lowers
the step onto 256 or 512 placeholder CPU devices and parses XLA's HLO; the
port runs one device's program eagerly on ``meta`` tensors (no
allocation, no arithmetic) under the op counter of ``launch.hlo_analysis``.

Per LM cell this script:
  1. builds the (16,16) single-pod or (2,16,16) multi-pod abstract mesh
     and its ``MeshRules``;
  2. runs the step (train step / prefill / decode step) at one device's
     local shapes: batch over (pod, data); heads, kv_heads, d_ff, vocab and
     experts over model; replicated where the rules drop a mapping, as the
     reference's SPMD replicates (``local_config``).  FSDP axes shrink the
     stored parameter and optimizer bytes, not the compute;
  3. lists the step's collectives analytically (``_collectives``) and puts
     each through the reference's ring model;
  4. writes one JSON to ``experiments/dryrun_torch/`` in the reference's
     record schema (``xla_flops_body_once`` dropped: there is no XLA
     count; ``timings`` holds ``trace_s``, the seconds the meta run took).

N-body cells run the port's ``make_strategy_evaluator`` over 256 or 512
``meta`` slots of its ``DeviceMesh``; the mesh's collectives are recorded
as they are issued.  ``--nbody-impl pallas_marked`` (the default) counts
K1 and K2 as the card runs them, one op each with the kernel's own work;
``xla`` asks the counter to expand each launch into its plain version on
``meta``, op by op (the reference's XLA stand-in; slow at the production
mesh: the ring issues P^2 launches).

Hardware constants: the H100 SXM data sheet at 700 W (``kernels.bounds``):
989e12 bf16 FLOP/s dense on the tensor cores, 67e12 fp32 FLOP/s outside
them, 3.35e12 B/s HBM3.  The collective term assumes one per-GPU
inter-node link, NDR InfiniBand at 50e9 B/s, as the reference assumes one
ICI link; NVLink within a node gives 450e9 B/s per direction.  These are
modeled numbers, not measurements.

Usage (no card needed; ``--device`` is not an option, meta is the
dry-run's device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --nbody --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed.shardings import MeshRules, _axes_tuple
from repro_torch.kernels import bounds
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import config as C
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamW, abstract_state
from repro_torch.train import make_train_step
from repro_torch.train.step import _value_and_grad

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# hardware constants (H100 SXM data sheet, 700 W)
PEAK_FLOPS = bounds.PEAK_BF16_FLOPS     # bf16 dense, tensor cores
PEAK_FP32_FLOPS = bounds.PEAK_FP32_FLOPS
HBM_BW = bounds.PEAK_HBM_BYTES          # bytes/s per card
NET_BW = 50e9                           # NDR InfiniBand, one link per GPU


def roofline_terms(flops, bytes_accessed, wire_bytes):
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": wire_bytes / NET_BW,
    }


def _model_flops(cfg, case) -> float:
    """6*N_active*D for train, 2*N_active*D for serve (D = tokens/step)."""
    n_active = P.count_active(cfg)
    if case.kind == "train":
        toks = case.global_batch * case.seq_len
        return 6.0 * n_active * toks
    if case.kind == "prefill":
        return 2.0 * n_active * case.global_batch * case.seq_len
    return 2.0 * n_active * case.global_batch  # decode: 1 token/seq


# ---------------------------------------------------------------------------
# one device's program
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _LocalConfig(ArchConfig):
    """An architecture at one device's share of the model axis: the vocab
    and the Mamba2 inner width divided as the rules divide them."""
    vocab_shards: int = 1
    inner_shards: int = 1

    @property
    def padded_vocab(self) -> int:
        return super().padded_vocab // self.vocab_shards

    @property
    def d_inner(self) -> int:
        return super().d_inner // self.inner_shards


def _split(rules: MeshRules, n: int, logical: str) -> int:
    """How many ways the rules split a dimension of ``n`` named
    ``logical``."""
    return rules.shards(rules.spec((n,), (logical,))[0]) \
        if rules.mesh is not None else 1


def local_config(cfg: ArchConfig, rules: MeshRules) -> ArchConfig:
    """``cfg`` at one device's share of the model axis.

    Heads, d_ff, vocab, experts and the Mamba2 inner width are divided
    where the rules shard them; kv heads follow their own rule, and where
    it drops them but the query heads shard, each device keeps the kv heads
    its query heads read (its GQA groups, at least one).  A device's
    experts keep the global slots per expert (the capacity factor scaled
    by the experts' split, top_k capped at the local experts).  Shared
    experts and the xLSTM cells (whose widths derive from d_model) run
    replicated.
    """
    if rules.mesh is None:
        return cfg
    h, kv = cfg.n_heads, cfg.n_kv_heads
    h_l = h // _split(rules, h, "heads")
    kv_sh = _split(rules, kv, "kv_heads")
    if kv_sh > 1 or h_l == h:
        kv_l = kv // kv_sh if h_l < h else kv
    else:
        g = h // kv
        kv_l = h_l // g if h_l >= g and h_l % g == 0 else 1
    if h_l % kv_l:
        kv_l = h_l
    kw = dict(n_heads=h_l, n_kv_heads=kv_l, head_dim=cfg.head_dim,
              d_ff=cfg.d_ff // _split(rules, cfg.d_ff, "d_ff")
              if cfg.d_ff else 0)
    if cfg.family == "ssm":      # widths derive from d_model: replicated
        kw.update(n_heads=h, n_kv_heads=kv)
    if cfg.n_experts:
        e_sh = _split(rules, cfg.n_experts, "experts")
        e_l = cfg.n_experts // e_sh
        k_l = min(cfg.top_k, e_l)
        kw.update(n_experts=e_l, top_k=k_l,
                  capacity_factor=cfg.capacity_factor * cfg.top_k
                  / (e_sh * k_l))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    fields.update(kw)
    inner = _split(rules, cfg.d_inner, "d_ff") if cfg.family == "hybrid" \
        else 1
    return _LocalConfig(**fields,
                        vocab_shards=_split(rules, cfg.padded_vocab, "vocab"),
                        inner_shards=inner)


def _serve_blocks(cfg: ArchConfig) -> tuple:
    """(tensor-parallel all-reduces, MoE layers) of one forward pass: two
    per attention + FFN block (three with cross-attention), one per
    Mamba2 layer."""
    if cfg.family == "hybrid":
        return cfg.n_layers + 2 * (cfg.n_layers // cfg.attn_every), 0
    if cfg.family == "audio":
        return 2 * cfg.encoder_layers + 3 * cfg.n_layers, 0
    if cfg.family == "moe":
        return 2 * cfg.n_layers, cfg.n_layers - cfg.first_k_dense
    return 2 * cfg.n_layers, 0


def _collectives(counter, cfg, cfg_l, rules, *, kind, tokens, accum):
    """The step's collectives, by layer and class (the reference's
    opcodes), each through the ring model.  ``tokens`` is the local tokens
    of one forward pass (a microbatch's in training).

    * FSDP ``all-gather`` of each parameter leaf over the axes its spec
      shards it on (``fsdp_d_model``), in each forward pass and again under
      remat in the backward;
    * ``reduce-scatter`` of each such gradient over those axes, and an
      ``all-reduce`` over the batch axes the leaf is not sharded on (across
      pods: the pod all-reduce);
    * tensor-parallel ``all-reduce`` of each block output over ``model``
      where the model axis splits the block, and of the embedding output
      where it splits the vocab;
    * ``all-to-all`` (dispatch and combine) per MoE layer where the
      experts shard.
    """
    sizes = rules.axis_sizes()
    if not sizes:
        return
    m = sizes.get("model", 1)
    batch_axes = [a for a in (rules.rules.get("batch") or ()) if a in sizes]
    batch_group = math.prod(sizes[a] for a in batch_axes)
    train = kind == "train"
    remat = train and cfg.remat != "none"
    passes = accum * (2 + remat) if train else 1   # fwd, recompute, bwd
    gathers = accum * (1 + remat) if train else 1
    pdt = 4 if train else 2
    defs = P.param_defs(cfg)
    for p in tree_util.leaves(defs):
        spec = rules.spec(p.shape, p.logical)
        g = math.prod(sizes[a] for e, lg in zip(spec, p.logical)
                      if lg and lg.startswith("fsdp") for a in _axes_tuple(e))
        model_local = math.prod(p.shape) // (
            m if any("model" in _axes_tuple(e) for e in spec) else 1)
        # one collective per layer of a stacked leaf
        n = p.shape[0] if p.logical[0] == "layers" else 1
        layer = model_local // n
        if g > 1:
            counter.add_collective("all-gather", layer * pdt, g,
                                   count=gathers * n)
        if train:
            if g > 1:
                counter.add_collective("reduce-scatter", layer // g * 4, g,
                                       count=n)
            if batch_group // g > 1:
                counter.add_collective("all-reduce", layer // g * 4,
                                       batch_group // g, count=n)
    act = tokens * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    n_ar, n_moe = _serve_blocks(cfg)
    split = (cfg_l.n_heads < cfg.n_heads or cfg_l.d_ff < cfg.d_ff
             or cfg_l.d_inner < cfg.d_inner)
    if m > 1 and split:
        counter.add_collective("all-reduce", act, m, count=n_ar * passes)
    if m > 1 and cfg_l.padded_vocab < cfg.padded_vocab:
        counter.add_collective("all-reduce", act, m, count=passes)
    if m > 1 and n_moe and cfg_l.n_experts < cfg.n_experts:
        counter.add_collective("all-to-all", act * cfg.top_k, m,
                               count=2 * n_moe * passes)


def _step_inputs(cfg, cfg_l, case, rules):
    """The step's three arguments on one device, made before the counter
    starts (parameters at the local config's shapes; the optimizer state
    or the decode cache; the batch or the decode tokens), and the stored
    trees whose bytes each device holds (parameters and optimizer state at
    their FSDP shapes, the local inputs)."""
    if case.kind == "train":
        batch = S.train_specs(cfg, case, rules)
        params_c = P.abstract_params(cfg_l)
        opt_c = abstract_state(params_c)
        stored_params = P.abstract_params(cfg, rules)
        stored = (stored_params, abstract_state(stored_params), batch)
        return params_c, opt_c, batch, stored
    params_c = P.abstract_params(cfg_l, dtype="bfloat16")
    stored_params = P.abstract_params(cfg, rules, dtype="bfloat16")
    if case.kind == "prefill":
        batch = S.prefill_specs(cfg, case, rules)
        return params_c, None, batch, (stored_params, batch)
    spec = S.decode_specs(cfg, case, rules)
    b_l = spec["tokens"].shape[0]
    # the cache the device computes on: the local config's leaves at the
    # spec's local batch and sequence extents
    s_l = case.seq_len // rules.shards(rules.spec(
        (case.seq_len,), ("cache_seq",))[0]) if rules.mesh is not None \
        else case.seq_len
    enc = s_l if cfg.family == "audio" else 0
    cache = M.cache_spec(cfg_l, b_l, s_l, enc_len=enc)
    cache["len"], cache["offset"] = s_l - 1, 0
    return params_c, cache, spec["tokens"], (stored_params, spec["cache"],
                                             spec["tokens"])


def lower_cell(arch: str, shape, *, multi_pod: bool = False,
               rule_overrides: dict | None = None, accum: int = 0,
               flash: bool = False, accum_dtype="float32", rules=None,
               grads_only: bool = False):
    """Run one cell's per-device step on meta; returns (record, counter).

    ``shape`` is a name of ``shapes.SHAPES`` or a ``ShapeCase``.
    ``accum=0`` selects the per-arch default microbatching
    (``shapes.TRAIN_ACCUM``) for train cells.  Serve cells run bf16
    weights.  ``rules`` (a ``MeshRules``) replaces the production mesh's,
    e.g. ``MeshRules.single_device()`` for one card.  ``grads_only`` runs
    a train cell's loss and gradients (``train.step._value_and_grad``)
    without the optimizer: no optimizer state is stored or updated, as a
    step that fits only without it runs on one card.
    """
    cfg = C.get(arch) if isinstance(arch, str) else arch
    if flash:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    case = S.SHAPES[shape] if isinstance(shape, str) else shape
    if rules is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        model_size = dict(zip(mesh.axis_names, mesh.shape))["model"]
        # decode caches: prefer kv-head sharding when it divides the model
        # axis; fall back to sequence-sharded caches for small-kv GQA archs
        if cfg.n_kv_heads % model_size == 0 and not cfg.uses_mla:
            overrides = {"cache_seq": None}
        else:
            overrides = {"cache_seq": "model"}
        overrides.update(rule_overrides or {})
        rules = MeshRules.for_mesh(mesh, overrides)
    sizes = rules.axis_sizes()
    chips = rules.num_devices()
    cfg_l = local_config(cfg, rules)

    if case.kind == "train":
        accum = accum or S.TRAIN_ACCUM.get(cfg.name, 1)
        # the global microbatch (batch/accum) must stay divisible by the
        # batch-sharding degree, as in the reference
        batch_shards = chips // sizes.get("model", 1)
        accum = max(1, min(accum, case.global_batch // batch_shards))
    else:
        accum = 1
    a, b, c, stored = _step_inputs(cfg, cfg_l, case, rules)
    if grads_only:
        if case.kind != "train" or accum != 1:
            raise ValueError("grads_only takes a train cell at accum 1")
        b, stored = None, (stored[0], stored[2])

        def step(params, _, batch):
            return _value_and_grad(cfg_l, params, batch)
        tokens = c["tokens"].numel()
    elif case.kind == "train":
        step = make_train_step(cfg_l, AdamW(learning_rate=1e-3), accum=accum,
                               accum_dtype=getattr(torch, accum_dtype))
        tokens = c["tokens"].numel() // accum
    elif case.kind == "prefill":
        def step(params, _, batch):
            return M.prefill(cfg_l, params, batch)
        tokens = c["tokens"].numel() + (c["patches"].shape[0]
                                        * c["patches"].shape[1]
                                        if "patches" in c else 0)
    else:
        def step(params, cache, tokens):
            return M.decode_step(cfg_l, params, cache, tokens)
        tokens = c.numel()

    t0 = time.time()
    with H.OpCounter() as counter:
        step(a, b, c)
        del a, b, c
    _collectives(counter, cfg, cfg_l, rules, kind=case.kind, tokens=tokens,
                 accum=accum)
    t_trace = time.time() - t0
    an = counter.summary()
    flops, bytes_acc, coll = an["flops"], an["hbm_bytes"], an["collectives"]
    terms = roofline_terms(flops, bytes_acc, coll["total"])
    mf = _model_flops(cfg, case)
    arg = H.tensor_bytes(stored)
    mesh_name = "x".join(str(s) for s in sizes.values()) or "1"
    record = {
        "arch": cfg.name,
        "shape": case.name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": case.kind,
        "per_device": {
            "flops": flops,
            "dot_flops": an["dot_flops"],
            "bytes_accessed": bytes_acc,
            "collective_wire_bytes": coll["total"],
            "collectives": {k: v for k, v in coll.items() if k != "total"},
            "argument_bytes": arg,
            "output_bytes": 0,
            "alias_bytes": 0,
            "temp_bytes": an["peak_bytes"],
            "peak_bytes": arg + an["peak_bytes"],
            "kernel_launches": an["kernels"],
            "ops": an["ops"],
        },
        "roofline": dict(
            terms,
            bottleneck=max(terms, key=terms.get).replace("_s", ""),
            step_time_s=max(terms.values()),
        ),
        "model_flops_total": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_fraction": (mf / chips) / flops if flops else 0.0,
        "accum": accum,
        "timings": {"trace_s": t_trace},
    }
    return record, counter


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: str,
             tag: str = "", rule_overrides: dict | None = None,
             accum: int = 0, flash: bool = False, verbose: bool = True,
             accum_dtype="float32"):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    ok, why = S.cell_supported(C.get(arch), shape)
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(
        out_dir, f"{arch}__{shape}__{mesh_name}{tag}.json")
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "skipped": why}
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape} x {mesh_name}: {why}")
        return rec
    try:
        rec, _ = lower_cell(arch, shape, multi_pod=multi_pod,
                            rule_overrides=rule_overrides, accum=accum,
                            flash=flash, accum_dtype=accum_dtype)
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] FAIL {arch} x {shape} x {mesh_name}: {e}")
        return rec
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        t = rec["roofline"]
        pd = rec["per_device"]
        print(f"[dryrun] OK {arch} x {shape} x {mesh_name}: "
              f"compute {t['compute_s']:.4f}s  memory {t['memory_s']:.4f}s  "
              f"collective {t['collective_s']:.4f}s  "
              f"bottleneck={t['bottleneck']}  "
              f"peak {pd['peak_bytes']/2**30:.2f} GiB/dev  "
              f"(trace {rec['timings']['trace_s']:.1f}s)", flush=True)
    return rec


# ---------------------------------------------------------------------------
# N-body cells (the paper's own workload on the production mesh)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _recording_mesh(counter, strategies):
    """The ``DeviceMesh`` collectives recorded in ``counter`` as they are
    issued (per device: each call is one collective that every slot takes
    part in), and every gather made once per slot, as distinct cards would
    hold it, so that the live bytes count each slot's copy.  The kernel
    wrappers the strategies call (``ops.acc_jerk_pot_rect``,
    ``ops.snap_rect``) are counted once per operand layout and replayed
    (``OpCounter.memoize``): the ring calls them P^2 times."""
    mesh_cls = strategies.DeviceMesh
    # from the class dict: ``_gather_group`` stays a staticmethod when
    # put back
    real = {n: mesh_cls.__dict__[n] for n in
            ("all_gather", "all_gather2", "place", "ppermute",
             "_gather_group")}
    rect = {n: getattr(strategies.ops, n)
            for n in ("acc_jerk_pot_rect", "snap_rect")}

    def size(parts):
        return sum(H.tensor_bytes(p) for p in parts)

    def all_gather(self, parts):
        counter.add_collective("all-gather", size(parts), self.size)
        return real["all_gather"](self, parts)

    def all_gather2(self, parts):
        cards, chips = self.shape
        counter.add_collective("all-gather", chips * size(parts[:1]), chips)
        counter.add_collective("all-gather", size(parts), cards)
        return real["all_gather2"](self, parts)

    def place(self, x, placement):
        if placement == "replicated" and not isinstance(x, torch.Tensor):
            counter.add_collective("all-gather", size(x), self.size)
        return real["place"](self, x, placement)

    def ppermute(self, window):
        counter.add_collective("collective-permute", size(window[:1]), 1)
        return real["ppermute"](self, window)

    def gather_group(parts, devices, dim=0):
        return [torch.cat([q.to(d) for q in parts], dim=dim)
                for d in devices]

    mesh_cls.all_gather, mesh_cls.all_gather2 = all_gather, all_gather2
    mesh_cls.place, mesh_cls.ppermute = place, ppermute
    mesh_cls._gather_group = staticmethod(gather_group)
    for n, f in rect.items():
        setattr(strategies.ops, n, counter.memoize(f))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(mesh_cls, n, f)
        for n, f in rect.items():
            setattr(strategies.ops, n, f)


def nbody_record(counter, *, strategy, n, chips, mesh_name, order,
                 argument_bytes, t_trace):
    """The reference's N-body record from a counter that ran the whole
    mesh: FLOPs and bytes divided over the ``chips`` symmetric slots, the
    collectives already per device, the live bytes one slot's share."""
    an = counter.summary()
    flops = an["flops"] / chips
    bytes_acc = an["hbm_bytes"] / chips
    coll = an["collectives"]
    terms = roofline_terms(flops, bytes_acc, coll["total"])
    # the all-pairs kernels are fp32 work outside the tensor cores
    terms["compute_vpu_s"] = flops / PEAK_FP32_FLOPS
    pair_flops = (44.0 + (50.0 if order >= 6 else 0.0)) * float(n) * n
    temp = an["peak_bytes"] / chips
    keys = ("compute_vpu_s", "memory_s", "collective_s")
    return {
        "arch": f"nbody-{strategy}",
        "shape": f"N{n}",
        "mesh": mesh_name,
        "chips": chips,
        "kind": "nbody",
        "per_device": {
            "flops": flops,
            "dot_flops": an["dot_flops"] / chips,
            "bytes_accessed": bytes_acc,
            "collective_wire_bytes": coll["total"],
            "collectives": {k: v for k, v in coll.items() if k != "total"},
            "argument_bytes": argument_bytes,
            "output_bytes": 0,
            "alias_bytes": 0,
            "temp_bytes": temp,
            "peak_bytes": argument_bytes + temp,
            "kernel_launches": {k: v / chips
                                for k, v in an["kernels"].items()},
            "ops": an["ops"] / chips,
        },
        "roofline": dict(
            terms,
            bottleneck=max(keys, key=terms.get).replace("_s", ""),
            step_time_s=max(terms[k] for k in keys),
        ),
        "model_flops_total": pair_flops,
        "model_flops_per_chip": pair_flops / chips,
        "useful_flops_fraction": (pair_flops / chips) / flops
        if flops else 0.0,
        "timings": {"trace_s": t_trace},
    }


def run_nbody_cell(strategy: str, *, n_particles: int = 409_600,
                   multi_pod: bool = False, out_dir: str = OUT_DIR,
                   order: int = 6, tag: str = "", impl: str = "pallas_marked",
                   verbose: bool = True, write: bool = True, rules=None,
                   dt=None, state_dtype=torch.float32):
    """One force evaluation of ``n_particles`` under ``strategy`` over the
    production mesh's slots, each slot on ``meta``; returns the record.

    ``impl`` picks what the counter does with a kernel launch (see the
    module docstring).  ``rules=MeshRules.single_device()`` runs one slot,
    where ``strategy="single"`` is the one-device evaluator
    (``core.evaluate.make_evaluator``).  With ``dt`` the cell is one whole
    Hermite step at that fixed step (predict, evaluate, correct;
    ``hermite.step``) of a state in ``state_dtype``.  The kernels run
    fp32."""
    from repro_torch.core import hermite, nbody
    from repro_torch.core import strategies as ST
    from repro_torch.core.evaluate import make_evaluator

    if impl not in ("xla", "pallas_marked"):
        raise ValueError(f"impl must be 'xla' or 'pallas_marked'; got "
                         f"{impl!r}")
    if rules is not None and rules.mesh is None:
        mesh_name, chips = "1", 1
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        chips = make_production_mesh(multi_pod=multi_pod).size
    devs = [torch.device("meta")] * chips
    n = n_particles

    def meta(*shape, dt=state_dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    state = nbody.ParticleState(
        pos=meta(n, 3), vel=meta(n, 3), acc=meta(n, 3), jerk=meta(n, 3),
        snap=meta(n, 3), crackle=meta(n, 3), mass=meta(n), pot=meta(n),
        time=meta())
    t0 = time.time()
    with H.OpCounter(expand_kernels=impl == "xla") as counter, \
            _recording_mesh(counter, ST):
        # built inside: the evaluator binds the mesh's gather methods
        if strategy == "single":
            ev = make_evaluator(order=order)
        else:
            ev = ST.make_strategy_evaluator(strategy, devices=devs, eps=1e-7,
                                            order=order, chips_per_card=2)
        if dt is None:
            ev(state.pos, state.vel, state.mass)
        else:
            hermite.step(state, dt, ev, order=order)
    t_trace = time.time() - t0
    args = (state.pos, state.vel, state.mass) if dt is None else [
        getattr(state, f.name) for f in dataclasses.fields(state)]
    rec = nbody_record(counter, strategy=strategy, n=n, chips=chips,
                       mesh_name=mesh_name, order=order,
                       argument_bytes=H.tensor_bytes(args), t_trace=t_trace)
    if write:
        os.makedirs(out_dir, exist_ok=True)
        fname = os.path.join(
            out_dir, f"nbody-{strategy}__N{n}__{mesh_name}{tag}.json")
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        t = rec["roofline"]
        print(f"[dryrun] OK nbody-{strategy} N={n} x {mesh_name}: "
              f"compute {t['compute_vpu_s']:.4f}s  "
              f"memory {t['memory_s']:.4f}s  "
              f"collective {t['collective_s']:.4f}s  "
              f"bottleneck={t['bottleneck']} (trace {t_trace:.1f}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(S.SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--nbody", action="store_true",
                    help="N-body strategy cells instead of LM cells")
    ap.add_argument("--strategy", default=None,
                    help="nbody strategy (default: all four)")
    ap.add_argument("--n-particles", type=int, default=409_600)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--accum", type=int, default=0)
    ap.add_argument("--flash", action="store_true",
                    help="attn_impl=flash (K3, counted by its formula)")
    ap.add_argument("--nbody-impl", default="pallas_marked",
                    choices=("xla", "pallas_marked"))
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.nbody:
        from repro_torch.core.strategies import STRATEGIES
        strats = [args.strategy] if args.strategy else list(STRATEGIES)
        for mp in meshes:
            for st in strats:
                run_nbody_cell(st, n_particles=args.n_particles,
                               multi_pod=mp, out_dir=args.out, tag=args.tag,
                               impl=args.nbody_impl)
        return

    archs = [args.arch] if args.arch else C.available()
    shps = [args.shape] if args.shape else list(S.SHAPES)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --arch/--shape, --all, or --nbody")
    for mp in meshes:
        for arch in archs:
            for shape in shps:
                run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                         tag=args.tag, accum=args.accum,
                         rule_overrides=None, flash=args.flash)


if __name__ == "__main__":
    main()
