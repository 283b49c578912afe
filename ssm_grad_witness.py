#!/usr/bin/env python3
"""Why the ssm and hybrid families' gradients lie further apart between
the card and the CPU than the attention families' do: rounding, or a
fault.

    python3 ssm_grad_witness.py
    python3 ssm_grad_witness.py --mlstm-ops [--out PATH]   # op by op only

Needs a card.  At ``chip_smoke.py`` phase 18 (c)'s inputs (full width,
xlstm-1.3b cut to 8 layers, zamba2-7b to 9, and qwen2-vl-2b at 2 as a
control with no recurrence; B = 1, 256 positions; the same seeded weights
and batch) it computes the loss and gradients six ways:

- ``card``, ``cpu``: fp32 activations on the card and on the CPU (phase 18
  (c)'s two sides);
- ``cpu1``: the CPU in fp32 on one thread (other orders of the sums in
  the CPU's own reductions);
- ``card64``, ``cpu64``: every activation and statistic in float64
  (``torch.float32`` and the model's ``F32`` read as float64 while they
  run; a dispatch mode counts any op that still gives a float32 tensor);
- ``bf16``: the card with bf16 activations (fp32 masters): the size of a
  real loss of precision, the control a tolerance must stay below.

It prints, per gradient leaf, max |a - b| / max |b| for card against cpu
(phase 18 (c)'s reading), cpu1 against cpu, card64 against cpu64 (the
same function on both sides, if the port is right: about 1e-12), card
and cpu each against cpu64 (how far each fp32 side lies from float64),
and bf16 against cpu64.  If card and cpu lie about as far from cpu64 as
each other and card64 meets cpu64, the fp32 gap is rounding that the
model's sensitivity amplifies, not a fault of either side.

Then, to find where the gap arises, one forward in fp32 on each side and
in float64 on the CPU: every block's output, and the sLSTM's hidden state
h in eight spans of 32 positions, each side against cpu64.  The last line
is one JSON object with every reading.

``--mlstm-ops`` reads the mLSTM cell op by op (``mlstm_ops``): the inputs
of ``ssm.mlstm_chunked`` in xlstm-1.3b's mLSTM block ``OPS_BLOCK`` (at
the inputs above, taken from the float64 forward on the CPU), its forward
and a backward against a seeded cotangent recorded op by op in float64 on
the CPU; then each recorded op is run again on its own float64 inputs
rounded to fp32, on the card and on the CPU, and its output held against
the float64 one.  That is each op's own rounding, with no error carried
in from the ops before it: an op whose card reading lies well above the
CPU's sums in an order of its own.  The whole cell, forward and backward,
is also run in fp32 on both sides from the rounded inputs and held
against float64 (how far the cell carries the ops' rounding).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.data import SyntheticLM, batch_spec_for  # noqa: E402
from repro_torch.models import config as lm_config  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import params as lm_params  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

ARCHS = ("xlstm-1.3b", "zamba2-7b", "qwen2-vl-2b")
#: the mLSTM block whose cell ``mlstm_ops`` reads (0-based): where the
#: fp32 gradients' distance from float64 peaks through xlstm's stack
OPS_BLOCK = 5
#: an op's own error on the card counts as its own order of summation
#: where it exceeds the CPU's by this factor (and 1e-7 of its output)
OPS_RATIO = 3.0
#: the op-by-op table prints the ops whose own error exceeds this on
#: either side; the whole table goes to ``OPS_OUT`` (or ``--out PATH``)
OPS_SHOWN = 2e-7
OPS_OUT = os.path.join(ROOT, "experiments", "ssm_grad_witness",
                       "mlstm_ops.json")
#: the block functions whose outputs the forward records
BLOCKS = ("mlstm_block", "slstm_block", "mamba_block", "transformer_block")
SPANS = 8


#: the real float32, kept while ``float64_everywhere`` stands in for it
FLOAT32 = torch.float32


class Float32Ops(TorchDispatchMode):
    """Counts the ops that give a float32 tensor, by name."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == FLOAT32
               for t in tree_leaves(out)):
            self.seen[str(func)] = self.seen.get(str(func), 0) + 1
        return out


@contextlib.contextmanager
def float64_everywhere():
    """``torch.float32`` and the model's ``F32`` read as float64 for the
    ``with`` block: every cast the model makes to fp32 makes float64."""
    saved = torch.float32, lm_model.F32, ssm.F32
    torch.float32 = lm_model.F32 = ssm.F32 = torch.float64
    try:
        yield
    finally:
        torch.float32, lm_model.F32, ssm.F32 = saved


def rel(a, b):
    """max |a - b| / max |b| (b's largest element 0: max |a|)."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max())
    d = float((a - b).abs().max())
    return d / scale if scale else d


def grads(cfg, params, batch, dtype):
    """(loss, gradient leaves on the CPU, seconds, the ops that gave a
    float32 tensor or None) of ``_value_and_grad`` with activations in
    ``dtype`` ("float32", "float64" or "bfloat16")."""
    t0 = time.perf_counter()
    f32 = None
    if dtype == "float64":
        p64 = tree_util.map(lambda x: x.double(), params)
        mode = Float32Ops()
        with float64_everywhere(), mode:
            loss, _, g = _value_and_grad(cfg, p64, batch)
        del p64
        f32 = mode.seen
    else:
        loss, _, g = _value_and_grad(dataclasses.replace(cfg, dtype=dtype),
                                     params, batch)
    leaves = [x.cpu() for x in tree_util.leaves(g)]
    del g
    return float(loss), leaves, time.perf_counter() - t0, f32


def forward_readings(cfg, params, batch, dtype):
    """Each block's output and each sLSTM's h of one forward
    (``train=False``) in fp32 or float64, moved to the CPU."""
    blocks, hs = [], []
    with contextlib.ExitStack() as stack:
        for name in BLOCKS:
            if hasattr(lm_model, name):
                stack.enter_context(cs.spying(
                    lm_model, name, lambda a, out, name=name: blocks.append(
                        (name, first(out)))))
        stack.enter_context(cs.spying(
            ssm, "slstm_scan", lambda a, out: hs.append(first(out))))
        if dtype == "float64":
            params = tree_util.map(lambda x: x.double(), params)
            stack.enter_context(float64_everywhere())
        lm_model.forward(cfg, params, batch)
    return blocks, hs


def first(out):
    """A block's (or scan's) output tensor, float64 on the CPU."""
    return (out[0] if isinstance(out, tuple) else out).double().cpu()


def spans(x, y):
    """rel of x against y in SPANS equal spans of positions (dim 1)."""
    n = x.shape[1]
    return [rel(x[:, j * n // SPANS:(j + 1) * n // SPANS],
                y[:, j * n // SPANS:(j + 1) * n // SPANS])
            for j in range(SPANS)]


def witness(dev, arch):
    cfg = dataclasses.replace(lm_config.get(arch), dtype="float32",
                              **cs.FAMILY_GRAD_CUT[arch])
    card = lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    spec = batch_spec_for(cfg, cs.FAMILY_GRAD_BATCH, cs.FAMILY_GRAD_SEQ)
    nb = SyntheticLM(cfg, spec, seed=1)(0)
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in nb.items()}
    on_card = {k: v.to(dev) for k, v in host.items()}
    cpu = tree_util.map(lambda x: x.cpu(), card)
    names = list(cs.leaf_names(card))
    keep = [i for i, x in enumerate(tree_util.leaves(card)) if x.numel()]
    threads = torch.get_num_threads()
    # the two references are kept; every other run is read against them
    # and dropped, so at most three sets of gradients are held at once
    refs = {"cpu64": grads(cfg, cpu, host, "float64"),
            "cpu": grads(cfg, cpu, host, "float32")}
    against = {"cpu": ("cpu64",), "card": ("cpu", "cpu64"),
               "cpu1": ("cpu", "cpu64"), "card64": ("cpu64",),
               "bf16": ("cpu64",)}
    leaves = {names[i]: {} for i in keep}
    losses, seconds, f32 = {}, {}, {}
    for run, refs_of in against.items():
        if run in refs:
            r = refs[run]
        elif run == "cpu1":
            torch.set_num_threads(1)
            try:
                r = grads(cfg, cpu, host, "float32")
            finally:
                torch.set_num_threads(threads)
        else:
            r = grads(cfg, card, on_card,
                      {"card": "float32", "card64": "float64",
                       "bf16": "bfloat16"}[run])
            torch.cuda.empty_cache()
        losses[run], seconds[run], f32[run] = r[0], r[2], r[3]
        for i in keep:
            for ref in refs_of:
                leaves[names[i]][f"{run}/{ref}"] = rel(r[1][i],
                                                       refs[ref][1][i])
        del r
    losses["cpu64"], seconds["cpu64"] = refs["cpu64"][0], refs["cpu64"][2]
    f32["cpu64"] = refs["cpu64"][3]
    del refs
    label = cs.family_label(cfg)
    print(f"== {label}, B={spec.batch} S={spec.seq}, CPU threads {threads}: "
          "loss " + ", ".join(f"{k} {v:.9f} ({seconds[k]:.1f} s)"
                              for k, v in losses.items()), flush=True)
    for k in ("card64", "cpu64"):
        print(f"  {k}: ops that gave a float32 tensor: {f32[k] or 'none'}",
              flush=True)
    cols = list(next(iter(leaves.values())))
    print(f"  {'leaf':<26}" + "".join(f"{c:>14}" for c in cols), flush=True)
    for name, row in leaves.items():
        print(f"  {name:<26}" + "".join(f"{row[c]:>14.3e}" for c in cols),
              flush=True)
    worst = {c: max(row[c] for row in leaves.values()) for c in cols}
    print("  worst leaf: " + ", ".join(f"{c} {v:.3e}"
                                        for c, v in worst.items()), flush=True)
    # where the gap arises: each block's output and the sLSTM's h
    ref_b, ref_h = forward_readings(cfg, cpu, host, "float64")
    fwd = {}
    for side, params, batch in (("card", card, on_card), ("cpu", cpu, host)):
        b, h = forward_readings(cfg, params, batch, "float32")
        fwd[side] = {"blocks": [(n, rel(x, y)) for (n, x), (_, y)
                                in zip(b, ref_b)],
                     "slstm_h": [spans(x, y) for x, y in zip(h, ref_h)]}
        print(f"  forward {side} fp32 vs cpu64, each block's output: "
              + ", ".join(f"{i} {n.split('_')[0]} {e:.2e}"
                          for i, (n, e) in enumerate(fwd[side]["blocks"])),
              flush=True)
        for i, row in enumerate(fwd[side]["slstm_h"]):
            print(f"  forward {side} fp32 vs cpu64, sLSTM {i}'s h in "
                  f"{SPANS} spans of positions: "
                  + " ".join(f"{e:.2e}" for e in row), flush=True)
    del card, cpu
    torch.cuda.empty_cache()
    return {"leaves": leaves, "worst": worst, "losses": losses,
            "float32_ops": f32, "forward": fwd}


class Recording(TorchDispatchMode):
    """Records each op that gives a floating tensor: (op, args, kwargs,
    output), every tensor a detached copy on the host."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and all(t.is_floating_point() for t in outs):
            keep = _tree_map(lambda t: t.detach().cpu().clone())
            self.ops.append((func, keep(args), keep(kwargs), keep(out)))
        return out


def _tree_map(fn):
    from torch.utils._pytree import tree_map

    def apply(tree):
        return tree_map(lambda t: fn(t) if isinstance(t, torch.Tensor)
                        else t, tree)
    return apply


def _as_fp32(tree, dev):
    """A recorded op's float64 arguments rounded to fp32 on ``dev``; a
    float64 dtype or a device among the keywords follows."""
    from torch.utils._pytree import tree_map

    def one(t):
        if isinstance(t, torch.Tensor):
            return t.to(dev, FLOAT32 if t.dtype == torch.float64 else t.dtype)
        if t is torch.float64:
            return FLOAT32
        if isinstance(t, torch.device):
            return torch.device(dev)
        return t
    return tree_map(one, tree)


def _cell(ins, kw, cot):
    """mlstm_chunked's h and the gradients of <h, cot> by its inputs."""
    ins = [x.detach().requires_grad_(True) for x in ins]
    h, _ = ssm.mlstm_chunked(*ins, **kw)
    return [h.detach()] + list(torch.autograd.grad(h, ins, cot))


def mlstm_ops(dev):
    """The op-by-op reading of the mLSTM cell (the module docstring's
    ``--mlstm-ops``).  Returns its readings."""
    arch = "xlstm-1.3b"
    cfg = dataclasses.replace(lm_config.get(arch), dtype="float32",
                              **cs.FAMILY_GRAD_CUT[arch])
    params = lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    spec = batch_spec_for(cfg, cs.FAMILY_GRAD_BATCH, cs.FAMILY_GRAD_SEQ)
    nb = SyntheticLM(cfg, spec, seed=1)(0)
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in nb.items()}
    cpu = tree_util.map(lambda x: x.cpu().double(), params)
    del params
    calls = []
    with float64_everywhere(), cs.spying(
            ssm, "mlstm_chunked", lambda a, out: calls.append(a)):
        lm_model.forward(cfg, cpu, host)
    del cpu
    q, k, v, gi, gf = (x.detach() for x in calls[OPS_BLOCK])
    kw = {"chunk": min(cfg.chunk_size, q.shape[1])}
    gen = torch.Generator().manual_seed(5)
    cot = torch.randn(q.shape, generator=gen, dtype=torch.float64)
    rec = Recording()
    with float64_everywhere(), rec:
        ref = _cell((q, k, v, gi, gf), kw, cot)
    # the whole cell in fp32 from the rounded inputs, each side
    cell = {}
    for side in ("card", "cpu"):
        d = dev if side == "card" else torch.device("cpu")
        got = _cell([x.to(d, FLOAT32) for x in (q, k, v, gi, gf)], kw,
                    cot.to(d, FLOAT32))
        cell[side] = {n: rel(g, r) for n, g, r in zip(
            ("h", "dq", "dk", "dv", "dgi", "dgf"), got, ref)}
    # each op on its own rounded inputs, each side
    rows = []
    for i, (func, args, kwargs, out) in enumerate(rec.ops):
        want = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        row = {"i": i, "op": str(func)}
        for side in ("card", "cpu"):
            d = dev if side == "card" else torch.device("cpu")
            got = [t for t in tree_leaves(func(*_as_fp32(args, d),
                                               **_as_fp32(kwargs, d)))
                   if isinstance(t, torch.Tensor)]
            row[side] = max((rel(g, w) for g, w in zip(got, want)),
                            default=0.0)
        row["shape"] = tuple(want[0].shape) if want else ()
        rows.append(row)
    own = [r for r in rows if r["card"] > OPS_RATIO * max(r["cpu"], 1e-30)
           and r["card"] > 1e-7]
    print(f"== mLSTM cell of {cs.family_label(cfg)} block {OPS_BLOCK}, "
          f"q {tuple(q.shape)}, chunk {kw['chunk']}: {len(rec.ops)} ops "
          f"(forward and backward) recorded in float64", flush=True)
    for side, r in cell.items():
        print(f"  whole cell fp32 {side} vs cpu64: "
              + ", ".join(f"{n} {e:.3e}" for n, e in r.items()), flush=True)
    print(f"  each op on its own fp32-rounded inputs vs float64, where either "
          f"side exceeds {OPS_SHOWN:g} (a rounding of the inputs alone is "
          f"about 6e-8):", flush=True)
    print(f"  {'#':>4} {'op':<44}{'card':>12}{'cpu':>12}  shape", flush=True)
    for r in rows:
        if max(r["card"], r["cpu"]) > OPS_SHOWN:
            print(f"  {r['i']:>4} {r['op']:<44}{r['card']:>12.3e}"
                  f"{r['cpu']:>12.3e}  {r['shape']}", flush=True)
    print(f"  ops whose own card error exceeds {OPS_RATIO:g}x the CPU's "
          f"(and 1e-7): " + ("; ".join(
              f"{r['i']} {r['op']} {r['card']:.2e} vs {r['cpu']:.2e}"
              for r in own) or "none"), flush=True)
    return {"block": OPS_BLOCK, "cell": cell, "ops": rows,
            "card_own_order": [r["i"] for r in own]}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_grad_witness: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if "--mlstm-ops" in sys.argv[1:]:
        t0 = time.perf_counter()
        out = mlstm_ops(dev)
        print(f"  took {time.perf_counter() - t0:.1f} s", flush=True)
        args = sys.argv[1:]
        path = args[args.index("--out") + 1] if "--out" in args else OPS_OUT
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f)
        print(json.dumps({"mlstm_ops": {k: out[k] for k in (
            "block", "cell", "card_own_order")}, "table": path}))
        return 0
    out = {}
    for arch in ARCHS:
        t0 = time.perf_counter()
        out[arch] = witness(dev, arch)
        print(f"  {arch} took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
