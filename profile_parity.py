#!/usr/bin/env python3
"""Whether ``chip_smoke.profile_readings``, which reads a ``torch.profiler``
window straight from its kineto events, gives what torch's own event tree
gives, and how much sooner.

    python3 profile_parity.py

Needs a card and ``nvcc``.  It profiles four windows of the kinds that
``chip_smoke.py`` profiles:

- ``train xlstm``: a train step of xlstm-1.3b cut to 8 layers (B = 1,
  S = 256; a Python loop of small kernels, the backward on autograd's
  device thread);
- ``prefill flash``: a prefill of qwen3-0.6b cut to 4 layers under the
  flash route (K3, launched through ``ctypes`` inside an aten op's span);
- ``decode``: one decode step on that prefill's cache;
- ``nbody``: 32 Hermite steps of a Plummer N = 16384 state (K1 and K2,
  launched through ``ctypes`` with no aten op around them), under CUDA's
  sync debug mode as ``kernel_profile`` runs them.

For each it reads the launch count, each kernel name's device ms, their
sum, K3's and K1 + K2's ms, and each aten op's self device ms, both from
``chip_smoke.device_profile`` and from ``prof.events()`` /
``prof.key_averages()``, with the seconds each way (the raw reading first,
before torch builds its tree).  It prints every reading that differs by
more than PARITY_TOL relative and exits nonzero if one does.  The last
line is one JSON object with the readings.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.core import hermite, nbody  # noqa: E402
from repro_torch.core.evaluate import make_evaluator  # noqa: E402
from repro_torch.data import SyntheticLM, batch_spec_for  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import config as lm_config  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import params as lm_params  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

#: the float sums differ only in the order torch adds a parent's and its
#: children's times (self = total - children's totals)
PARITY_TOL = 1e-9
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def profiled(fn, sync_debug=False):
    """(prof, wall ms) of ``fn()`` under ``torch.profiler``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            if sync_debug:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return prof, wall


def tree_readings(prof):
    """The readings from torch's event tree, as chip_smoke read them
    before ``profile_readings``."""
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            n += 1
    ops = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
           if e.device_type == CPU and e.self_device_time_total > 0}
    return {"kernels": n, "by_name": by_name, "ops": ops}


def differences(raw, tree):
    """Readings that differ by more than PARITY_TOL relative."""
    out = []
    if raw["kernels"] != tree["kernels"]:
        out.append(("kernels", raw["kernels"], tree["kernels"]))
    for what in ("by_name", "ops"):
        a, b = raw[what], tree[what]
        for key in sorted(set(a) | set(b)):
            x, y = a.get(key, 0.0), b.get(key, 0.0)
            if abs(x - y) > PARITY_TOL * max(abs(x), abs(y)):
                out.append((f"{what}[{key}]", x, y))
    return out


def compare(label, prof, wall):
    t0 = time.perf_counter()
    p = cs.device_profile(prof, wall)
    raw_s = time.perf_counter() - t0
    raw = {"kernels": p["kernels"] if p else 0,
           "by_name": p["by_name"] if p else {},
           "ops": dict(p["ops"]) if p else {}}
    t0 = time.perf_counter()
    tree = tree_readings(prof)
    tree_s = time.perf_counter() - t0
    diff = differences(raw, tree)
    dev_ms = (sum(raw["by_name"].values()), sum(tree["by_name"].values()))
    print(f"{label}: {raw['kernels']} launches (tree {tree['kernels']}), "
          f"device {dev_ms[0]:.6f} ms (tree {dev_ms[1]:.6f}), "
          f"{len(raw['by_name'])} kernel names, {len(raw['ops'])} ops with "
          f"device time (tree {len(tree['ops'])}); raw reading {raw_s:.2f} s, "
          f"torch's tree {tree_s:.2f} s; {len(diff)} readings differ",
          flush=True)
    for what, x, y in diff[:40]:
        print(f"  differs: {what}: raw {x!r} tree {y!r}", flush=True)
    top = sorted(raw["ops"].items(), key=lambda kv: -kv[1])[:6]
    print("  top ops: " + ", ".join(f"{k} {v:.3f}" for k, v in top),
          flush=True)
    return {"kernels": raw["kernels"], "device_ms": dev_ms,
            "raw_s": raw_s, "tree_s": tree_s,
            "differ": [list(map(str, d)) for d in diff]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_parity: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build()
    out = {}

    cfg = dataclasses.replace(lm_config.get("xlstm-1.3b"), n_layers=8)
    params = lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = AdamW(learning_rate=1e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg, batch_spec_for(cfg, 1, 256), seed=0)(0).items()}
    step(params, state, batch)
    out["train xlstm"] = compare("train xlstm", *profiled(
        lambda: step(params, state, batch)))
    del params, state, step
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(lm_config.get("qwen3-0.6b"), n_layers=4,
                              attn_impl="flash")
    params = lm_params.cast_params(lm_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (4, 2048), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    lm_model.prefill(cfg, params, {"tokens": toks}, max_len=2049)
    held = {}

    def prefill():
        held["cache"] = lm_model.prefill(cfg, params, {"tokens": toks},
                                         max_len=2049)[1]

    out["prefill flash"] = compare("prefill flash", *profiled(prefill))
    out["decode"] = compare("decode", *profiled(
        lambda: lm_model.decode_step(cfg, params, held["cache"],
                                     toks[:, :1])))
    del params, held
    torch.cuda.empty_cache()

    st = nbody.plummer(16384, seed=0, device=dev)
    ev = make_evaluator(order=6, eps=1e-7, dtype="fp32")
    st = hermite.initialize(st, ev)

    def steps():
        s = st
        for _ in range(32):
            s = hermite.step(s, 2.0 ** -12, ev)

    out["nbody"] = compare("nbody", *profiled(steps, sync_debug=True))
    failed = [k for k, v in out.items() if v["differ"]]
    print(f"profile parity: {'every reading equal' if not failed else 'differs in ' + ', '.join(failed)}",
          flush=True)
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
