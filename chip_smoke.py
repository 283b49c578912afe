#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``;
3. each kernel held against its plain PyTorch version on the card, at the
   main path's shape (N_t = N_s = 16384, fp32 and mixed), on a rectangle
   with a partial target mask that includes a fully inactive block, and on
   a batch of two systems;
4. the committed golden trajectories replayed through the kernels, then the
   main path through ``repro_torch.launch.nbody_run.run``: Plummer
   N = 16384, seed 0, Hermite-6, shared Aarseth step (eta = 0.02) to
   t = 0.0625 at fp32, and a shorter mixed-precision run; the kernels'
   launch counts are zeroed just before each run and read just after;
5. CUDA-event timings of each kernel at N = 16384 and 65536 beside its
   plain version and its bound, printed as one ``kernels`` JSON line;
6. ``{"ok": true, "device": {...}}`` as the last line.

It imports torch, numpy, the standard library and ``repro_torch`` only, and
exits nonzero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import hermite, nbody  # noqa: E402
from repro_torch.core.evaluate import make_evaluator  # noqa: E402
from repro_torch.kernels import _build, nbody_force, ops  # noqa: E402
from repro_torch.launch import nbody_run  # noqa: E402

N_MAIN = 16384
N_LARGE = 65536
T_END = 0.0625
T_END_MIXED = 0.015625
ETA = 0.02

#: Kernel vs plain version, as max |kernel - plain| over a column group
#: divided by max |plain| over that group.  fp32: both sum the same float32
#: terms in other orders (the kernel per 128-source tile, the plain version
#: per 512-source block) and the kernel uses rsqrtf and FMA contraction;
#: rounding of a 16384-term sum stays near sqrt(16384) * 2**-24 ~ 8e-6 of
#: the partial-sum scale at worst, so 1e-5 of the group's largest value
#: holds.  mixed: a term that lands on the other side of a bfloat16 rounding
#: boundary moves by one bf16 ulp (2**-8 relative); 1e-2 bounds a few such
#: flips in the largest row while an uncompensated or unrounded sum fails.
TOL = {"fp32": 1e-5, "mixed": 1e-2}
#: |dE/E| tiers of the precision modes (benchmarks/bench_ci.py DE_TIERS)
DE_TIERS = {"fp32": 1e-4, "mixed": 1e-3}
#: golden-trajectory tiers (tests/test_golden_trajectories.py TOL)
GOLDEN_TOL = {"fp32": 1e-7, "mixed": 1e-3}

#: H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores and HBM3 bandwidth, at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: operations per pair, counted from src/repro_torch/csrc/nbody_force.cu
#: (FMA = 2, rsqrtf = 1); mixed replaces each accumulate-add by a two-sum
FLOPS_PER_PAIR = {("acc_jerk_pot", "fp32"): 43, ("acc_jerk_pot", "mixed"): 85,
                  ("snap", "fp32"): 72, ("snap", "mixed"): 90}
REPLACES = {
    "acc_jerk_pot": "src/repro/kernels/nbody_force.py:146",
    "snap": "src/repro/kernels/nbody_force.py:189",
}
SOURCE = "src/repro_torch/csrc/nbody_force.cu"


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def phase(title: str):
    print(f"== {title}", flush=True)


# --------------------------------------------------------------------------
# operands
# --------------------------------------------------------------------------
def plummer_operands(n, seed, dev, block_i, block_j):
    """Packed K1 and K2 operands of a Plummer system; the snap pass's
    accelerations come from the plain K1 at float32."""
    s = nbody.plummer(n, seed=seed, device=dev)
    nt = -(-n // block_i) * block_i
    ns = -(-n // block_j) * block_j
    tgt = ops.pack_targets(s.pos, s.vel, nt)
    src = ops.pack_sources(s.pos, s.vel, s.mass, ns)
    acc = nbody_force._acc_jerk_plain(
        ops.pack_targets(s.pos, s.vel, ns), src, eps=1e-7,
        block_i=block_i, block_j=block_j, compute_dtype=None)[:n, 0:3]
    tacc = ops.pack_acc_targets(acc, nt)
    sacc = ops.pack_acc_sources(acc, ns)
    return tgt, src, tacc, sacc


def rect_operands(n_t, n_s, dev, block_i, block_j, seed=7):
    """A target cloud of n_t and a source cloud of n_s (some zero-mass
    sources, some targets also sources), with a partial mask whose first
    block_i targets are all inactive."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    ps, vs = t(rng.standard_normal((n_s, 3))), t(0.1 * rng.standard_normal((n_s, 3)))
    ms = t(rng.uniform(0.5, 1.5, n_s) / n_s)
    ms[-97:] = 0.0
    pt, vt = t(rng.standard_normal((n_t, 3))), t(0.1 * rng.standard_normal((n_t, 3)))
    pt[: n_t // 4], vt[: n_t // 4] = ps[: n_t // 4], vs[: n_t // 4]
    mask = torch.as_tensor(rng.uniform(size=n_t) < 0.5, device=dev)
    mask[:block_i] = False
    nt = -(-n_t // block_i) * block_i
    ns = -(-n_s // block_j) * block_j
    acc_t, acc_s = t(rng.standard_normal((n_t, 3))), t(rng.standard_normal((n_s, 3)))
    return (ops.pack_targets(pt, vt, nt, mask), ops.pack_sources(ps, vs, ms, ns),
            ops.pack_acc_targets(acc_t, nt), ops.pack_acc_sources(acc_s, ns))


# --------------------------------------------------------------------------
# comparisons and timings
# --------------------------------------------------------------------------
GROUPS = {"acc_jerk_pot": {"acc": (0, 3), "jerk": (3, 6), "pot": (6, 7)},
          "snap": {"snap": (0, 3)}}


def compare(name, got, want, tgt, tol):
    """Normalised and absolute error of a kernel output against its plain
    version, with the exact-zero contracts (pad column, inactive rows)."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    norm_err, abs_err = 0.0, 0.0
    for lo, hi in GROUPS[name].values():
        d = float((got[..., lo:hi] - want[..., lo:hi]).abs().max())
        scale = float(want[..., lo:hi].abs().max())
        abs_err = max(abs_err, d)
        norm_err = max(norm_err, d / scale if scale > 0 else d)
    zero_cols = 7 if name == "acc_jerk_pot" else 3
    check(bool((got[..., zero_cols:] == 0).all()),
          f"{name}: padding columns not exactly zero")
    inactive = tgt[..., 3] == 0
    check(bool((got[inactive] == 0).all()),
          f"{name}: inactive target rows not exactly zero")
    check(norm_err <= tol, f"{name}: normalised error {norm_err:.3e} > {tol}")
    return norm_err, abs_err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(name, dtype, n_t_active, n_t, n_s):
    """Least time for the work: flops of the active pairs over the fp32
    peak, or each operand read once and the output written once over HBM
    bandwidth, whichever is larger."""
    flops = FLOPS_PER_PAIR[(name, dtype)] * n_t_active * n_s
    operands = 2 if name == "acc_jerk_pot" else 4
    nbytes = 4 * 8 * (n_t + n_s) * (operands // 2) + 4 * 8 * n_t
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no card, "
              "nothing run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"acc_jerk_pot": nbody_force.acc_jerk_pot_packed,
               "snap": nbody_force.snap_packed}
    plains = {"acc_jerk_pot": nbody_force._acc_jerk_plain,
              "snap": nbody_force._snap_plain}
    bi, bj = nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J

    phase("1. card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)

    phase("3. kernels vs plain versions on the card")
    errs = {}

    def hold(label, name, operands, dtype):
        cdt = ops.compute_dtype_for(dtype)
        got = kernels[name](*operands, block_i=bi, block_j=bj, compute_dtype=cdt)
        batch = operands[0].shape[0] if operands[0].dim() == 3 else 0
        want = nbody_force._plain(plains[name], operands, batch, eps=1e-7,
                                  block_i=bi, block_j=bj, compute_dtype=cdt)
        torch.cuda.synchronize()
        norm_err, abs_err = compare(name, got, want, operands[0], TOL[dtype])
        errs[(label, name, dtype)] = (norm_err, abs_err)
        print(f"{label:<28} {name:<13} {dtype:<6} max normalised err "
              f"{norm_err:.3e} (tol {TOL[dtype]:.0e})  max abs err "
              f"{abs_err:.3e}", flush=True)

    tgt, src, tacc, sacc = plummer_operands(N_MAIN, 0, dev, bi, bj)
    main_ops = {"acc_jerk_pot": (tgt, src), "snap": (tgt, src, tacc, sacc)}
    for dtype in ("fp32", "mixed"):
        for name in kernels:
            hold(f"plummer {N_MAIN}", name, main_ops[name], dtype)
    r_tgt, r_src, r_tacc, r_sacc = rect_operands(3000, 10000, dev, bi, bj)
    rect_ops = {"acc_jerk_pot": (r_tgt, r_src),
                "snap": (r_tgt, r_src, r_tacc, r_sacc)}
    for dtype in ("fp32", "mixed"):
        for name in kernels:
            hold("rect 3072x10240 masked", name, rect_ops[name], dtype)
    pairs = [plummer_operands(2048, seed, dev, bi, bj) for seed in (1, 2)]
    batch_ops = [torch.stack(xs) for xs in zip(*pairs)]
    for name, k in (("acc_jerk_pot", 2), ("snap", 4)):
        hold("batch B=2 plummer 2048", name, batch_ops[:k], "fp32")

    phase("4. golden replays and the main path")
    for fname in ("two_body.json", "plummer16.json"):
        with open(os.path.join(ROOT, "tests", "golden", fname)) as f:
            doc = json.load(f)
        m = doc["meta"]
        for dtype in ("fp32", "mixed"):
            st = nbody.zeros_like_state(
                *(torch.tensor(doc[k], dtype=torch.float64, device=dev)
                  for k in ("pos0", "vel0", "mass")))
            out = hermite.evolve_scan(
                st, make_evaluator(order=m["order"], eps=m["eps"], dtype=dtype),
                n_steps=m["n_steps"], dt=m["dt"], order=m["order"])
            dev_pos = float(np.abs(out.pos.cpu().numpy() - np.asarray(doc["pos"])).max())
            dev_vel = float(np.abs(out.vel.cpu().numpy() - np.asarray(doc["vel"])).max())
            print(f"golden {fname:<15} {dtype:<6} max |dpos| {dev_pos:.3e} "
                  f"|dvel| {dev_vel:.3e} (tol {GOLDEN_TOL[dtype]:.0e})", flush=True)
            check(max(dev_pos, dev_vel) <= GOLDEN_TOL[dtype],
                  f"golden {fname} {dtype} off by {max(dev_pos, dev_vel):.3e}")

    launches, step_ms = {}, {}
    for dtype, t_end in (("fp32", T_END), ("mixed", T_END_MIXED)):
        for k in kernels.values():
            k.launches = 0
        r = nbody_run.run(n=N_MAIN, t_end=t_end, eta=ETA, seed=0, dtype=dtype,
                          device=dev)
        counts = {name: k.launches for name, k in kernels.items()}
        launches[dtype] = counts
        step_ms[dtype] = 1e3 * r["wall_s"] / max(r["steps"], 1)
        out = r["state"]
        print(f"main path {dtype}: N={N_MAIN} t={r['t']:.6f} steps={r['steps']} "
              f"evaluations={r['evals']} launches={counts} "
              f"wall={r['wall_s']:.3f} s ({step_ms[dtype]:.4f} "
              f"ms/step) |dE/E|={r['de_rel']:.3e} (tier {DE_TIERS[dtype]:.0e})",
              flush=True)
        for name, c in counts.items():
            check(c > 0, f"main path {dtype}: kernel {name} never launched")
            check(c == r["evals"], f"main path {dtype}: {name} launched {c} "
                                   f"times for {r['evals']} evaluations")
        check(abs(r["t"] - t_end) < 1e-12, f"main path {dtype} stopped at t={r['t']}")
        check(all(bool(torch.isfinite(x).all()) for x in (out.pos, out.vel, out.acc))
              and tuple(out.pos.shape) == (N_MAIN, 3), f"main path {dtype}: bad state")
        check(r["de_rel"] <= DE_TIERS[dtype],
              f"main path {dtype}: |dE/E| {r['de_rel']:.3e} > {DE_TIERS[dtype]}")

    phase("5. timings (CUDA events)")
    timings = {}
    large = plummer_operands(N_LARGE, 0, dev, bi, bj)
    shapes = {N_MAIN: main_ops,
              N_LARGE: {"acc_jerk_pot": large[:2], "snap": large}}
    for n, ops_n in shapes.items():
        for name in kernels:
            for dtype in ("fp32", "mixed"):
                cdt = ops.compute_dtype_for(dtype)
                x = ops_n[name]

                def k_call():
                    return kernels[name](*x, block_i=bi, block_j=bj, compute_dtype=cdt)

                def p_call():
                    return plains[name](*x, eps=1e-7, block_i=bi, block_j=bj,
                                        compute_dtype=cdt)

                kr = 10 if n == N_MAIN else 3
                ms = cuda_ms(k_call, kr)
                pms = cuda_ms(p_call, 3 if n == N_MAIN else 1, warmup=1)
                bms, by = bound_ms(name, dtype, int((x[0][:, 3] != 0).sum()), x[0].shape[0],
                                   x[1].shape[1])
                timings[(name, dtype, n)] = (ms, pms, bms, by)
                print(f"{name:<13} {dtype:<6} N={n:<6} kernel {ms:.4f} ms  "
                      f"plain {pms:.4f} ms  bound {bms:.4f} ms ({by})  "
                      f"bound/kernel {bms / ms:.3f}", flush=True)

    for dtype in ("fp32", "mixed"):
        k_ms = sum(timings[(name, dtype, N_MAIN)][0] for name in kernels)
        print(f"step breakdown {dtype}: the two kernels take {k_ms:.4f} ms of "
              f"{step_ms[dtype]:.4f} ms per step ({100 * k_ms / step_ms[dtype]:.1f}%); "
              f"the rest is float64 predict/correct, packing and the host",
              flush=True)

    rows = []
    for name in kernels:
        ms, pms, bms, by = timings[(name, "fp32", N_MAIN)]
        ms_l, pms_l, bms_l, _ = timings[(name, "fp32", N_LARGE)]
        ms_m, pms_m, bms_m, _ = timings[(name, "mixed", N_MAIN)]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches["fp32"][name],
            "max_abs_err": errs[(f"plummer {N_MAIN}", name, "fp32")][1],
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "n": N_MAIN, "dtype": "fp32",
            "max_norm_err": errs[(f"plummer {N_MAIN}", name, "fp32")][0],
            "tol": TOL["fp32"],
            "launches_mixed": launches["mixed"][name],
            "ms_mixed": ms_m, "plain_ms_mixed": pms_m, "bound_ms_mixed": bms_m,
            "ms_n65536": ms_l, "plain_ms_n65536": pms_l,
            "bound_ms_n65536": bms_l,
        })
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
