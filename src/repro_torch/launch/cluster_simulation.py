"""The paper's representative simulation: a Plummer sphere, 6th-order
Hermite, float32 force evaluation on the card under any of the paper's
scaling strategies (and the ring), validated against the FP64 golden run
with the Fig. 4 energy-distribution comparison.

Counterpart of ``examples/cluster_simulation.py``:

    PYTHONPATH=src python -m repro_torch.launch.cluster_simulation \
        --n 2048 --t-end 0.5 --strategy replicated --devices 4
    PYTHONPATH=src python -m repro_torch.launch.cluster_simulation \
        --n 64 --t-end 0.0625 --device cpu

``--device`` defaults to ``cuda`` and refuses to start without a card.
``--devices k`` runs a strategy's k shards as k slots of the one card
(``[cuda:0] * k``), or of the CPU with ``--device cpu``.  The FP64 golden
run is ``make_evaluator(dtype="fp64")``, the plain float64 oracle, on the
same device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import hermite, nbody, strategies
from repro_torch.core.evaluate import make_evaluator

STRATEGIES = ("single",) + strategies.STRATEGIES
#: the Fig. 4 histogram's bins
BINS = 24


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def energy_overlap(e_dev: np.ndarray, e_golden: np.ndarray):
    """(overlap, device histogram, golden histogram, edges): the shared area
    of the two per-particle energy densities over their common range, the
    example's Fig. 4 measure (1 when the distributions coincide)."""
    lo = min(e_golden.min(), e_dev.min())
    hi = max(e_golden.max(), e_dev.max())
    hg, edges = np.histogram(e_golden, bins=BINS, range=(lo, hi), density=True)
    hd, _ = np.histogram(e_dev, bins=BINS, range=(lo, hi), density=True)
    overlap = float(np.minimum(hg, hd).sum() * (edges[1] - edges[0]))
    return overlap, hd, hg, edges


def run(*, n: int = 2048, t_end: float = 0.5, dt: float = 1.0 / 256,
        strategy: str = "single", devices: int = 1, validate: bool = True,
        seed: int = 0, device="cuda", out=print) -> dict:
    """Plummer(n, seed) to ``t_end`` at the fixed step ``dt`` under
    ``strategy`` over ``devices`` slots of ``device``; with ``validate``,
    the FP64 golden run from the same state and the energy-distribution
    overlap.  Prints the example's lines with ``out`` and returns
    ``{"de_rel", "state", "wall_s"}`` plus, with ``validate``,
    ``{"overlap", "hist", "hist_golden", "edges", "golden_state",
    "golden_s"}``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    dev = nbody.resolve_device(device)
    state = nbody.plummer(n, seed=seed, device=dev)
    if strategy == "single":
        ev = make_evaluator(order=6)
    else:
        ev = strategies.make_strategy_evaluator(
            strategy, devices=[dev] * devices)

    init = hermite.initialize(state, ev)
    e0 = float(nbody.total_energy(init))
    _sync(dev)
    t0 = time.perf_counter()
    final = hermite.evolve(state, ev, t_end=t_end, dt=dt)
    _sync(dev)
    wall = time.perf_counter() - t0
    e1 = float(nbody.total_energy(final))
    de = abs((e1 - e0) / e0)
    out(f"[sim] N={n} strategy={strategy} t={float(final.time):.3f}"
        f" |dE/E|={de:.3e}")
    result = {"de_rel": de, "state": final, "wall_s": wall}
    if not validate:
        return result

    golden = make_evaluator(dtype="fp64")
    t0 = time.perf_counter()
    final_g = hermite.evolve(state, golden, t_end=t_end, dt=dt)
    _sync(dev)
    golden_s = time.perf_counter() - t0
    overlap, hd, hg, edges = energy_overlap(
        nbody.particle_energies(final).cpu().numpy(),
        nbody.particle_energies(final_g).cpu().numpy())
    out(f"[validate] energy-distribution overlap vs FP64 golden: "
        f"{overlap:.3f} (paper Fig. 4: distributions coincide)")
    # ASCII histogram, accelerated (*) vs golden (.)
    peak = max(hg.max(), hd.max())
    for i in range(BINS):
        g = int(30 * hg[i] / peak)
        d = int(30 * hd[i] / peak)
        out(f"  {edges[i]:+.3f} " + "#" * min(g, d)
            + ("*" * (d - g) if d > g else "." * (g - d)))
    result.update(overlap=overlap, hist=hd, hist_golden=hg, edges=edges,
                  golden_state=final_g, golden_s=golden_s)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--t-end", type=float, default=0.5)
    ap.add_argument("--dt", type=float, default=1.0 / 256)
    ap.add_argument("--strategy", default="single", choices=STRATEGIES)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--validate", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(n=args.n, t_end=args.t_end, dt=args.dt, strategy=args.strategy,
        devices=args.devices, validate=args.validate, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
