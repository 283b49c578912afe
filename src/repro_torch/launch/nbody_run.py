"""N-body simulation launcher: the paper's one-card workload end to end.

Port of ``repro/launch/nbody_run.py``.  Runs a Plummer-sphere direct
N-body simulation with the 6th-order Hermite integrator, the force
evaluation on the card's CUDA kernels:

  PYTHONPATH=src python -m repro_torch.launch.nbody_run --n 16384 \
      --t-end 0.0625 --dtype fp32

``--device cpu`` runs the plain PyTorch versions instead; the default,
``cuda``, refuses to start without a card.  Only ``--strategy single`` is
ported; the multi-device strategies are ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.core import hermite, nbody
from repro_torch.core.evaluate import make_evaluator
from repro_torch.kernels import ops

STRATEGIES = ("single", "replicated", "two_level", "mesh_sharded", "ring")


def run(*, n: int, t_end: float, dt=None, eta: float = 0.02, order: int = 6,
        seed: int = 0, dtype: str = "fp32", device="cuda") -> dict:
    """Plummer(n, seed) evolved to ``t_end``; returns the energy drift, the
    number of force evaluations (each launches both kernels once at order
    6) and the wall time of the evolution."""
    dev = nbody.resolve_device(device)
    state = nbody.plummer(n, seed=seed, device=dev)
    evaluate = make_evaluator(order=order, dtype=dtype)
    n_evals = 0

    def counted(pos, vel, mass):
        nonlocal n_evals
        n_evals += 1
        return evaluate(pos, vel, mass)

    e0 = float(nbody.total_energy(hermite.initialize(state, counted)))
    t0 = time.perf_counter()
    out = hermite.evolve(state, counted, t_end=t_end, dt=dt, eta=eta,
                         order=order)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    e1 = float(nbody.total_energy(out))
    return {"n": n, "dtype": dtype, "device": str(dev), "order": order,
            "t": float(out.time), "steps": n_evals - 2, "evals": n_evals,
            "wall_s": wall, "e0": e0, "e1": e1,
            "de_rel": abs((e1 - e0) / e0), "state": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--dt", type=float, default=None,
                    help="fixed step (default: shared adaptive Aarseth)")
    ap.add_argument("--eta", type=float, default=0.02)
    ap.add_argument("--order", type=int, default=6, choices=(4, 6))
    ap.add_argument("--strategy", default="single", choices=STRATEGIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="fp32", choices=ops.DTYPES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.strategy != "single":
        ap.exit(2, f"--strategy {args.strategy}: not yet ported to "
                   f"repro_torch; see ROADMAP.md queue 1 item 7\n")
    r = run(n=args.n, t_end=args.t_end, dt=args.dt, eta=args.eta,
            order=args.order, seed=args.seed, dtype=args.dtype,
            device=args.device)
    print(f"[nbody] N={r['n']} strategy=single device={r['device']} "
          f"dtype={r['dtype']} order={r['order']} steps={r['steps']}")
    print(f"[nbody] t={r['t']:.4f} wall={r['wall_s']:.2f}s "
          f"E0={r['e0']:.6f} E1={r['e1']:.6f} |dE/E0|={r['de_rel']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
