"""Quickstart: a 512-body Plummer cluster, 6th-order Hermite, the paper's
split (float64 host state, float32 force kernels on the card).

Counterpart of ``examples/quickstart.py``:

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

``--device`` defaults to ``cuda`` and refuses to start without a card;
``--device cpu`` runs the kernels' plain versions.  ``--dtype mixed`` runs
bfloat16 per-pair arithmetic with compensated float32 sums.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import hermite, nbody
from repro_torch.core.evaluate import make_evaluator
from repro_torch.kernels import nbody_force

LEGS = 4
LEG = 0.25


def run(*, n: int = 512, seed: int = 0, dtype: str = "fp32", eta=0.02,
        device="cuda", out=print) -> float:
    """Plummer(n, seed) evolved in ``LEGS`` legs of ``LEG`` time units,
    printing each leg's energy with ``out``; returns the final |dE/E|."""
    state = nbody.plummer(n, seed=seed, device=device)
    # logical tiles no wider than the system: the operands are padded to
    # them, and the plain versions on the CPU pay for the padding
    rows = -(-n // 8) * 8
    evaluator = make_evaluator(
        order=6, dtype=dtype, block_i=min(nbody_force.DEFAULT_BLOCK_I, rows),
        block_j=min(nbody_force.DEFAULT_BLOCK_J, rows))

    state = hermite.initialize(state, evaluator)
    e0 = float(nbody.total_energy(state))
    out(f"t=0.000  E={e0:+.6f}")
    de = 0.0
    for _ in range(LEGS):
        state = hermite.evolve(state, evaluator,
                               t_end=float(state.time) + LEG, eta=eta)
        e = float(nbody.total_energy(state))
        de = abs((e - e0) / e0)
        out(f"t={float(state.time):.3f}  E={e:+.6f}  |dE/E|={de:.2e}")
    return de


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="fp32", choices=("fp32", "mixed"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(n=args.n, seed=args.seed, dtype=args.dtype, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
