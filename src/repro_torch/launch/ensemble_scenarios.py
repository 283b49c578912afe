"""Scenario-library and ensemble-engine tour: a small batched ensemble of
every registered scenario, with per-scenario telemetry.

Counterpart of ``examples/ensemble_scenarios.py``:

    PYTHONPATH=src python -m repro_torch.launch.ensemble_scenarios \
        --n 128 --ensemble 4 --t-end 0.125 [--devices 2]
    PYTHONPATH=src python -m repro_torch.launch.ensemble_scenarios \
        --n 32 --ensemble 2 --t-end 0.03125 --device cpu

Each scenario runs as one batched call of ``sim.driver.run`` (B lockstep
copies with different seeds, a per-run shared adaptive step); the table
compares wall time, steps, pair-interaction throughput and the worst
member's energy drift.  ``--device`` defaults to ``cuda`` and refuses to
start without a card; ``--devices k`` shards the members over k slots
(the first k cards; ``--device cpu``: k CPU slots).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.sim import driver, scenarios

HEADER = (f"{'scenario':16s} {'steps':>6s} {'wall_s':>8s} {'pairs/s':>10s} "
          f"{'max|dE/E|':>10s}")


def scenario_n(name: str, n: int) -> int:
    """The example's body count for ``name``: at least the scenario's
    minimum, and 2 for the two-body problem."""
    if name == "two_body":
        return 2
    return max(n, scenarios.get_spec(name).min_n)


def run(*, n: int = 128, ensemble: int = 4, t_end: float = 0.125,
        devices: int = 1, device="cuda", out=print) -> dict:
    """Every registered scenario through ``driver.run``; prints the
    example's table with ``out`` and returns each scenario's report."""
    out(HEADER)
    reports = {}
    for name in scenarios.available():
        report = driver.run(driver.SimConfig(
            scenario=name, n=scenario_n(name, n), ensemble=ensemble,
            t_end=t_end, devices=devices, diag_every=16, device=device))
        out(f"{name:16s} {report['steps']:6d} {report['wall_s']:8.2f} "
            f"{report['interactions_per_s']:10.2e} "
            f"{report['de_rel']:10.2e}")
        reports[name] = report
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--ensemble", type=int, default=4)
    ap.add_argument("--t-end", type=float, default=0.125)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(n=args.n, ensemble=args.ensemble, t_end=args.t_end,
        devices=args.devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
