"""Whether the one adaptive step between the port's and the reference's
kepler_disk at the scenario tour's defaults is rounding.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_tour_steps.py

Not collected by pytest (minutes on a CPU).  It runs kepler_disk as
``examples/ensemble_scenarios.py`` runs it at its defaults (n = 128, 4
members, t_end = 0.125, a diagnostics snapshot every 16 steps) through the
reference's ``repro.sim.driver`` and the port's ``repro_torch.sim.driver``
on the CPU, each in fp32 and in fp64, and the port's fp32 once more on one
CPU thread (other orders of the force sums), and prints each run's steps
and |dE/E|.  If both packages take the same steps in fp64 and the fp32
count moves with the order of the sums alone, the fp32 gap is rounding at
a step-size decision, not a fault.  The last line is one JSON object.
"""

from __future__ import annotations

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

from repro.sim import driver as jdriver  # noqa: E402
from repro_torch.sim import driver  # noqa: E402

SCENARIO = "kepler_disk"
KW = dict(scenario=SCENARIO, n=128, ensemble=4, t_end=0.125, diag_every=16)


def main() -> int:
    out = {}
    for dtype in ("fp32", "fp64"):
        t0 = time.perf_counter()
        impl = {"impl": "xla"} if dtype == "fp32" else {}  # fp64: the oracle
        rep = jdriver.run(jdriver.SimConfig(dtype=dtype, **impl, **KW))
        out[f"reference {dtype}"] = (rep["steps"], rep["de_rel"],
                                     time.perf_counter() - t0)
    threads = torch.get_num_threads()
    for dtype, n_threads in (("fp32", threads), ("fp32", 1), ("fp64", threads)):
        torch.set_num_threads(n_threads)
        t0 = time.perf_counter()
        rep = driver.run(driver.SimConfig(dtype=dtype, device="cpu", **KW))
        out[f"port {dtype} {n_threads} threads"] = (
            rep["steps"], rep["de_rel"], time.perf_counter() - t0)
    torch.set_num_threads(threads)
    for label, (steps, de, secs) in out.items():
        print(f"{SCENARIO} {label:<22} steps {steps:5d} |dE/E| {de:.3e} "
              f"({secs:.1f} s)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
