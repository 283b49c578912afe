"""The paper's Fig. 6 / Table 1 energy model with the H100's constants.

Port of ``repro/obs/energy.py``: the same model and util check, with the
card's constants in place of the reference's TPU ones.  Energy to solution
is *modeled* the way the paper's own analysis does it (documented
constants, dominant-term occupancy):

  P_chip = 700 W            (the H100 SXM's power limit)
  P_host = 250 W            (host CPUs amortized across the job)
  E = T * (P_host + n_chips * P_chip * util),  util from the roofline
      (idle cards draw IDLE_FRAC * P_chip)

``repro_torch.sim.telemetry`` imports from here, so the constants in its
reports have one source.  ``chip_smoke.py`` phase 9 reads the card's own
energy counter (NVML) beside this model.
"""

from __future__ import annotations

#: the card's power limit at full occupancy (W): NVIDIA H100 80GB HBM3,
#: as ``nvidia-smi --query-gpu=name,power.limit`` reads it (700.00 W)
P_CHIP = 700.0
#: host CPU power amortized across the job (W), the paper's host term
P_HOST = 250.0
#: fraction of P_CHIP an idle card still draws: NVML read 74.852 W (20
#: readings over 2 s, 73.118 to 75.505 W) on an NVIDIA H100 80GB HBM3 with
#: a 700.00 W limit and nothing running on it (``chip_smoke.py`` phase 1),
#: 0.1069 of P_CHIP; a later card read 69.450 W (0.0992), another, not
#: yet settled, 79 to 121 W (PERF.md §6 gives every reading)
IDLE_FRAC = 0.107

#: Dominant-term device occupancy the model assumes (not a measurement;
#: the reference's value, the util figure of its table1_strategies).
DEFAULT_UTIL = 0.6


def modeled_energy(t_solution: float, n_chips: int, util: float) -> dict:
    """Paper Fig. 6 energy model; returns E (J), peak power (W), EDP (J s).

    ``util`` is a device occupancy *fraction* and must lie in [0, 1]: a
    roofline ratio above 1 (or a negative one) would silently model
    above-limit card power in every EDP row downstream.
    """
    util = float(util)
    if not 0.0 <= util <= 1.0:
        raise ValueError(
            f"util={util} must be an occupancy fraction in [0, 1] "
            "(util > 1 would model above-nameplate chip power)")
    p_chips = n_chips * P_CHIP * (IDLE_FRAC + (1 - IDLE_FRAC) * util)
    p_total = P_HOST + p_chips
    e = t_solution * p_total
    return {"energy_J": e, "peak_W": p_total, "edp_Js": e * t_solution}
