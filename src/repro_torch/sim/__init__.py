"""``repro_torch.sim``: scenario library, batched ensemble engine, telemetry.

Port of ``repro.sim``.  Three layers on top of the core Hermite machinery:

* ``scenarios``  — a registry of named initial-condition generators behind a
  common :class:`~repro_torch.sim.scenarios.Scenario` dataclass, each
  validated by construction-time diagnostics (centre-of-mass frame, virial
  ratio);
* ``ensemble``   — packs B independent simulations into stacked
  ``ParticleState`` tensors and runs the full predict-evaluate-correct loop
  with the batch axis reaching the kernels as their own leading axis; mixed
  scenarios of different N ride in one rectangular batch via zero-mass
  padding + a per-run ``n_active`` mask, with three stepper modes — fixed
  dt, per-run shared-adaptive lockstep, and hierarchical per-particle block
  timesteps;
* ``api`` / ``driver`` / ``telemetry`` — a unified run loop (diagnostics
  cadence, per-step wall time, modeled energy/EDP) emitting one JSON report
  per run in the reference's schema, wired into the
  ``repro_torch.launch.sim_run`` CLI.
"""

from repro_torch.sim import api, driver, ensemble, scenarios, \
    telemetry  # noqa: F401
