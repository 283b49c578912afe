"""repro_torch.obs — observability substrate for the ensemble engine.

Port of ``repro/obs``.  Four small modules every other
layer reports through:

* :mod:`repro_torch.obs.trace`   — nestable host-side spans exported as
  Chrome-trace/Perfetto JSON, each live span also a
  ``torch.profiler.record_function`` range so it lines up with the card's
  kernels in a ``torch.profiler`` trace;
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms collected
  into a per-run registry and snapshotted into the telemetry report under a
  versioned ``metrics`` key;
* :mod:`repro_torch.obs.energy`  — the paper's Fig. 6 energy model with the
  H100's constants (single source of truth for ``P_CHIP`` / ``P_HOST`` /
  ``IDLE_FRAC``).

* :mod:`repro_torch.obs.regress` — the perf-regression gate over a bench
  trajectory (``python -m repro_torch.obs.regress``).

Submodules are imported explicitly (``from repro_torch.obs import
metrics``) — no eager re-exports here.
"""
