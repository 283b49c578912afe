"""Compatibility shim: the run loop lives in :mod:`repro_torch.sim.api`.

Port of ``repro/sim/driver.py``: ``driver.run`` / ``driver.SimConfig``
remain the stable entry names, re-exported unchanged from the registry of
composable build/step/collect runners (see
:class:`repro_torch.sim.api.Runner`).  New code should import from
``repro_torch.sim.api``.
"""

from __future__ import annotations

from repro_torch.sim.api import (  # noqa: F401
    MAX_STEPS,
    RUNNERS,
    RunHandle,
    Runner,
    SimConfig,
    _auto_levels,
    _build_states,
    _chunk_spans,
    _device_list,
    _mix_params,
    get_runner,
    register_runner,
    resolve_kind,
    run,
    validate_config,
)
