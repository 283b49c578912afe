"""Per-run telemetry: wall-time accounting, modeled energy/EDP, JSON reports.

Port of ``repro/sim/telemetry.py``: the same versioned :class:`RunReport`
schema, so a report from either package loads with the other's
:meth:`RunReport.from_json` and compares field by field.  The energy model
lives in ``repro_torch.obs.energy`` (the paper's Fig. 6 model with the
H100's constants).  Callers hand the recorder plain Python numbers (the
runners read their tensors with ``.tolist()`` / ``float``), so a report
holds numbers, strings and lists only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
import warnings
from typing import Any, Dict, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.energy import DEFAULT_UTIL, modeled_energy  # noqa: F401
#   (re-exported, as in the reference: callers read telemetry.DEFAULT_UTIL)

#: schema version stamped into every RunReport (bump on breaking key changes)
REPORT_SCHEMA_VERSION = 1


class RunReport(dict):
    """Versioned, typed telemetry report of one run.

    A ``dict`` subclass, so every historical consumer (``report["wall_s"]``,
    ``json.dump``, ``report.get(...)``) keeps working unchanged — but new
    code should treat the mapping surface as legacy and use the typed one:
    the ``schema_version`` stamp, :meth:`to_json` / :meth:`from_json` (an
    exact round-trip, validated on load) and the read-only field properties.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None, **kw):
        super().__init__(data or {}, **kw)
        self.setdefault("schema_version", REPORT_SCHEMA_VERSION)

    # ------------------------------------------------------------- typed view
    @property
    def schema_version(self) -> int:
        return int(self["schema_version"])

    @property
    def wall_s(self) -> float:
        return float(self["wall_s"])

    @property
    def steps(self) -> int:
        return int(self["steps"])

    @property
    def steps_per_s(self) -> float:
        return float(self["steps_per_s"])

    @property
    def interactions_per_s(self) -> float:
        return float(self["interactions_per_s"])

    @property
    def snapshots(self) -> List[Dict[str, Any]]:
        return self["snapshots"]

    @property
    def as_dict(self) -> Dict[str, Any]:
        """Deprecated: a plain-dict copy for legacy consumers.

        ``RunReport`` *is* a mapping — index it directly, or use the typed
        properties.  This escape hatch exists only for callers that type-check
        against ``dict`` exactly; it will be removed once none remain.
        """
        warnings.warn(
            "RunReport.as_dict is deprecated: RunReport is a dict — index "
            "it directly or use the typed properties", DeprecationWarning,
            stacklevel=2)
        return dict(self)

    # ------------------------------------------------------------ round-trip
    def to_json(self) -> str:
        return json.dumps(self, default=float)

    @classmethod
    def from_json(cls, text: str) -> "RunReport":
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(
                f"RunReport.from_json: expected a JSON object, "
                f"got {type(data).__name__}")
        version = data.get("schema_version")
        if version != REPORT_SCHEMA_VERSION:
            raise ValueError(
                f"RunReport.from_json: schema_version {version!r} does not "
                f"match this reader ({REPORT_SCHEMA_VERSION})")
        return cls(data)


@dataclasses.dataclass
class StepSample:
    step: int
    t_sim: float
    wall_s: float


class TelemetryRecorder:
    """Accumulates per-step wall times + diagnostics snapshots for one run."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        self.meta: Dict[str, Any] = dict(meta or {})
        self.steps: List[StepSample] = []
        self.snapshots: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    # ---------------------------------------------------------------- record
    def record_step(self, step: int, t_sim: float, wall_s: float) -> None:
        self.steps.append(StepSample(step=step, t_sim=t_sim, wall_s=wall_s))

    def record_snapshot(self, step: int, t_sim: float, **values) -> None:
        self.snapshots.append({"step": step, "t_sim": t_sim, **values})

    # -------------------------------------------------------------- finalize
    def finalize(self, *, n_bodies: int, ensemble: int = 1,
                 n_devices: int = 1, util: float = DEFAULT_UTIL,
                 n_active: Optional[List[int]] = None,
                 per_run_steps: Optional[List[int]] = None,
                 per_run_pairs: Optional[List[float]] = None,
                 per_run_tiles: Optional[List[float]] = None,
                 per_shard_tiles: Optional[List[float]] = None,
                 metrics: Optional[Dict[str, Any]] = None,
                 extra: Optional[Dict[str, Any]] = None) -> RunReport:
        """Assemble the versioned :class:`RunReport` for this run.

        For padded ensembles pass ``n_active`` (per-run real particle
        counts): interaction throughput then counts ``n_active**2`` pairs per
        run rather than the padded ``n_bodies**2``, so telemetry and the EDP
        model never credit work done on zero-mass padding rows.
        ``per_run_steps`` (e.g. adaptive-mode productive step counts) further
        replaces the shared lockstep step count per run.

        ``per_run_pairs`` is the strongest form: the *measured* per-run
        pairwise force-evaluation count (per Hermite pass).  The block
        stepper evaluates only its active targets each substep, so its cost
        is not ``steps * n_active**2`` — when counts are given they override
        the step-based estimate entirely, and the report carries them as
        ``force_evals`` / ``force_evals_total``.

        ``per_run_tiles`` reports the kernel grid tiles *launched* per run
        (both Hermite passes) as ``grid_tiles`` / ``grid_tiles_total`` —
        next to ``force_evals`` this shows whether algorithmic savings
        reached the launch schedule: the masked block path shrinks
        ``force_evals`` but launches the full grid every event, the
        compaction path shrinks both.

        ``metrics`` is a ``repro_torch.obs.metrics`` registry snapshot (or a
        dict with the same versioned schema — validated here, so a malformed
        payload fails at finalize time, not when a reader chokes on the
        report); it lands under the report's ``metrics`` key.

        ``per_shard_tiles`` (strategy-distributed block runs) additionally
        breaks the launched tiles down *per device shard* as
        ``grid_tiles_per_shard`` — under shard-local compaction each chip
        enqueues only the buckets its own local active set needed, so the
        vector shows which shards the activity actually touched (a flat
        vector at the dense count means compaction never engaged).
        """
        walls = [s.wall_s for s in self.steps]
        wall_total = sum(walls) if walls else time.perf_counter() - self._t0
        n_steps = self.steps[-1].step if self.steps else 0
        # each Hermite-6 step sweeps all pairs twice (acc/jerk pass + snap)
        if per_run_pairs is not None:
            force_evals = [float(p) for p in per_run_pairs]
            interactions = 2.0 * sum(force_evals)
        elif n_active is not None:
            acts = [float(a) for a in n_active]
            steps_per_run = [float(s) for s in per_run_steps] \
                if per_run_steps is not None else [float(n_steps)] * len(acts)
            if len(steps_per_run) != len(acts):
                raise ValueError(
                    f"per_run_steps (len {len(steps_per_run)}) must match "
                    f"n_active (len {len(acts)})")
            force_evals = [st * a * a for st, a in zip(steps_per_run, acts)]
            interactions = 2.0 * sum(force_evals)
        else:
            force_evals = None
            interactions = 2.0 * n_steps * ensemble * float(n_bodies) ** 2
        energy = modeled_energy(wall_total, n_devices, util)
        if metrics is not None:
            obs_metrics.validate_snapshot(metrics)
        report: Dict[str, Any] = {
            **self.meta,
            "n_bodies": n_bodies,
            "ensemble": ensemble,
            "devices": n_devices,
            **({"n_active": [int(a) for a in n_active]}
               if n_active is not None else {}),
            **({"force_evals": force_evals,
                "force_evals_total": sum(force_evals)}
               if force_evals is not None else {}),
            **({"grid_tiles": [float(t) for t in per_run_tiles],
                "grid_tiles_total": float(sum(per_run_tiles))}
               if per_run_tiles is not None else {}),
            **({"grid_tiles_per_shard": [float(t) for t in per_shard_tiles]}
               if per_shard_tiles is not None else {}),
            "steps": n_steps,
            "wall_s": wall_total,
            "steps_per_s": n_steps / wall_total if wall_total > 0 else 0.0,
            "interactions_per_s":
                interactions / wall_total if wall_total > 0 else 0.0,
            "step_wall_s": {
                "mean": statistics.fmean(walls) if walls else 0.0,
                "median": statistics.median(walls) if walls else 0.0,
                "max": max(walls) if walls else 0.0,
            },
            "modeled": {
                "util": util,
                "energy_J": energy["energy_J"],
                "peak_W": energy["peak_W"],
                "edp_Js": energy["edp_Js"],
            },
            **({"metrics": metrics} if metrics is not None else {}),
            "snapshots": self.snapshots,
        }
        if extra:
            report.update(extra)
        return RunReport(report)


def write_report(report: Dict[str, Any], path: str) -> str:
    """Persist a report dict as pretty-printed JSON; returns the path."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=float)
    return path


def default_report_path(meta: Dict[str, Any], root: str = ".") -> str:
    """experiments/sim/<scenario>_n<N>[_eB]_<strategy>.json"""
    bits = [str(meta.get("scenario", "run")), f"n{meta.get('n', 0)}"]
    if int(meta.get("ensemble", 1)) > 1:
        bits.append(f"e{meta['ensemble']}")
    bits.append(str(meta.get("strategy", "single")))
    return os.path.join(root, "experiments", "sim", "_".join(bits) + ".json")
