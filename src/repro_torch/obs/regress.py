"""Perf-regression gate over a bench trajectory (``BENCH_ci.json``'s
format).

Port of ``repro/obs/regress.py``.  A bench run appends one stamped record
per run — git SHA, trajectory ``schema_version``, torch and CUDA versions,
the card's name, device count — turning the file from an anecdote into a
trajectory.  This module is the gate over it: the newest record is compared against the most recent *comparable*
earlier record (or an explicit ``--baseline`` file), and CI fails when any
tracked lower-is-better metric — wall per event, launched tiles, modeled
EDP, the neighbor-scheme wall and |dE/E|, the overlapped ring's wall per
evaluation and ppermute rounds, serving seconds-per-request /
p99 turnaround — regresses more than
:data:`DEFAULT_THRESHOLD` (20%).

Two refusal rules keep the gate honest:

* records without matching provenance (``schema_version`` /
  ``torch_version`` / ``cuda_version`` / ``device_name`` / ``device_count``
  / ``dtype``) are *incomparable* — never silently compared.  The port's
  key has the torch, CUDA and card stamps where the reference's has
  ``jax_version``, so a record the reference stamped (no torch version) is
  never comparable with one the port stamped.  When scanning the trajectory they are skipped; an explicit
  ``--baseline`` that is incomparable is a hard error (exit 2).  A record
  stamped before the precision axis existed carries no ``dtype`` field and
  is read as the historical ``"fp32"`` — the committed history keeps gating
  non-vacuously, but a mixed-precision run never compares against it;
* a metric present in the baseline but missing from the current record is a
  regression (a silently dropped row must not pass the gate); a metric new
  in the current record is informational only.

CLI::

    python -m repro_torch.obs.regress BENCH_ci.json [--threshold 0.2]
    python -m repro_torch.obs.regress new.json --baseline committed.json

Exit codes: 0 pass, 1 regression, 2 refused (incomparable / malformed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

#: version of the BENCH_ci.json *trajectory* format (bumped from the
#: implicit v1 single-record file the gate still reads as legacy)
BENCH_SCHEMA_VERSION = 2

#: relative regression that fails the gate (current > (1+thr) * baseline)
DEFAULT_THRESHOLD = 0.20

#: provenance fields that must match for two records to be comparable
_COMPARABLE_FIELDS = ("schema_version", "torch_version", "cuda_version",
                      "device_name", "device_count", "dtype")

#: fields whose absence reads as a historical default instead of a mismatch
#: (records stamped before the precision axis existed are all-fp32 runs)
_COMPARABLE_DEFAULTS = {"dtype": "fp32"}


# --------------------------------------------------------------------------
# provenance stamping
# --------------------------------------------------------------------------
def git_sha(repo: Optional[str] = None) -> str:
    """HEAD commit of ``repo`` (cwd by default); ``"unknown"`` off-repo."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo, capture_output=True,
            text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def provenance(device_count: int, *, repo: Optional[str] = None,
               torch_version: Optional[str] = None,
               cuda_version: Optional[str] = None,
               device_name: Optional[str] = None,
               dtype: str = "fp32") -> Dict[str, Any]:
    """The stamp every bench record carries (comparability contract).

    The versions default to this process's torch (``torch.__version__``,
    ``torch.version.cuda``, ``"none"`` for a CPU build) and the name of
    card 0 (``"cpu"`` without a card).  ``dtype`` is the suite's *base*
    precision axis: per-dtype sweeps (e.g. ``precision_sweep``) key their
    rows by dtype inside the record, so the stamp records the precision of
    the single-dtype suites.
    """
    import torch

    if torch_version is None:
        torch_version = torch.__version__
    if cuda_version is None:
        cuda_version = torch.version.cuda or "none"
    if device_name is None:
        device_name = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else "cpu"
    return {
        "git_sha": git_sha(repo),
        "schema_version": BENCH_SCHEMA_VERSION,
        "torch_version": str(torch_version),
        "cuda_version": str(cuda_version),
        "device_name": str(device_name),
        "device_count": int(device_count),
        "dtype": str(dtype),
    }


# --------------------------------------------------------------------------
# trajectory I/O
# --------------------------------------------------------------------------
def load_trajectory(path: str) -> List[Dict[str, Any]]:
    """Records oldest-first.  A legacy single-record file (the pre-gate
    ``BENCH_ci.json``: one suite dict, no provenance) loads as a one-record
    trajectory so history survives the format migration."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "records" in doc:
        records = doc["records"]
        if not isinstance(records, list):
            raise ValueError(f"{path}: 'records' must be a list")
        return records
    if isinstance(doc, dict) and doc.get("suite") == "bench_ci":
        return [doc]  # legacy v1: the bare suite record
    raise ValueError(
        f"{path}: neither a bench_ci trajectory nor a legacy suite record")


def save_trajectory(path: str, records: List[Dict[str, Any]]) -> str:
    doc = {
        "format": "bench_ci_trajectory",
        "schema_version": BENCH_SCHEMA_VERSION,
        "records": records,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def append_record(path: str, record: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Append ``record`` to the trajectory at ``path`` (created if absent);
    returns the full record list."""
    records = load_trajectory(path) if os.path.exists(path) else []
    records.append(record)
    save_trajectory(path, records)
    return records


# --------------------------------------------------------------------------
# tracked metrics
# --------------------------------------------------------------------------
def tracked_metrics(record: Dict[str, Any]) -> Dict[str, float]:
    """Flatten one suite record to its gated lower-is-better metrics.

    Keys are stable row paths (``sweep/row-key/metric``) so trajectories
    remain joinable as sweeps grow rows.
    """
    out: Dict[str, float] = {}

    def put(key: str, value: Any) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if v > 0:  # zero/absent measurements carry no regression signal
            out[key] = v

    for row in record.get("stepper_modes") or ():
        base = f"stepper_modes/{row.get('stepper')}"
        put(f"{base}/wall_per_event_s", row.get("wall_per_event_s"))
        put(f"{base}/edp_Js", row.get("edp_Js"))
    for row in record.get("block_compaction") or ():
        base = f"block_compaction/seed{row.get('seed')}"
        put(f"{base}/wall_per_event_gather_s",
            row.get("wall_per_event_gather_s"))
        put(f"{base}/tiles_gather", row.get("tiles_gather"))
    for row in record.get("strategy_compaction") or ():
        base = f"strategy_compaction/seed{row.get('seed')}"
        put(f"{base}/wall_per_event_gather_s",
            row.get("wall_per_event_gather_s"))
        put(f"{base}/tiles_shard_max_gather",
            row.get("tiles_shard_max_gather"))
    for row in record.get("precision_sweep") or ():
        # rows are keyed by their own dtype so fp32 wall only ever compares
        # against fp32 wall, mixed |dE/E| against mixed |dE/E|, etc.
        base = f"precision_sweep/{row.get('dtype')}"
        put(f"{base}/wall_per_event_s", row.get("wall_per_event_s"))
        put(f"{base}/de_rel", row.get("de_rel"))
    for row in record.get("neighbor_sweep") or ():
        # only the CI-reproducible rows gate (``gate=True``): the large-N
        # rows exist only in BENCH_NEIGHBOR_FULL=1 local sweeps, and a
        # tracked metric missing from the next record reads as a regression
        if not row.get("gate"):
            continue
        base = f"neighbor_sweep/n{row.get('n')}"
        put(f"{base}/wall_per_event_neighbor_s",
            row.get("wall_per_event_neighbor_s"))
        put(f"{base}/de_rel_neighbor", row.get("de_rel_neighbor"))
    for row in record.get("ring_overlap") or ():
        # rows key by forced-host device count; the shift-round count is
        # exact (trace-time counter), so reintroducing the dead ppermute
        # (p-1 -> p rounds per pass) is a +33%-at-p=4 gated regression
        base = f"ring_overlap/dev{row.get('devices')}"
        put(f"{base}/wall_per_eval_overlap_s",
            row.get("wall_per_eval_overlap_s"))
        put(f"{base}/shift_rounds_overlap", row.get("shift_rounds_overlap"))
    for row in record.get("serve_throughput") or ():
        # only the server row gates: the one-process-per-request baseline
        # is informational (its wall is dominated by interpreter startup)
        if row.get("mode") != "server":
            continue
        base = "serve_throughput/server"
        put(f"{base}/s_per_request", row.get("s_per_request"))
        put(f"{base}/p99_turnaround_s", row.get("p99_turnaround_s"))
    return out


def comparable(current: Dict[str, Any],
               baseline: Dict[str, Any]) -> Tuple[bool, str]:
    """Whether two stamped records may be compared; (ok, reason-if-not)."""
    pc, pb = current.get("provenance"), baseline.get("provenance")
    if not isinstance(pc, dict):
        return False, "current record is unstamped (no provenance)"
    if not isinstance(pb, dict):
        return False, "baseline record is unstamped (no provenance)"
    for field in _COMPARABLE_FIELDS:
        default = _COMPARABLE_DEFAULTS.get(field)
        fc, fb = pc.get(field, default), pb.get(field, default)
        if fc is None:
            fc = default
        if fb is None:
            fb = default
        if fc != fb:
            return False, (f"{field} mismatch: current={fc!r} "
                           f"baseline={fb!r}")
    return True, ""


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Regression:
    metric: str
    baseline: float
    current: float

    @property
    def ratio(self) -> float:
        return self.current / self.baseline if self.baseline else float("inf")

    def __str__(self) -> str:
        return (f"{self.metric}: {self.baseline:g} -> {self.current:g} "
                f"({self.ratio:.2f}x)")


@dataclasses.dataclass
class GateResult:
    ok: bool
    regressions: List[Regression]
    notes: List[str]
    baseline_sha: Optional[str] = None

    def summary(self) -> str:
        lines = [f"# regress: {'PASS' if self.ok else 'FAIL'}"
                 + (f" (baseline {self.baseline_sha})"
                    if self.baseline_sha else "")]
        lines += [f"#   REGRESSED {r}" for r in self.regressions]
        lines += [f"#   note: {n}" for n in self.notes]
        return "\n".join(lines)


def compare(current: Dict[str, Any], baseline: Dict[str, Any],
            threshold: float = DEFAULT_THRESHOLD) -> List[Regression]:
    """Tracked metrics of ``current`` vs ``baseline``; all lower-is-better.

    A metric the baseline tracked but the current record dropped is a
    regression (value ``inf``): a sweep silently vanishing must not pass.
    """
    cur, base = tracked_metrics(current), tracked_metrics(baseline)
    regressions = []
    for key, b in sorted(base.items()):
        c = cur.get(key)
        if c is None:
            regressions.append(Regression(key, b, float("inf")))
        elif c > b * (1.0 + threshold):
            regressions.append(Regression(key, b, c))
    return regressions


def find_baseline(records: List[Dict[str, Any]]
                  ) -> Tuple[Optional[Dict[str, Any]], List[str]]:
    """Most recent record comparable with the newest one, scanning backwards;
    incomparable records are skipped with a note (never silently compared)."""
    notes = []
    current = records[-1]
    for rec in reversed(records[:-1]):
        ok, reason = comparable(current, rec)
        if ok:
            return rec, notes
        sha = (rec.get("provenance") or {}).get("git_sha", "unstamped")
        notes.append(f"skipped baseline candidate {sha}: {reason}")
    return None, notes


def check(path: str, *, baseline_path: Optional[str] = None,
          threshold: float = DEFAULT_THRESHOLD) -> GateResult:
    """Gate the newest record of ``path``.

    With ``baseline_path`` the baseline is that file's newest record and an
    incomparable pair *refuses* (raises ``ValueError``) — the explicit-
    baseline caller asked for exactly that comparison.  Without it, the
    trajectory is scanned for the latest comparable record; if none exists
    (e.g. the first stamped run after the format migration) the gate passes
    with a note rather than inventing a comparison.
    """
    records = load_trajectory(path)
    if not records:
        raise ValueError(f"{path}: empty trajectory")
    current = records[-1]
    notes: List[str] = []
    if baseline_path is not None:
        baseline = load_trajectory(baseline_path)[-1]
        ok, reason = comparable(current, baseline)
        if not ok:
            raise ValueError(
                f"refusing to compare {path} against {baseline_path}: "
                f"{reason}")
    else:
        baseline, notes = find_baseline(records)
        if baseline is None:
            notes.append("no comparable baseline in trajectory; gate passes "
                         "vacuously (first stamped record?)")
            return GateResult(ok=True, regressions=[], notes=notes)
    regressions = compare(current, baseline, threshold)
    sha = (baseline.get("provenance") or {}).get("git_sha")
    return GateResult(ok=not regressions, regressions=regressions,
                      notes=notes, baseline_sha=sha)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trajectory", help="bench trajectory to gate")
    ap.add_argument("--baseline", default=None,
                    help="explicit baseline trajectory (newest record); "
                         "incomparable records refuse instead of skipping")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="relative regression that fails the gate "
                         "(default 0.20)")
    args = ap.parse_args(argv)
    try:
        result = check(args.trajectory, baseline_path=args.baseline,
                       threshold=args.threshold)
    except (ValueError, OSError) as e:
        print(f"# regress: REFUSED — {e}")
        return 2
    print(result.summary())
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
