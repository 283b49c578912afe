"""The port's perf-regression gate (``repro_torch.obs.regress``) against
the reference's (``repro.obs.regress``).

Each scenario of ``tests/test_obs_regress.py`` runs through both gates,
each on records it stamps itself (the reference with a jax version, the
port with torch, CUDA and card stamps), and must give the same verdicts
and exit codes.  The port's ``tracked_metrics`` equals the reference's on
every record of the committed ``BENCH_ci.json``, and a record the
reference stamped is never comparable with one the port stamped.
"""

import json
import os

import pytest

from repro.obs import regress as jregress
from repro_torch.obs import regress

BENCH_CI = os.path.join(os.path.dirname(__file__), "..", "BENCH_ci.json")

#: (module, its version stamp, the same stamp with another version)
SIDES = {
    "reference": (jregress, {"jax_version": "0.4.37"},
                  {"jax_version": "0.5.0"}),
    "port": (regress, {"torch_version": "2.5.1", "cuda_version": "12.4",
                       "device_name": "NVIDIA H100 80GB HBM3"},
             {"torch_version": "2.6.0"}),
}


def record(side, wall=0.01, tiles=1000.0, edp=100.0, sha="aaa",
           other_version=False, **prov):
    """A minimal stamped record with one row per gated sweep (the
    reference test's ``record``), stamped by ``side``."""
    mod, stamp, other = SIDES[side]
    p = {"git_sha": sha, "schema_version": mod.BENCH_SCHEMA_VERSION,
         "device_count": 2, **stamp, **(other if other_version else {}),
         **prov}
    return {
        "suite": "bench_ci",
        "stepper_modes": [
            {"stepper": "block", "wall_per_event_s": wall, "edp_Js": edp}],
        "block_compaction": [
            {"seed": 0, "wall_per_event_gather_s": wall,
             "tiles_gather": tiles}],
        "strategy_compaction": [
            {"seed": 0, "wall_per_event_gather_s": wall,
             "tiles_shard_max_gather": tiles / 2}],
        "provenance": p,
    }


def _gate(mod, path, **kw):
    r = mod.check(path, **kw)
    return (r.ok, sorted(x.metric for x in r.regressions),
            [x.current == float("inf") for x in r.regressions],
            r.baseline_sha, len(r.notes))


# -- the 20 scenarios, each returning what both gates must agree on --------
def s_provenance_stamp_fields(side, tmp):
    mod = SIDES[side][0]
    p = mod.provenance(4, repo=str(tmp))
    return (p["schema_version"], p["device_count"], p["git_sha"], p["dtype"])


def s_trajectory_roundtrip_and_append(side, tmp):
    mod = SIDES[side][0]
    path = str(tmp / "t.json")
    mod.append_record(path, record(side, sha="one"))
    recs = mod.append_record(path, record(side, sha="two"))
    doc = json.load(open(path))
    return ([r["provenance"]["git_sha"] for r in recs], doc["format"],
            doc["schema_version"], mod.load_trajectory(path) == recs)


def s_legacy_single_record_loads(side, tmp):
    mod = SIDES[side][0]
    path = str(tmp / "t.json")
    legacy = {"suite": "bench_ci", "unix_time": 123, "stepper_modes": []}
    json.dump(legacy, open(path, "w"))
    first = mod.load_trajectory(path) == [legacy]
    recs = mod.append_record(path, record(side))
    return first, recs[0] == legacy, len(recs)


def s_load_rejects_unknown_shape(side, tmp):
    mod = SIDES[side][0]
    path = str(tmp / "x.json")
    json.dump({"something": "else"}, open(path, "w"))
    with pytest.raises(ValueError):
        mod.load_trajectory(path)
    return True


def s_tracked_metrics_flattening(side, tmp):
    mod = SIDES[side][0]
    return (mod.tracked_metrics(record(side, wall=0.02, tiles=640.0,
                                       edp=50.0)),
            mod.tracked_metrics({"stepper_modes": [
                {"stepper": "none", "wall_per_event_s": 0.0,
                 "edp_Js": "n/a"}]}))


def s_comparable_requires_matching_provenance(side, tmp):
    mod = SIDES[side][0]
    same = mod.comparable(record(side), record(side))[0]
    ok, why = mod.comparable(record(side), record(side, device_count=4))
    ok2, why2 = mod.comparable({"no": "stamp"}, record(side))
    return same, ok, "device_count" in why, ok2, "unstamped" in why2


def _pair(side, tmp, base_kw, head_kw):
    mod = SIDES[side][0]
    path = str(tmp / "t.json")
    mod.append_record(path, record(side, sha="base", **base_kw))
    mod.append_record(path, record(side, sha="head", **head_kw))
    return mod, path


def s_gate_passes_within_threshold(side, tmp):
    mod, path = _pair(side, tmp, {"wall": 0.0100}, {"wall": 0.0115})
    return _gate(mod, path), "PASS" in mod.check(path).summary()


def s_synthetic_25pct_regression_fails(side, tmp):
    mod, path = _pair(side, tmp, {"wall": 0.0100}, {"wall": 0.0125})
    return _gate(mod, path), mod.main([path])


def s_tiles_and_edp_regressions_gate(side, tmp):
    mod, path = _pair(side, tmp, {"tiles": 1000.0, "edp": 100.0},
                      {"tiles": 1300.0, "edp": 130.0})
    return _gate(mod, path)


def s_dropped_metric_is_a_regression(side, tmp):
    mod = SIDES[side][0]
    path = str(tmp / "t.json")
    mod.append_record(path, record(side, sha="base"))
    gutted = record(side, sha="head")
    gutted["block_compaction"] = []
    mod.append_record(path, gutted)
    return _gate(mod, path)


def s_scan_skips_incomparable_baselines(side, tmp):
    mod = SIDES[side][0]
    path = str(tmp / "t.json")
    mod.append_record(path, record(side, sha="old-comparable"))
    mod.append_record(path, record(side, sha="other-version",
                                   other_version=True))
    mod.append_record(path, record(side, sha="head"))
    r = mod.check(path)
    return _gate(mod, path), any("other-version" in n for n in r.notes)


def s_no_comparable_baseline_passes_vacuously(side, tmp):
    mod = SIDES[side][0]
    path = str(tmp / "t.json")
    json.dump({"suite": "bench_ci", "stepper_modes": []}, open(path, "w"))
    mod.append_record(path, record(side, sha="first-stamped"))
    r = mod.check(path)
    return _gate(mod, path), any("vacuously" in n for n in r.notes)


def _explicit(side, tmp, cur_kw, base_kw, *argv):
    mod = SIDES[side][0]
    cur, base = str(tmp / "cur.json"), str(tmp / "base.json")
    mod.append_record(cur, record(side, sha="head", **cur_kw))
    mod.append_record(base, record(side, sha="base", **base_kw))
    return [mod.main([cur, "--baseline", base, *a]) for a in argv or ((),)]


def s_explicit_incomparable_baseline_refuses(side, tmp):
    return _explicit(side, tmp, {}, {"device_count": 8})


def s_explicit_comparable_baseline_compares(side, tmp):
    return _explicit(side, tmp, {"wall": 0.05}, {"wall": 0.01}, (),
                     ("--threshold", "10"))


def s_provenance_stamps_dtype(side, tmp):
    mod = SIDES[side][0]
    return (mod.provenance(2, repo=str(tmp))["dtype"],
            mod.provenance(2, repo=str(tmp), dtype="mixed")["dtype"])


def s_cross_dtype_comparison_refused(side, tmp):
    mod = SIDES[side][0]
    a = mod.comparable(record(side, dtype="mixed"), record(side))
    b = mod.comparable(record(side), record(side, dtype="mixed"))
    c = mod.comparable(record(side, dtype="mixed"),
                       record(side, dtype="mixed"))
    return a[0], "dtype" in a[1], b[0], "dtype" in b[1], c[0]


def s_absent_dtype_reads_as_fp32(side, tmp):
    mod = SIDES[side][0]
    legacy = record(side)
    legacy["provenance"].pop("dtype", None)
    return (mod.comparable(record(side, dtype="fp32"), legacy)[0],
            mod.comparable(record(side, dtype="mixed"), legacy)[0])


def s_cross_dtype_explicit_baseline_refuses(side, tmp):
    return _explicit(side, tmp, {"dtype": "mixed"}, {"dtype": "fp32"})


def s_precision_sweep_rows_tracked_per_dtype(side, tmp):
    mod = SIDES[side][0]

    def sweep(sha, des):
        r = record(side, sha=sha)
        r["precision_sweep"] = [
            {"dtype": d, "wall_per_event_s": w, "de_rel": e}
            for d, w, e in zip(("fp64", "fp32", "mixed"),
                               (0.04, 0.01, 0.02), des)]
        return r

    path = str(tmp / "t.json")
    mod.append_record(path, sweep("base", (1e-12, 1e-7, 1e-4)))
    mod.append_record(path, sweep("head", (1e-12, 1e-7, 1e-2)))
    return mod.tracked_metrics(sweep("x", (1e-12, 1e-7, 1e-4))), \
        _gate(mod, path)


def s_committed_trajectory_is_gated(side, tmp):
    mod = SIDES[side][0]
    return len(mod.load_trajectory(BENCH_CI)), mod.main([BENCH_CI])


SCENARIOS = {name[2:]: fn for name, fn in sorted(globals().items())
             if name.startswith("s_")}


def test_twenty_scenarios():
    assert len(SCENARIOS) == 20


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_gives_the_reference_verdict(name, tmp_path, capsys):
    verdicts = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        verdicts[side] = SCENARIOS[name](side, d)
        out = capsys.readouterr().out
        verdicts[side] = (verdicts[side],
                          [w for w in ("PASS", "FAIL", "REFUSED",
                                       "REGRESSED") if w in out])
    assert verdicts["port"] == verdicts["reference"]


def test_verdicts_are_the_reference_tests_expectations(tmp_path):
    """Spot checks that the shared verdicts are the gate's contract, not a
    shared fault: a 25% slip fails with exit 1, an incomparable explicit
    baseline refuses with exit 2, the committed trajectory passes."""
    assert s_synthetic_25pct_regression_fails("port", tmp_path)[1] == 1
    (tmp_path / "b").mkdir()
    assert s_explicit_incomparable_baseline_refuses(
        "port", tmp_path / "b") == [2]
    assert s_committed_trajectory_is_gated("port", tmp_path)[1] == 0


@pytest.mark.parametrize("index", range(4))
def test_tracked_metrics_match_on_committed_records(index):
    records = jregress.load_trajectory(BENCH_CI)
    assert len(records) == 4
    rec = records[index]
    assert regress.tracked_metrics(rec) == jregress.tracked_metrics(rec)


def test_reference_stamped_baseline_refuses(tmp_path, capsys):
    """A record the reference stamped is never comparable with one the port
    stamped: ``--baseline`` refuses with exit 2."""
    cur, base = str(tmp_path / "cur.json"), str(tmp_path / "base.json")
    stamped = record("port", sha="head")
    stamped["provenance"] = regress.provenance(2, repo=str(tmp_path))
    regress.append_record(cur, stamped)
    jregress.append_record(base, record("reference", sha="base"))
    assert regress.main([cur, "--baseline", base]) == 2
    assert "REFUSED" in capsys.readouterr().out
    ok, why = regress.comparable(stamped, record("reference"))
    assert not ok and "torch_version" in why


def test_port_stamp_names_torch_cuda_and_card(tmp_path):
    import torch

    p = regress.provenance(1, repo=str(tmp_path))
    assert p["torch_version"] == torch.__version__
    assert p["cuda_version"] == (torch.version.cuda or "none")
    assert p["device_name"] == (torch.cuda.get_device_name(0)
                                if torch.cuda.is_available() else "cpu")
    assert "jax_version" not in p
