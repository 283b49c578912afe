"""Port parity: the simulation API (``repro_torch.sim.api``, ``driver``,
``telemetry``) against ``repro.sim``'s.

Each runner kind runs one configuration through both packages' ``run``
(the port's on the CPU) and the two reports are held field by field: the
same keys recursively, ``meta`` equal, every count exact, energies and
simulated times within the golden tiers (``TOL`` / ``BLOCK_TOL`` of
``tests/test_golden_trajectories.py``), the ``sim.*`` metrics equal.  The
``engine.*`` metrics count engine builds, which depend on what ran before
in the process, so both packages' engine caches are emptied before each
run and those metrics are held by name and unit only.  The reference runs
its default evaluation path on the CPU; none of these configurations
leans on a reference path that fails in this container (ROADMAP.md queue
3 C).
"""

import json
import math

import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.sim import api as japi
from repro.sim import ensemble as jens
from repro.sim import telemetry as jtelemetry
from repro_torch.kernels import ops
from repro_torch.obs import energy
from repro_torch.obs import metrics
from repro_torch.sim import api, driver, telemetry
from repro_torch.sim import ensemble as ens
from repro_torch.sim.telemetry import REPORT_SCHEMA_VERSION, RunReport


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: tests/test_golden_trajectories.py TOL and BLOCK_TOL (pos tier)
TOL = {"fp64": 1e-12, "fp32": 1e-7, "mixed": 1e-3}
BLOCK_TOL = {"fp64": 1e-12, "fp32": 1e-6, "mixed": 1e-3}
#: wall-clock fields: present in both, values not compared
WALL = ("wall_s", "steps_per_s", "interactions_per_s", "step_wall_s")

_BLOCK = dict(scenario="plummer", n=32, ensemble=2, t_end=0.0625,
              stepper="block", n_levels=3, block_i=8, block_j=32,
              diag_every=4, validate_ic=False)
CONFIGS = {
    "single_fixed": dict(scenario="plummer", n=16, t_end=0.02, dt=1 / 256,
                         diag_every=4, validate_ic=False),
    "single_adaptive": dict(scenario="plummer", n=16, t_end=0.02,
                            diag_every=4, validate_ic=False),
    "ensemble_fixed": dict(scenario="plummer", n=16, ensemble=2, t_end=0.02,
                           dt=1 / 256, diag_every=4, validate_ic=False),
    "ensemble_adaptive": dict(scenario="plummer", n=16, ensemble=2,
                              t_end=0.01, diag_every=4, validate_ic=False),
    "block_none": dict(_BLOCK),
    "block_gather_member": dict(_BLOCK, compaction="gather"),
    "block_gather_shared": dict(_BLOCK, compaction="gather",
                                bucket_mode="shared"),
    "block_levels_auto": dict(scenario="binary_plummer", n=32, t_end=0.0625,
                              stepper="block", n_levels=None,
                              compaction="gather", block_i=8, block_j=32,
                              diag_every=4, validate_ic=False),
    "mixed": dict(mix=(("plummer", 16), ("two_body", 2)), scenario="mixed",
                  t_end=0.02, dt=1 / 256, diag_every=4, validate_ic=False),
    # the distribution strategies at one device, where the reference runs
    # them in this process; a single-strategy run ignores devices
    "single_devices2": dict(scenario="plummer", n=16, t_end=0.02,
                            dt=1 / 256, devices=2, diag_every=4,
                            validate_ic=False),
    "single_ring": dict(scenario="plummer", n=16, t_end=0.02, dt=1 / 256,
                        strategy="ring", diag_every=4, validate_ic=False),
    # tests/test_neighbor.py's API case, as a batch of two
    "block_neighbor": dict(scenario="plummer", n=64, ensemble=2,
                           t_end=0.0625, stepper="block", n_levels=4,
                           sources="neighbor", neighbor_radius=0.5,
                           block_i=16, block_j=16, diag_every=8,
                           validate_ic=False),
    # binary_plummer_block_2dev.json's recipe, at one device
    "block_strategy_gather": dict(scenario="binary_plummer", n=24, seed=1,
                                  t_end=0.0625, dt_max=1 / 64,
                                  stepper="block", n_levels=4,
                                  compaction="gather", block_i=8,
                                  block_j=128, strategy="mesh_sharded",
                                  impl="xla", diag_every=4,
                                  validate_ic=False),
}


def _clear_engines():
    for fn in (jens._engine, jens._adaptive_engine, jens._block_engine,
               jens._strategy_block_engine, jens._fused_block_engine,
               ens._engine, ens._adaptive_engine, ens._block_engine,
               ens._strategy_block_engine):
        fn.cache_clear()


@pytest.fixture(scope="module")
def reports():
    out = {}
    for name, kw in CONFIGS.items():
        _clear_engines()
        want = json.loads(json.dumps(japi.run(japi.SimConfig(**kw)),
                                     default=float))
        got = api.run(api.SimConfig(device="cpu", **kw))
        out[name] = (want, got)
    return out


def _keys(want, got, path="report"):
    """The same keys, recursively (metric names of ``engine.*`` excepted:
    they are held by name and unit in their own test)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        if path.endswith(("counters", "gauges", "histograms")):
            want = {k: v for k, v in want.items()
                    if not k.startswith("engine.")}
            got = {k: v for k, v in got.items()
                   if not k.startswith("engine.")}
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            _keys(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _keys(a, b, f"{path}[{i}]")


def _plain(x, path="report"):
    """Every value is a Python number, string, bool, None, list or dict."""
    if isinstance(x, dict):
        for k, v in x.items():
            _plain(v, f"{path}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            _plain(v, f"{path}[{i}]")
    else:
        assert x is None or type(x) in (int, float, str, bool), (path, type(x))


def _tol(kw):
    return (BLOCK_TOL if kw.get("stepper") == "block" else TOL)[
        kw.get("dtype", "fp32")]


@pytest.mark.parametrize("name", CONFIGS)
def test_report_has_the_references_keys(reports, name):
    want, got = reports[name]
    _keys(want, got)
    _plain(dict(got))
    assert isinstance(got, RunReport)
    assert got.schema_version == REPORT_SCHEMA_VERSION == \
        jtelemetry.REPORT_SCHEMA_VERSION


@pytest.mark.parametrize("name", CONFIGS)
def test_report_counts_equal_the_references(reports, name):
    want, got = reports[name]
    meta = ("scenario", "n", "seed", "ensemble", "strategy", "t_end", "dt",
            "order", "stepper", "dtype", "params", "dt_max", "n_levels",
            "n_levels_auto", "compaction", "bucket_mode", "sources", "mix",
            "pad", "kernel", "n_bodies", "devices", "n_active")
    for k in meta:
        assert want.get(k) == got.get(k), k
    for k in ("steps", "force_evals", "force_evals_total", "grid_tiles",
              "grid_tiles_total", "grid_tiles_per_shard"):
        assert want.get(k) == got.get(k), k
    for a, b in zip(want.get("runs", []), got.get("runs", [])):
        for k in ("run", "scenario", "n", "seed", "steps", "force_evals",
                  "grid_tiles"):
            assert a.get(k) == b.get(k), k
    assert [s["step"] for s in want["snapshots"]] == \
        [s["step"] for s in got["snapshots"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_report_energies_within_the_golden_tiers(reports, name):
    want, got = reports[name]
    tol = _tol(CONFIGS[name])

    def close(a, b, what):
        a, b = (a, b) if isinstance(a, list) else ([a], [b])
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            assert abs(x - y) <= tol, (what, x, y)

    close(want["e0"], got["e0"], "e0")
    close(want["e1"], got["e1"], "e1")
    close(want["t_final"], got["t_final"], "t_final")
    e0 = min(abs(x) for x in (got["e0"] if isinstance(got["e0"], list)
                              else [got["e0"]]))
    assert abs(want["de_rel"] - got["de_rel"]) <= 2 * tol / e0
    for a, b in zip(want["snapshots"], got["snapshots"]):
        close(a["t_sim"], b["t_sim"], "snapshot t_sim")
        close(a["energy"], b["energy"], "snapshot energy")
    for a, b in zip(want.get("runs", []), got.get("runs", [])):
        close(a["e0"], b["e0"], "run e0")
        close(a["e1"], b["e1"], "run e1")


@pytest.mark.parametrize("name", CONFIGS)
def test_report_metrics_equal_the_references(reports, name):
    want, got = reports[name]
    jmetrics.validate_snapshot(got["metrics"])
    metrics.validate_snapshot(want["metrics"])
    for section in ("counters", "gauges", "histograms"):
        sim_w = {k: v for k, v in want["metrics"][section].items()
                 if k.startswith("sim.")}
        sim_g = {k: v for k, v in got["metrics"][section].items()
                 if k.startswith("sim.")}
        assert sim_w == sim_g, section
        eng_w = {k: v["unit"] for k, v in want["metrics"][section].items()
                 if k.startswith("engine.")}
        eng_g = {k: v["unit"] for k, v in got["metrics"][section].items()
                 if k.startswith("engine.")}
        assert eng_w == eng_g, section


@pytest.mark.parametrize("name", CONFIGS)
def test_report_wall_fields_and_modeled_energy(reports, name):
    want, got = reports[name]
    for k in WALL:
        assert k in want and k in got
    assert got["wall_s"] > 0
    model = energy.modeled_energy(got["wall_s"], got["devices"],
                                  energy.DEFAULT_UTIL)
    assert got["modeled"] == {"util": energy.DEFAULT_UTIL, **model}


@pytest.mark.parametrize("name", ("single_fixed", "block_gather_member",
                                  "mixed"))
def test_reports_load_with_each_others_reader(reports, name, tmp_path):
    want, got = reports[name]
    back = jtelemetry.RunReport.from_json(got.to_json())
    assert back == json.loads(got.to_json())
    path = jtelemetry.write_report(want, str(tmp_path / "ref.json"))
    with open(path) as f:
        assert RunReport.from_json(f.read()) == want
    path = telemetry.write_report(got, str(tmp_path / "port.json"))
    with open(path) as f:
        assert jtelemetry.RunReport.from_json(f.read()) == \
            json.loads(got.to_json())


# --------------------------------------------------------------------------
# dispatch and validation
# --------------------------------------------------------------------------
def _cfg(mod, **kw):
    base = dict(scenario="plummer", n=16, t_end=0.02, dt=1.0 / 256,
                diag_every=4, validate_ic=False)
    base.update(kw)
    if mod is api:
        base.setdefault("device", "cpu")
    return mod.SimConfig(**base)


@pytest.mark.parametrize("kw,kind", [
    (dict(), "single"),
    (dict(ensemble=2), "ensemble"),
    (dict(stepper="block", dt=None, n_levels=2, impl="xla"), "ensemble"),
    (dict(stepper="block", dt=None, n_levels=2, impl="xla",
          strategy="mesh_sharded"), "block_strategy"),
    (dict(mix=(("plummer", 16), ("two_body", 2)), scenario="mixed"),
     "mixed"),
])
def test_resolve_kind_dispatch(kw, kind):
    """``tests/test_sim_api.py``'s table."""
    assert api.resolve_kind(_cfg(api, **kw)) == kind
    assert japi.resolve_kind(_cfg(japi, **kw)) == kind


def test_runners_register_in_the_references_order():
    assert tuple(api.RUNNERS) == tuple(japi.RUNNERS)
    with pytest.raises(ValueError, match="unknown runner kind"):
        api.get_runner("warp_drive")


_BLOCK_DT = dict(stepper="block", dt=None)
BAD = {
    "ensemble": dict(ensemble=0),
    "metrics_interval": dict(metrics_interval=-1),
    "dtype": dict(dtype="fp16"),
    "fp64_kernel": dict(dtype="fp64", kernel="pallas"),
    "fp64_mixed": dict(impl="fp64", dtype="mixed"),
    "stepper": dict(stepper="warp"),
    "fixed_no_dt": dict(stepper="fixed", dt=None),
    "adaptive_dt": dict(stepper="adaptive"),
    "compaction_lockstep": dict(compaction="gather"),
    "bucket_mode": dict(_BLOCK_DT, bucket_mode="wide"),
    "bucket_mode_shared": dict(_BLOCK_DT, bucket_mode="shared"),
    "tile_lockstep": dict(block_i=8),
    "sources": dict(_BLOCK_DT, sources="far"),
    "neighbor_lockstep": dict(sources="neighbor"),
    "neighbor_gather": dict(_BLOCK_DT, sources="neighbor",
                            compaction="gather"),
    "neighbor_strategy": dict(_BLOCK_DT, sources="neighbor",
                              strategy="ring"),
    "neighbor_mix": dict(_BLOCK_DT, sources="neighbor", scenario="mixed",
                         mix=(("plummer", 16), ("two_body", 2))),
    "refresh_levels": dict(_BLOCK_DT, refresh_levels=-1),
    "mesh_lockstep": dict(mesh=(1, 1)),
    "mesh_shape": dict(_BLOCK_DT, mesh=(2, 0)),
    "mesh_devices": dict(_BLOCK_DT, mesh=(2, 2)),
    "mesh_strategy": dict(_BLOCK_DT, mesh=(1, 1), strategy="ring"),
    "mesh_bucket_mode": dict(_BLOCK_DT, mesh=(1, 1), compaction="gather",
                             bucket_mode="shared"),
    "levels_auto_lockstep": dict(n_levels=None),
    # raised at build
    "impl_and_kernel": dict(impl="xla", kernel="ref"),
    "unknown_kernel": dict(kernel="warp"),
    "fp64_strategy": dict(dtype="fp64", strategy="ring"),
    "unknown_strategy": dict(strategy="warp"),
    "ensemble_unknown_strategy": dict(ensemble=2, strategy="warp"),
}


def _error(mod, kw):
    cfg = _cfg(mod, **kw)
    with pytest.raises(Exception) as info:
        mod.get_runner(mod.resolve_kind(cfg)).build(cfg)
    return info.value


@pytest.mark.parametrize("name", BAD)
def test_bad_configs_raise_as_the_reference(name):
    want, got = _error(japi, BAD[name]), _error(api, BAD[name])
    assert type(got) is type(want)
    assert str(got) == str(want)


@pytest.mark.parametrize("kw,item", [
    (dict(ensemble=2, devices=2), "item 7b"),
    (dict(stepper="block", dt=None, ensemble=2, devices=2), "item 7b"),
    (dict(stepper="block", dt=None, mesh=(1, 1)), "item 7b"),
    (dict(stepper="block", dt=None, sources="neighbor"), "item 8"),
    (dict(stepper="block", dt=None, ensemble=2, sources="neighbor"),
     "item 8"),
])
def test_what_one_card_does_not_run_raises(kw, item):
    """Configurations the port once refused now run.  The neighbor scheme
    (item 8): its report equals the reference's counts, neighbor fields and
    ``sim.*`` metrics.  A batch sharded over CPU slots and the fused mesh
    (item 7b): the report equals the same configuration's one-slot report
    field by field (counts, energies, per-run rows), bar the device count
    and, under the mesh, the gauges the reference drops there; the JAX
    package's own multi-device reports are held in
    ``test_torch_batch_layouts.py``."""
    cfg = _cfg(api, **kw)
    if item == "item 7b":
        got = api.run(cfg)
        one = api.run(_cfg(api, **{k: v for k, v in kw.items()
                                   if k not in ("devices", "mesh")}))
        assert got["devices"] == max(kw.get("devices", 1), 1)
        for k in ("steps", "force_evals_total", "grid_tiles_total", "e0",
                  "e1", "de_rel", "t_final", "runs", "ensemble", "n_bodies"):
            assert got.get(k) == one.get(k), k
        dropped = {"sim.tiles_occupancy_bound", "sim.bucket_hits"} \
            if "mesh" in kw else set()
        for section in ("counters", "gauges"):
            assert ({k: v for k, v in got["metrics"][section].items()
                     if k.startswith("sim.")}
                    == {k: v for k, v in one["metrics"][section].items()
                        if k.startswith("sim.") and k not in dropped}), \
                section
        return
    if item == "item 8":
        _clear_engines()
        want = json.loads(json.dumps(japi.run(_cfg(japi, **kw)),
                                     default=float))
        got = api.run(cfg)
        _keys(want, got)
        for k in ("steps", "force_evals", "force_evals_total", "grid_tiles",
                  "neighbor_refreshes", "neighbor_overflows", "sources"):
            assert got[k] == want[k], k
        assert got["neighbor_refreshes"] > 0
        for a, b in zip(want["runs"], got["runs"]):
            for k in ("steps", "force_evals", "grid_tiles",
                      "neighbor_refreshes", "neighbor_overflows"):
                assert a[k] == b[k], k
        for section in ("counters", "gauges", "histograms"):
            assert ({k: v for k, v in got["metrics"][section].items()
                     if k.startswith("sim.")}
                    == {k: v for k, v in want["metrics"][section].items()
                        if k.startswith("sim.")}), section
        assert abs(got["de_rel"] - want["de_rel"]) <= 1e-6


@pytest.mark.parametrize("name,kind,devices", [
    ("single_devices2", "single", 1),
    ("single_ring", "single", 1),
    ("block_strategy_gather", "block_strategy", 1),
])
def test_what_the_strategies_port_runs(reports, name, kind, devices):
    """A single run over several devices, a single run under a strategy
    and the block-strategy runner now run, as the reference's do (their
    reports are held field by field by the ``CONFIGS`` tests above): the
    kind dispatched, the devices reported and the per-shard tiles."""
    want, got = reports[name]
    assert api.resolve_kind(api.SimConfig(**CONFIGS[name])) == kind
    assert got["devices"] == want["devices"] == devices
    if kind == "block_strategy":
        assert got["grid_tiles_per_shard"] == want["grid_tiles_per_shard"]
        assert got["grid_tiles_per_shard"] == [got["grid_tiles_total"]]
        assert got["grid_tiles_total"] < got["steps"] * ops.CapacityPlan(
            24, 24, 8, 128).dense_tiles


def test_device_count_is_resolved_per_device():
    """On the CPU a run takes ``devices`` slots of the CPU; on ``cuda`` the
    first ``devices`` cards, refused with the visible count when fewer are
    there (no fallback)."""
    assert api._device_list(_cfg(api, devices=3)) == \
        [torch.device("cpu")] * 3
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api._device_list(_cfg(api, device="cuda"))


def test_strategy_runs_shard_over_cpu_slots():
    """A single run under each strategy over two CPU slots: the same steps
    as the single path, energies within the fp32 tier of it."""
    plain = api.run(_cfg(api))
    for strategy in ("replicated", "two_level", "mesh_sharded", "ring"):
        got = api.run(_cfg(api, strategy=strategy, devices=2))
        assert got["devices"] == 2 and got["steps"] == plain["steps"]
        assert abs(got["e1"] - plain["e1"]) <= TOL["fp32"], strategy


def test_strategy_label_on_a_batch_only_tags_the_report():
    kw = dict(ensemble=2, strategy="ring")
    got = api.run(_cfg(api, **kw))
    plain = api.run(_cfg(api, ensemble=2))
    assert got["strategy"] == "ring" and got["e1"] == plain["e1"]


@pytest.mark.parametrize("impl", ("xla", "pallas_interpret"))
def test_plain_version_labels_are_refused_on_the_card(impl):
    """A label naming a plain version runs on the CPU only: on ``cuda`` the
    force evaluation is the kernels' (the check needs no card)."""
    with pytest.raises(ValueError, match="plain version"):
        ens.check_impl(impl, "cuda")
    assert ens.check_impl(impl, "cpu") == impl
    for ok in (None, "pallas", "fp64"):
        assert ens.check_impl(ok, "cuda") == ok
    with pytest.raises(ValueError, match="unknown impl"):
        ens.check_impl("warp", "cpu")


def test_impl_resolution_keeps_the_references_names():
    assert ens.STEPPERS == jens.STEPPERS
    assert ens.KERNELS == jens.KERNELS
    assert ens.ENSEMBLE_IMPLS == jens.ENSEMBLE_IMPLS
    assert ens.resolve_kernel("ref") == jens.resolve_kernel("ref") == "xla"
    assert ens.resolve_kernel("pallas") == "pallas"
    assert ens.resolve_eval_impl("fp64", None) == "fp64"
    assert ens.resolve_eval_impl(None, None) is None
    for args in (("xla", "ref"), (None, "warp")):
        with pytest.raises(ValueError) as ours:
            ens.resolve_eval_impl(*args)
        with pytest.raises(ValueError) as theirs:
            jens.resolve_eval_impl(*args)
        assert str(ours.value) == str(theirs.value)


def test_device_stays_out_of_meta():
    cfg = _cfg(api)
    assert cfg.device == "cpu" and "device" not in cfg.meta()
    assert cfg.meta() == _cfg(japi).meta()


def test_driver_shim_is_the_api():
    assert driver.run is api.run
    assert driver.SimConfig is api.SimConfig
    assert driver.RUNNERS is api.RUNNERS


# --------------------------------------------------------------------------
# build/step/collect == run(), and the cached engines
# --------------------------------------------------------------------------
_DETERMINISTIC = ("scenario", "n_bodies", "ensemble", "steps", "e0", "e1",
                  "de_rel", "t_final", "force_evals_total")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ensemble=2, stepper="adaptive", dt=None, t_end=0.01),
    dict(mix=(("plummer", 16), ("two_body", 2)), scenario="mixed"),
    dict(stepper="block", dt=None, n_levels=3, compaction="gather",
         block_i=8, ensemble=2),
])
def test_build_step_collect_matches_run(kw):
    cfg = _cfg(api, **kw)
    monolithic = api.run(cfg)
    runner = api.get_runner(api.resolve_kind(cfg))
    with metrics.use():
        h = runner.build(cfg)
        while not runner.step(h):
            pass
        composed = runner.collect(h)
    assert isinstance(composed, RunReport)
    assert {k: composed[k] for k in _DETERMINISTIC if k in composed} == \
        {k: monolithic[k] for k in _DETERMINISTIC if k in monolithic}


def _block_state(b=2, n=32):
    from repro_torch.sim import scenarios
    return ens.ensemble_initialize(ens.stack_states(
        [scenarios.make("plummer", n, seed=s, device="cpu")
         for s in range(b)]))


def test_engine_cache_ticks_once_per_key_and_keeps_the_bits():
    """``ensemble_run_block`` reuses one engine per key: a cached run gives
    a fresh engine's bits, and ``engine.cache_miss`` ticks once per new
    key, never once per call."""
    init = _block_state()
    kw = dict(t_end=0.0625, n_events=2, n_levels=3, compaction="gather",
              block_i=8, block_j=32)

    def chunks(**extra):
        s, c = init, None
        for _ in range(4):
            s, c = ens.ensemble_run_block(s, carry=c, **{**kw, **extra})
        return s, c

    ens._block_engine.cache_clear()
    with metrics.use() as reg:
        first, c1 = chunks()
        again, c2 = chunks()
        counters = reg.snapshot()["counters"]
        assert counters["engine.cache_miss.block"]["value"] == 1.0
        assert counters["engine.bucket_branches"]["value"] == 3.0
        chunks(n_levels=4)
        assert reg.counter("engine.cache_miss.block").value == 2.0
    ens._block_engine.cache_clear()
    fresh, c3 = chunks()
    for f in ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot", "time"):
        assert torch.equal(getattr(first, f), getattr(again, f)), f
        assert torch.equal(getattr(first, f), getattr(fresh, f)), f
    assert torch.equal(c1.n_tiles, c3.n_tiles)
    assert torch.equal(c1.n_events, c2.n_events)


def test_lockstep_engines_are_cached_per_key():
    init = _block_state()
    ens._engine.cache_clear()
    ens._adaptive_engine.cache_clear()
    with metrics.use() as reg:
        a = ens.ensemble_run(init, n_steps=2, dt=1e-3)
        b = ens.ensemble_run(init, n_steps=2, dt=1e-3)
        ens.ensemble_initialize(init)
        ens.ensemble_run_adaptive(init, t_end=0.01, n_steps=2)
        ens.ensemble_run_adaptive(init, t_end=0.01, n_steps=2)
        ens.ensemble_run(init, n_steps=1, dt=1e-3, dtype="fp64")
        c = reg.snapshot()["counters"]
    assert c["engine.cache_miss.fixed"]["value"] == 2.0     # fp32, fp64
    assert c["engine.cache_miss.adaptive"]["value"] == 1.0
    assert c["engine.cache_miss"]["value"] == 3.0
    assert torch.equal(a.pos, b.pos)


def test_runreport_roundtrip_and_version_check():
    rec = telemetry.TelemetryRecorder({"scenario": "x"})
    rec.record_step(2, 0.05, 0.25)
    report = rec.finalize(n_bodies=8, n_active=[6])
    assert isinstance(report, dict) and report.steps == 2
    back = RunReport.from_json(report.to_json())
    assert back == json.loads(report.to_json()) and back["n_active"] == [6]
    bad = json.dumps({"schema_version": REPORT_SCHEMA_VERSION + 1})
    with pytest.raises(ValueError, match="schema_version"):
        RunReport.from_json(bad)
    with pytest.raises(ValueError, match="JSON object"):
        RunReport.from_json("[1, 2]")
    with pytest.deprecated_call():
        assert report.as_dict == dict(report)


def test_finalize_keys_equal_the_references():
    kw = dict(n_bodies=8, ensemble=2, n_devices=1, n_active=[6, 8],
              per_run_steps=[2, 3], per_run_tiles=[4.0, 5.0],
              metrics=metrics.MetricsRegistry().snapshot(),
              extra={"e0": [1.0, 2.0]})
    reports = []
    for mod in (telemetry, jtelemetry):
        rec = mod.TelemetryRecorder({"scenario": "x"})
        rec.record_step(3, 0.1, 0.5)
        rec.record_snapshot(3, 0.1, energy=-0.25, de_rel=1e-9)
        reports.append(rec.finalize(**kw))
    ours, theirs = reports
    assert list(ours) == list(theirs)
    for k in ours:
        if k != "modeled":
            assert ours[k] == theirs[k], k
    with pytest.raises(ValueError):
        rec.finalize(n_bodies=8, n_active=[8, 8], per_run_steps=[2])


def test_default_report_path_equals_the_references(tmp_path):
    for meta in ({"scenario": "king", "n": 256, "ensemble": 1,
                  "strategy": "single"},
                 {"scenario": "king", "n": 256, "ensemble": 8,
                  "strategy": "ring"}):
        assert telemetry.default_report_path(meta, root=str(tmp_path)) == \
            jtelemetry.default_report_path(meta, root=str(tmp_path))
    assert math.isfinite(energy.modeled_energy(1.0, 1, 0.5)["energy_J"])
