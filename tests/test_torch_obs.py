"""Port parity: ``repro_torch.obs`` (metrics registry, energy model, span
tracer) against ``repro.obs``.

The metrics cases are the reference's ``tests/test_obs_metrics.py`` run on
the port's module, plus snapshots that cross-validate between the two
packages.  The energy model keeps the reference's formula and util check
with the H100's constants.  The tracer keeps the reference's Chrome-trace
layout; a traced block + gather run at ``tests/test_obs_driver.py``'s
``BLOCK_KW`` (on the CPU) must show the same span taxonomy and the same
tile chain.
"""

import inspect
import json

import pytest
import torch

from repro.obs import energy as jenergy
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.obs import energy, metrics, trace
from repro_torch.sim import api, telemetry

#: tests/test_obs_driver.py BLOCK_KW, on the CPU
BLOCK_KW = dict(scenario="plummer", n=32, ensemble=2, t_end=0.0625,
                stepper="block", dt_max=0.0625, n_levels=3,
                compaction="gather", block_i=8, block_j=32,
                impl="xla", diag_every=4, validate_ic=False, device="cpu")


# --------------------------------------------------------------------------
# metrics: the reference's cases on the port's module
# --------------------------------------------------------------------------
def test_counter_monotone():
    c = metrics.Counter("c", unit="events")
    c.inc()
    c.inc(4.0)
    assert c.value == 5.0
    with pytest.raises(ValueError):
        c.inc(-1.0)


def test_gauge_holds_vectors():
    g = metrics.Gauge("g")
    g.set([1.0, 2.0])
    assert g.dump()["value"] == [1.0, 2.0]


def test_histogram_summary_and_percentiles():
    h = metrics.Histogram("h", unit="fraction")
    for v in (0.1, 0.2, 0.3, 0.4):
        h.observe(v)
    d = h.dump()
    assert d["count"] == 4 and d["min"] == 0.1 and d["max"] == 0.4
    assert d["mean"] == pytest.approx(0.25)
    assert 0.1 <= d["p50"] <= 0.4 and 0.1 <= d["p95"] <= 0.4


def test_histogram_sample_cap_keeps_summary_exact():
    assert metrics.HISTOGRAM_SAMPLE_CAP == jmetrics.HISTOGRAM_SAMPLE_CAP
    h = metrics.Histogram("h")
    for i in range(metrics.HISTOGRAM_SAMPLE_CAP + 10):
        h.observe(float(i))
    assert h.count == metrics.HISTOGRAM_SAMPLE_CAP + 10
    assert h.max == float(metrics.HISTOGRAM_SAMPLE_CAP + 9)
    assert len(h._samples) == metrics.HISTOGRAM_SAMPLE_CAP


def test_histogram_dump_equals_the_reference():
    ours, theirs = metrics.Histogram("h", "s"), jmetrics.Histogram("h", "s")
    for v in (0.5, 0.125, 3.0, 2.0, 0.75):
        ours.observe(v)
        theirs.observe(v)
    assert ours.dump() == theirs.dump()


def test_registry_get_or_create_and_kind_mismatch():
    reg = metrics.MetricsRegistry()
    c1 = reg.counter("sim.events", unit="events")
    assert reg.counter("sim.events") is c1
    with pytest.raises(TypeError):
        reg.gauge("sim.events")


def test_snapshot_schema_validates():
    reg = metrics.MetricsRegistry()
    reg.counter("a.count").inc(2)
    reg.gauge("a.gauge").set(7.5)
    reg.histogram("a.hist").observe(1.0)
    snap = reg.snapshot()
    assert snap["schema_version"] == metrics.METRICS_SCHEMA_VERSION == \
        jmetrics.METRICS_SCHEMA_VERSION
    assert snap["counters"]["a.count"]["value"] == 2.0
    assert snap["gauges"]["a.gauge"]["value"] == 7.5
    assert snap["histograms"]["a.hist"]["count"] == 1
    metrics.validate_snapshot(snap)  # must not raise


@pytest.mark.parametrize("mutate", [
    lambda s: s.pop("schema_version"),
    lambda s: s.update(schema_version=999),
    lambda s: s.pop("counters"),
    lambda s: s["counters"].update(bad="not-a-dict"),
    lambda s: s["counters"].update(bad={}),  # missing 'value'
])
def test_validate_snapshot_rejects_malformed(mutate):
    reg = metrics.MetricsRegistry()
    reg.counter("x").inc()
    snap = reg.snapshot()
    mutate(snap)
    with pytest.raises(ValueError):
        metrics.validate_snapshot(snap)
    with pytest.raises(ValueError):
        jmetrics.validate_snapshot(snap)


def test_validate_snapshot_rejects_non_dict():
    with pytest.raises(ValueError):
        metrics.validate_snapshot([1, 2, 3])


def test_snapshots_cross_validate():
    """A snapshot from either package passes the other's validator, and
    the same emissions give the same snapshot."""
    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (ours, theirs):
        reg.counter("sim.events", unit="events").inc(37)
        reg.gauge("sim.bucket_hits", unit="hits").set([1.0, 2.0])
        reg.histogram("sim.active_fraction", unit="fraction").observe(0.25)
    a, b = ours.snapshot(), theirs.snapshot()
    jmetrics.validate_snapshot(a)
    metrics.validate_snapshot(b)
    assert a == b


def test_use_scopes_the_current_registry():
    outer = metrics.registry()
    with metrics.use() as reg:
        assert metrics.registry() is reg and reg is not outer
        metrics.registry().counter("scoped").inc()
        with metrics.use() as inner:  # nested scopes stack
            assert metrics.registry() is inner
        assert metrics.registry() is reg
    assert metrics.registry() is outer
    assert "scoped" not in outer.snapshot()["counters"]


def test_set_registry_returns_previous_and_none_restores_default():
    fresh = metrics.MetricsRegistry()
    prev = metrics.set_registry(fresh)
    try:
        assert metrics.registry() is fresh
    finally:
        assert metrics.set_registry(None) is fresh
    assert metrics.registry() is prev


def test_block_tile_chain_launched_bound_dense():
    """The reference's tile chain on the port: launched tiles never exceed
    the analytic occupancy bound, which never exceeds the dense schedule,
    and compaction launches fewer than the dense schedule."""
    report = api.run(api.SimConfig(
        scenario="binary_plummer", n=64, seed=1, stepper="block",
        compaction="gather", t_end=0.0625, dt_max=1.0 / 64, n_levels=4,
        block_i=16, block_j=16, eta=0.02, diag_every=8, device="cpu"))
    c = report["metrics"]["counters"]
    g = report["metrics"]["gauges"]
    launched = c["sim.tiles_launched"]["value"]
    bound = g["sim.tiles_occupancy_bound"]["value"]
    dense = c["sim.tiles_dense_baseline"]["value"]
    assert 0 < launched <= bound <= dense
    assert launched < dense


# --------------------------------------------------------------------------
# energy: the reference's model with the H100's constants
# --------------------------------------------------------------------------
def test_energy_constants_are_the_h100s():
    assert energy.P_CHIP == 700.0          # the H100 SXM's power limit
    assert energy.P_HOST == jenergy.P_HOST == 250.0
    assert energy.DEFAULT_UTIL == jenergy.DEFAULT_UTIL == 0.6
    assert 0.0 < energy.IDLE_FRAC < 0.35    # an idle H100, not the TPU's
    assert (energy.P_CHIP, energy.IDLE_FRAC) != (jenergy.P_CHIP,
                                                 jenergy.IDLE_FRAC)


def test_energy_module_holds_no_tpu_constant():
    src = inspect.getsource(energy)
    for tpu in ("170", "0.35", "v5e"):
        assert tpu not in src, tpu


def test_modeled_energy_math():
    m = energy.modeled_energy(10.0, 2, util=0.5)
    watts = energy.P_HOST + 2 * energy.P_CHIP * (
        energy.IDLE_FRAC + (1 - energy.IDLE_FRAC) * 0.5)
    assert m["peak_W"] == pytest.approx(watts)
    assert m["energy_J"] == pytest.approx(10.0 * watts)
    assert m["edp_Js"] == pytest.approx(m["energy_J"] * 10.0)


@pytest.mark.parametrize("bad", (1.2, -0.1, 2.0, float("nan")))
def test_modeled_energy_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as ours:
        energy.modeled_energy(10.0, 2, util=bad)
    with pytest.raises(ValueError) as theirs:
        jenergy.modeled_energy(10.0, 2, util=bad)
    assert str(ours.value) == str(theirs.value)


def test_modeled_energy_boundaries():
    assert energy.modeled_energy(1.0, 1, util=0.0)["peak_W"] == \
        pytest.approx(energy.P_HOST + energy.P_CHIP * energy.IDLE_FRAC)
    assert energy.modeled_energy(1.0, 1, util=1.0)["peak_W"] == \
        pytest.approx(energy.P_HOST + energy.P_CHIP)


def test_telemetry_models_with_the_ports_constants():
    assert telemetry.modeled_energy is energy.modeled_energy
    assert telemetry.modeled_energy is not jenergy.modeled_energy
    assert telemetry.DEFAULT_UTIL == energy.DEFAULT_UTIL
    rec = telemetry.TelemetryRecorder({"scenario": "x"})
    rec.record_step(1, 0.1, 2.0)
    report = rec.finalize(n_bodies=8)
    assert report["modeled"]["energy_J"] == pytest.approx(
        energy.modeled_energy(2.0, 1, energy.DEFAULT_UTIL)["energy_J"])


# --------------------------------------------------------------------------
# trace: the reference's cases on the port's tracer
# --------------------------------------------------------------------------
def test_null_tracer_is_inert():
    t = trace.NullTracer()
    assert not t.enabled
    with t.span("anything", foo=1):
        pass
    t.add_span("x", 0.0, 1.0)
    t.instant("y")
    assert t.export("/nonexistent/should/never/be/written.json") is None


def test_span_records_complete_event():
    t = trace.SpanTracer()
    with t.span("outer", key="v"):
        pass
    (ev,) = t.events
    assert ev["name"] == "outer" and ev["ph"] == "X"
    assert ev["dur"] >= 0.001 and ev["args"] == {"key": "v"}


def test_nested_spans_contained_in_time():
    t = trace.SpanTracer()
    with t.span("outer"):
        with t.span("inner"):
            pass
    by = {e["name"]: e for e in t.events}
    outer, inner = by["outer"], by["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_add_span_synthetic_and_instant():
    t = trace.SpanTracer()
    t.add_span("event", 10.0, 5.0, args={"synthetic": True})
    t.add_span("degenerate", 0.0, 0.0)  # dur clamped to a visible sliver
    t.instant("marker", n=3)
    by = {e["name"]: e for e in t.events}
    assert by["event"]["args"]["synthetic"] is True
    assert by["degenerate"]["dur"] == 0.001
    assert by["marker"]["ph"] == "i"


def test_export_chrome_trace_json(tmp_path):
    t = trace.SpanTracer()
    t.add_span("b", 5.0, 1.0)
    t.add_span("a", 1.0, 10.0)
    path = t.export(str(tmp_path / "sub" / "trace.json"))  # creates parents
    doc = json.load(open(path))
    assert doc["otherData"]["schema_version"] == trace.TRACE_SCHEMA_VERSION \
        == jtrace.TRACE_SCHEMA_VERSION
    assert doc["otherData"]["producer"] == "repro_torch.obs.trace"
    evs = doc["traceEvents"]
    assert [e["name"] for e in evs] == ["a", "b"]
    for e in evs:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)


def test_exports_share_the_references_layout(tmp_path):
    docs = []
    for mod in (trace, jtrace):
        t = mod.SpanTracer()
        t.add_span("macro-step", 1.0, 4.0, args={"events": 2})
        t.instant("marker")
        path = t.export(str(tmp_path / f"{mod.__name__}.json"))
        docs.append(json.load(open(path)))
    ours, theirs = docs
    assert set(ours) == set(theirs)
    assert set(ours["otherData"]) == set(theirs["otherData"])
    for a, b in zip(ours["traceEvents"], theirs["traceEvents"]):
        assert set(a) == set(b) and a["name"] == b["name"]


def test_module_tracer_scoping(tmp_path):
    assert not trace.get_tracer().enabled  # default is the null tracer
    out = tmp_path / "t.json"
    with trace.tracing(str(out)) as t:
        assert trace.get_tracer() is t
        with trace.get_tracer().span("scoped"):
            pass
    assert not trace.get_tracer().enabled  # restored on exit
    assert json.load(open(out))["traceEvents"][0]["name"] == "scoped"


def test_set_tracer_returns_previous():
    live = trace.SpanTracer()
    prev = trace.set_tracer(live)
    try:
        assert trace.get_tracer() is live
    finally:
        trace.set_tracer(prev)
    assert trace.get_tracer() is prev


def test_live_spans_reach_the_torch_profiler():
    """Each live span is a ``torch.profiler.record_function`` range, so it
    shows in a profiler window beside the kernels."""
    t = trace.SpanTracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("macro-step"):
            torch.ones(4).sum()
    assert "macro-step" in {e.name for e in prof.events()}


# --------------------------------------------------------------------------
# a traced block + gather run through the port's API
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs")
    trace_path = str(out / "trace.json")
    report = api.run(api.SimConfig(trace=trace_path, metrics_interval=1,
                                   **BLOCK_KW))
    return report, json.load(open(trace_path))


def test_traced_run_has_nested_span_taxonomy(traced_run):
    report, doc = traced_run
    assert report["trace_path"].endswith("trace.json")
    assert doc["otherData"]["producer"] == "repro_torch.obs.trace"
    by = {}
    for ev in doc["traceEvents"]:
        by.setdefault(ev["name"], []).append(ev)
    assert by.get("macro-step") and by.get("event") and by.get(
        "kernel-launch")

    def inside(child, parent, tol=1.0):
        return (parent["ts"] <= child["ts"] + tol and
                child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
                + tol)

    for name in ("event", "kernel-launch"):
        for child in by[name]:
            assert child["args"]["synthetic"] is True
            assert any(inside(child, ms) for ms in by["macro-step"])
    for kl in by["kernel-launch"]:
        assert any(inside(kl, ev) for ev in by["event"])
    macro = by["macro-step"]
    assert sum(e["args"]["events"] for e in macro) == \
        sum(r["steps"] for r in report["runs"])
    assert sum(e["args"]["tiles"] for e in macro) == pytest.approx(
        report["grid_tiles_total"])
    assert sum(e["dur"] for e in macro) / 1e6 <= report["wall_s"]


def test_traced_run_metrics_payload(traced_run):
    report, _ = traced_run
    m = report["metrics"]
    metrics.validate_snapshot(m)
    jmetrics.validate_snapshot(m)
    c, g = m["counters"], m["gauges"]
    assert c["sim.events"]["value"] == sum(r["steps"] for r in report["runs"])
    assert c["sim.tiles_launched"]["value"] == pytest.approx(
        report["grid_tiles_total"])
    assert 0 < c["sim.tiles_launched"]["value"] <= \
        g["sim.tiles_occupancy_bound"]["value"] <= \
        c["sim.tiles_dense_baseline"]["value"]
    hits = g["sim.bucket_hits"]["value"]
    assert len(hits) >= 2 and sum(hits) == sum(r["steps"]
                                               for r in report["runs"])
    assert m["histograms"]["sim.active_fraction"]["count"] > 0
    assert 0.0 < m["histograms"]["sim.active_fraction"]["mean"] <= 1.0
    tagged = [s for s in report["snapshots"] if "metrics" in s]
    assert tagged
    vals = [s["metrics"]["counters"]["sim.events"]["value"] for s in tagged]
    assert vals == sorted(vals)


def test_untraced_run_has_metrics_but_no_trace():
    report = api.run(api.SimConfig(**BLOCK_KW))
    assert "trace_path" not in report
    metrics.validate_snapshot(report["metrics"])
