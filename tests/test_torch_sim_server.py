"""Port parity: the continuous-batching ``SimServer``
(``repro_torch.serve.sim_engine``) against ``repro.serve.sim_engine``.

The same deterministic trace (numpy seed 0; mixed scenarios and steppers,
small n) goes through both servers, with full-source and with neighbor
block pods: the same retire order, the same per-report counts, final
energies, times and each retired member's rows within the golden tiers.  Within the port: no engine
build after ``warmup``, batch-mates bit for bit the same across a
neighbour's retire and backfill, ``suspend`` -> ``resume`` continuing bit
for bit, and the admission policy's tile bound.  The reference's own
Hypothesis property for that bound fails under the installed JAX
(ROADMAP.md queue 3 C), so the bound is held as a property of the port's
own functions, not compared against it.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import sim_engine as jse
from repro.sim import ensemble as jens
from repro.sim.scenarios import ScenarioSpec as JSpec
from repro_torch.core.nbody import FIELDS
from repro_torch.kernels import ops
from repro_torch.serve import (Pod, ServerConfig, SimRequest, SimServer,
                               fifo_event_tiles, packed_event_tiles)
from repro_torch.sim import ensemble as ens
from repro_torch.sim.scenarios import ScenarioError, ScenarioSpec
from repro_torch.sim.telemetry import RunReport


@pytest.fixture(scope="module", autouse=True)
def cold_reference_engines():
    """Leave the JAX package's engine caches empty, as a fresh process has
    them: this file's replays build the engines of the reference server's
    own test configs, and tests/test_sim_server.py counts the engines its
    warmup builds (0 if a file before it in the same process built them)."""
    yield
    for fn in (jens._engine, jens._adaptive_engine, jens._block_engine,
               jens._strategy_block_engine, jens._fused_block_engine):
        fn.cache_clear()


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: tests/test_golden_trajectories.py tiers at fp32: TOL (lockstep) and
#: BLOCK_TOL's position tier (block), on energies and times
TIER = {"adaptive": 1e-7, "block": 1e-6}
#: the same tiers on final (pos, vel): TOL and BLOCK_TOL at fp32
FINAL_TOL = {"adaptive": (1e-7, 1e-7), "block": (1e-6, 1e-5)}
#: fp32 K1 against its plain version, max |diff| / max |want|
#: (tests/test_torch_cuda.py TOL)
ACC_TOL = 1e-5
NBR = dict(sources="neighbor", neighbor_radius=0.5, block_i=16, block_j=16)
#: neighbor pods at the base tile (32), so the small requests share a pod
NBR32 = dict(sources="neighbor", neighbor_radius=0.5)


def _base(**kw):
    base = dict(slots_per_pod=2, n_max=64, chunk_events=4, dt_max=0.0625,
                n_levels=4, block_i=32, block_j=32, devices=1)
    base.update(kw)
    return base


def _cfg(**kw):
    return ServerConfig(device="cpu", **_base(**kw))


def _req(token, stepper="adaptive", t_end=0.02, seed=0):
    return SimRequest(spec=ScenarioSpec.parse(token, seed=seed),
                      stepper=stepper, t_end=t_end)


def _trace(n=8):
    """``[(token, stepper, t_end, seed), ...]`` drawn with numpy seed 0."""
    rng = np.random.default_rng(0)
    toks = ("plummer:24", "king:20", "two_body:2", "plummer:40",
            "binary_plummer:32", "merger:48")
    return [(toks[rng.integers(len(toks))],
             ("adaptive", "block")[rng.integers(2)],
             float(rng.choice([0.01, 0.02, 0.03])), int(rng.integers(5)))
            for _ in range(n)]


# --------------------------------------------------------------------------
# the same trace through both servers
# --------------------------------------------------------------------------
#: the rows each retired member is held to the reference's on
FINAL_FIELDS = ("pos", "vel", "acc")


@contextlib.contextmanager
def capturing_finals(pod_cls, finals):
    """Keep each retired member's ``FINAL_FIELDS`` rows as float64 numpy
    (``finals[request_id]``) as ``pod_cls.retire`` frees its slot."""
    real = pod_cls.retire

    def retire(pod, slot, now):
        n = pod.slots[slot].request.spec.n
        rows = {f: np.array(getattr(pod.batched, f)[slot][:n],
                            dtype=np.float64) for f in FINAL_FIELDS}
        report = real(pod, slot, now)
        finals[report["request_id"]] = rows
        return report

    pod_cls.retire = retire
    try:
        yield finals
    finally:
        pod_cls.retire = real


@pytest.fixture(scope="module")
def replays():
    torch.set_num_threads(1)
    out = {}
    for label, extra in (("full", {}), ("neighbor", NBR)):
        js = jse.SimServer(jse.ServerConfig(impl="xla", **_base(**extra)))
        ts = SimServer(_cfg(**extra))
        for tok, stepper, t_end, seed in _trace():
            js.submit(jse.SimRequest(spec=JSpec.parse(tok, seed=seed),
                                     stepper=stepper, t_end=t_end), now=0.0)
            ts.submit(_req(tok, stepper, t_end, seed), now=0.0)
        orders, finals = ([], []), ({}, {})
        tick = 0
        with capturing_finals(jse.Pod, finals[0]), \
                capturing_finals(Pod, finals[1]):
            while js.busy() or ts.busy():
                orders[0].extend(r["request_id"] for r in js.step(now=tick))
                orders[1].extend(r["request_id"] for r in ts.step(now=tick))
                tick += 1
                assert tick < 500
        out[label] = (js, ts, orders, finals)
    return out


@pytest.mark.parametrize("label", ("full", "neighbor"))
def test_trace_retires_in_the_references_order(replays, label):
    js, ts, (want, got), _ = replays[label]
    assert got == want and len(got) == len(_trace())
    assert sorted(ts.pods) == sorted(js.pods)


@pytest.mark.parametrize("label", ("full", "neighbor"))
def test_trace_reports_equal_the_references(replays, label):
    js, ts, _, _ = replays[label]
    want = {r["request_id"]: r for r in js.reports}
    got = {r["request_id"]: r for r in ts.reports}
    assert set(got) == set(want)
    for rid, w in want.items():
        g = got[rid]
        assert isinstance(g, RunReport)
        assert set(g) == set(w)
        for k in ("steps", "force_evals", "grid_tiles", "n_active",
                  "n_bodies", "pod_cap", "scenario", "stepper", "request_id",
                  "neighbor_refreshes", "neighbor_overflows"):
            assert g.get(k) == w.get(k), (rid, k)
        tier = TIER[g["stepper"]]
        for k in ("e0", "e1", "t_final"):
            assert abs(g[k] - w[k]) <= tier, (rid, k)
    if label == "neighbor":
        assert any(r.get("neighbor_refreshes", 0) > 0 for r in ts.reports)


@pytest.mark.parametrize("label", ("full", "neighbor"))
def test_trace_final_states_equal_the_references(replays, label):
    """Each retired member's rows against the reference member with the
    same request id: positions and velocities at the golden tiers,
    accelerations (the fp32 kernels' output) at the kernels' normalised
    tolerance."""
    js, ts, _, (want, got) = replays[label]
    assert set(got) == set(want) == set(range(len(_trace())))
    steppers = {r["request_id"]: r["stepper"] for r in ts.reports}
    for rid, w in want.items():
        g = got[rid]
        tol_pos, tol_vel = FINAL_TOL[steppers[rid]]
        assert g["pos"].shape == w["pos"].shape
        assert np.abs(g["pos"] - w["pos"]).max() <= tol_pos, rid
        assert np.abs(g["vel"] - w["vel"]).max() <= tol_vel, rid
        assert (np.abs(g["acc"] - w["acc"]).max()
                <= ACC_TOL * np.abs(w["acc"]).max()), rid


def test_trace_metrics_match_the_references(replays):
    js, ts, _, _ = replays["full"]
    want, got = js.metrics_snapshot(), ts.metrics_snapshot()
    for section in ("counters", "gauges"):
        w = {k: v for k, v in want[section].items() if k.startswith("serve.")}
        g = {k: v for k, v in got[section].items() if k.startswith("serve.")}
        assert g == w, section


# --------------------------------------------------------------------------
# no engine build after warmup
# --------------------------------------------------------------------------
@pytest.mark.parametrize("extra", ({}, NBR), ids=("full", "neighbor"))
def test_zero_cache_miss_after_warmup(extra):
    # the engines are cached per process: start from none built
    for fn in (ens._engine, ens._adaptive_engine, ens._block_engine):
        fn.cache_clear()
    server = SimServer(_cfg(**extra))
    server.warmup([_req("plummer:24", "adaptive"),
                   _req("plummer:40", "block")])
    baseline = server.cache_misses()
    assert baseline > 0   # warmup itself built the engines
    for seed in range(3):
        server.submit(_req("plummer:24", "adaptive", 0.02, seed=seed))
        server.submit(_req("king:40", "block", 0.02, seed=seed))
    assert len(server.run_until_drained()) == 6
    assert server.cache_misses() == baseline


# --------------------------------------------------------------------------
# batch-mates across retire + backfill
# --------------------------------------------------------------------------
def _member_rows(pod, slot):
    return {f: getattr(pod.batched, f)[slot] for f in FIELDS}


@pytest.mark.parametrize("stepper,extra", [("adaptive", {}), ("block", {}),
                                           ("block", NBR32)],
                         ids=("adaptive", "block", "block-neighbor"))
def test_batch_mate_bit_identical_across_backfill(stepper, extra):
    """A neighbour retiring and a new member backfilling its slot must not
    move the surviving member by a single bit."""
    short, long_ = 0.01, 0.08
    treatment, control = SimServer(_cfg(**extra)), SimServer(_cfg(**extra))
    for srv in (treatment, control):
        srv.submit(_req("plummer:24", stepper, short), now=0.0)
        srv.submit(_req("two_body:2", stepper, long_), now=0.0)
    treatment.submit(_req("king:20", stepper, short, seed=5), now=0.0)
    tensors = None
    ticks = 0
    while treatment.busy() or control.busy():
        treatment.step(now=float(ticks))
        control.step(now=float(ticks))
        ticks += 1
        assert ticks < 1000
        (t_pod,), (c_pod,) = treatment.pods.values(), control.pods.values()
        if tensors is None:
            tensors = t_pod.batched.pos.shape
        assert t_pod.batched.pos.shape == tensors   # never reallocated
        if t_pod.slots[1] is not None and c_pod.slots[1] is not None:
            t_rows, c_rows = _member_rows(t_pod, 1), _member_rows(c_pod, 1)
            for f in FIELDS:
                assert torch.equal(t_rows[f], c_rows[f]), f
    by_rid = {r["request_id"]: r for r in treatment.reports}
    assert len(by_rid) == 3
    want = {r["request_id"]: r for r in control.reports}[1]
    for key in ("steps", "t_final", "e1"):
        assert by_rid[1][key] == want[key]


# --------------------------------------------------------------------------
# suspend / resume
# --------------------------------------------------------------------------
@pytest.mark.parametrize("stepper,extra", [("adaptive", {}), ("block", {}),
                                           ("block", NBR32)],
                         ids=("adaptive", "block", "block-neighbor"))
def test_suspend_resume_bit_identical(tmp_path, stepper, extra):
    def build():
        s = SimServer(_cfg(**extra))
        s.submit(_req("plummer:24", stepper, 0.04), now=0.0)
        s.submit(_req("two_body:2", stepper, 0.04), now=0.0)
        s.submit(_req("king:20", stepper, 0.04, seed=3), now=0.0)
        return s

    straight = build()
    straight.run_until_drained()
    paused = build()
    paused.step(now=0.0)
    paused.step(now=1.0)
    paused.suspend(str(tmp_path / "ckpt"))
    resumed = SimServer.resume(str(tmp_path / "ckpt"))
    assert resumed.cfg == paused.cfg
    resumed.reports = list(paused.reports)
    resumed.run_until_drained()

    def key(reports):
        return sorted((r["request_id"], r["steps"], r["e1"], r["t_final"])
                      for r in reports)

    assert key(resumed.reports) == key(straight.reports)


def test_neighbor_pod_round_trip(tmp_path):
    """tests/test_neighbor.py's server case in the port: a neighbor-sources
    block pod suspends and resumes its NeighborCarry bit for bit."""
    srv = SimServer(ServerConfig(slots_per_pod=2, n_max=128, chunk_events=8,
                                 dtype="fp32", eta=0.02, device="cpu",
                                 **NBR))
    srv.submit(_req("plummer:64", "block", 0.0625))
    srv.step()
    pod = next(iter(srv.pods.values()))
    assert pod.carry is not None and pod.carry.nbr is not None
    srv.suspend(str(tmp_path))
    srv2 = SimServer.resume(str(tmp_path))
    pod2 = next(iter(srv2.pods.values()))
    assert pod2.carry.nbr is not None
    for a, b in zip(pod.carry.nbr, pod2.carry.nbr):
        assert torch.equal(a, b)
    srv.step()
    srv2.step()
    assert torch.equal(next(iter(srv.pods.values())).batched.pos,
                       next(iter(srv2.pods.values())).batched.pos)


# --------------------------------------------------------------------------
# admission policy: packing by bucket never launches more tiles than FIFO
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_max,bi,bj", [(64, 32, 32), (128, 32, 32),
                                         (256, 64, 64)])
def test_packed_tiles_never_exceed_fifo_exhaustive(n_max, bi, bj):
    plan = ops.CapacityPlan(n_max, n_max, bi, bj)
    for n in range(1, n_max + 1):
        assert packed_event_tiles(plan, n) <= fifo_event_tiles(plan, n)
        assert packed_event_tiles(plan, n) == jse.packed_event_tiles(
            jse.ops.CapacityPlan(n_max, n_max, bi, bj), n)


@settings(deadline=None, max_examples=200)
@given(n=st.integers(min_value=1, max_value=1024),
       shape=st.sampled_from([(1024, 32, 32), (1024, 64, 64),
                              (512, 32, 64)]))
def test_packed_tiles_never_exceed_fifo_property(n, shape):
    """The bound as a property of the port's own functions (the
    reference's live property test fails under the installed JAX)."""
    n_max, bi, bj = shape
    n = min(n, n_max)
    plan = ops.CapacityPlan(n_max, n_max, bi, bj)
    assert packed_event_tiles(plan, n) <= fifo_event_tiles(plan, n)


# --------------------------------------------------------------------------
# reports, pods and admission-boundary validation
# --------------------------------------------------------------------------
def test_retire_report_contents():
    server = SimServer(_cfg())
    rid = server.submit(_req("plummer:24", "block", t_end=0.02, seed=7),
                        now=0.0)
    (report,) = server.run_until_drained()
    assert report["scenario"] == "plummer:24"
    assert report["n_active"] == [24]
    assert report["n_bodies"] == server.pod_for(
        _req("plummer:24", "block")).cap
    assert report["request_id"] == rid and report["steps"] >= 1
    assert report["t_final"] >= 0.02
    assert report["turnaround_s"] >= report["admission_latency_s"] >= 0.0
    assert np.isfinite(report["de_rel"]) and report["grid_tiles"][0] > 0
    snap = server.metrics_snapshot()
    assert {"serve.requests_admitted",
            "serve.requests_retired"} <= set(snap["counters"])
    assert "serve.queue_depth" in snap["gauges"]
    assert "serve.turnaround_s" in snap["histograms"]


def test_bucket_packing_separates_pods_and_fifo_per_bucket():
    server = SimServer(_cfg())
    server.submit(_req("plummer:24", "adaptive"))   # cap 32 pod
    server.submit(_req("plummer:40", "adaptive"))   # cap 64 pod
    server.submit(_req("plummer:20", "block"))      # block cap 32 pod
    server.step(now=0.0)
    assert set(server.pods) == {("adaptive", 32), ("adaptive", 64),
                                ("block", 32)}
    assert not server.queue
    for pod in server.pods.values():
        assert pod.batched.pos.device.type == "cpu"


@pytest.mark.parametrize("make,exc,match", [
    (lambda: SimRequest(spec=ScenarioSpec.parse("plummer")), ScenarioError,
     "SimRequest.spec.n"),
    (lambda: _req("plummer:100"), ValueError, "n_max=64"),
    (lambda: _req("plummer:24", stepper="fixed"), ValueError,
     "not servable"),
    (lambda: _req("plummer:24", t_end=0.0), ValueError, "SimRequest.t_end"),
])
def test_submit_rejects_what_the_reference_rejects(make, exc, match):
    with pytest.raises(exc, match=match):
        SimServer(_cfg()).submit(make())


@pytest.mark.parametrize("kw,exc,match", [
    (dict(n_max=65), ValueError, "block_i-aligned"),
    (dict(sources="neighbor", compaction="gather"), ValueError,
     "compaction"),
    (dict(devices=3), ValueError, "multiple of the batch extent 3"),
    (dict(mesh=(2, 2)), ValueError, "covers 4 devices; devices says 1"),
])
def test_config_rejects_what_the_port_does_not_take(kw, exc, match):
    with pytest.raises(exc, match=match):
        SimServer(dataclasses.replace(_cfg(), **kw))
