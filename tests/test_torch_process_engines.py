"""Port parity: the N-body block-timestep engines over a mesh of processes
(``repro_torch.distributed.process_mesh``), one gloo rank per shard on the
CPU, against the in-process mesh and the JAX package's committed runs.

A spawn of two ranks replays ``binary_plummer_block_2dev.json`` (the
reference's 2-device mesh_sharded gather run) through
``evolve_strategy_block`` over the process mesh under every strategy
(two_level as one card of two chips), both compactions and both ring
modes.  A spawn of four ranks replays ``plummer_block_fused_2x2.json`` on
the fused ``(2, 2)`` grid, runs the 1-D batch layout (fixed dt, adaptive,
block with none and gather, a B = 3 batch padded to 4, one mixed-precision
case), neighbor sources on both layouts, the API's runners, and one job
with a planted fault: each rank choosing its bucket group's capacity from
its own members alone.  Held:

* the goldens: the event count (and the fused run's tiles) exactly,
  pos/vel within ``BLOCK_TOL`` fp32 of ``tests/test_golden_trajectories.py``;
* every rank's state and carry (events, pairs, per-shard tiles, bucket
  hits, the strategy engine's per-event bounds) equal, bit for bit, to the
  in-process mesh's over as many CPU slots (``distributed.mesh_runs``, the
  same code), and the 1-D layouts to one slot's;
  ``tests/test_torch_strategy_block.py`` holds those counts against the
  JAX package's live 2-device run;
* the host reads per event of the in-process run on every rank, each
  answered by one collective;
* rank 0's API report, and ``sim_run --backend gloo``'s, equal to the
  in-process report outside the wall-clock fields;
* the planted fault changes the carry's tiles or bucket hits, so the
  check above catches it.
"""

import concurrent.futures
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import strategies
from repro_torch.distributed import mesh_runs, process_mesh
from repro_torch.distributed.process_mesh import ProcessMesh
from repro_torch.launch import sim_run
from repro_torch.sim import api
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_2DEV = os.path.join(ROOT, "tests", "golden",
                           "binary_plummer_block_2dev.json")
GOLDEN_FUSED = os.path.join(ROOT, "tests", "golden",
                            "plummer_block_fused_2x2.json")
#: tests/test_golden_trajectories.py BLOCK_TOL fp32 (pos, vel)
BLOCK_TOL = (1e-6, 1e-5)
#: a hang fails its spawn in this many seconds, not process_mesh's 600
TIMEOUT_S = 120.0
#: (strategy, ring mode): every strategy, the ring in both schedules
MODES = [(s, "overlap") for s in strategies.STRATEGIES] + [("ring", "sync")]
#: a padded mixed batch (B = 3, padded to 4) at a few hundred bodies, and
#: tiles small enough that a member has several capacity buckets
MIX = [("plummer", 200), ("king", 256), ("plummer", 300)]
TILES = dict(block_i=16, block_j=32)
#: one macro-step of 16 ticks, deep enough that a member's active count
#: moves between buckets from event to event (a none run does all its
#: n_events)
BLOCK_RUN = dict(t_end=1 / 128, dt_max=1 / 128, n_levels=5, n_events=16,
                 **TILES)
NBR_RUN = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=4, block_i=16,
               block_j=16, sources="neighbor", neighbor_radius=0.5)
#: the report's wall-clock fields, the only ones a rank may differ in
WALL = ("wall_s", "step_wall_s", "steps_per_s", "interactions_per_s",
        "modeled", "report_path")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(path):
    with open(path) as f:
        doc = json.load(f)
    m = doc["meta"]
    run = dict(t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
               eta=m["eta"], order=m["order"], eps=m["eps"])
    return doc, m, run


def _strategy_jobs():
    _, m, run = _golden(GOLDEN_2DEV)
    return [dict(kind="strategy_block", strategy=s, ring_mode=mode,
                 compaction=c, scenario=m["scenario"], n=m["n"],
                 seed=m["seed"], block_i=m["block_i"], block_j=m["block_j"],
                 chips_per_card=2, run=run)
            for s, mode in MODES for c in strategies.COMPACTIONS]


def _layout_jobs():
    """The four ranks' jobs by name (dicts keep their order)."""
    _, m, run = _golden(GOLDEN_FUSED)
    jobs = {
        "fused golden": dict(
            kind="layout", stepper="block", mix=[(m["scenario"], m["n"])],
            seed=m["seed"], repeat=m["ensemble"], mesh=tuple(m["mesh"]),
            run=dict(run, compaction=m["compaction"])),
        "fixed": dict(kind="layout", stepper="fixed", mix=[("plummer", 64)],
                      repeat=3, run=dict(n_steps=4, dt=1e-2)),
        "adaptive": dict(kind="layout", stepper="adaptive",
                         mix=[("plummer", 64)], repeat=4,
                         run=dict(t_end=0.05, n_steps=12)),
        "fused gather": dict(kind="layout", stepper="block",
                             mix=[("plummer", 256)], repeat=3, mesh=(2, 2),
                             run=dict(BLOCK_RUN, compaction="gather")),
        "neighbor": dict(kind="layout", stepper="block",
                         mix=[("plummer", 200)], repeat=3, run=NBR_RUN),
        "fused neighbor": dict(kind="layout", stepper="block",
                               mix=[("plummer", 200)], repeat=3, mesh=(2, 2),
                               run=NBR_RUN),
        "gather mixed": dict(kind="layout", stepper="block", mix=MIX,
                             dtype="mixed",
                             run=dict(BLOCK_RUN, compaction="gather")),
    }
    for c in strategies.COMPACTIONS:
        for mode in ens.BUCKET_MODES:
            jobs[f"{c} {mode}"] = dict(
                kind="layout", stepper="block", mix=MIX,
                run=dict(BLOCK_RUN, compaction=c, bucket_mode=mode))
    # one group over every rank: four members of one size, their active
    # counts unequal event by event
    shared = dict(kind="layout", stepper="block", mix=[("plummer", 256)],
                  repeat=4, run=dict(BLOCK_RUN, compaction="gather",
                                     bucket_mode="shared"))
    jobs["shared 4"] = shared
    jobs["planted"] = dict(shared, fault="own_capacity")
    for name, cfg in API_CASES.items():
        jobs[f"api {name}"] = dict(kind="api", cfg=cfg)
    return jobs


#: the API's runners over four shards: a block run under the ring, the
#: fused grid, and a fixed-dt ensemble over the 1-D layout
API_CASES = {
    "block ring": dict(scenario="binary_plummer", n=96, t_end=1 / 32,
                       stepper="block", dt_max=1 / 32, n_levels=4,
                       strategy="ring", devices=4, compaction="gather",
                       diag_every=8, validate_ic=False, **TILES),
    "fused": dict(scenario="plummer", n=128, ensemble=2, t_end=1 / 32,
                  stepper="block", dt_max=1 / 32, n_levels=4, devices=4,
                  mesh=(2, 2), compaction="gather", diag_every=8,
                  validate_ic=False, **TILES),
    "fixed": dict(scenario="plummer", n=64, ensemble=3, t_end=0.02,
                  dt=1 / 256, devices=4, diag_every=4, validate_ic=False),
}


#: the jobs of the 1-D layout (run on one slot too)
ONE_SLOT = [i for i, j in enumerate(_layout_jobs().values())
            if j["kind"] == "layout" and "mesh" not in j]


def _planted(job):
    """The fault: each rank reads its own members' decisions alone, so a
    bucket group spread over ranks launches at each rank's capacity."""
    if job.get("fault") != "own_capacity":
        return None
    read = ens._BlockEngine._read

    def own(self, x):
        ens.ensemble_run_block.host_syncs += 1
        return x.tolist()

    ens._BlockEngine._read = own
    return read


def planted_rank(device, jobs, out_dir):
    """``mesh_runs.strategy_rank`` with a job's ``fault`` planted while it
    runs."""
    run = mesh_runs.run_job

    def one(mesh, dev, job):
        read = _planted(job)
        try:
            return run(mesh, dev, {k: v for k, v in job.items()
                                   if k != "fault"})
        finally:
            if read is not None:
                ens._BlockEngine._read = read

    mesh_runs.run_job = one
    mesh_runs.strategy_rank(device, jobs, out_dir, True)


def _spawn(tmp_path_factory, world, fn, jobs):
    out = str(tmp_path_factory.mktemp(f"engines{world}"))
    process_mesh.spawn(fn, world, "gloo", "cpu", jobs, out,
                       timeout=TIMEOUT_S)
    return mesh_runs.load_ranks(out, world)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The ranks' results and the in-process mesh's over two CPU slots,
    the second computed here while the ranks run."""
    jobs = _strategy_jobs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn, tmp_path_factory, 2,
                            mesh_runs.strategy_rank, jobs)
        ref = mesh_runs.in_process(["cpu"] * 2, jobs)
        return jobs, ranks.result(), ref


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The ranks' results by job name, the in-process mesh's over four CPU
    slots, and (the 1-D layouts) one slot's, the last two computed here
    while the ranks run."""
    named = _layout_jobs()
    jobs = list(named.values())
    sound = [{k: v for k, v in j.items() if k != "fault"} for j in jobs]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn, tmp_path_factory, 4, planted_rank, jobs)
        four = mesh_runs.in_process(["cpu"] * 4, sound)
        one = {i: r for i, r in zip(
            ONE_SLOT, mesh_runs.in_process(["cpu"],
                                           [sound[i] for i in ONE_SLOT]))}
        ranks = ranks.result()
    return {name: ([r[i] for r in ranks], four[i], one.get(i))
            for i, name in enumerate(named)}


def _same_tensors(got, want, tag):
    assert got["tensors"].keys() == want["tensors"].keys(), tag
    for name, t in want["tensors"].items():
        assert torch.equal(got["tensors"][name], t), (tag, name)
        assert got["digests"][name] == mesh_runs.digest(t), (tag, name)


# --------------------------------------------------------------------------
# the strategy engine over two ranks
# --------------------------------------------------------------------------
def _strategy_index(strategy, mode, compaction):
    return [(s, m, c) for s, m in MODES
            for c in strategies.COMPACTIONS].index((strategy, mode,
                                                     compaction))


@pytest.mark.parametrize("compaction", strategies.COMPACTIONS)
@pytest.mark.parametrize("strategy,mode", MODES)
def test_strategy_engine_over_ranks_replays_the_golden(two_ranks, strategy,
                                                       mode, compaction):
    doc, m, _ = _golden(GOLDEN_2DEV)
    jobs, ranks, _ = two_ranks
    i = _strategy_index(strategy, mode, compaction)
    for res in ranks:
        t = res[i]["tensors"]
        assert int(t["carry.n_events"]) == doc["n_events"]
        np.testing.assert_allclose(t["state.pos"].numpy(),
                                   np.asarray(doc["pos"]), rtol=0,
                                   atol=BLOCK_TOL[0])
        np.testing.assert_allclose(t["state.vel"].numpy(),
                                   np.asarray(doc["vel"]), rtol=0,
                                   atol=BLOCK_TOL[1])
        assert float(t["state.time"]) == m["t_end"]


@pytest.mark.parametrize("compaction", strategies.COMPACTIONS)
@pytest.mark.parametrize("strategy,mode", MODES)
def test_strategy_engine_ranks_are_the_in_process_engine(two_ranks, strategy,
                                                         mode, compaction):
    """Every rank's state, events, pairs, per-shard tiles and per-event
    gather bounds are the in-process 2-slot engine's, bit for bit, and so
    are its host reads; gather reads one bound vector per event."""
    jobs, ranks, ref = two_ranks
    i = _strategy_index(strategy, mode, compaction)
    for r, res in enumerate(ranks):
        _same_tensors(res[i], ref[i], (strategy, mode, compaction, r))
        assert res[i]["counts"]["host_syncs"] == ref[i]["counts"]["host_syncs"]
        assert res[i]["counts"]["shifts"] == ref[i]["counts"]["shifts"]
    t = ref[i]["tensors"]
    events = int(t["carry.n_events"])
    assert tuple(t["carry.n_tiles"].shape) == (2,)
    if compaction == "gather":
        assert tuple(t["bounds"].shape) == (events, 2)
        # an event's read, the read that finds the run past t_end, and the
        # end of the chunk
        assert ref[i]["counts"]["host_syncs"] == events + 2
    else:
        assert t["bounds"].numel() == 0


@pytest.mark.parametrize("strategy,mode", MODES)
def test_strategy_engine_over_ranks_gather_equals_none(two_ranks, strategy,
                                                       mode):
    _, ranks, _ = two_ranks
    a, b = (ranks[1][_strategy_index(strategy, mode, c)]["tensors"]
            for c in ("none", "gather"))
    for k, t in a.items():
        if k.startswith("state."):
            assert torch.equal(t, b[k]), k
    assert torch.equal(a["carry.n_pairs"], b["carry.n_pairs"])
    assert (b["carry.n_tiles"] < a["carry.n_tiles"]).all()


# --------------------------------------------------------------------------
# the batch layouts over four ranks
# --------------------------------------------------------------------------
LAYOUT_NAMES = [n for n in _layout_jobs() if n != "planted"]


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_layout_ranks_are_the_in_process_run(four_ranks, name):
    """Every rank holds the whole output, bit for bit the in-process
    mesh's over four CPU slots (rank 0's API report: every field outside
    the wall clock), with the in-process run's host reads."""
    ranks, four, _ = four_ranks[name]
    for r, res in enumerate(ranks):
        _same_tensors(res, four, (name, r))
        assert res["counts"]["host_syncs"] == four["counts"]["host_syncs"]
    if name.startswith("api"):
        want = four["info"]["report"]
        for res in ranks:
            got = res["info"]["report"]
            assert {k: v for k, v in got.items() if k not in WALL} \
                == {k: v for k, v in want.items() if k not in WALL}
            assert got["devices"] == 4


@pytest.mark.parametrize("name", [n for i, n in enumerate(_layout_jobs())
                                  if i in ONE_SLOT and n != "planted"])
def test_1d_layout_over_ranks_is_the_one_slot_run(four_ranks, name):
    """The 1-D layout over four ranks (B = 3 padded to 4 where the batch
    is three) gives one slot's bits: every state leaf and carry counter,
    and one slot's host reads, each answered by one collective."""
    ranks, _, one = four_ranks[name]
    _same_tensors(ranks[0], one, name)
    assert ranks[0]["counts"]["host_syncs"] == one["counts"]["host_syncs"]
    assert ranks[0]["counts"]["collectives"] > 0


def test_fused_over_ranks_replays_the_golden(four_ranks):
    doc, m, _ = _golden(GOLDEN_FUSED)
    ranks, _, _ = four_ranks["fused golden"]
    for res in ranks:
        t = res["tensors"]
        assert t["carry.n_events"].tolist() == doc["n_events"]
        assert t["carry.n_tiles"].tolist() == doc["n_tiles"]
        np.testing.assert_allclose(t["state.pos"].numpy(),
                                   np.asarray(doc["pos"]), rtol=0,
                                   atol=BLOCK_TOL[0])
        np.testing.assert_allclose(t["state.vel"].numpy(),
                                   np.asarray(doc["vel"]), rtol=0,
                                   atol=BLOCK_TOL[1])
        assert not t["carry.bucket_hits"].any()


@pytest.mark.parametrize("name", ["neighbor", "fused neighbor"])
def test_neighbor_sources_over_ranks_refresh_and_read(four_ranks, name):
    """The neighbor scheme over either layout: windows refreshed, the
    refresh events' second read, and the 1-D layout's bits one slot's."""
    ranks, four, one = four_ranks[name]
    t = ranks[0]["tensors"]
    assert bool((t["nbr.n_refresh"] > 0).all())
    events = int(t["carry.n_events"].max())
    assert ranks[0]["counts"]["host_syncs"] > events
    _same_tensors(ranks[0], four, name)


def test_a_capacity_chosen_by_one_rank_alone_is_caught(four_ranks):
    """The planted fault: each rank sizes the shared bucket group from its
    own member.  The bits stay (a wider window only adds masked rows), but
    the carry's tiles or bucket hits leave the in-process run's, so the
    rank-versus-in-process check fails on it."""
    ranks, _, _ = four_ranks["planted"]
    _, four, _ = four_ranks["shared 4"]
    got, want = ranks[0]["tensors"], four["tensors"]
    assert torch.equal(got["state.pos"], want["state.pos"])
    assert not (torch.equal(got["carry.n_tiles"], want["carry.n_tiles"])
                and torch.equal(got["carry.bucket_hits"],
                                want["carry.bucket_hits"]))
    with pytest.raises(AssertionError):
        _same_tensors(ranks[0], four, "planted")


# --------------------------------------------------------------------------
# the CLI, the mesh's views and its limits
# --------------------------------------------------------------------------
def _report(path):
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if k not in WALL}


CLI = ["--device", "cpu", "--devices", "4", "--stepper", "block",
       "--strategy", "ring", "--scenario", "plummer", "--n", "64",
       "--t-end", "0.03125", "--dt-max", "0.03125", "--levels", "4",
       "--compaction", "gather", "--block-i", "16", "--block-j", "32",
       "--no-validate"]


def test_sim_run_over_gloo_gives_the_in_process_report(tmp_path, capfd):
    """``sim_run --backend gloo --devices 4 --stepper block --strategy
    ring``: four ranks, rank 0 writes the in-process run's report (the
    wall clock aside) and prints its ``[sim]`` lines."""
    ens._strategy_block_engine.cache_clear()
    assert sim_run.main(CLI + ["--out", str(tmp_path / "one.json")]) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("[sim]") and "wall=" not in ln
             and "E_model" not in ln and "report ->" not in ln]
    assert sim_run.main(CLI + ["--backend", "gloo",
                               "--out", str(tmp_path / "ranks.json")]) == 0
    out = capfd.readouterr().out
    assert "transport: gloo, host memory" in out
    assert [ln for ln in out.splitlines() if ln in lines] == lines
    want, got = _report(tmp_path / "one.json"), _report(tmp_path / "ranks.json")
    assert got == want
    assert got["devices"] == 4 and len(got["grid_tiles_per_shard"]) == 4


@pytest.mark.parametrize("argv", [
    ["--devices", "1", "--strategy", "ring"],
    ["--devices", "4"],
])
def test_sim_run_backend_refuses_what_shards_nothing(argv):
    with pytest.raises(SystemExit):
        sim_run.main(["--device", "cpu", "--backend", "gloo", "--scenario",
                      "plummer", "--n", "32", "--t-end", "0.01"] + argv)


def test_sim_run_nccl_refuses_more_ranks_than_cards(tmp_path):
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{visible} cards visible"):
        sim_run.main(["--backend", "nccl", "--devices", str(visible + 2),
                      "--strategy", "ring", "--scenario", "plummer", "--n",
                      "32", "--t-end", "0.01", "--out",
                      str(tmp_path / "r.json")])
    assert not dist.is_initialized()


def test_engine_cache_never_crosses_process_groups():
    """A process mesh keys the strategy engine by identity: the same mesh
    finds its engine, a mesh of the next process group builds its own."""
    from repro_torch.obs import metrics
    state = scenarios.make("plummer", 32, seed=3, device="cpu")
    engines = []
    with metrics.use() as reg:
        for _ in range(2):
            with process_mesh.single_rank_group("gloo", "cpu", timeout=30):
                mesh = ProcessMesh("gloo", device="cpu")
                for _ in range(2):
                    ens.strategy_run_block(state, t_end=1 / 64, n_events=2,
                                           strategy="replicated", mesh=mesh)
                engines.append(ens._strategy_block_engine(
                    "replicated", mesh, 2, 6, 1e-7, 0.02, 0.0625, 8,
                    "none", strategies.nbody_force.DEFAULT_BLOCK_I,
                    strategies.nbody_force.DEFAULT_BLOCK_J, "fp32", "full",
                    "overlap"))
                assert mesh.reshape((1,), ("batch",)) is \
                    mesh.reshape((1,), ("batch",))
        builds = reg.snapshot()["counters"][
            "engine.cache_miss.block_strategy"]["value"]
    assert engines[0] is not engines[1] and builds == 2
    with pytest.raises(ValueError, match="not both"):
        ens.strategy_run_block(state, t_end=1 / 64, mesh=object(),
                               devices=["cpu"])


def _stalled_rank(device, seconds):
    """Rank 1 never joins rank 0's collective."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(seconds)


def test_a_collective_nobody_joins_fails_at_the_spawn_timeout():
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        process_mesh.spawn(_stalled_rank, 2, "gloo", "cpu", 60.0, timeout=3)
    assert time.perf_counter() - t0 < 45
