"""Port parity: ensembles sharded over devices and the fused ``(batch,
dev)`` mesh (``repro_torch.sim.ensemble``'s batch layouts) against
``repro.sim.ensemble``'s, through the engines, the API, the CLI and the
server.

The port's slots are the CPU named once per slot (``["cpu"] * k``), as the
reference runs on XLA's placeholder host devices.  The JAX runs need the
forced host device count before JAX starts, so they run once, in a
subprocess with four host devices, on the same seeded initial states
(equal bit for bit, ``test_torch_scenarios.py``).  Held to:

* the port's own one-slot run, bit for bit: every state leaf and every
  carry counter (members are independent, and the block engine shares its
  capacity buckets over the whole batch, as the reference's vmap does);
* the JAX package's 2- and 4-device runs: events, pairs, tiles and bucket
  hits exactly, trajectories within ``TOL`` (lockstep) and ``BLOCK_TOL``
  (block) of ``tests/test_golden_trajectories.py``, fp32;
* the committed ``plummer_block_fused_2x2.json`` and the JAX package's
  live fused run: events and tiles exactly, pos/vel within ``BLOCK_TOL``;
  and the port's fused run equals its 1-D batch run and each member's solo
  ``mesh_sharded`` run bit for bit.  The port's plain kernels sum each
  target row in the same order whatever launch extent it sits in, so on
  the CPU all three are bitwise, as on the card (XLA's CPU reduction is
  not, which is why the reference pins only fused == solo);
* the API's reports (counts and ``sim.*`` metrics) and the server's retire
  order and reports, field by field against the JAX package's.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.sim import api as japi
from repro_torch.launch import sim_run
from repro_torch.serve import sim_engine
from repro_torch.sim import api
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios
from repro_torch.sim.scenarios import ScenarioSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "plummer_block_fused_2x2.json")
#: tests/test_golden_trajectories.py TOL and BLOCK_TOL, fp32
TOL = 1e-7
BLOCK_TOL = (1e-6, 1e-5)
FIELDS = ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot", "time")
CARRY = ("t_last", "levels", "dt_macro", "n_pairs", "n_events", "n_tiles",
         "bucket_hits")
#: the padded mixed batch of the block cases (B = 3: padded to 4 on both
#: meshes)
MIX = [("plummer", 24), ("king", 32), ("plummer", 40)]
LOCKSTEP_N = 32
BLOCK_KW = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=4, block_i=8,
                block_j=16)
NBR_KW = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=4, block_i=8,
              block_j=8, sources="neighbor", neighbor_radius=0.5)
#: (name, block kwargs): both compactions x both bucket modes, and the
#: neighbor scheme
BLOCK_CASES = [(f"{c} {m}", dict(BLOCK_KW, compaction=c, bucket_mode=m))
               for c in ("none", "gather") for m in ("member", "shared")] \
    + [("neighbor", NBR_KW)]
#: (stepper, slots, batch size): B = 3 over 2 slots pads by repeating
#: member 0
LOCKSTEP_CASES = [(s, k, b) for s in ("fixed", "adaptive")
                  for k, b in ((2, 3), (2, 4), (4, 4))]
#: tests/test_fused_mesh.py's SimConfig and its gather variant, and
#: ensembles over two devices
API_CASES = {
    "fused": dict(scenario="plummer", n=32, t_end=0.02, stepper="block",
                  dt=None, dt_max=0.0625, n_levels=2, impl="xla", ensemble=2,
                  devices=4, mesh=(2, 2), validate_ic=False),
    "fused_gather": dict(scenario="plummer", n=32, t_end=0.02,
                         stepper="block", dt=None, dt_max=0.0625, n_levels=2,
                         impl="xla", ensemble=2, devices=4, mesh=(2, 2),
                         compaction="gather", block_i=8, block_j=16,
                         validate_ic=False),
    "fixed_devices2": dict(scenario="plummer", n=16, t_end=0.02,
                           dt=1 / 256, ensemble=3, devices=2, diag_every=4,
                           impl="xla", validate_ic=False),
    "block_devices2": dict(scenario="plummer", n=24, t_end=0.02,
                           stepper="block", dt_max=0.0625, n_levels=3,
                           ensemble=3, devices=2, compaction="gather",
                           block_i=8, block_j=16, diag_every=4, impl="xla",
                           validate_ic=False),
}
SERVE_CFG = dict(slots_per_pod=2, n_max=256, chunk_events=8, dt_max=0.0625,
                 n_levels=4, devices=4, mesh=(2, 2), sources="neighbor",
                 neighbor_radius=0.5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_4DEV = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.serve import ServerConfig, SimRequest, SimServer
    from repro.sim import api, ensemble as ens, scenarios
    from repro.sim.scenarios import ScenarioSpec

    cfg = json.loads(sys.argv[2])
    devs = jax.devices()
    assert len(devs) == 4
    arrays, doc = {}, {}

    def keep(tag, state, carry=None):
        for f in ("pos", "vel"):
            arrays[f"{tag}.{f}"] = np.asarray(getattr(state, f))
        if carry is not None:
            doc[tag] = {k: np.asarray(getattr(carry, k)).tolist()
                        for k in ("n_events", "n_pairs", "n_tiles",
                                  "bucket_hits")}

    def plummers(b, n):
        return ens.stack_states([scenarios.make("plummer", n, seed=s)
                                 for s in range(b)])

    for stepper, k, b in cfg["lockstep"]:
        batched = plummers(b, cfg["lockstep_n"])
        if stepper == "fixed":
            out = ens.evolve_ensemble(batched, n_steps=4, dt=1e-2,
                                      impl="xla", devices=devs[:k])
            keep(f"{stepper} {k} {b}", out)
        else:
            init = ens.ensemble_initialize(batched, impl="xla",
                                           devices=devs[:k])
            out, h, taken = ens.ensemble_run_adaptive(
                init, t_end=0.05, n_steps=12, impl="xla", devices=devs[:k])
            keep(f"{stepper} {k} {b}", out)
            doc[f"{stepper} {k} {b}"] = {
                "n_taken": np.asarray(taken).tolist()}

    specs = scenarios.make_mix([tuple(m) for m in cfg["mix"]], seed=0)
    batched, na = scenarios.build_padded(specs)
    for name, kw in cfg["block"]:
        for k in (2, 4):
            out, carry = ens.evolve_ensemble_block(
                batched, n_active=na, impl="xla", devices=devs[:k], **kw)
            keep(f"{name} {k}", out, carry)

    golden = json.load(open(sys.argv[3]))
    m = golden["meta"]
    states = [scenarios.make(m["scenario"], m["n"], seed=m["seed"] + i)
              for i in range(m["ensemble"])]
    out, carry = ens.evolve_ensemble_block(
        states, mesh=tuple(m["mesh"]), devices=devs[:m["devices"]],
        t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
        eta=m["eta"], order=m["order"], eps=m["eps"], impl=m["impl"],
        compaction=m["compaction"])
    keep("fused", out, carry)

    reports = {}
    for name, kw in cfg["api"].items():
        kw = dict(kw)
        if kw.get("mesh") is not None:
            kw["mesh"] = tuple(kw["mesh"])
        reports[name] = api.run(api.SimConfig(**kw))
    doc["api"] = json.loads(json.dumps(reports, default=float))

    server = SimServer(ServerConfig(impl="xla", **{
        k: tuple(v) if k == "mesh" else v for k, v in cfg["serve"].items()}))
    server.warmup([SimRequest(spec=ScenarioSpec.parse("plummer:256"),
                              stepper="block", t_end=0.0625)])
    for seed in (1, 2):
        server.submit(SimRequest(
            spec=ScenarioSpec.parse("plummer:256", seed=seed),
            stepper="block", t_end=0.0625))
    doc["serve"] = json.loads(json.dumps(server.run_until_drained(),
                                         default=float))
    np.savez(sys.argv[1] + ".npz", **arrays)
    with open(sys.argv[1] + ".json", "w") as f:
        json.dump(doc, f)
""")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's runs at four forced host devices: ``(arrays,
    doc)``, arrays by ``"<case>.<field>"``, counts and reports in doc."""
    path = str(tmp_path_factory.mktemp("jax4") / "layouts")
    cfg = {"lockstep": LOCKSTEP_CASES, "lockstep_n": LOCKSTEP_N, "mix": MIX,
           "block": BLOCK_CASES, "api": API_CASES, "serve": SERVE_CFG}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    res = subprocess.run([sys.executable, "-c", _JAX_4DEV, path,
                          json.dumps(cfg), GOLDEN], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    with open(path + ".json") as f:
        doc = json.load(f)
    return dict(np.load(path + ".npz")), doc


def _same_state(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _same_carry(a, b):
    for f in CARRY:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.nbr is None) == (b.nbr is None)
    if a.nbr is not None:
        for x, y in zip(a.nbr, b.nbr):
            assert torch.equal(x, y)


def _close(state, arrays, tag, tol):
    for f, t in zip(("pos", "vel"), tol):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   arrays[f"{tag}.{f}"], rtol=0, atol=t,
                                   err_msg=f"{tag} {f}")


# --------------------------------------------------------------------------
# the 1-D batch layout: fixed dt and adaptive
# --------------------------------------------------------------------------
def _plummers(b, n=LOCKSTEP_N):
    return ens.stack_states([scenarios.make("plummer", n, seed=s,
                                            device="cpu") for s in range(b)])


def _lockstep(stepper, devices, b):
    batched = _plummers(b)
    if stepper == "fixed":
        return ens.evolve_ensemble(batched, n_steps=4, dt=1e-2,
                                   devices=devices), None
    init = ens.ensemble_initialize(batched, devices=devices)
    out, _, taken = ens.ensemble_run_adaptive(init, t_end=0.05, n_steps=12,
                                              devices=devices)
    return out, taken


@pytest.fixture(scope="module")
def lockstep_runs():
    out = {}
    for stepper, k, b in LOCKSTEP_CASES:
        out[(stepper, k, b)] = _lockstep(stepper, ["cpu"] * k, b)
        out[(stepper, 1, b)] = _lockstep(stepper, None, b)
    return out


@pytest.mark.parametrize("stepper,k,b", LOCKSTEP_CASES)
def test_lockstep_over_slots_is_the_one_slot_run(lockstep_runs, stepper, k,
                                                 b):
    (got, taken), (one, taken1) = lockstep_runs[(stepper, k, b)], \
        lockstep_runs[(stepper, 1, b)]
    assert got.pos.shape[0] == b
    _same_state(got, one)
    if taken is not None:
        assert torch.equal(taken, taken1)


@pytest.mark.parametrize("stepper,k,b", LOCKSTEP_CASES)
def test_lockstep_over_slots_matches_the_jax_devices(lockstep_runs, jax_runs,
                                                     stepper, k, b):
    arrays, doc = jax_runs
    got, taken = lockstep_runs[(stepper, k, b)]
    _close(got, arrays, f"{stepper} {k} {b}", (TOL, TOL))
    if taken is not None:
        assert taken.tolist() == doc[f"{stepper} {k} {b}"]["n_taken"]


# --------------------------------------------------------------------------
# the 1-D batch layout: the block engine
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block_runs():
    specs = scenarios.make_mix(MIX, seed=0)
    batched, na = scenarios.build_padded(specs, device="cpu")
    out = {}
    for name, kw in BLOCK_CASES:
        for k in (1, 2, 4):
            ens.ensemble_run_block.host_syncs = 0
            res = ens.evolve_ensemble_block(
                batched, n_active=na, devices=["cpu"] * k, **kw)
            out[(name, k)] = res + (ens.ensemble_run_block.host_syncs,)
    return out


@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("name", [c for c, _ in BLOCK_CASES])
def test_block_over_slots_is_the_one_slot_run(block_runs, name, k):
    """Every leaf and counter, and the host reads: one per event over the
    whole batch, however many slots launch."""
    got, carry, reads = block_runs[(name, k)]
    one, carry1, reads1 = block_runs[(name, 1)]
    _same_state(got, one)
    _same_carry(carry, carry1)
    assert reads == reads1


@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("name", [c for c, _ in BLOCK_CASES])
def test_block_over_slots_matches_the_jax_devices(block_runs, jax_runs,
                                                  name, k):
    arrays, doc = jax_runs
    got, carry, _ = block_runs[(name, k)]
    want = doc[f"{name} {k}"]
    assert carry.n_events.tolist() == want["n_events"]
    assert carry.n_pairs.tolist() == want["n_pairs"]
    assert carry.n_tiles.tolist() == want["n_tiles"]
    assert carry.bucket_hits.tolist() == want["bucket_hits"]
    _close(got, arrays, f"{name} {k}", BLOCK_TOL)


def test_groups_share_their_capacity_across_slots(block_runs):
    """The trap the batch layout must not fall into: a member-mode bucket
    group spread over several slots keeps ONE capacity per event (the
    reference vmaps the whole padded batch), so members 0 and 1, one group
    on two slots, hit the same buckets event for event, while member 2,
    its own group, does not."""
    _, carry, _ = block_runs[("gather member", 4)]
    hits = carry.bucket_hits
    assert torch.equal(hits[0], hits[1])
    assert not torch.equal(hits[0], hits[2])


def test_batch_layouts_refuse_what_does_not_tile():
    state = scenarios.make("plummer", 16, device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices; got 3"):
        ens.evolve_ensemble_block([state], t_end=0.01, mesh=(2, 2),
                                  devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="extents must be >= 1"):
        ens.evolve_ensemble_block([state], t_end=0.01, mesh=(0, 2),
                                  devices=["cpu"] * 4)
    from repro_torch.core import strategies
    fused = strategies.make_fused_block_evaluator((2, 1),
                                                  devices=["cpu"] * 2)
    b = ens.stack_states([state] * 3)
    mask = torch.ones(b.pos.shape[:2], dtype=torch.bool)
    with pytest.raises(ValueError, match="not divisible by the mesh's "
                                         "batch extent 2"):
        fused(b.pos, b.vel, b.acc, b.mass, mask)


# --------------------------------------------------------------------------
# the fused mesh
# --------------------------------------------------------------------------
def _golden():
    with open(GOLDEN) as f:
        doc = json.load(f)
    m = doc["meta"]
    kw = dict(t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
              eta=m["eta"], order=m["order"], eps=m["eps"],
              compaction=m["compaction"])
    states = [scenarios.make(m["scenario"], m["n"], seed=m["seed"] + i,
                             device="cpu") for i in range(m["ensemble"])]
    return doc, kw, states


@pytest.fixture(scope="module")
def fused_runs():
    doc, kw, states = _golden()
    m = doc["meta"]
    p = m["mesh"][1]
    fused = ens.evolve_ensemble_block(states, mesh=tuple(m["mesh"]),
                                      devices=["cpu"] * m["devices"], **kw)
    one_d = ens.evolve_ensemble_block(states, devices=["cpu"] * len(states),
                                      **kw)
    solo = [ens.evolve_strategy_block(st, strategy="mesh_sharded",
                                      devices=["cpu"] * p, **kw)
            for st in states]
    return {"fused": fused, "1d": one_d, "solo": solo}


def test_fused_reproduces_the_golden(fused_runs):
    doc, _, _ = _golden()
    out, carry = fused_runs["fused"]
    assert carry.n_events.tolist() == doc["n_events"]
    assert carry.n_tiles.tolist() == doc["n_tiles"]
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(doc["pos"]),
                               rtol=0, atol=BLOCK_TOL[0])
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(doc["vel"]),
                               rtol=0, atol=BLOCK_TOL[1])


def test_fused_matches_the_jax_fused_run(fused_runs, jax_runs):
    arrays, doc = jax_runs
    out, carry = fused_runs["fused"]
    assert carry.n_events.tolist() == doc["fused"]["n_events"]
    assert carry.n_tiles.tolist() == doc["fused"]["n_tiles"]
    assert carry.n_pairs.tolist() == doc["fused"]["n_pairs"]
    _close(out, arrays, "fused", BLOCK_TOL)


def test_fused_is_the_1d_batch_run_bitwise(fused_runs):
    """The same bits and events; the fused engine counts its shards' tiles
    (each slot's cap from its own bound) and reports no bucket hits."""
    (out, carry), (one, c1) = fused_runs["fused"], fused_runs["1d"]
    _same_state(out, one)
    assert torch.equal(carry.n_events, c1.n_events)
    assert torch.equal(carry.n_pairs, c1.n_pairs)
    assert not carry.bucket_hits.any()


@pytest.mark.parametrize("member", (0, 1))
def test_fused_member_is_its_solo_mesh_sharded_run(fused_runs, member):
    """Bit for bit, and the member's tiles are the sum of its solo run's
    per-shard tiles where the two shards' bounds agree with the fused
    slots' (one member per slot here: the caps are the solo run's)."""
    out, carry = fused_runs["fused"]
    solo, cs = fused_runs["solo"][member]
    for f in FIELDS:
        assert torch.equal(getattr(out, f)[member], getattr(solo, f)), f
    assert int(carry.n_events[member]) == int(cs.n_events)
    assert float(carry.n_tiles[member]) == float(cs.n_tiles.sum())
    assert float(carry.n_pairs[member]) == float(cs.n_pairs)


def test_fused_engine_reads_once_per_event_and_builds_once():
    """One host read of ``B*p + 1`` counts per gather event, the engine
    built once and counted under ``block_fused``; B = 3 pads to the batch
    extent and slices back."""
    from repro_torch.obs import metrics
    _, kw, states = _golden()
    states = states + [scenarios.make("plummer", 64, seed=9, device="cpu")]
    batched = ens.ensemble_initialize(ens.stack_states(states[:3]))
    ens._block_engine.cache_clear()
    with metrics.use() as reg:
        ens.ensemble_run_block.host_syncs = 0
        run_kw = {k: v for k, v in kw.items() if k != "t_end"}
        out, carry = ens.ensemble_run_block(
            batched, t_end=kw["t_end"], n_events=6, mesh=(2, 2),
            devices=["cpu"] * 4, **run_kw)
        reads = ens.ensemble_run_block.host_syncs
        out2, carry2 = ens.ensemble_run_block(
            out, t_end=kw["t_end"], n_events=2, carry=carry, mesh=(2, 2),
            devices=["cpu"] * 4, **run_kw)
        counters = reg.snapshot()["counters"]
    assert counters["engine.cache_miss.block_fused"]["value"] == 1.0
    assert out.pos.shape[0] == 3 and carry.n_events.tolist() == [6] * 3
    assert reads == 6
    one, c1 = ens.ensemble_run_block(batched, t_end=kw["t_end"], n_events=8,
                                     devices=["cpu"] * 2, **run_kw)
    _same_state(out2, one)
    assert torch.equal(carry2.n_events, c1.n_events)


@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)))
def test_fused_neighbor_is_the_unsharded_neighbor_run(mesh):
    """Neighbor sources under a mesh: each member's target blocks split
    over its row's slots (a slot may get none), window buckets shared over
    the batch; the bits and every counter are the unsharded run's."""
    states = [scenarios.make("plummer", 40, seed=1 + i, device="cpu")
              for i in range(3)]
    want, cw = ens.evolve_ensemble_block(states, **NBR_KW)
    got, cg = ens.evolve_ensemble_block(states, mesh=mesh,
                                        devices=["cpu"] * 4, **NBR_KW)
    _same_state(got, want)
    _same_carry(cg, cw)


# --------------------------------------------------------------------------
# the API, the CLI and the server
# --------------------------------------------------------------------------
def _port_cfg(kw):
    return api.SimConfig(device="cpu", **kw)


@pytest.fixture(scope="module")
def api_reports():
    return {name: api.run(_port_cfg(kw)) for name, kw in API_CASES.items()}


@pytest.mark.parametrize("name", API_CASES)
def test_api_reports_equal_the_references(api_reports, jax_runs, name):
    want, got = jax_runs[1]["api"][name], api_reports[name]
    assert set(got) - {"metrics", "snapshots", "step_wall_s"} \
        == set(want) - {"metrics", "snapshots", "step_wall_s"}
    for k in ("steps", "force_evals", "force_evals_total", "grid_tiles",
              "grid_tiles_total", "devices", "ensemble", "n_bodies",
              "mesh", "stepper", "compaction"):
        assert got.get(k) == want.get(k), k
    for a, b in zip(want["runs"], got["runs"]):
        for k in ("steps", "force_evals", "grid_tiles", "seed"):
            assert a.get(k) == b.get(k), k
        assert abs(a["de_rel"] - b["de_rel"]) <= 1e-6
    for section in ("counters", "gauges", "histograms"):
        assert ({k: v for k, v in got["metrics"][section].items()
                 if k.startswith("sim.")}
                == {k: v for k, v in want["metrics"][section].items()
                    if k.startswith("sim.")}), section


@pytest.mark.parametrize("kw,match", [
    (dict(devices=3), "tile the device list exactly"),
    (dict(mesh=(4,)), "two positive extents"),
    (dict(strategy="mesh_sharded", ensemble=1), "shard the same axis twice"),
    (dict(bucket_mode="shared", compaction="gather"), "bucket"),
    (dict(stepper="adaptive", n_levels=None), "no domain-sharded force"),
])
def test_mesh_configs_raise_as_the_reference(kw, match):
    """``tests/test_fused_mesh.py``'s validation cases: the same error, the
    same message."""
    base = dict(API_CASES["fused"], **kw)
    errors = []
    for mod in (japi, api):
        cfg = mod.SimConfig(**base)
        with pytest.raises(ValueError, match=match) as info:
            mod.resolve_kind(cfg)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_cli_runs_the_fused_mesh(api_reports, tmp_path):
    """``sim_run --ensemble 2 --devices 4 --mesh 2x2 --stepper block`` exits
    0 and writes the fused report: the API's counts for that config."""
    out = str(tmp_path / "r.json")
    kw = API_CASES["fused"]
    assert sim_run.main([
        "--device", "cpu", "--ensemble", "2", "--devices", "4", "--mesh",
        "2x2", "--stepper", "block", "--scenario", "plummer", "--n",
        str(kw["n"]), "--t-end", str(kw["t_end"]), "--levels",
        str(kw["n_levels"]), "--no-validate", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    want = api_reports["fused"]
    assert report["mesh"] == [2, 2] and report["devices"] == 4
    for k in ("steps", "force_evals_total", "grid_tiles_total", "e1"):
        assert report[k] == want[k], k


def _serve(**kw):
    """The SERVE-MESH recipe: a warmed server, two neighbor members."""
    server = sim_engine.SimServer(sim_engine.ServerConfig(
        device="cpu", **dict(SERVE_CFG, **kw)))
    spent = server.warmup([sim_engine.SimRequest(
        spec=ScenarioSpec.parse("plummer:256"), stepper="block",
        t_end=0.0625)])
    base = server.cache_misses()
    for seed in (1, 2):
        server.submit(sim_engine.SimRequest(
            spec=ScenarioSpec.parse("plummer:256", seed=seed),
            stepper="block", t_end=0.0625))
    return server, spent, base


def _rows(server):
    (pod,) = server.pods.values()
    return {f: getattr(pod.batched, f) for f in FIELDS}


@pytest.fixture(scope="module")
def served():
    server, spent, base = _serve()
    return server, spent, base, server.run_until_drained()


def test_server_mesh_builds_nothing_after_warmup(served):
    server, spent, base, reports = served
    assert spent > 0
    assert server.cache_misses() == base
    assert len(reports) == 2
    assert all(r["devices"] == 4 for r in reports)


def test_server_mesh_reports_equal_the_jax_servers(served, jax_runs):
    _, _, _, reports = served
    want = jax_runs[1]["serve"]
    assert [r["request_id"] for r in reports] \
        == [r["request_id"] for r in want]
    for a, b in zip(want, reports):
        for k in ("steps", "force_evals_total", "grid_tiles_total",
                  "neighbor_refreshes", "neighbor_overflows", "t_final",
                  "pod_cap", "scenario"):
            assert a[k] == b[k], k
        assert abs(a["de_rel"] - b["de_rel"]) <= 1e-6


def test_server_mesh_rows_equal_a_one_slot_server(served, tmp_path):
    """The mesh pod's final rows are a ``devices=1`` server's bit for bit,
    and a server suspended under the mesh after one tick and resumed ends
    on the same bits."""
    server = served[0]
    one, _, _ = _serve(devices=1, mesh=None)
    one.run_until_drained()
    paused, _, _ = _serve()
    paused.step()
    paused.suspend(str(tmp_path), step=1)
    resumed = sim_engine.SimServer.resume(str(tmp_path))
    assert resumed.cfg.mesh == [2, 2] or tuple(resumed.cfg.mesh) == (2, 2)
    resumed.run_until_drained()
    want = _rows(server)
    for other in (one, resumed):
        got = _rows(other)
        for f in FIELDS:
            assert torch.equal(got[f], want[f]), f
