"""Port parity: the strategy block evaluators (shard-local compaction) of
``repro_torch.core.strategies`` and the single-run strategy engine
``repro_torch.sim.ensemble.evolve_strategy_block``, at two CPU slots.

Held against:

* the committed ``binary_plummer_block_2dev.json`` (the 2-device
  mesh_sharded gather run; the recipe replayed under every strategy, both
  compactions and both ring modes): the event count exact, positions and
  velocities within ``BLOCK_TOL`` fp32 (1e-6, 1e-5);
* itself: ``compaction="gather"`` gives the ``"none"`` run's bits in every
  strategy and ring mode, and the ring's overlap gives sync's bits;
* the JAX package's counts: its 2-device ``evolve_strategy_block`` runs
  live in a subprocess with two forced host devices, and the port's events,
  pairs and per-shard tiles equal its.  Its trajectories are not compared
  there: the reference's 2-device differentials fail in this container
  (ROADMAP.md queue 3 C), so the trajectories are held to the golden.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import hermite, strategies
from repro_torch.core.evaluate import make_evaluator
from repro_torch.kernels import ops
from repro_torch.obs import metrics
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "binary_plummer_block_2dev.json")
#: tests/test_golden_trajectories.py BLOCK_TOL fp32 (pos, vel)
BLOCK_TOL = (1e-6, 1e-5)
FIELDS = ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot", "time")
SLOTS = ["cpu"] * 2
#: (strategy, ring mode) pairs: every strategy, the ring in both modes
MODES = [(s, "overlap") for s in strategies.STRATEGIES] + [("ring", "sync")]


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    with open(GOLDEN) as f:
        doc = json.load(f)
    m = doc["meta"]
    kw = dict(t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
              eta=m["eta"], order=m["order"], eps=m["eps"],
              block_i=m["block_i"], block_j=m["block_j"])
    state = scenarios.make(m["scenario"], m["n"], seed=m["seed"],
                           device="cpu")
    return doc, kw, state


@pytest.fixture(scope="module")
def runs():
    """The golden recipe through every strategy, ring mode and compaction
    at two CPU slots."""
    doc, kw, state = _golden()
    out = {}
    for strategy, mode in MODES:
        for compaction in strategies.COMPACTIONS:
            out[(strategy, mode, compaction)] = ens.evolve_strategy_block(
                state, strategy=strategy, compaction=compaction,
                ring_mode=mode, devices=SLOTS, **kw)
    return out


@pytest.mark.parametrize("compaction", strategies.COMPACTIONS)
@pytest.mark.parametrize("strategy,mode", MODES)
def test_strategy_block_golden_replays(runs, strategy, mode, compaction):
    doc, _, _ = _golden()
    out, carry = runs[(strategy, mode, compaction)]
    assert int(carry.n_events) == doc["n_events"]
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(doc["pos"]),
                               rtol=0, atol=BLOCK_TOL[0])
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(doc["vel"]),
                               rtol=0, atol=BLOCK_TOL[1])
    assert float(out.time) == doc["meta"]["t_end"]


@pytest.mark.parametrize("strategy,mode", MODES)
def test_gather_bitwise_equals_none(runs, strategy, mode):
    (a, ca), (b, cb) = runs[(strategy, mode, "none")], \
        runs[(strategy, mode, "gather")]
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(ca.n_events) == int(cb.n_events)
    assert float(ca.n_pairs) == float(cb.n_pairs)
    assert (cb.n_tiles < ca.n_tiles).all()


@pytest.mark.parametrize("compaction", strategies.COMPACTIONS)
def test_ring_overlap_bitwise_equals_sync(runs, compaction):
    (a, ca), (b, cb) = runs[("ring", "overlap", compaction)], \
        runs[("ring", "sync", compaction)]
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ca.n_tiles, cb.n_tiles)


_JAX_2DEV = textwrap.dedent(r"""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.core.strategies import STRATEGIES
    from repro.sim import ensemble as ens, scenarios
    doc = json.load(open(sys.argv[1]))
    m = doc["meta"]
    state = scenarios.make(m["scenario"], m["n"], seed=m["seed"])
    out = {}
    for strategy in STRATEGIES:
        for compaction in ("none", "gather"):
            _, c = ens.evolve_strategy_block(
                state, strategy=strategy, impl="xla", compaction=compaction,
                t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
                eta=m["eta"], order=m["order"], eps=m["eps"],
                block_i=m["block_i"], block_j=m["block_j"], devices=2)
            out[f"{strategy} {compaction}"] = {
                "n_events": int(c.n_events), "n_pairs": float(c.n_pairs),
                "n_tiles": [float(t) for t in np.asarray(c.n_tiles)]}
    print("COUNTS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX package's 2-device strategy block counts (a subprocess: the
    host device count must be set before JAX starts)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    res = subprocess.run([sys.executable, "-c", _JAX_2DEV, GOLDEN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("COUNTS ")]
    return json.loads(line[0][len("COUNTS "):])


@pytest.mark.parametrize("compaction", strategies.COMPACTIONS)
@pytest.mark.parametrize("strategy", strategies.STRATEGIES)
def test_counts_equal_the_references(runs, jax_counts, strategy,
                                     compaction):
    """Events, measured pairs and the per-shard tiles of the (P,) carry
    equal the JAX package's at two devices."""
    _, carry = runs[(strategy, "overlap", compaction)]
    want = jax_counts[f"{strategy} {compaction}"]
    assert tuple(carry.n_tiles.shape) == (2,)
    assert int(carry.n_events) == want["n_events"]
    assert float(carry.n_pairs) == want["n_pairs"]
    assert carry.n_tiles.tolist() == want["n_tiles"]


@pytest.mark.parametrize("p", (1, 2, 4))
@pytest.mark.parametrize("n,block_i", [(24, 8), (256, 32), (4096, 256)])
def test_capacity_plan_shard_equals_the_references(n, block_i, p):
    """``CapacityPlan.shard`` is the plan each shard builds from its own
    extent, field for field the JAX package's."""
    ours = ops.CapacityPlan(n, n, block_i, 128).shard(p)
    theirs = jops.CapacityPlan(n, n, block_i, 128).shard(p)
    local = ops.CapacityPlan(n // p, n, block_i, 128)
    for plan in (ours, local):
        assert plan.n_targets == theirs.n_targets == n // p
        assert plan.caps == theirs.caps == ops.capacity_buckets(n // p,
                                                                block_i)
        assert plan.tiles_by_cap == theirs.tiles_by_cap
        assert plan.dense_tiles == theirs.dense_tiles
    with pytest.raises(ValueError, match="do not split"):
        ops.CapacityPlan(n + 1, n, block_i, 128).shard(2)


def _event_inputs(n=40, seed=2, frac=0.4):
    """An initialized Plummer state and a random mask, uneven over the
    shards (the first half of the rows twice as active)."""
    state = scenarios.make("plummer", n, seed=seed, device="cpu")
    state = hermite.initialize(state, make_evaluator())
    rng = np.random.default_rng(seed)
    p_act = np.where(np.arange(n) < n // 2, 2 * frac, frac / 2)
    mask = torch.tensor(rng.uniform(size=n) < p_act)
    ap = state.acc + 0.01 * torch.tensor(rng.standard_normal((n, 3)))
    return state, mask, ap


@pytest.mark.parametrize("strategy,mode", MODES)
def test_block_evaluator_gather_equals_none_and_bound_equals_measure(
        strategy, mode):
    """One event's masked evaluation: gather gives none's bits, a host
    bound gives the measured bound's bits and tiles, and the masked rows
    are exactly zero; N = 40 over p = 4 leaves one shard's rows partly
    padding."""
    state, mask, ap = _event_inputs()
    args = (state.pos, state.vel, ap, state.mass, mask)
    kw = dict(devices=["cpu"] * 4, block_i=4, block_j=16, ring_mode=mode)
    none = strategies.make_strategy_block_evaluator(strategy, **kw)
    gather = strategies.make_strategy_block_evaluator(
        strategy, compaction="gather", **kw)
    ev_n, t_n = none(*args)
    ev_g, t_g = gather(*args)
    bound = mask.reshape(4, -1).sum(dim=1)
    ev_b, t_b = gather(*args, n_bound=bound.tolist())
    for f in ("acc", "jerk", "snap", "pot"):
        assert torch.equal(getattr(ev_n, f), getattr(ev_g, f)), f
        assert torch.equal(getattr(ev_g, f), getattr(ev_b, f)), f
        assert not getattr(ev_g, f)[~mask].any(), f
    assert torch.equal(t_g, t_b)
    assert (t_g <= t_n).all() and (t_g < t_n).any()
    # an over-wide bound lands on the full window, never out of range
    ev_w, t_w = gather(*args, n_bound=[10 ** 6] * 4)
    assert torch.equal(ev_w.acc, ev_n.acc) and torch.equal(t_w, t_n)


@pytest.mark.parametrize("strategy", strategies.STRATEGIES)
def test_all_ones_mask_is_the_lockstep_evaluation(strategy):
    state, _, _ = _event_inputs()
    mask = torch.ones(state.pos.shape[0], dtype=torch.bool)
    kw = dict(devices=SLOTS, block_i=8, block_j=16)
    ev, tiles = strategies.make_strategy_block_evaluator(strategy, **kw)(
        state.pos, state.vel, torch.zeros_like(state.pos), state.mass, mask)
    want = strategies.make_strategy_evaluator(strategy, **kw)(
        state.pos, state.vel, state.mass)
    for f in ("acc", "jerk", "snap", "pot"):
        assert torch.equal(getattr(ev, f), getattr(want, f)), f
    assert tiles.dtype == torch.int64 and tuple(tiles.shape) == (2,)


def test_block_evaluator_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="full sources only"):
        strategies.make_strategy_block_evaluator(
            "ring", devices=SLOTS, sources="neighbor")
    with pytest.raises(ValueError, match="sources must be"):
        strategies.make_strategy_block_evaluator(
            "ring", devices=SLOTS, sources="near")
    with pytest.raises(ValueError, match="compaction must be"):
        strategies.make_strategy_block_evaluator(
            "ring", devices=SLOTS, compaction="scatter")
    with pytest.raises(ValueError, match="fp64"):
        strategies.make_strategy_block_evaluator(
            "replicated", devices=SLOTS, dtype="fp64")
    state, mask, ap = _event_inputs()
    ev = strategies.make_strategy_block_evaluator(
        "replicated", devices=SLOTS, compaction="gather")
    with pytest.raises(ValueError, match="n_bound has 3 entries"):
        ev(state.pos, state.vel, ap, state.mass, mask, n_bound=[1, 2, 3])


# --------------------------------------------------------------------------
# the single-run strategy engine
# --------------------------------------------------------------------------
def _init(kw, state):
    ev = strategies.make_strategy_evaluator(
        "mesh_sharded", devices=SLOTS, block_i=kw["block_i"],
        block_j=kw["block_j"])
    return hermite.initialize(state, ev)


@pytest.mark.parametrize("compaction,per_event", [("none", 0),
                                                  ("gather", 1)])
def test_engine_host_reads_and_carry(compaction, per_event):
    """Gather reads the shards' bounds and the live flag in one copy per
    event; none reads nothing.  The carry is unbatched with (P,) tiles and
    no bucket distribution."""
    doc, kw, state = _golden()
    init = _init(kw, state)
    run_kw = {k: kw[k] for k in kw if k != "t_end"}
    before = ens.ensemble_run_block.host_syncs
    _, carry = ens.strategy_run_block(
        init, t_end=kw["t_end"], n_events=10, strategy="mesh_sharded",
        compaction=compaction, devices=SLOTS, **run_kw)
    assert ens.ensemble_run_block.host_syncs - before == 10 * per_event
    assert int(carry.n_events) == 10
    assert carry.levels.shape == (state.pos.shape[0],)
    assert tuple(carry.n_tiles.shape) == (2,)
    assert carry.bucket_hits.shape == (0,)
    assert carry.n_pairs.dtype == torch.float64


def test_engine_chunks_equal_one_chunk_and_build_once():
    """Chunks of 5 events give one 64-event chunk's bits; the engine is
    built once per key and counted under ``block_strategy``."""
    doc, kw, state = _golden()
    init = _init(kw, state)
    run_kw = {k: kw[k] for k in kw if k != "t_end"}
    ens._strategy_block_engine.cache_clear()
    with metrics.use() as reg:
        s, c = init, None
        for _ in range(8):
            s, c = ens.strategy_run_block(
                s, t_end=kw["t_end"], n_events=5, carry=c,
                strategy="mesh_sharded", compaction="gather", devices=SLOTS,
                **run_kw)
        one, c1 = ens.strategy_run_block(
            init, t_end=kw["t_end"], n_events=64, strategy="mesh_sharded",
            compaction="gather", devices=SLOTS, **run_kw)
        counters = reg.snapshot()["counters"]
    assert counters["engine.cache_miss.block_strategy"]["value"] == 1.0
    assert int(c.n_events) == int(c1.n_events) == doc["n_events"]
    for f in FIELDS:
        assert torch.equal(getattr(s, f), getattr(one, f)), f
    assert torch.equal(c.n_tiles, c1.n_tiles)


def test_engine_takes_a_device_count():
    """An int count is resolved for the state's device: two CPU slots."""
    doc, kw, state = _golden()
    a, ca = ens.evolve_strategy_block(state, strategy="replicated",
                                      devices=2, **kw)
    b, cb = ens.evolve_strategy_block(state, strategy="replicated",
                                      devices=SLOTS, **kw)
    assert torch.equal(a.pos, b.pos) and torch.equal(ca.n_tiles, cb.n_tiles)
    with pytest.raises(ValueError, match="n_levels"):
        ens.strategy_run_block(state, t_end=0.1, n_levels=0, devices=SLOTS)
