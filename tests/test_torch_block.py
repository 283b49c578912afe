"""Port parity: the block-timestep stepper of ``repro_torch.sim.ensemble``
with and without gather compaction.

Held against the committed golden ``binary_plummer_block.json`` (event
count exact, positions and velocities within ``BLOCK_TOL``), against the
live JAX ``evolve_ensemble_block(impl="xla")``, and against itself:
``compaction="gather"`` must give the ``"none"`` run's bits at every
precision with strictly fewer tiles, and the two bucket modes the same
bits.  The reference's own ``block_golden_gather_bitwise_equals_none``
fails in this container (ROADMAP.md queue 3 C), so the port is held to the
golden and to itself, not to that test.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.sim import ensemble as jens
from repro.sim import scenarios as jscenarios
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small tensor operations; with the default
    thread pool in each of several test workers, idle pool threads spin
    and starve the other workers, so each test here takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "binary_plummer_block.json")
#: tests/test_golden_trajectories.py BLOCK_TOL (pos, vel)
BLOCK_TOL = {"fp64": (1e-12, 1e-12), "fp32": (1e-6, 1e-5),
             "mixed": (1e-3, 2e-2)}
FIELDS = ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot", "time")


def _golden():
    with open(GOLDEN) as f:
        doc = json.load(f)
    m = doc["meta"]
    kw = dict(t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
              eta=m["eta"], order=m["order"], eps=m["eps"])
    return doc, m, kw


def _assert_bitwise(a, b, members=None):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if members is not None:
            x = x[members]
        assert torch.equal(x, y), name


@pytest.mark.parametrize("compaction", ("none", "gather"))
@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_block_golden_replays(dtype, compaction):
    """The level schedule is the golden's to the event, and the trajectory
    stays inside the block tier of its precision."""
    doc, m, kw = _golden()
    state = scenarios.make(m["scenario"], m["n"], seed=m["seed"],
                           device="cpu")
    out, carry = ens.evolve_ensemble_block([state], dtype=dtype,
                                           compaction=compaction, **kw)
    assert int(carry.n_events[0]) == doc["n_events"]
    tol_pos, tol_vel = BLOCK_TOL[dtype]
    np.testing.assert_allclose(out.pos[0].numpy(), np.asarray(doc["pos"]),
                               rtol=0, atol=tol_pos)
    np.testing.assert_allclose(out.vel[0].numpy(), np.asarray(doc["vel"]),
                               rtol=0, atol=tol_vel)
    assert float(out.time[0]) == m["t_end"]


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_gather_bitwise_equals_none(dtype):
    doc, m, kw = _golden()
    state = scenarios.make(m["scenario"], m["n"], seed=m["seed"],
                           device="cpu")
    kw.update(dtype=dtype, block_i=8, block_j=128)
    dense, c0 = ens.evolve_ensemble_block([state], compaction="none", **kw)
    packed, c1 = ens.evolve_ensemble_block([state], compaction="gather",
                                           **kw)
    _assert_bitwise(dense, packed)
    assert torch.equal(c0.n_events, c1.n_events)
    assert torch.equal(c0.n_pairs, c1.n_pairs)
    assert torch.equal(c0.levels, c1.levels)
    assert float(c1.n_tiles[0]) < float(c0.n_tiles[0])
    assert not c0.bucket_hits.any()
    assert float(c1.bucket_hits.sum()) == int(c1.n_events[0])


@pytest.mark.parametrize("compaction", ("none", "gather"))
def test_block_matches_jax(compaction):
    """The live JAX engine on the same initial state, fp32: the same event
    schedule, pairs and tiles, and the trajectory within the fp32 block
    tier."""
    doc, m, kw = _golden()
    kw.update(block_i=8, block_j=128, compaction=compaction)
    jout, jc = jens.evolve_ensemble_block(
        [jscenarios.make(m["scenario"], m["n"], seed=m["seed"])],
        impl="xla", **kw)
    out, c = ens.evolve_ensemble_block(
        [scenarios.make(m["scenario"], m["n"], seed=m["seed"],
                        device="cpu")], **kw)
    assert int(c.n_events[0]) == int(jc.n_events[0]) == doc["n_events"]
    assert float(c.n_pairs[0]) == float(jc.n_pairs[0])
    assert float(c.n_tiles[0]) == float(jc.n_tiles[0])
    np.testing.assert_array_equal(c.bucket_hits.numpy(),
                                  np.asarray(jc.bucket_hits))
    tol_pos, tol_vel = BLOCK_TOL["fp32"]
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=tol_pos)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=0, atol=tol_vel)


def _mixed_batch(n_max=None):
    specs = [scenarios.Scenario(name="binary_plummer", n=24, seed=1),
             scenarios.Scenario(name="plummer", n=16, seed=7),
             scenarios.Scenario(name="king", n=40, seed=2)]
    batched, n_active = scenarios.build_padded(specs, n_max=n_max,
                                               device="cpu")
    return specs, batched, n_active


KW = dict(t_end=0.03125, dt_max=1 / 64, n_levels=4, block_i=8, block_j=16)


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_bucket_modes_bitwise_equal(dtype):
    """Member groups (three ceilings: 24, 16 and 40 rows at block_i 8) and
    one shared group launch differently and compute the same bits, and
    both equal the masked dense run."""
    _, batched, n_active = _mixed_batch()
    assert len(ens._bucket_groups(40, n_active.tolist(), 8, 16, "gather",
                                  "member")) == 3
    runs = {mode: ens.evolve_ensemble_block(
        batched, n_active=n_active, compaction="gather", bucket_mode=mode,
        dtype=dtype, **KW) for mode in ens.BUCKET_MODES}
    dense = ens.evolve_ensemble_block(batched, n_active=n_active,
                                      compaction="none", dtype=dtype, **KW)
    (member, cm), (shared, cs) = runs["member"], runs["shared"]
    _assert_bitwise(member, shared)
    _assert_bitwise(member, dense[0])
    assert torch.equal(cm.n_events, cs.n_events)
    assert torch.equal(cm.n_pairs, cs.n_pairs)
    # a member's own ceiling never launches a wider bucket than a shared one
    assert (cm.n_tiles <= cs.n_tiles).all() and (cm.n_tiles < cs.n_tiles).any()
    assert (cs.n_tiles < dense[1].n_tiles).all()


@pytest.mark.parametrize("compaction", ("none", "gather"))
def test_members_are_independent(compaction):
    """Each member of a mixed padded batch follows its own schedule: it
    equals the same member alone in a B = 1 batch of the same width bit for
    bit, and its unpadded run to 1e-12 (fp64, as the reference's test)."""
    specs, batched, n_active = _mixed_batch()
    kw = dict(KW, dtype="fp64", compaction=compaction)
    out, carry = ens.evolve_ensemble_block(batched, n_active=n_active, **kw)
    for i, spec in enumerate(specs):
        solo_b, na = scenarios.build_padded([spec], n_max=40, device="cpu")
        solo, c_solo = ens.evolve_ensemble_block(solo_b, n_active=na, **kw)
        _assert_bitwise(out, solo, members=slice(i, i + 1))
        assert int(carry.n_events[i]) == int(c_solo.n_events[0])
        assert float(carry.n_tiles[i]) == float(c_solo.n_tiles[0])
        alone, c_alone = ens.evolve_ensemble_block(
            [spec.build(device="cpu")], **kw)
        n = spec.n
        assert int(c_alone.n_events[0]) == int(carry.n_events[i])
        assert float(c_alone.n_pairs[0]) == float(carry.n_pairs[i])
        np.testing.assert_allclose(out.pos[i, :n].numpy(),
                                   alone.pos[0].numpy(), rtol=0, atol=1e-12)
        for name in ("pos", "vel", "acc", "jerk", "snap", "pot"):
            assert not getattr(out, name)[i, n:].any(), (i, name)


def test_chunked_run_equals_one_chunk():
    """The carry goes on across calls: events in chunks of 5 give the bits
    of one long chunk, and a finished member freezes while a batch-mate
    with a later deadline goes on."""
    _, batched, n_active = _mixed_batch()
    kw = dict(KW, n_active=n_active, compaction="gather")
    one, c1 = ens.evolve_ensemble_block(batched, n_events=256, **kw)
    many, c5 = ens.evolve_ensemble_block(batched, n_events=5, **kw)
    _assert_bitwise(one, many)
    assert torch.equal(c1.n_events, c5.n_events)
    init = ens.ensemble_initialize(batched, n_active=n_active)
    t_end = torch.tensor([1 / 64, 1 / 32, 1 / 32], dtype=torch.float64)
    s, c = init, None
    for _ in range(20):
        s, c = ens.ensemble_run_block(
            s, t_end=t_end, n_events=16, carry=c, n_active=n_active,
            dt_max=KW["dt_max"], n_levels=4, block_i=8, block_j=16,
            compaction="gather")
    np.testing.assert_array_equal(s.time.numpy(), t_end.numpy())
    assert int(c.n_events[0]) < int(c1.n_events[0])


def test_initialized_batch_skips_only_the_bootstrap():
    """``initialized=True`` on a batch that ``ensemble_initialize``
    bootstrapped gives the one-shot run's bits and carry."""
    _, batched, n_active = _mixed_batch()
    kw = dict(KW, n_active=n_active, compaction="gather")
    one, c1 = ens.evolve_ensemble_block(batched, **kw)
    init = ens.ensemble_initialize(batched, n_active=n_active)
    two, c2 = ens.evolve_ensemble_block(init, initialized=True, **kw)
    _assert_bitwise(one, two)
    assert c1.nbr is None and c2.nbr is None   # full sources
    for f in c1._fields:
        if f != "nbr":
            assert torch.equal(getattr(c1, f), getattr(c2, f)), f


def test_single_level_block_equals_fixed_dt():
    """n_levels = 1: every particle is active at every event, so the block
    stepper is the fixed-dt lockstep engine bit for bit."""
    state = scenarios.make("plummer", 16, seed=0, device="cpu")
    blk, carry = ens.evolve_ensemble_block([state], t_end=0.125,
                                           dt_max=1 / 64, n_levels=1,
                                           dtype="fp64")
    fixed = ens.evolve_ensemble([state], n_steps=8, dt=1 / 64, dtype="fp64")
    np.testing.assert_allclose(blk.pos.numpy(), fixed.pos.numpy(), rtol=0,
                               atol=1e-15)
    assert int(carry.n_events[0]) == 8
    assert float(carry.n_pairs[0]) == 8 * 16 * 16


@pytest.mark.parametrize("compaction,per_event", [("none", 0),
                                                  ("gather", 1)])
def test_host_reads_per_event(compaction, per_event):
    """A gather event reads its bucket indices to the host once; a none
    event reads nothing (the only reads are per chunk)."""
    _, m, kw = _golden()
    state = scenarios.make(m["scenario"], m["n"], seed=m["seed"],
                           device="cpu")
    batched = ens.ensemble_initialize(ens.stack_states([state]))
    before = ens.ensemble_run_block.host_syncs
    _, carry = ens.ensemble_run_block(batched, n_events=20, block_i=8,
                                      block_j=128, compaction=compaction,
                                      bucket_mode="shared", **kw)
    assert int(carry.n_events[0]) == 20
    assert ens.ensemble_run_block.host_syncs - before == 20 * per_event


def test_block_refuses_what_is_not_ported():
    state = scenarios.make("plummer", 16, seed=0, device="cpu")
    with pytest.raises(ValueError, match="sources must be"):
        ens.evolve_ensemble_block([state], t_end=0.01, sources="near")
    # two slots (the batch padded to two by repeating its run) and the
    # fused 1x1 mesh give the unsharded run's bits; one device is the
    # batch's own
    plain, _ = ens.evolve_ensemble_block([state], t_end=0.01)
    for kw in (dict(devices=["cpu", "cpu"]), dict(mesh=(1, 1)),
               dict(devices=["cpu"])):
        out, _ = ens.evolve_ensemble_block([state], t_end=0.01, **kw)
        assert out.pos.shape == plain.pos.shape
        assert torch.equal(out.pos, plain.pos), kw
    with pytest.raises(ValueError, match="needs 4 devices; got 2"):
        ens.evolve_ensemble_block([state], t_end=0.01, mesh=(2, 2),
                                  devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="compaction must be"):
        ens.evolve_ensemble_block([state], t_end=0.01, compaction="scatter")
    with pytest.raises(ValueError, match="bucket_mode"):
        ens.evolve_ensemble_block([state], t_end=0.01, compaction="gather",
                                  bucket_mode="pod")
    with pytest.raises(ValueError, match="n_levels"):
        ens.evolve_ensemble_block([state], t_end=0.01, n_levels=0)
