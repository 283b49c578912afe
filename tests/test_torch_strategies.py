"""Port parity: the lockstep distribution strategies of
``repro_torch.core.strategies`` against ``repro.core.strategies``.

The port's device mesh runs on the CPU with the CPU named once per slot
(``["cpu"] * p``), as the reference runs on XLA's placeholder host devices.
Inputs are the reference's own numpy-seeded Plummer states, handed to both
packages as numpy arrays.  Tolerances:

* an evaluation against the single-device one: 1e-5 relative per field
  (max |a - b| / max |b|), the reference's own limit
  (``tests/test_strategies.py``): the sum over sources runs in another
  order;
* the committed goldens: ``TOL`` of ``tests/test_golden_trajectories.py``
  (fp32 1e-7, mixed 1e-3 absolute);
* the ring's two schedules: bit for bit, and ``ring.shifts_issued`` exact.

The reference's ``test_mixed_strategies_reproduce_golden[replicated|ring]``
fails in this container (ROADMAP.md queue 3 C), so the mixed strategies are
held to the golden, not to that path.  Its 4-device lockstep equivalence
passes here, so the p = 4 comparison runs the JAX strategies live, in a
subprocess with four forced host devices.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import nbody as jnbody
from repro.core.evaluate import make_evaluator as jmake_evaluator
from repro.core import strategies as jstrategies
from repro_torch.core import hermite, nbody, strategies
from repro_torch.obs import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
#: tests/test_golden_trajectories.py TOL
TOL = {"fp32": 1e-7, "mixed": 1e-3}
#: a strategy's evaluation against the single-device one, relative per
#: field (tests/test_strategies.py)
REL = 1e-5
FIELDS = ("acc", "jerk", "snap", "pot")
STATE_FIELDS = ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot",
                "time")


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, seed):
    """The reference's Plummer state as numpy arrays (pos, vel, mass)."""
    s = jnbody.plummer(n, seed=seed)
    return tuple(np.asarray(x) for x in (s.pos, s.vel, s.mass))


def _torch(arrays):
    return tuple(torch.tensor(x) for x in arrays)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _slots(p):
    return ["cpu"] * p


def _strategy_cases():
    for p in (1, 2, 4):
        for strategy in strategies.STRATEGIES:
            if strategy == "two_level" and p % 2:
                continue  # two chips per card: see the odd-p test
            yield p, strategy


@pytest.fixture(scope="module")
def plummer500():
    arrays = _arrays(500, 7)
    ref = jmake_evaluator(impl="xla")(*(jnp.asarray(x) for x in arrays))
    return arrays, ref


@pytest.mark.parametrize("p,strategy", list(_strategy_cases()))
def test_strategy_matches_the_jax_single_path(plummer500, p, strategy):
    """Every strategy over 1, 2 and 4 CPU slots against the live JAX
    ``make_evaluator(impl="xla")`` on plummer(500, seed=7)."""
    arrays, ref = plummer500
    ev = strategies.make_strategy_evaluator(strategy, devices=_slots(p))
    out = ev(*_torch(arrays))
    for f in FIELDS:
        assert getattr(out, f).dtype == torch.float32
        assert _rel(getattr(out, f), getattr(ref, f)) < REL, (strategy, f)


@pytest.mark.parametrize("strategy", ("replicated", "mesh_sharded", "ring"))
def test_one_device_matches_the_jax_strategy(plummer500, strategy):
    """At one device the JAX package runs its strategies in this process:
    the two packages' strategy evaluations agree."""
    arrays, _ = plummer500
    jev = jstrategies.make_strategy_evaluator(strategy, impl="xla")
    want = jev(*(jnp.asarray(x) for x in arrays))
    got = strategies.make_strategy_evaluator(strategy, devices=["cpu"])(
        *_torch(arrays))
    for f in FIELDS:
        assert _rel(getattr(got, f), getattr(want, f)) < REL, (strategy, f)


_JAX_4DEV = textwrap.dedent(r"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.core import nbody
    from repro.core.strategies import STRATEGIES, make_strategy_evaluator
    assert len(jax.devices()) == 4
    state = nbody.plummer(int(sys.argv[2]), seed=7)
    out = {}
    for strategy in STRATEGIES:
        ev = make_strategy_evaluator(strategy, devices=jax.devices(),
                                     impl="xla", chips_per_card=2)
        r = ev(state.pos, state.vel, state.mass)
        for f in ("acc", "jerk", "snap", "pot"):
            out[f"{strategy}.{f}"] = np.asarray(getattr(r, f))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_4dev(tmp_path_factory):
    """The JAX strategies at four forced host devices on plummer(N, 7),
    N = 500 and 501 (a multiple of 4 and not): the device count must be
    set before JAX starts, so they run in a subprocess."""
    out = {}
    for n in (500, 501):
        path = str(tmp_path_factory.mktemp("jax4") / f"eval{n}.npz")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        res = subprocess.run([sys.executable, "-c", _JAX_4DEV, path, str(n)],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, res.stdout + "\n" + res.stderr
        out[n] = dict(np.load(path))
    return out


@pytest.mark.parametrize("n", (500, 501))
@pytest.mark.parametrize("strategy", strategies.STRATEGIES)
def test_four_devices_match_the_jax_strategies(jax_4dev, strategy, n):
    """p = 4 against the JAX strategies at four devices.  N = 501 pads the
    sources with three zero-mass rows and the shards with inactive ones."""
    got = strategies.make_strategy_evaluator(strategy, devices=_slots(4))(
        *_torch(_arrays(n, 7)))
    for f in FIELDS:
        want = jax_4dev[n][f"{strategy}.{f}"]
        assert getattr(got, f).shape == want.shape
        assert _rel(getattr(got, f), want) < REL, (strategy, f)


def _golden(fname):
    with open(os.path.join(GOLDEN_DIR, fname)) as f:
        return json.load(f)


def _replay(doc, ev):
    m = doc["meta"]
    st = nbody.zeros_like_state(*(torch.tensor(doc[k], dtype=torch.float64)
                                  for k in ("pos0", "vel0", "mass")))
    return hermite.evolve_scan(st, ev, n_steps=m["n_steps"], dt=m["dt"],
                               order=m["order"])


def _assert_golden(out, doc, tol):
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(doc["pos"]),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(doc["vel"]),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("p", (1, 2))
@pytest.mark.parametrize("strategy", strategies.STRATEGIES)
@pytest.mark.parametrize("fname", ("two_body.json", "plummer16.json"))
def test_strategies_reproduce_the_goldens(fname, strategy, p):
    """``two_body.json`` (N = 2: a shard of one particle at p = 2) and
    ``plummer16.json`` replayed under every strategy at the fp32 tier."""
    doc = _golden(fname)
    m = doc["meta"]
    ev = strategies.make_strategy_evaluator(
        strategy, devices=_slots(p), eps=m["eps"], order=m["order"],
        chips_per_card=2 if p % 2 == 0 else 1)
    _assert_golden(_replay(doc, ev), doc, TOL["fp32"])


@pytest.mark.parametrize("strategy", strategies.STRATEGIES)
def test_mixed_strategies_reproduce_the_golden(strategy):
    """dtype='mixed' under every strategy within the mixed tier of
    ``plummer16.json`` (the per-shard compensated sums must not widen
    it); held to the golden, as the reference's live path fails here."""
    doc = _golden("plummer16.json")
    m = doc["meta"]
    ev = strategies.make_strategy_evaluator(
        strategy, devices=_slots(2), eps=m["eps"], order=m["order"],
        dtype="mixed")
    _assert_golden(_replay(doc, ev), doc, TOL["mixed"])


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
@pytest.mark.parametrize("p", (2, 4))
def test_ring_overlap_equals_sync_and_counts_its_shifts(p, dtype):
    """The overlap schedule issues 2 (p - 1) shift rounds per evaluation
    (acc and snap passes), sync 2 p; both give the same bits on every
    leaf of an initialized state."""
    arrays = _arrays(64, 3)
    state = nbody.zeros_like_state(*_torch(arrays))
    outs, counts = {}, {}
    for mode in strategies.RING_MODES:
        with metrics.use() as reg:
            ev = strategies.make_strategy_evaluator(
                "ring", devices=_slots(p), dtype=dtype, ring_mode=mode)
            outs[mode] = hermite.initialize(state, ev)
            counts[mode] = reg.counter("ring.shifts_issued").value
    assert counts == {"overlap": 2 * (p - 1), "sync": 2 * p}
    for f in STATE_FIELDS:
        assert torch.equal(getattr(outs["overlap"], f),
                           getattr(outs["sync"], f)), f


def test_shift_rounds_count_per_evaluation():
    """Eagerly issued rounds add up over evaluations: a bootstrap and two
    steps are three evaluations."""
    state = nbody.zeros_like_state(*_torch(_arrays(32, 1)))
    ev = strategies.make_strategy_evaluator("ring", devices=_slots(4))
    with metrics.use() as reg:
        hermite.evolve_scan(state, ev, n_steps=2, dt=1e-3)
        assert reg.counter("ring.shifts_issued").value == 3 * 2 * 3


@pytest.mark.parametrize("p", (1, 3))
def test_two_level_needs_whole_cards(p):
    with pytest.raises(ValueError, match="not divisible by chips_per_card"):
        strategies.make_strategy_evaluator("two_level", devices=_slots(p))
    with pytest.raises(ValueError, match="not divisible by chips_per_card"):
        strategies.make_strategy_block_evaluator("two_level",
                                                 devices=_slots(p))
    with pytest.raises(ValueError) as theirs:
        jstrategies.make_strategy_evaluator(
            "two_level", devices=[object()] * p)
    assert "not divisible by chips_per_card" in str(theirs.value)


def test_arguments_are_validated():
    with pytest.raises(ValueError, match="fp64"):
        strategies.make_strategy_evaluator("ring", devices=_slots(2),
                                           dtype="fp64")
    with pytest.raises(ValueError, match="unknown strategy"):
        strategies.make_strategy_evaluator("warp", devices=_slots(2))
    with pytest.raises(ValueError, match="ring_mode"):
        strategies.make_strategy_evaluator("ring", devices=_slots(2),
                                           ring_mode="async")
    with pytest.raises(ValueError, match="at least one device"):
        strategies.make_strategy_evaluator("ring", devices=[])
    assert strategies.STRATEGIES == jstrategies.STRATEGIES
    assert strategies.RING_MODES == jstrategies.RING_MODES
    assert strategies.COMPACTIONS == jstrategies.COMPACTIONS


def test_mesh_devices_on_the_cpu():
    assert strategies.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert strategies.mesh_devices(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="at least one device"):
        strategies.mesh_devices(0, "cpu")


# --------------------------------------------------------------------------
# the device mesh's collectives
# --------------------------------------------------------------------------
def _parts(p, rows=2):
    return [torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
            + 100 * i for i in range(p)]


@pytest.mark.parametrize("p", (1, 2, 4))
def test_shard_and_unshard_round_trip(p):
    mesh = strategies.DeviceMesh(_slots(p))
    x = torch.arange(4 * p * 3, dtype=torch.float64).reshape(4 * p, 3)
    parts = mesh.shard(x)
    assert len(parts) == p and all(q.shape == (4, 3) for q in parts)
    assert torch.equal(mesh.unshard(parts, "cpu"), x)


@pytest.mark.parametrize("p", (2, 4))
def test_gathers_keep_the_slot_order(p):
    """The 1-D gather and the two-stage (card, chip) gather both give every
    slot the blocks in slot order, as the reference's tiled gathers do."""
    parts = _parts(p)
    whole = torch.cat(parts)
    flat = strategies.DeviceMesh(_slots(p))
    grid = strategies.make_mesh("two_level", _slots(p))
    assert grid.shape == (p // 2, 2) and grid.axis_names == ("card", "chip")
    for mesh, gather in ((flat, flat.all_gather), (grid, grid.all_gather2)):
        got = gather(parts)
        assert len(got) == p
        assert all(torch.equal(g, whole) for g in got)


def test_placements_name_the_layout():
    mesh = strategies.DeviceMesh(_slots(4))
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    sharded = mesh.place(x, "sharded")
    assert [q.shape[0] for q in sharded] == [2] * 4
    assert all(torch.equal(r, x) for r in mesh.place(x, "replicated"))
    # a sharded value replicated is an all-gather
    assert all(torch.equal(r, x) for r in mesh.place(sharded, "replicated"))
    assert all(torch.equal(a, b) for a, b in
               zip(mesh.place(sharded, "sharded"), sharded))
    with pytest.raises(ValueError, match="placement"):
        mesh.place(x, "striped")


@pytest.mark.parametrize("p", (2, 3, 4))
def test_ppermute_moves_each_window_one_slot_on(p):
    """Slot i receives slot (i - 1) mod p's window, so after k rounds slot
    i holds source shard (i - k) mod p."""
    mesh = strategies.DeviceMesh(_slots(p))
    win = [(q,) for q in _parts(p)]
    start = [w[0] for w in win]
    for k in range(1, p + 1):
        win = mesh.ppermute(win)
        for i in range(p):
            assert torch.equal(win[i][0], start[(i - k) % p])


def test_mesh_shape_must_tile_the_devices():
    with pytest.raises(ValueError, match="does not tile"):
        strategies.DeviceMesh(_slots(4), (3, 2), ("card", "chip"))
