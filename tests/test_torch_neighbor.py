"""Port parity: the Ahmad-Cohen neighbor scheme of ``repro_torch``
(``kernels/neighbor.py``, the neighbor plan of ``kernels/ops.py``,
``core.evaluate.make_neighbor_block_evaluator`` and the block engine's
``sources="neighbor"``) against ``repro``'s on the same inputs.

The window construction must equal the JAX functions' outputs exactly,
over a Hypothesis sweep and at a radius placed exactly on a box distance
(the norm rounds as XLA's fused sum of squares does); the reference's
no-drop property holds on the port's own functions; the near passes agree
with the JAX evaluator within ``TOL``; and the engine agrees with the live
JAX engine (event, refresh, overflow, pair and tile counts exactly,
positions and velocities within ``BLOCK_TOL``) and replays the committed
golden ``binary_plummer_neighbor.json``.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import evaluate as jevaluate
from repro.kernels import neighbor as jneighbor
from repro.kernels import ops as jops
from repro.sim import ensemble as jens
from repro.sim import scenarios as jscenarios
from repro_torch.core import evaluate
from repro_torch.kernels import neighbor, ops
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one thread per test worker, so idle
    pool threads do not starve the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: tests/test_golden_trajectories.py TOL and BLOCK_TOL (pos, vel)
TOL = {"fp64": 1e-12, "fp32": 1e-7, "mixed": 1e-3}
#: the near passes' outputs against the reference's, as normalised error:
#: fp64 and mixed at TOL; fp32 at the port's packed-kernel tolerance
#: (tests/test_torch_kernels.py PACKED_TOL), since float32 rsqrt and sum
#: order differ between the plain version and the reference by about 2e-7
#: (interpreted kernel) to 4.5e-7 (``impl="xla"``) of the largest value,
#: above TOL's 1e-7 for positions
NEAR_TOL = {"fp64": 1e-12, "fp32": 2e-6, "mixed": 1e-3}
BLOCK_TOL = {"fp64": (1e-12, 1e-12), "fp32": (1e-6, 1e-5),
             "mixed": (1e-3, 2e-2)}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "binary_plummer_neighbor.json")
SWEEP = dict(deadline=None, max_examples=25,
             suppress_health_check=[HealthCheck.too_slow])


#: the reference's functions compiled whole, as its engine runs them (one
#: compilation per shape instead of one per operation)
_j_kd_perm = jax.jit(jneighbor.kd_perm, static_argnames="leaf")
_j_morton_keys = jax.jit(jneighbor.morton_keys)
_j_morton_perm = jax.jit(jneighbor.morton_perm)
_j_block_bounds = jax.jit(jneighbor.block_bounds, static_argnums=2)
_j_build_windows = jax.jit(jneighbor.build_windows,
                           static_argnames=("block_i", "block_j"))
#: cloud sizes of the sweep (each size compiles the reference once)
SWEEP_NS = (8, 33, 100, 160, 200)


def _cloud(n, seed, spread=1.0):
    """tests/test_neighbor.py's lognormal cloud: a dense core and a sparse
    halo, the geometry that stresses the window tests."""
    rng = np.random.default_rng(seed)
    r = rng.lognormal(mean=0.0, sigma=spread, size=n)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return u * r[:, None]


def _both(pos, valid):
    return ((jnp.asarray(pos), jnp.asarray(valid)),
            (torch.from_numpy(pos), torch.from_numpy(valid)))


def _equal(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# --------------------------------------------------------------------------
# window construction: exactly the reference's
# --------------------------------------------------------------------------
def _check_exact(n, n_active, seed, radius, dtype, block_i=8, block_j=16):
    n_active = min(n_active, n)
    pos = _cloud(n, seed).astype(dtype)
    valid = np.arange(n) < n_active
    j, t = _both(pos, valid)
    _equal(_j_kd_perm(*j, leaf=8), neighbor.kd_perm(*t, leaf=8))
    keys = np.asarray(_j_morton_keys(*j)).astype(np.int64)
    np.testing.assert_array_equal(keys, neighbor.morton_keys(*t).numpy())
    _equal(_j_morton_perm(*j), neighbor.morton_perm(*t))
    for want, got in zip(_j_block_bounds(*j, block_i),
                         neighbor.block_bounds(*t, block_i)):
        _equal(want, got)
    for want, got in zip(
            _j_build_windows(*j, block_i=block_i, block_j=block_j,
                             radius=radius),
            neighbor.build_windows(*t, block_i=block_i, block_j=block_j,
                                   radius=radius)):
        _equal(want, got)


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("n,n_active,seed,radius", [
    (8, 8, 0, 0.25), (33, 20, 1, 0.5), (100, 37, 3, 0.1),
    (200, 111, 4, 2.0), (160, 160, 5, 0.01)])
def test_windows_and_orderings_equal_the_reference(n, n_active, seed, radius,
                                                   dtype):
    _check_exact(n, n_active, seed, radius, dtype)


@settings(**SWEEP)
@given(n=st.sampled_from(SWEEP_NS), n_active=st.integers(1, 200),
       seed=st.integers(0, 10_000), radius=st.floats(0.01, 2.0),
       fp32=st.booleans())
def test_windows_and_orderings_equal_the_reference_sweep(n, n_active, seed,
                                                         radius, fp32):
    _check_exact(n, n_active, seed, radius,
                 np.float32 if fp32 else np.float64)


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_windows_on_the_radius_equal_the_reference(seed, dtype):
    """A radius placed exactly on a box distance (as the reference's norm
    rounds it) selects the same windows: the norm's rounding decides
    them."""
    n, b = 96, 8
    valid = np.arange(n) < 90
    pos = _cloud(n, seed)
    pos = pos[np.asarray(jneighbor.kd_perm(jnp.asarray(pos),
                                           jnp.asarray(valid), leaf=b))]
    j, t = _both(pos.astype(dtype), valid)
    lo, hi, _ = _j_block_bounds(*j, b)
    gap = jnp.maximum(jnp.maximum(lo[None] - hi[:, None],
                                  lo[:, None] - hi[None]), 0.0)
    d = np.asarray(jnp.linalg.norm(gap, axis=-1))
    radii = np.unique(d[np.isfinite(d) & (d > 0)])[:12]
    assert radii.size
    for r in radii:
        for want, got in zip(
                _j_build_windows(*j, block_i=b, block_j=b, radius=float(r)),
                neighbor.build_windows(*t, block_i=b, block_j=b,
                                       radius=float(r))):
            _equal(want, got)


def test_batched_windows_are_the_members():
    """``build_windows`` takes a leading batch axis (the engine's refresh
    builds every member's windows at once)."""
    pos = np.stack([_cloud(64, s) for s in (0, 1)])
    valid = np.stack([np.arange(64) < 64, np.arange(64) < 40])
    t_pos, t_valid = torch.from_numpy(pos), torch.from_numpy(valid)
    idx, cnt = neighbor.build_windows(t_pos, t_valid, block_i=8, block_j=16,
                                      radius=0.5)
    for b in range(2):
        one = neighbor.build_windows(t_pos[b], t_valid[b], block_i=8,
                                     block_j=16, radius=0.5)
        assert torch.equal(idx[b], one[0]) and torch.equal(cnt[b], one[1])


def test_block_spheres_match_the_reference():
    pos = _cloud(100, 9)
    valid = np.arange(100) < 77
    j, t = _both(pos, valid)
    for want, got in zip(jneighbor.block_spheres(*j, 16),
                         neighbor.block_spheres(*t, 16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-15)


# --------------------------------------------------------------------------
# the reference's no-drop property, on the port's own functions
# --------------------------------------------------------------------------
def _check_coverage(n, n_active, seed, radius, sort):
    """No valid pair within the neighbor radius may miss its window,
    sorted or not (tests/test_neighbor.py:_check_coverage)."""
    n_active = min(n_active, n)
    bi = bj = 8
    pos = torch.from_numpy(_cloud(n, seed))
    valid = torch.arange(n) < n_active
    if sort:
        pos = pos[neighbor.kd_perm(pos, valid, leaf=bi)]
    win_idx, win_cnt = neighbor.build_windows(pos, valid, block_i=bi,
                                              block_j=bj, radius=radius)
    p = pos[:n_active].numpy()
    d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
    for i, j in zip(*np.nonzero(d <= radius)):
        tb, sb = i // bi, j // bj
        assert sb in win_idx[tb, : win_cnt[tb]].tolist(), (i, j, d[i, j])


@pytest.mark.parametrize("n,n_active,seed,radius,sort", [
    (16, 16, 0, 0.25, True), (64, 64, 1, 0.5, True),
    (64, 40, 2, 1.0, True), (160, 160, 3, 0.1, True),
    (96, 96, 4, 0.5, False), (100, 61, 5, 2.0, False),
    (64, 9, 6, 0.01, True),
])
def test_no_pair_inside_radius_is_dropped(n, n_active, seed, radius, sort):
    _check_coverage(n, n_active, seed, radius, sort)


@settings(**SWEEP)
@given(n=st.integers(16, 160), n_active=st.integers(8, 160),
       seed=st.integers(0, 10_000), radius=st.floats(0.01, 2.0),
       sort=st.booleans())
def test_no_pair_dropped_property(n, n_active, seed, radius, sort):
    _check_coverage(n, n_active, seed, radius, sort)


def test_empty_blocks_never_selected_and_select_nothing():
    valid = torch.arange(64) < 20          # blocks 3..7 are all padding
    win_idx, win_cnt = neighbor.build_windows(
        torch.from_numpy(_cloud(64, 7)), valid, block_i=8, block_j=8,
        radius=1e9)
    assert (win_cnt[3:] == 0).all()
    for tb in range(3):
        assert set(win_idx[tb, : win_cnt[tb]].tolist()) <= {0, 1, 2}


# --------------------------------------------------------------------------
# the neighbor plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,bi,bj", [(96, 8, 8), (64, 16, 16),
                                     (1000, 32, 64), (16384, 32, 32)])
def test_neighbor_plan_equals_the_reference(n, bi, bj):
    want = jops.CapacityPlan(n, n, bi, bj, sources="neighbor")
    got = ops.CapacityPlan(n, n, bi, bj, sources="neighbor")
    assert got.source_caps == want.source_caps
    assert got.source_caps[-1] == -(-n // bj) * bj   # overflow: full window
    assert got.window_tiles_by_cap == want.window_tiles_by_cap
    assert got.tile_io_bytes == want.tile_io_bytes
    for rows in range(0, got.source_caps[-1] + 1, bj):
        i = int(got.source_bucket(rows))
        assert i == int(want.source_bucket(rows))
        assert got.source_caps[i] >= rows
        assert got.window_tiles(i) == int(want.window_tiles(i))
    for a in range(1, n + 1, max(1, n // 97)):
        assert got.admission_cap(a) == want.admission_cap(a)
    with pytest.raises(ValueError, match="capacity range"):
        got.admission_cap(0)
    with pytest.raises(ValueError, match="sources"):
        ops.CapacityPlan(n, n, bi, bj, sources="far")


def test_full_plan_tile_bytes_unchanged():
    plan = ops.CapacityPlan(64, 64, 16, 32)
    assert plan.tile_io_bytes == jops.CapacityPlan(64, 64, 16,
                                                   32).tile_io_bytes


# --------------------------------------------------------------------------
# the near passes against the JAX evaluator
# --------------------------------------------------------------------------
def _near_inputs(n=100, seed=0):
    """A sorted cloud of ``n`` (the last 10 rows zero-mass padding), a
    partial target mask and the reference's windows, which select some of
    the source blocks."""
    rng = np.random.default_rng(seed)
    valid = jnp.asarray(np.arange(n) < 90)
    pos = _cloud(n, seed)
    pos = pos[np.asarray(jneighbor.kd_perm(jnp.asarray(pos), valid,
                                           leaf=16))]
    vel = 0.1 * rng.standard_normal((n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    mass[90:] = 0.0
    mask = rng.uniform(size=n) < 0.6
    acc_t, acc_s = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    win_idx, win_cnt = jneighbor.build_windows(
        jnp.asarray(pos), valid, block_i=16, block_j=16, radius=0.3)
    return pos, vel, mass, mask, acc_t, acc_s, np.asarray(win_idx), \
        np.asarray(win_cnt)


def _norm_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()
                 / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("w_idx", (2, 3))
@pytest.mark.parametrize("dtype,impl", (("fp64", None),
                                        ("fp32", "pallas_interpret"),
                                        ("mixed", "pallas_interpret"),
                                        ("fp32", "xla"), ("mixed", "xla")))
def test_near_passes_match_the_reference(dtype, impl, w_idx):
    """``near1``/``near2`` against the reference's on the same gathered
    windows (fp64 the oracle; fp32 and mixed the interpreted Pallas kernel
    and the XLA evaluator), as the normalised error of each output, within
    ``NEAR_TOL``."""
    n = 100
    pos, vel, mass, mask, acc_t, acc_s, win_idx, win_cnt = _near_inputs(n)
    kw = dict(n=n, eps=1e-7, block_i=16, block_j=16)
    if dtype == "fp64":
        j1, j2 = jevaluate.make_neighbor_block_evaluator(precision="fp64",
                                                         **kw)
    else:
        j1, j2 = jevaluate.make_neighbor_block_evaluator(
            impl=impl, dtype=dtype, **kw)
    t1, t2 = evaluate.make_neighbor_block_evaluator(dtype=dtype, **kw)
    f = np.float64 if dtype == "fp64" else np.float32
    jin = [jnp.asarray(x.astype(f)) for x in (pos, vel, mass)]
    tin = [torch.from_numpy(x.astype(f)) for x in (pos, vel, mass)]
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    jw = (jnp.asarray(win_idx), jnp.asarray(win_cnt))
    tw = (torch.from_numpy(win_idx), torch.from_numpy(win_cnt))
    want = j1(*jin, jm, *jw, w_idx)
    got = t1(*tin, tm, *tw, w_idx)
    for g, w in zip(got, want):
        assert g.dtype == (torch.float64 if dtype == "fp64"
                           else torch.float32)
        assert _norm_err(g, w) <= NEAR_TOL[dtype]
        assert not g[~tm].any()
    at, as_ = (jnp.asarray(x) for x in (acc_t, acc_s))
    want = j2(jin[0], jin[1], at, as_, jin[2], jm, *jw, w_idx)
    got = t2(tin[0], tin[1], torch.from_numpy(acc_t),
             torch.from_numpy(acc_s), tin[2], tm, *tw, w_idx)
    assert _norm_err(got, want) <= NEAR_TOL[dtype]


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
def test_a_wider_bucket_gives_the_same_bits(dtype):
    """The slots a wider bucket appends are zero-mass tail rows: every
    row's sum gains exact zeros only.  The targets are those of the blocks
    whose windows fit a bucket below the full extent."""
    n = 100
    pos, vel, mass, mask, acc_t, acc_s, win_idx, win_cnt = _near_inputs(n)
    t1, t2 = evaluate.make_neighbor_block_evaluator(
        n=n, eps=1e-7, block_i=16, block_j=16, dtype=dtype)
    caps = ops.capacity_buckets(n, 16)
    fits = win_cnt * 16 <= caps[-2]
    mask = mask & np.repeat(fits, 16)[:n]
    assert mask.any()
    x = [torch.from_numpy(a) for a in (pos, vel, mass, mask)]
    w = [torch.from_numpy(a) for a in (win_idx, win_cnt)]
    base = int(ops.CapacityPlan(n, n, 16, 16).source_bucket(
        int(win_cnt[fits].max()) * 16))
    outs = [t1(*x, *w, i) + (t2(x[0], x[1], torch.from_numpy(acc_t),
                                torch.from_numpy(acc_s), x[2], x[3], *w, i),)
            for i in range(base, len(caps))]
    assert len(outs) >= 2
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_near_passes_take_a_batch():
    """A batch of B systems goes through one launch per pass, each member
    bit for bit its own unbatched evaluation."""
    n = 100
    pos, vel, mass, mask, _, _, win_idx, win_cnt = _near_inputs(n)
    pos2, _, _, mask2, _, _, idx2, cnt2 = _near_inputs(n, seed=1)
    t1, _ = evaluate.make_neighbor_block_evaluator(
        n=n, eps=1e-7, block_i=16, block_j=16, dtype="fp32")
    T = torch.from_numpy
    batch = t1(T(np.stack([pos, pos2])), T(np.stack([vel, vel])),
               T(np.stack([mass, mass])), T(np.stack([mask, mask2])),
               T(np.stack([win_idx, idx2])), T(np.stack([win_cnt, cnt2])), 3)
    for b, (p, m, i, c) in enumerate(((pos, mask, win_idx, win_cnt),
                                      (pos2, mask2, idx2, cnt2))):
        one = t1(T(p), T(vel), T(mass), T(m), T(i), T(c), 3)
        assert all(torch.equal(x[b], y) for x, y in zip(batch, one))


def test_near_passes_refuse_a_launch_past_the_grid_limit():
    """``B * nbt`` rides the kernels' ``gridDim.y``: above 65535 the near
    evaluator refuses before anything launches."""
    n, b = 64, 1025                       # block_i 1: 64 blocks a member
    near1, _ = evaluate.make_neighbor_block_evaluator(
        n=n, block_i=1, block_j=1, dtype="fp32")
    z = torch.zeros(b, n, 3)
    with pytest.raises(ValueError, match="65535"):
        near1(z, z, torch.zeros(b, n), torch.ones(b, n, dtype=torch.bool),
              torch.zeros(b, n, n, dtype=torch.int32),
              torch.zeros(b, n, dtype=torch.int32), 0)


# --------------------------------------------------------------------------
# the engine against the live JAX engine and the golden
# --------------------------------------------------------------------------
def _golden_kw():
    with open(GOLDEN) as f:
        doc = json.load(f)
    m = doc["meta"]
    kw = dict(t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
              eta=m["eta"], order=m["order"], eps=m["eps"],
              sources=m["sources"], neighbor_radius=m["neighbor_radius"],
              refresh_levels=m["refresh_levels"], block_i=m["block_i"],
              block_j=m["block_j"])
    return doc, m, kw


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_neighbor_engine_matches_the_reference_and_the_golden(dtype):
    doc, m, kw = _golden_kw()
    state = scenarios.make(m["scenario"], m["n"], seed=m["seed"],
                           device="cpu")
    ens.ensemble_run_block.host_syncs = 0
    out, c = ens.evolve_ensemble_block([state], dtype=dtype, **kw)
    jout, jc = jens.evolve_ensemble_block(
        [jscenarios.make(m["scenario"], m["n"], seed=m["seed"])],
        impl="fp64" if dtype == "fp64" else "xla", dtype=dtype, **kw)
    assert int(c.n_events[0]) == int(jc.n_events[0]) == doc["n_events"]
    for name in ("n_refresh", "n_overflow"):
        assert getattr(c.nbr, name).tolist() == \
            np.asarray(getattr(jc.nbr, name)).tolist()
    assert c.nbr.n_refresh[0] > 0
    for name in ("n_pairs", "n_tiles"):
        assert getattr(c, name).tolist() == \
            np.asarray(getattr(jc, name)).tolist()
    tol_pos, tol_vel = BLOCK_TOL[dtype]
    for want in (np.asarray(jout.pos[0]), np.asarray(doc["pos"])):
        np.testing.assert_allclose(out.pos[0].numpy(), want, rtol=0,
                                   atol=tol_pos)
    for want in (np.asarray(jout.vel[0]), np.asarray(doc["vel"])):
        np.testing.assert_allclose(out.vel[0].numpy(), want, rtol=0,
                                   atol=tol_vel)
    # one host read per event, one more per refresh event, the read that
    # finds no member live, and the chunk loop's end-of-chunk check
    refresh_events = int(c.nbr.n_refresh[0])
    assert ens.ensemble_run_block.host_syncs == \
        doc["n_events"] + refresh_events + 2


def test_sorted_state_equals_the_reference():
    """The spatially sorted initial state is the reference's, bit for bit
    (ROADMAP's rule for initial conditions), batched and unbatched."""
    for name, n, seed in (("binary_plummer", 64, 1), ("plummer", 100, 3)):
        want = jens.spatial_sort_state(jscenarios.make(name, n, seed=seed),
                                       leaf=16)
        got = ens.spatial_sort_state(
            scenarios.make(name, n, seed=seed, device="cpu"), leaf=16)
        for f in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    states = [scenarios.make("plummer", 64, seed=s, device="cpu")
              for s in (0, 1)]
    batched = ens.spatial_sort_batched(ens.stack_states(states), [64, 50],
                                       leaf=8)
    jbatched = jens.spatial_sort_batched(
        jens.stack_states([jscenarios.make("plummer", 64, seed=s)
                           for s in (0, 1)]), jnp.asarray([64, 50]), leaf=8)
    np.testing.assert_array_equal(batched.pos.numpy(),
                                  np.asarray(jbatched.pos))


def test_overflow_falls_back_to_full_window_exactly():
    """tests/test_neighbor.py's case in the port: a radius that puts every
    source block in every window counts overflows and reproduces the
    all-pairs trajectory."""
    state = scenarios.make("binary_plummer", 64, seed=1, device="cpu")
    kw = dict(t_end=0.03125, dt_max=1.0 / 64, n_levels=3, eta=0.02,
              dtype="fp64", block_i=16, block_j=16)
    full, cf = ens.evolve_ensemble_block(
        [ens.spatial_sort_state(state, leaf=16)], **kw)
    nbr, cn = ens.evolve_ensemble_block(
        [state], sources="neighbor", neighbor_radius=1e9, refresh_levels=0,
        **kw)
    assert int(cn.nbr.n_overflow[0]) > 0
    assert int(cn.n_events[0]) == int(cf.n_events[0])
    np.testing.assert_allclose(nbr.pos[0].numpy(), full.pos[0].numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(nbr.vel[0].numpy(), full.vel[0].numpy(),
                               rtol=0, atol=1e-12)


def test_full_sources_ignore_neighbor_knobs():
    state = scenarios.make("plummer", 32, seed=0, device="cpu")
    kw = dict(t_end=0.03125, dt_max=1.0 / 64, n_levels=3, eta=0.02,
              dtype="fp64", block_i=16, block_j=16, sources="full")
    a, ca = ens.evolve_ensemble_block([state], neighbor_radius=0.1, **kw)
    b, cb = ens.evolve_ensemble_block([state], neighbor_radius=7.0, **kw)
    assert torch.equal(a.pos, b.pos)
    assert ca.nbr is None and cb.nbr is None


@pytest.mark.parametrize("kw,match", [
    (dict(sources="neighbor", compaction="gather"), "compaction"),
    (dict(sources="neighbor", refresh_levels=-1), "refresh_levels"),
    (dict(sources="far"), "sources"),
])
def test_engine_refuses_what_the_reference_refuses(kw, match):
    state = ens.ensemble_initialize(ens.stack_states(
        [scenarios.make("plummer", 16, device="cpu")]))
    with pytest.raises(ValueError, match=match):
        ens.ensemble_run_block(state, t_end=0.01, **kw)


def test_spatial_sort_leaf_divides_blocks():
    """The entry points sort with leaf = gcd(block_i, block_j); the sort
    keeps the multiset of rows."""
    assert math.gcd(16, 64) == 16
    state = scenarios.make("plummer", 96, seed=0, device="cpu")
    srt = ens.spatial_sort_state(state, leaf=8)
    assert torch.equal(torch.sort(srt.mass).values,
                       torch.sort(state.mass).values)
    assert torch.equal(torch.sort(srt.pos[:, 0]).values,
                       torch.sort(state.pos[:, 0]).values)
