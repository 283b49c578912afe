"""Port parity of the main path as a whole: ``repro_torch.core.{hermite,
evaluate}`` and ``repro_torch.launch.nbody_run`` against the reference and
its committed goldens, on the CPU (the packed wrappers run their plain
versions there).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hermite as jhermite
from repro.core import nbody as jnbody
from repro.core.evaluate import make_block_evaluator as jax_block_evaluator
from repro.core.evaluate import make_evaluator as jax_make_evaluator
from repro_torch.core import hermite, nbody
from repro_torch.core.evaluate import make_block_evaluator, make_evaluator
from repro_torch.launch import nbody_run

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
#: the golden tiers of tests/test_golden_trajectories.py
TOL = {"fp64": 1e-12, "fp32": 1e-7, "mixed": 1e-3}
#: |dE/E| tiers of the precision modes (benchmarks/bench_ci.py DE_TIERS)
DE_TIERS = {"fp64": 1e-6, "fp32": 1e-4, "mixed": 1e-3}


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _random_state(n, seed, with_pot=True):
    """A float64 state with every derivative set, made with numpy; returns
    the reference's state and the port's."""
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal((n, 3)) for k in
         ("pos", "vel", "acc", "jerk", "snap", "crackle")}
    f["mass"] = rng.uniform(0.5, 1.5, n) / n
    f["pot"] = -rng.uniform(0.5, 1.5, n) if with_pot else np.zeros(n)
    f["time"] = np.asarray(0.25)
    j = jnbody.ParticleState(**{k: jnp.asarray(v) for k, v in f.items()})
    return j, nbody.state_from_numpy(f, device="cpu")


# --------------------------------------------------------------------------
# the whole slice against the committed goldens
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
@pytest.mark.parametrize("fname", ("two_body.json", "plummer16.json"))
def test_slice_reproduces_golden(fname, dtype):
    """The golden's recorded t=0 state through the port's evaluator and
    fixed-dt loop lands on the recorded final state within the golden tier
    of its precision mode."""
    with open(os.path.join(GOLDEN_DIR, fname)) as f:
        doc = json.load(f)
    m = doc["meta"]
    state = nbody.zeros_like_state(_t(doc["pos0"]), _t(doc["vel0"]),
                                   _t(doc["mass"]))
    ev = make_evaluator(order=m["order"], eps=m["eps"], dtype=dtype)
    out = hermite.evolve_scan(state, ev, n_steps=m["n_steps"], dt=m["dt"],
                              order=m["order"])
    assert out.dtype == torch.float64
    assert float(out.time) == pytest.approx(m["dt"] * m["n_steps"])
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(doc["pos"]),
                               rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(doc["vel"]),
                               rtol=0, atol=TOL[dtype])


def test_adaptive_plummer_matches_reference_step_for_step():
    """Plummer N=64 with the shared Aarseth step to t = 1/16: the port takes
    as many steps as the reference's ``impl="xla"`` evaluator and ends
    within the fp32 golden tier (1e-7; measured ~2e-9 in velocity)."""
    counts = {"jax": 0, "port": 0}

    def counting(key, ev):
        def evaluate(pos, vel, mass):
            counts[key] += 1
            return ev(pos, vel, mass)
        return evaluate

    want = jhermite.evolve(jnbody.plummer(64, seed=0),
                           counting("jax", jax_make_evaluator(impl="xla")),
                           t_end=1 / 16, eta=0.02)
    got = hermite.evolve(nbody.plummer(64, seed=0, device="cpu"),
                         counting("port", make_evaluator()),
                         t_end=1 / 16, eta=0.02)
    assert counts["port"] == counts["jax"] > 2
    assert float(got.time) == float(want.time) == 1 / 16
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL["fp32"])


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_block_evaluator_matches_reference(dtype):
    """The masked evaluator, with predicted accelerations standing in for
    the inactive sources of the snap pass, against the reference's
    ``impl="xla"`` (or fp64 oracle) evaluator."""
    n = 40
    jstate, state = _random_state(n, seed=3)
    mask = np.random.default_rng(4).uniform(size=n) < 0.6
    kw = dict(eps=1e-7, block_i=16, block_j=32)
    jev = jax_block_evaluator(impl="xla", dtype=dtype, **kw)
    want = jev(jstate.pos, jstate.vel, jstate.acc, jstate.mass,
               jnp.asarray(mask))
    ev = make_block_evaluator(dtype=dtype, **kw)
    got = ev(state.pos, state.vel, state.acc, state.mass,
             torch.from_numpy(mask))
    tol = {"fp64": 1e-14, "fp32": 2e-6, "mixed": 2.0 ** -7}[dtype]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert g.dtype == (torch.float64 if dtype == "fp64"
                           else torch.float32)
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= tol * scale
        assert not g.numpy()[~mask].any()


def test_lockstep_evaluator_is_all_ones_block_evaluator():
    _, state = _random_state(24, seed=5)
    kw = dict(block_i=8, block_j=16)
    got = make_evaluator(**kw)(state.pos, state.vel, state.mass)
    want = make_block_evaluator(**kw)(
        state.pos, state.vel, torch.zeros_like(state.pos), state.mass,
        torch.ones(24, dtype=torch.bool))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_evaluator_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        make_block_evaluator(compaction="gather")
    with pytest.raises(ValueError):
        make_block_evaluator(compaction="scatter")
    with pytest.raises(ValueError):
        make_evaluator(dtype="fp16")


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_quickstart_run_conserves_energy(dtype):
    """A short quickstart-like run through the launcher's ``run`` keeps
    |dE/E| inside its precision tier; each step is one evaluation."""
    r = nbody_run.run(n=64, t_end=1 / 32, dtype=dtype, device="cpu")
    assert r["t"] == pytest.approx(1 / 32)
    assert r["evals"] == r["steps"] + 2 and r["steps"] > 0
    assert r["de_rel"] <= DE_TIERS[dtype]
    assert torch.isfinite(r["state"].pos).all()


def test_cli_runs_single_and_refuses_other_strategies(capsys):
    assert nbody_run.main(["--n", "32", "--t-end", "0.005",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "strategy=single device=cpu dtype=fp32" in out
    assert "|dE/E0|=" in out
    with pytest.raises(SystemExit) as exc:
        nbody_run.main(["--strategy", "ring", "--device", "cpu"])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


# --------------------------------------------------------------------------
# core/hermite.py, function by function
# --------------------------------------------------------------------------
def _close(got, want, rtol=1e-14):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("column", (False, True))
def test_predict_and_correct_match_reference(column):
    jstate, state = _random_state(16, seed=6)
    dt = 0.01 * (1 + np.arange(16)[:, None] / 16) if column else 0.01
    jdt, tdt = (jnp.asarray(dt), _t(dt)) if column else (dt, dt)
    for got, want in zip(hermite.predict(state, tdt),
                         jhermite.predict(jstate, jdt)):
        _close(got, want)
    _close(hermite.predict_acc(state, tdt), jhermite.predict_acc(jstate, jdt))
    rng = np.random.default_rng(7)
    ev = [rng.standard_normal((16, 3)).astype(np.float32) for _ in range(3)]
    pot = rng.standard_normal(16).astype(np.float32)
    jev = jhermite.Evaluation(*(jnp.asarray(x) for x in ev + [pot]))
    tev = hermite.Evaluation(*(torch.from_numpy(x) for x in ev + [pot]))
    for order in (4, 6):
        for got, want in zip(hermite.correct(state, tev, tdt, order=order),
                             jhermite.correct(jstate, jev, jdt, order=order)):
            _close(got, want, rtol=1e-12)


@pytest.mark.parametrize("use_crackle", (False, True))
def test_aarseth_dt_matches_reference(use_crackle):
    jstate, state = _random_state(32, seed=8)
    # zero-derivative rows (padding) fall back to dt_max in both
    f = {k: np.asarray(getattr(jstate, k)).copy() for k in nbody.FIELDS}
    for k in ("acc", "jerk", "snap"):
        f[k][-4:] = 0.0
    jstate = jnbody.ParticleState(**{k: jnp.asarray(v) for k, v in f.items()})
    state = nbody.state_from_numpy(f, device="cpu")
    kw = dict(eta=0.03, dt_max=0.125, use_crackle=use_crackle)
    want = jhermite.aarseth_dt_particles(jstate, **kw)
    got = hermite.aarseth_dt_particles(state, **kw)
    _close(got, want)
    assert (got[-4:] == 0.125).all()
    assert float(hermite.aarseth_dt(state, **kw)) == pytest.approx(
        float(jhermite.aarseth_dt(jstate, **kw)), rel=1e-14)


def test_block_level_helpers_match_reference():
    rng = np.random.default_rng(9)
    dt_i = 0.0625 * 2.0 ** -rng.uniform(0, 9, 64)
    dt_i[:3] = (0.0625, 1.0, 0.0)
    n_levels = 6
    want = jhermite.quantize_block_levels(jnp.asarray(dt_i), dt_max=0.0625,
                                          n_levels=n_levels)
    levels = hermite.quantize_block_levels(_t(dt_i), dt_max=0.0625,
                                           n_levels=n_levels)
    assert levels.dtype == torch.int32
    np.testing.assert_array_equal(levels.numpy(), np.asarray(want))

    # XLA's exp2 on the CPU may miss an exact power of two by an ulp
    _close(hermite.block_level_dt(levels, _t(0.0625)),
           jhermite.block_level_dt(want, jnp.float64(0.0625)), rtol=3e-16)
    assert hermite.block_level_dt(levels, 0.0625,
                                  torch.float32).dtype == torch.float32

    mask = rng.uniform(size=64) < 0.8
    for m in (None, mask):
        np.testing.assert_array_equal(
            hermite.block_level_occupancy(
                levels, n_levels=n_levels,
                mask=None if m is None else torch.from_numpy(m)).numpy(),
            np.asarray(jhermite.block_level_occupancy(
                want, n_levels=n_levels,
                mask=None if m is None else jnp.asarray(m))))
    for tick in range(1, 2 ** (n_levels - 1) + 1):
        assert int(hermite.tick_threshold_level(tick, n_levels=n_levels)) \
            == int(jhermite.tick_threshold_level(tick, n_levels=n_levels))
        np.testing.assert_array_equal(
            hermite.block_active_mask(levels, tick,
                                      n_levels=n_levels).numpy(),
            np.asarray(jhermite.block_active_mask(want, tick,
                                                  n_levels=n_levels)))
    assert int(hermite.auto_n_levels(_t(dt_i[3:]), dt_max=0.0625)) == int(
        jhermite.auto_n_levels(jnp.asarray(dt_i[3:]), dt_max=0.0625))
