"""Port parity: the fixed-dt and adaptive ensembles of
``repro_torch.sim.ensemble`` against ``repro.sim.ensemble``.

B = 3 Plummer members of N = 32 go through the JAX ensemble and the port's
on the same initial states (equal bit for bit, ``test_torch_scenarios.py``)
and must agree within the golden tiers ``TOL``.  The reference's own
``test_ensemble_matches_sequential_fixed_dt`` fails in this container
(ROADMAP.md queue 3 C), so the port's ensemble is held to the port's own
sequential path instead: ``hermite.evolve_scan`` / ``hermite.evolve`` on
each member alone, bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.sim import ensemble as jens
from repro.sim import scenarios as jscenarios
from repro_torch.core import hermite, nbody
from repro_torch.core.evaluate import make_evaluator
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


#: tests/test_golden_trajectories.py TOL
TOL = {"fp64": 1e-12, "fp32": 1e-7, "mixed": 1e-3}
FIELDS = ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot", "time")


def _states(b=3, n=32):
    return [scenarios.make("plummer", n, seed=s, device="cpu")
            for s in range(b)]


def _jax_states(b=3, n=32):
    return [jscenarios.make("plummer", n, seed=s) for s in range(b)]


def _jax_kw(dtype):
    return (dict(impl="fp64") if dtype == "fp64"
            else dict(impl="xla", dtype=dtype))


def _close(got, want, tol, names=("pos", "vel")):
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=tol, err_msg=name)


def test_stack_unstack_roundtrip():
    states = _states()
    batched = ens.stack_states(states)
    assert batched.pos.shape == (3, 32, 3) and ens.batch_size(batched) == 3
    for orig, back in zip(states, ens.unstack_states(batched)):
        for name in FIELDS:
            assert torch.equal(getattr(orig, name), getattr(back, name))
    with pytest.raises(ValueError, match="share N"):
        ens.stack_states([scenarios.make("plummer", 32, device="cpu"),
                          scenarios.make("plummer", 48, device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        ens.stack_states([])


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_fixed_dt_ensemble_matches_jax(dtype):
    want = jens.evolve_ensemble(jens.stack_states(_jax_states()), n_steps=4,
                                dt=1e-2, **_jax_kw(dtype))
    got = ens.evolve_ensemble(ens.stack_states(_states()), n_steps=4,
                              dt=1e-2, dtype=dtype)
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(got.time.numpy(), np.asarray(want.time),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_fixed_dt_ensemble_is_the_sequential_path(dtype):
    """Each member equals its own ``hermite.evolve_scan`` bit for bit: one
    launch per pass serves the whole batch without changing a member's
    arithmetic."""
    states = _states()
    got = ens.evolve_ensemble(ens.stack_states(states), n_steps=4, dt=1e-2,
                              dtype=dtype)
    ev = make_evaluator(dtype=dtype)
    for i, s in enumerate(states):
        ref = hermite.evolve_scan(s, ev, n_steps=4, dt=1e-2)
        for name in FIELDS:
            assert torch.equal(getattr(got, name)[i], getattr(ref, name)), \
                (i, name)


def _drive_adaptive(batched, n_active=None, t_end=0.03, dtype="fp32"):
    b = ens.ensemble_initialize(batched, n_active=n_active, dtype=dtype)
    h = cnt = None
    for _ in range(16):
        b, h, cnt = ens.ensemble_run_adaptive(
            b, t_end=t_end, n_steps=8, h_prev=h, n_taken=cnt,
            n_active=n_active, dtype=dtype)
        if float(b.time.min()) >= t_end:
            break
    return b, h, cnt


@pytest.mark.parametrize("dtype", ("fp64", "fp32", "mixed"))
def test_adaptive_ensemble_matches_jax(dtype):
    jb = jens.ensemble_initialize(jens.stack_states(_jax_states()),
                                  **_jax_kw(dtype))
    jh = jcnt = None
    for _ in range(16):
        jb, jh, jcnt = jens.ensemble_run_adaptive(
            jb, t_end=0.03, n_steps=8, h_prev=jh, n_taken=jcnt,
            **_jax_kw(dtype))
        if float(np.min(np.asarray(jb.time))) >= 0.03:
            break
    got, _, cnt = _drive_adaptive(ens.stack_states(_states()), dtype=dtype)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert (got.time.numpy() == 0.03).all()
    _close(got, jb, TOL[dtype])


@pytest.mark.parametrize("dtype", ("fp64", "fp32"))
def test_adaptive_ensemble_is_the_sequential_path(dtype):
    """Each member carries its own step and equals ``hermite.evolve`` of
    that member alone, bit for bit; the crackle of the last step to 1e-12
    (its 1/h**3 takes h as a Python float in ``evolve``, as a tensor
    here)."""
    states = _states()
    got, _, cnt = _drive_adaptive(ens.stack_states(states), dtype=dtype)
    ev = make_evaluator(dtype=dtype)
    assert len(set(cnt.tolist())) > 1  # the members took their own steps
    for i, s in enumerate(states):
        ref = hermite.evolve(s, ev, t_end=0.03)
        for name in FIELDS:
            if name == "crackle":
                np.testing.assert_allclose(got.crackle[i].numpy(),
                                           ref.crackle.numpy(), rtol=1e-12,
                                           atol=0)
                continue
            assert torch.equal(getattr(got, name)[i], getattr(ref, name)), \
                (i, name)


def _padded_batch(mix=(("king", 24), ("plummer", 16), ("merger", 20)),
                  n_max=None):
    specs = scenarios.make_mix(list(mix))
    batched, n_active = scenarios.build_padded(specs, n_max=n_max,
                                               device="cpu")
    return specs, batched, n_active


def test_padded_matches_unpadded_sequential():
    """Each member of a mixed padded batch reproduces its own unpadded
    sequential integration (zero-mass sources change the summation length
    of the plain version, so to the fp32 tier, as the reference's test)."""
    specs, batched, n_active = _padded_batch()
    out = ens.evolve_ensemble(batched, n_steps=4, dt=1e-2, n_active=n_active)
    ev = make_evaluator()
    for i, spec in enumerate(specs):
        ref = hermite.evolve_scan(spec.build(device="cpu"), ev, n_steps=4,
                                  dt=1e-2)
        n = int(n_active[i])
        np.testing.assert_allclose(out.pos[i, :n].numpy(), ref.pos.numpy(),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(out.vel[i, :n].numpy(), ref.vel.numpy(),
                                   rtol=0, atol=1e-8)


def test_padded_ensemble_matches_jax():
    specs, batched, n_active = _padded_batch()
    jbatched, jn_active = jscenarios.build_padded(
        jscenarios.make_mix([("king", 24), ("plummer", 16), ("merger", 20)]))
    want = jens.evolve_ensemble(jbatched, n_steps=4, dt=1e-2,
                                n_active=jn_active, impl="xla")
    got = ens.evolve_ensemble(batched, n_steps=4, dt=1e-2, n_active=n_active)
    _close(got, want, TOL["fp32"])


def test_padding_rows_stay_frozen():
    _, batched, n_active = _padded_batch()
    out = ens.evolve_ensemble(batched, n_steps=4, dt=1e-2, n_active=n_active)
    for i, n in enumerate(n_active.tolist()):
        for name in ("pos", "vel", "acc", "jerk", "snap", "pot"):
            assert not getattr(out, name)[i, n:].any(), (i, name)
    state, _, _ = _drive_adaptive(batched, n_active, t_end=0.01)
    for i, n in enumerate(n_active.tolist()):
        assert not state.pos[i, n:].any() and not state.acc[i, n:].any()


def test_adaptive_padded_matches_unpadded():
    """Padding does not perturb a member's Aarseth step: the same run,
    padded and unpadded, takes the same steps to the same state."""
    _, unpadded, na_u = _padded_batch((("plummer", 24),))
    _, padded, na_p = _padded_batch((("plummer", 24),), n_max=40)
    out_u, _, cnt_u = _drive_adaptive(unpadded, na_u, t_end=0.0625)
    out_p, _, cnt_p = _drive_adaptive(padded, na_p, t_end=0.0625)
    np.testing.assert_array_equal(cnt_u.numpy(), cnt_p.numpy())
    np.testing.assert_allclose(out_p.pos[0, :24].numpy(),
                               out_u.pos[0].numpy(), rtol=0, atol=1e-7)


def test_energies_are_per_member_and_padding_blind():
    specs, batched, n_active = _padded_batch()
    init = ens.ensemble_initialize(batched, n_active=n_active, dtype="fp64")
    e = ens.batched_total_energy(init)
    q = ens.batched_virial_ratio(init)
    assert e.shape == q.shape == (3,)
    ev = make_evaluator(dtype="fp64")
    for i, spec in enumerate(specs):
        alone = hermite.initialize(spec.build(device="cpu"), ev)
        assert float(e[i]) == pytest.approx(float(nbody.total_energy(alone)),
                                            rel=1e-12)
        ratio = float(nbody.kinetic_energy(alone)
                      / abs(nbody.potential_energy(alone)))
        assert float(q[i]) == pytest.approx(ratio, rel=1e-12)


def test_inputs_are_validated():
    _, batched, _ = _padded_batch()
    with pytest.raises(ValueError, match="n_active must have shape"):
        ens.ensemble_initialize(batched, n_active=[24])
    init = ens.ensemble_initialize(batched)
    with pytest.raises(ValueError, match="t_end must be"):
        ens.ensemble_run_adaptive(init, t_end=[0.1, 0.2], n_steps=1)
    with pytest.raises(ValueError, match="unknown strategy"):
        ens.evolve_ensemble(batched, n_steps=1, dt=1e-2, strategy="bogus")
    # a batch over two CPU slots (B = 3 padded to 4) gives the one-slot bits
    two = ens.evolve_ensemble(batched, n_steps=1, dt=1e-2, devices=2)
    one = ens.evolve_ensemble(batched, n_steps=1, dt=1e-2)
    assert two.pos.shape == one.pos.shape and torch.equal(two.pos, one.pos)
    with pytest.raises(ValueError, match="needs 4 devices; got 1"):
        ens.ensemble_initialize(batched, mesh=(2, 2))
    # a strategy label on a batch only tags it (its members are
    # independent), as in the reference
    tagged = ens.evolve_ensemble(batched, n_steps=1, dt=1e-2,
                                 strategy="ring")
    plain = ens.evolve_ensemble(batched, n_steps=1, dt=1e-2)
    assert torch.equal(tagged.pos, plain.pos)
