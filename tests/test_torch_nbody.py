"""Port parity: ``repro_torch.core.nbody`` against ``repro.core.nbody``.

Both packages run on the CPU; data crosses between them as numpy arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nbody as jnbody
from repro.core.evaluate import make_evaluator as jax_make_evaluator
from repro.core.hermite import initialize as jax_initialize
from repro_torch.core import nbody


def _numpy_fields(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("n,seed", [(1, 0), (16, 42), (64, 0), (257, 3),
                                    (1000, 123)])
def test_plummer_initial_conditions_bitwise(n, seed):
    """Same numpy generator, same draws in the same order: the initial
    conditions are bitwise those of the reference."""
    want = jnbody.plummer(n, seed=seed)
    got = nbody.plummer(n, seed=seed, device="cpu")
    for name in ("pos", "vel", "mass"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    for name in ("acc", "jerk", "snap", "crackle", "pot"):
        assert not getattr(got, name).any()
    assert float(got.time) == 0.0 and got.time.dim() == 0


def test_plummer_float32_matches_reference_cast():
    want = jnbody.plummer(100, seed=5, dtype=jnp.float32)
    got = nbody.plummer(100, seed=5, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.vel.numpy(), np.asarray(want.vel))


def test_two_body_circular_matches():
    want = _numpy_fields(jnbody.two_body_circular())
    got = nbody.two_body_circular(device="cpu")
    for name in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name])


@pytest.mark.parametrize("n,seed", [(32, 0), (200, 9)])
def test_energies_agree(n, seed):
    """Kinetic, potential, total and per-particle energies of one state
    (the reference's, after its fp64 initialize, so the potential is set)
    agree to 1e-14 relative: the same float64 sums in other orders."""
    jstate = jax_initialize(jnbody.plummer(n, seed=seed),
                            jax_make_evaluator(precision="fp64"))
    state = nbody.state_from_numpy(_numpy_fields(jstate), device="cpu")
    for fn in ("kinetic_energy", "potential_energy", "total_energy"):
        want = float(getattr(jnbody, fn)(jstate))
        got = float(getattr(nbody, fn)(state))
        assert abs(got - want) <= 1e-14 * abs(want), (fn, got, want)
    want = np.asarray(jnbody.particle_energies(jstate))
    got = nbody.particle_energies(state).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


def test_state_from_numpy_round_trips():
    jstate = jnbody.plummer(48, seed=1)
    arrays = _numpy_fields(jstate)
    state = nbody.state_from_numpy(arrays, device="cpu")
    assert state.n == 48 and state.dtype == torch.float64
    assert state.device == torch.device("cpu")
    back = {f.name: getattr(state, f.name).numpy()
            for f in dataclasses.fields(state)}
    for name, want in arrays.items():
        assert back[name].dtype == want.dtype
        assert back[name].shape == want.shape
        np.testing.assert_array_equal(back[name], want)
    # the port's state owns its memory: writing it leaves the input alone
    state.pos[0, 0] += 1.0
    assert arrays["pos"][0, 0] == np.asarray(jstate.pos)[0, 0]


def test_state_from_numpy_requires_every_field():
    arrays = _numpy_fields(jnbody.plummer(8, seed=0))
    del arrays["crackle"]
    with pytest.raises(ValueError, match="crackle"):
        nbody.state_from_numpy(arrays, device="cpu")
