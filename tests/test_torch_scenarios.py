"""Port parity: ``repro_torch.sim.scenarios`` against ``repro.sim.scenarios``.

The generators are the same numpy code drawing the same numbers in the same
order, so every initial state must equal the reference's bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.sim import scenarios as jscenarios
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



def _assert_state_equal(got, want):
    for name in ("pos", "vel", "mass"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("acc", "jerk", "snap", "crackle", "pot"):
        assert not getattr(got, name).any(), name


def test_registry_matches_the_reference():
    assert scenarios.available() == jscenarios.available()
    for name in scenarios.available():
        mine, ref = scenarios.get_spec(name), jscenarios.get_spec(name)
        assert (mine.equilibrium, mine.rescale, mine.min_n,
                dict(mine.defaults)) == (ref.equilibrium, ref.rescale,
                                         ref.min_n, dict(ref.defaults)), name


def _sizes(name):
    if name == "two_body":
        return [(2, 0), (2, 5)]
    return [(48, 0), (130, 7)]


@pytest.mark.parametrize("name,n,seed", [
    (name, n, seed) for name in jscenarios.available()
    for n, seed in _sizes(name)])
def test_generators_bitwise(name, n, seed):
    want = jscenarios.make(name, n, seed=seed)
    got = scenarios.make(name, n, seed=seed, device="cpu")
    _assert_state_equal(got, want)
    assert float(got.time) == 0.0 and got.time.dim() == 0


@pytest.mark.parametrize("name,params", [
    ("king", {"w0": 3.0}),
    ("king", {"w0": 9.0}),
    ("cold_collapse", {"virial_ratio": 0.2}),
    ("merger", {"separation": 6.0, "impact_parameter": 1.0,
                "v_scale": 0.5}),
    ("binary_plummer", {"binary_frac": 0.5, "sma": 0.01}),
    ("kepler_disk", {"m_central": 0.9, "r_in": 0.2, "aspect": 0.05}),
])
def test_generators_bitwise_at_other_params(name, params):
    want = jscenarios.make(name, 64, seed=3, **params)
    got = scenarios.make(name, 64, seed=3, device="cpu", **params)
    _assert_state_equal(got, want)


def test_float32_state_is_the_reference_cast():
    want = jscenarios.make("king", 40, seed=1, dtype=np.float32)
    got = scenarios.make("king", 40, seed=1, dtype=torch.float32,
                         device="cpu")
    _assert_state_equal(got, want)


@pytest.mark.parametrize("name", ["king", "merger", "kepler_disk"])
def test_diagnostics_match(name):
    want = jscenarios.state_diagnostics(jscenarios.make(name, 64, seed=2))
    got = scenarios.state_diagnostics(
        scenarios.make(name, 64, seed=2, device="cpu"))
    assert got == want


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_threaded_potential_is_the_reference_loop_bit_for_bit(
        threads, monkeypatch):
    """The blocks run on threads and their shares are added in block
    order: the bits of the reference's serial loop, at three blocks (the
    last one partial) with two bodies at one point (r = 0)."""
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(2500, 3))
    pos[7] = pos[1900]
    mass = rng.uniform(0.5, 1.5, size=2500) / 2500
    monkeypatch.setattr(scenarios, "_POTENTIAL_THREADS", threads)
    assert scenarios._pairwise_potential(pos, mass) == \
        jscenarios._pairwise_potential(pos, mass)


@pytest.mark.parametrize("token", ["king:256", "king", "plummer:1",
                                   "nope:12", "king:abc", "king:",
                                   "merger:8", "two_body:2", ":4"])
def test_spec_parse_matches(token):
    try:
        want = jscenarios.ScenarioSpec.parse(token, seed=4)
    except jscenarios.ScenarioError as e:
        with pytest.raises(scenarios.ScenarioError) as got:
            scenarios.ScenarioSpec.parse(token, seed=4)
        assert str(got.value) == str(e)
        return
    got = scenarios.ScenarioSpec.parse(token, seed=4)
    assert (got.name, got.n, got.seed, dict(got.params)) == (
        want.name, want.n, want.seed, dict(want.params))
    assert got.format() == want.format() == (
        token if ":" in token else token.split(":")[0])
    assert scenarios.parse_mix_token(token) == \
        jscenarios.parse_mix_token(token)


@pytest.mark.parametrize("kw", [
    dict(name="", n=8), dict(name="king", n=1), dict(name="king", n=8.0),
    dict(name="king", n=True), dict(name="king", n=8, seed=-1),
    dict(name="king", n=8, seed=1.5), dict(name="king", n=8,
                                           params={"bogus": 1}),
    dict(name="king", n=8, params={"w0": 4.0}), dict(name="king", n=None),
])
def test_spec_validate_matches(kw):
    try:
        jscenarios.ScenarioSpec(**kw).validate()
    except jscenarios.ScenarioError as e:
        with pytest.raises(scenarios.ScenarioError) as got:
            scenarios.ScenarioSpec(**kw).validate()
        assert str(got.value) == str(e)
        return
    scenarios.ScenarioSpec(**kw).validate()


def test_spec_build_and_with_n():
    spec = scenarios.ScenarioSpec.parse("king", seed=2).with_n(32)
    assert spec.format() == "king:32"
    with pytest.raises(scenarios.ScenarioError, match="unset"):
        scenarios.ScenarioSpec.parse("king").scenario()
    _assert_state_equal(
        spec.build(device="cpu"),
        jscenarios.ScenarioSpec.parse("king", seed=2).with_n(32).build())


@pytest.mark.parametrize("name,n,params", [
    ("two_body", 3, {}), ("merger", 8, {}), ("king", 16, {"w0": 20.0}),
    ("king", 16, {"zz": 1}), ("kepler_disk", 16, {"r_in": 2.0}),
    ("cold_collapse", 16, {"virial_ratio": 1.5}), ("nope", 16, {}),
])
def test_build_errors_match(name, n, params):
    with pytest.raises(jscenarios.ScenarioError) as want:
        jscenarios.make(name, n, **params)
    with pytest.raises(scenarios.ScenarioError) as got:
        scenarios.make(name, n, device="cpu", **params)
    assert str(got.value) == str(want.value)


def test_build_padded_shapes_and_n_active():
    mix = [("king", 24), ("plummer", 16), ("merger", 32)]
    specs = scenarios.make_mix(mix, seed=5, repeat=2)
    jspecs = jscenarios.make_mix(mix, seed=5, repeat=2)
    assert [(s.name, s.n, s.seed) for s in specs] == \
        [(s.name, s.n, s.seed) for s in jspecs]
    assert [s.seed for s in specs] == list(range(5, 11))
    batched, n_active = scenarios.build_padded(specs, device="cpu")
    jbatched, jn_active = jscenarios.build_padded(jspecs)
    assert batched.pos.shape == (6, 32, 3) and batched.mass.shape == (6, 32)
    assert batched.time.shape == (6,)
    assert n_active.dtype == torch.int32
    np.testing.assert_array_equal(n_active.numpy(), np.asarray(jn_active))
    for name in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(getattr(batched, name).numpy(),
                                      np.asarray(getattr(jbatched, name)))
    assert not batched.mass[1, 16:].any() and not batched.pos[0, 24:].any()


def test_build_padded_explicit_n_max_and_errors():
    specs = [scenarios.Scenario(name="plummer", n=8, seed=1)]
    batched, n_active = scenarios.build_padded(specs, n_max=20, device="cpu")
    assert batched.pos.shape == (1, 20, 3) and int(n_active[0]) == 8
    with pytest.raises(scenarios.ScenarioError, match="below the largest"):
        scenarios.build_padded(specs, n_max=4, device="cpu")
    with pytest.raises(scenarios.ScenarioError, match="at least one"):
        scenarios.build_padded([], device="cpu")
    with pytest.raises(scenarios.ScenarioError, match="cannot pad"):
        scenarios.pad_state(scenarios.make("plummer", 16, device="cpu"), 4)


def test_make_mix_params_by_name():
    specs = scenarios.make_mix([("king", 16), ("plummer", 8)], seed=1,
                               params={"king": {"w0": 3.0}})
    assert dict(specs[0].params) == {"w0": 3.0} and not specs[1].params
    _assert_state_equal(specs[0].build(device="cpu"),
                        jscenarios.make("king", 16, seed=1, w0=3.0))
