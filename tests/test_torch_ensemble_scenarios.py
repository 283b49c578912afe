"""The port's scenario tour (``repro_torch.launch.ensemble_scenarios``, the
counterpart of ``examples/ensemble_scenarios.py``) held against the
reference example's runs on the CPU, scenario by scenario: n = 32 (each
scenario's minimum where larger, 2 for two_body), an ensemble of 2, to
t = 1/32.  The example's own configuration goes through the reference's
``driver.run`` (as the example builds it: ``impl="xla"``,
``diag_every=16``); the port's through its own ``sim.driver``.

The adaptive step count must be the reference's exactly, and each run's
worst |dE/E| must stay inside the fp32 tier of ``benchmarks/bench_ci.py``.
"""

import pytest
import torch

from repro.sim import driver as jdriver
from repro.sim import scenarios as jscenarios
from repro_torch.launch import ensemble_scenarios as es
from repro_torch.sim import scenarios

N, ENSEMBLE, T_END = 32, 2, 1.0 / 32
#: benchmarks/bench_ci.py DE_TIERS
DE_TIER_FP32 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_reports():
    lines = []
    reports = es.run(n=N, ensemble=ENSEMBLE, t_end=T_END, device="cpu",
                     out=lines.append)
    assert lines[0] == es.HEADER
    assert len(lines) == 1 + len(reports)
    return reports


def test_the_tour_covers_the_reference_registry(port_reports):
    assert tuple(port_reports) == jscenarios.available() \
        == scenarios.available()


@pytest.mark.parametrize("name", scenarios.available())
def test_each_scenario_matches_the_example(name, port_reports):
    n = max(N, jscenarios.get_spec(name).min_n) if name != "two_body" else 2
    assert es.scenario_n(name, N) == n
    ref = jdriver.run(jdriver.SimConfig(
        scenario=name, n=n, ensemble=ENSEMBLE, t_end=T_END, devices=1,
        impl="xla", diag_every=16))
    got = port_reports[name]
    assert got["steps"] == ref["steps"]
    assert got["n_bodies"] == ref["n_bodies"] and got["ensemble"] == ENSEMBLE
    assert 0 <= got["de_rel"] <= DE_TIER_FP32
    assert 0 <= ref["de_rel"] <= DE_TIER_FP32
