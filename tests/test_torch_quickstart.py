"""The port's quickstart (``repro_torch.launch.quickstart``, the counterpart
of ``examples/quickstart.py``) keeps |dE/E| inside the precision tiers of
``benchmarks/bench_ci.py`` on the CPU.

The module's default, Plummer N = 512, takes minutes through the plain
versions on the CPU, so the test runs N = 64; the four legs of 0.25 time
units are the quickstart's own.
"""

import pytest
import torch

from repro_torch.launch import quickstart


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small tensor operations; with the default
    thread pool in each of several test workers, idle pool threads spin
    and starve the other workers, so each test here takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: benchmarks/bench_ci.py DE_TIERS
DE_TIERS = {"fp64": 1e-6, "fp32": 1e-4, "mixed": 1e-3}


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
def test_quickstart_conserves_energy(dtype):
    lines = []
    de = quickstart.run(n=64, dtype=dtype, device="cpu", out=lines.append)
    assert len(lines) == quickstart.LEGS + 1
    assert lines[-1].startswith("t=1.000")
    assert 0 < de <= DE_TIERS[dtype]
