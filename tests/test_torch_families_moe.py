"""Port parity of the moe family's serve path (phi3.5-moe-42b-a6.6b, and
deepseek-v2-236b with MLA) at scale 0.04: ``tests/test_torch_families.py``'s
check, in a file of its own so that each file stays near a minute on one
worker (the bf16 cases run the reference eagerly to record its routing).
"""

import pytest
import torch

from test_torch_families import cases, serve_parity


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,dtype,impl",
                         cases(("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")))
def test_moe_family_serves_as_the_reference(arch, dtype, impl, monkeypatch):
    serve_parity(arch, dtype, impl, monkeypatch)
