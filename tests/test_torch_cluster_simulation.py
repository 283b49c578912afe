"""The port's cluster simulation (``repro_torch.launch.cluster_simulation``,
the counterpart of ``examples/cluster_simulation.py``) held against the
reference example on the CPU: Plummer N = 64 to t = 1/16 at dt = 1/256,
single in process and ``replicated`` over two devices, where the example
runs in a subprocess because its ``--devices`` sets ``XLA_FLAGS`` before
JAX is imported.

Both runs keep |dE/E| inside the fp32 tier of ``benchmarks/bench_ci.py``
and the energy-distribution overlap (Fig. 4) within 0.02 of the
example's; the port's replicated run gives its single run's bits.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import cluster_simulation as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "cluster_simulation.py")
N, T_END, DT = 64, 1.0 / 16, 1.0 / 256
ARGS = ["--n", str(N), "--t-end", str(T_END), "--dt", str(DT)]
#: benchmarks/bench_ci.py DE_TIERS
DE_TIER_FP32 = 1e-4
OVERLAP_TOL = 0.02


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one thread per test worker, as
    tests/test_torch_quickstart.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(text):
    """(|dE/E|, overlap) from the example's ``[sim]`` and ``[validate]``
    lines."""
    de = float(re.search(r"\|dE/E\|=([0-9.e+-]+)", text).group(1))
    overlap = float(re.search(r"FP64 golden: ([0-9.]+)", text).group(1))
    return de, overlap


def _example_in_process(argv):
    spec = importlib.util.spec_from_file_location("_cluster_example", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [EXAMPLE] + argv
    try:
        with contextlib.redirect_stdout(buf):
            assert mod.main() == 0
    finally:
        sys.argv = saved
    return _parse(buf.getvalue())


def _example_subprocess(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, EXAMPLE] + argv, env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return _parse(out.stdout)


def _port(**kw):
    lines = []
    r = cs.run(n=N, t_end=T_END, dt=DT, device="cpu", out=lines.append, **kw)
    assert lines[0].startswith(f"[sim] N={N}")
    assert len(lines) == (2 + cs.BINS if kw.get("validate", True) else 1)
    return r


def _hold(r, ref_de, ref_overlap):
    assert abs(float(r["state"].time) - T_END) < 1e-12
    assert 0 < r["de_rel"] <= DE_TIER_FP32
    assert 0 < ref_de <= DE_TIER_FP32
    assert abs(r["overlap"] - ref_overlap) <= OVERLAP_TOL
    assert r["hist"].shape == r["hist_golden"].shape == (cs.BINS,)
    assert r["golden_state"].pos.dtype == torch.float64


def test_single_matches_the_example():
    ref_de, ref_overlap = _example_in_process(ARGS)
    _hold(_port(), ref_de, ref_overlap)


def test_replicated_matches_the_example_and_the_single_run_bit_for_bit():
    ref_de, ref_overlap = _example_subprocess(
        ARGS + ["--strategy", "replicated", "--devices", "2"])
    rep = _port(strategy="replicated", devices=2)
    _hold(rep, ref_de, ref_overlap)
    single = _port(validate=False)
    for f in ("pos", "vel", "acc", "jerk", "snap"):
        assert torch.equal(getattr(rep["state"], f),
                           getattr(single["state"], f)), f


def test_the_launcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.main(ARGS)
    with pytest.raises(ValueError, match="unknown strategy"):
        cs.run(strategy="bogus", device="cpu")
