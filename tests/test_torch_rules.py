"""Rules the port keeps: it stands alone, it never picks a device for the
caller, and it never hides which path ran."""

import ast
import inspect
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import evaluate, nbody
from repro_torch.kernels import _build, nbody_force, ops
from repro_torch.launch import nbody_run

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


@pytest.fixture
def no_card(monkeypatch):
    """A host without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nbody.plummer(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nbody.two_body_circular()
    arrays = {f: np.zeros(()) for f in nbody.FIELDS}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nbody.state_from_numpy(arrays, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nbody_run.main(["--n", "16", "--t-end", "0.001"])
    assert nbody_run.main(["--n", "16", "--t-end", "0.001",
                           "--device", "cpu"]) == 0


def test_evaluator_and_wrappers_take_no_device():
    """Below the entry points the tensors' device decides: none of these
    functions has a device to pick."""
    for fn in (evaluate.make_evaluator, evaluate.make_block_evaluator,
               ops.acc_jerk_pot_rect, ops.snap_rect,
               nbody_force.acc_jerk_pot_packed, nbody_force.snap_packed):
        assert "device" not in inspect.signature(fn).parameters, fn.__name__


@pytest.fixture
def counts():
    before = (nbody_force.acc_jerk_pot_packed.launches,
              nbody_force.snap_packed.launches)
    nbody_force.acc_jerk_pot_packed.launches = 0
    nbody_force.snap_packed.launches = 0
    yield
    (nbody_force.acc_jerk_pot_packed.launches,
     nbody_force.snap_packed.launches) = before


def test_cpu_tensors_leave_the_launch_counters_at_zero(counts):
    state = nbody.plummer(40, seed=2, device="cpu")
    for dtype in ("fp32", "mixed"):
        ev = evaluate.make_evaluator(block_i=8, block_j=32, dtype=dtype)
        out = ev(state.pos, state.vel, state.mass)
        assert all(x.device.type == "cpu" for x in out)
    r = nbody_run.run(n=16, t_end=0.002, device="cpu")
    assert r["evals"] > 2
    assert nbody_force.acc_jerk_pot_packed.launches == 0
    assert nbody_force.snap_packed.launches == 0


def test_wrappers_refuse_devices_they_have_no_path_for():
    tgt = torch.zeros(8, 8, device="meta")
    src = torch.zeros(8, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nbody_force.acc_jerk_pot_packed(tgt, src, block_i=8, block_j=32)


def test_build_command_targets_sm_90a():
    cmd = _build.nvcc_command(_build.CSRC / "nbody_force.cu",
                              Path("libnbody_force.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    for flag in ("-shared", "-O3", "-std=c++17", "-fPIC"):
        assert flag in cmd
    assert (_build.CSRC / "nbody_force.cu").exists()
    assert _build.BUILD_ROOT == ROOT / "build" / "repro_torch"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_path_follows_the_sources(monkeypatch, tmp_path):
    """The build key changes with the source bytes, so an edited kernel is
    never served from an old library."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build._library_path("k")
    (src / "k.cu").write_text("// two\n")
    assert _build._library_path("k") != first
    assert first.name == "libk.so" and os.fspath(first).startswith(
        os.fspath(_build.BUILD_ROOT))
