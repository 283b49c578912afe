"""Rules the port keeps: it stands alone, it never picks a device for the
caller, and it never hides which path ran."""

import ast
import importlib.util
import inspect
import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import store
from repro_torch.core import evaluate, nbody, strategies
from repro_torch.kernels import (_build, flash_attention, nbody_force,
                                 neighbor, ops)
from repro_torch.launch import nbody_run, quickstart, serve_lm, sim_run
from repro_torch.models import config as lm_config
from repro_torch.models import layers, model, params
from repro_torch.serve import sim_engine
from repro_torch.sim import api, ensemble, scenarios

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flash_mutants.py",
    ROOT / "flash_long_rows.py", ROOT / "ssm_grad_witness.py",
    ROOT / "profile_parity.py"]


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


def test_sim_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    spec = scenarios.Scenario(name="plummer", n=16)
    for call in (lambda: scenarios.make("plummer", 16),
                 lambda: scenarios.build(spec),
                 spec.build,
                 lambda: scenarios.build_padded([spec]),
                 lambda: scenarios.ScenarioSpec.parse("king:16").build(),
                 lambda: quickstart.main([]),
                 lambda: quickstart.run(n=16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert scenarios.make("plummer", 16, device="cpu").device.type == "cpu"


#: the simulation API slice: each mirrors its reference module by path
API_MODULES = ("obs/__init__.py", "obs/metrics.py", "obs/energy.py",
               "obs/trace.py", "sim/telemetry.py", "sim/api.py",
               "sim/driver.py", "launch/sim_run.py")


@pytest.mark.parametrize("rel", API_MODULES)
def test_api_modules_mirror_the_reference_and_stand_alone(rel):
    """Each module exists beside its reference counterpart and is among
    the files the import rule above checks."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path.exists() and (ROOT / "src" / "repro" / rel).exists()
    assert path in PORT_FILES
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_api_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    assert api.SimConfig().device == "cuda"
    cfg = api.SimConfig(n=16, t_end=0.001, dt=0.0005, validate_ic=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run(api.SimConfig(n=16, ensemble=2, t_end=0.001, dt=0.0005,
                              validate_ic=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_run.main(["--n", "16", "--t-end", "0.001", "--no-validate"])
    assert sim_run.main(["--n", "16", "--t-end", "0.001", "--no-validate",
                         "--device", "cpu", "--out", os.devnull]) == 0


def test_ensemble_functions_take_no_device_and_refuse_what_is_not_ported():
    """Below the scenario entry points the batch's device decides; the
    neighbor scheme runs on the CPU, a batch over several CPU slots and the
    fused mesh run too, a device list naming a card that is not there
    raises ``ValueError`` (nothing falls back to the batch's own device),
    and a strategy label on a batch only tags it."""
    for fn in (ensemble.ensemble_initialize, ensemble.ensemble_run,
               ensemble.ensemble_run_adaptive, ensemble.evolve_ensemble,
               ensemble.ensemble_run_block, ensemble.evolve_ensemble_block,
               ensemble.strategy_run_block, ensemble.evolve_strategy_block,
               ensemble.block_admit_member, ensemble.spatial_sort_batched):
        assert "device" not in inspect.signature(fn).parameters, fn.__name__
    state = scenarios.make("plummer", 16, device="cpu")
    out, carry = ensemble.evolve_ensemble_block([state], t_end=0.01,
                                                sources="neighbor")
    assert out.pos.device.type == "cpu" and carry.nbr is not None
    assert int(carry.nbr.n_refresh[0]) > 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # small ops: idle pool threads starve others
    try:
        kw = dict(t_end=1 / 64, dt_max=1 / 64, n_levels=2, n_events=8)
        one, _ = ensemble.evolve_ensemble_block([state], sources="neighbor",
                                                **kw)
        two, _ = ensemble.evolve_ensemble_block([state], sources="neighbor",
                                                devices=2, **kw)
        assert torch.equal(two.pos, one.pos)
        fused, _ = ensemble.evolve_ensemble_block([state], mesh=(1, 1), **kw)
        assert fused.pos.device.type == "cpu"
    finally:
        torch.set_num_threads(threads)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        ensemble.evolve_ensemble([state], n_steps=1, dt=0.01,
                                 devices=[f"cuda:{cards}"] * 2)
    tagged = ensemble.evolve_ensemble([state], n_steps=1, dt=0.01,
                                      strategy="mesh_sharded")
    plain = ensemble.evolve_ensemble([state], n_steps=1, dt=0.01)
    assert torch.equal(tagged.pos, plain.pos)


#: this slice's modules: each mirrors its reference module by path
SLICE_MODULES = ("kernels/neighbor.py", "checkpoint/store.py",
                 "serve/sim_engine.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_neighbor_and_server_modules_mirror_the_reference(rel):
    path = ROOT / "src" / "repro_torch" / rel
    assert path.exists() and (ROOT / "src" / "repro" / rel).exists()
    assert path in PORT_FILES
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_server_defaults_to_cuda_and_raises_without_a_card(no_card):
    assert sim_engine.ServerConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_engine.SimServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_engine.SimServer(sim_engine.ServerConfig(n_max=64, block_i=32))
    cfg = sim_engine.ServerConfig(n_max=64, block_i=32, block_j=32,
                                  device="cpu")
    assert sim_engine.SimServer(cfg).cfg.device == "cpu"
    two = sim_engine.SimServer(sim_engine.ServerConfig(
        n_max=64, block_i=32, devices=2, device="cpu"))
    assert two.cfg.slots() == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_engine.SimServer(sim_engine.ServerConfig(
            n_max=64, block_i=32, devices=2, mesh=(1, 2)))
    with pytest.raises(ValueError, match="covers 4 devices"):
        sim_engine.SimServer(sim_engine.ServerConfig(
            n_max=64, block_i=32, devices=2, mesh=(2, 2), device="cpu"))


def test_neighbor_and_store_functions_take_no_device():
    """The windows, the near evaluator and the store follow their tensors
    (a restored leaf goes to its template's device)."""
    for fn in (neighbor.kd_perm, neighbor.morton_keys,
               neighbor.block_bounds, neighbor.build_windows,
               evaluate.make_neighbor_block_evaluator, store.save,
               store.restore, store.restore_latest):
        assert "device" not in inspect.signature(fn).parameters, fn.__name__


def test_strategies_module_mirrors_the_reference_and_stands_alone():
    path = ROOT / "src" / "repro_torch" / "core" / "strategies.py"
    assert (ROOT / "src" / "repro" / "core" / "strategies.py").exists()
    assert path in PORT_FILES
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_strategies_default_to_every_card_and_raise_without_one(no_card):
    """``devices=None`` is every visible card: without a card the mesh
    raises, as every entry point does; ``["cpu"] * p`` must be asked for."""
    for call in (lambda: strategies.mesh_devices(),
                 lambda: strategies.mesh_devices(2),
                 lambda: strategies.make_strategy_evaluator("ring"),
                 lambda: strategies.make_strategy_block_evaluator(
                     "replicated")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert strategies.mesh_devices(2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nbody_run.main(["--n", "16", "--t-end", "0.001", "--strategy",
                        "ring", "--devices", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_run.main(["--n", "16", "--t-end", "0.001", "--no-validate",
                      "--strategy", "ring", "--devices", "2"])


def test_evaluator_and_wrappers_take_no_device():
    """Below the entry points the tensors' device decides: none of these
    functions has a device to pick."""
    for fn in (evaluate.make_evaluator, evaluate.make_block_evaluator,
               ops.acc_jerk_pot_rect, ops.snap_rect,
               nbody_force.acc_jerk_pot_packed, nbody_force.snap_packed):
        assert "device" not in inspect.signature(fn).parameters, fn.__name__


def test_lm_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    cfg = lm_config.get("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--scale", "0.04"])
    assert serve_lm.main(["--scale", "0.04", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "16",
                          "--gen", "2"]) == 0


def test_flash_wrapper_and_model_functions_take_no_device():
    """Below the LM entry points the tensors' device decides."""
    for fn in (flash_attention.flash_attention, layers.attention,
               layers._attn_dispatch, model.forward, model.prefill,
               model.decode_step):
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
    with FakeTensorMode():
        tgt = torch.empty(8, 8, device="xla")
        src = torch.empty(8, 32, device="xla")
    with pytest.raises(ValueError, match="unsupported device"):
        nbody_force.acc_jerk_pot_packed(tgt, src, block_i=8, block_j=32)
    # meta is the dry-run's path: an empty result, no launch counted
    launches = nbody_force.acc_jerk_pot_packed.launches
    out = nbody_force.acc_jerk_pot_packed(
        torch.zeros(8, 8, device="meta"), torch.zeros(8, 32, device="meta"),
        block_i=8, block_j=32)
    assert out.device.type == "meta" and out.shape == (8, 8)
    assert nbody_force.acc_jerk_pot_packed.launches == launches


def test_build_command_targets_sm_90a():
    cmd = _build.nvcc_command(_build.CSRC / "nbody_force.cu",
                              Path("libnbody_force.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    for flag in ("-shared", "-O3", "-std=c++17", "-fPIC"):
        assert flag in cmd
    for name in ("nbody_force", "flash_attention"):
        assert (_build.CSRC / f"{name}.cu").exists()
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


def _assigned_constant(path, name):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path.name} assigns no {name}")


def test_tile_share_checks_follow_the_kernels_key_tile():
    """The bf16 tile-share check runs the plain version at the kernel's own
    key tile; both copies of that constant must be the kernel's."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    found = re.findall(r"constexpr int kBf16Keys = (\d+);", src)
    assert len(found) == 1, found
    for path in (ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
                 ROOT / "flash_long_rows.py"):
        assert _assigned_constant(path, "KERNEL_KEY_TILE") == int(found[0]), path


def test_flash_mutants_plant_every_fault_in_the_kernel():
    """Each planted fault of flash_mutants.py edits its own kernel (bf16 or
    fp32) as it stands, once per edit, and leaves the other kernel as it
    is."""
    spec = importlib.util.spec_from_file_location(
        "flash_mutants", ROOT / "flash_mutants.py")
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    text = (_build.CSRC / "flash_attention.cu").read_text()
    cut = text.index(mutants.FP32_BANNER)
    assert text.count(mutants.FP32_BANNER) == 1
    musts = {"bf16": 0, "fp32": 0}
    for name, (section, edits, must) in mutants.FAULTS.items():
        out = mutants.mutant_source(text, section, edits)
        assert (out == text) == (not edits), name
        if section == "bf16":
            assert out.endswith(text[cut:]), name
        else:
            assert out.startswith(text[:cut]), name
        musts[section] += must
    assert musts == {"bf16": 6, "fp32": 3}


def _split_constants(prefix):
    src = (_build.CSRC / "nbody_force.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {prefix}{name} = (\d+);", src)
        assert len(found) == 1, (prefix + name, found)
        return int(found[0])

    slices = const("Slices")
    return slices, const("Threads") // slices * const("Per")


def test_snap_cases_follow_the_kernels_split():
    """The on-card snap cases are cut against the kernel's source split:
    both constants of tests/test_torch_cuda.py must be the kernel's."""
    slices, targets = _split_constants("kSnap")
    path = ROOT / "tests" / "test_torch_cuda.py"
    assert _assigned_constant(path, "SNAP_SLICES") == slices
    assert _assigned_constant(path, "SNAP_TARGETS") == targets


def test_acc_jerk_cases_follow_the_kernels_split():
    """The on-card K1 cases are cut against the kernel's source split:
    both constants of tests/test_torch_cuda.py must be the kernel's."""
    slices, targets = _split_constants("kAcc")
    path = ROOT / "tests" / "test_torch_cuda.py"
    assert _assigned_constant(path, "ACC_SLICES") == slices
    assert _assigned_constant(path, "ACC_TARGETS") == targets


def test_nbody_launchers_report_the_grid_they_launch():
    """The grid sizes the wrappers record (``blocks``) are the launchers'
    own: each launcher writes the blocks of the grid it launches, and no
    other."""
    src = (_build.CSRC / "nbody_force.cu").read_text()
    bodies = re.findall(r'extern "C" int (\w+)\(.*?\n}\n', src, re.S)
    assert bodies == ["nbody_acc_jerk_pot", "nbody_snap"]
    for body in re.findall(r'extern "C" int \w+\((.*?)\n}\n', src, re.S):
        assert body.count("*blocks = static_cast<int>(grid.x * grid.y);") == 1
        assert body.count("dim3 grid(") == 1
        assert body.count("<<<grid,") == 2  # the fp32 and the mixed kernel
