"""Port parity of the trainer and the training launchers:
``repro_torch.train.Trainer`` against ``repro.train.Trainer``.

A checkpoint either package's trainer writes (the tree ``{"params",
"opt"}``, the reference's leaf names and dtypes) resumes in the other,
and the continuation's losses are held to the writer's own continuation.
The launchers run in-process on the CPU.  The reference's trainer tests
(``tests/test_substrate.py``) are mirrored on the port.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.distributed.shardings import MeshRules
from repro.models.config import ArchConfig as JArchConfig
from repro.optim import AdamW as JAdamW
from repro.train import StragglerMonitor as JStragglerMonitor
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import store
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_lm
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamW
from repro_torch.train import StragglerMonitor, Trainer, TrainerConfig

RULES = MeshRules.single_device()
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_chunked_above=10 ** 9,
            dtype="float32")
#: the continuation's losses, port vs reference, relative: both resume the
#: same bits and run fp32 steps whose sums differ in order; Adam spreads
#: that noise over the parameters (tests/test_torch_train.py), measured
#: <= 1.5e-7 over two steps
LOSS_TOL = 1e-6


def _fixed_data():
    rng = np.random.default_rng(0)
    fixed = rng.integers(0, 256, size=(4, 33), dtype=np.int32)
    return lambda step: {"tokens": fixed[:, :-1], "labels": fixed[:, 1:]}


def _quiet(_):
    return None


def _port_trainer(ckpt, steps, ckpt_every=10):
    return Trainer(ArchConfig(**TINY), AdamW(learning_rate=3e-3), _fixed_data(),
                   TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=str(ckpt), log_every=1000),
                   device="cpu", log=_quiet)


def _jax_trainer(ckpt, steps, ckpt_every=10):
    return JTrainer(JArchConfig(**TINY), RULES, JAdamW(learning_rate=3e-3),
                    _fixed_data(),
                    JTrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                   ckpt_dir=str(ckpt), log_every=1000),
                    log=_quiet)


def _losses(history):
    return [(h["step"], h["loss"]) for h in history]


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """One package trains steps 0-9 and checkpoints at step 10; each
    package resumes a copy to step 12.  The reader starts at step 10 and
    its losses follow the writer's own continuation."""
    make = {"jax": _jax_trainer, "port": _port_trainer}
    reader = "port" if writer == "jax" else "jax"
    ckpt = tmp_path / "ckpt"
    make[writer](ckpt, 10).run()
    assert store.available_steps(str(ckpt)) == [10]
    shutil.copytree(ckpt, tmp_path / "copy")
    _, _, own = make[writer](ckpt, 12).run()
    _, _, other = make[reader](tmp_path / "copy", 12).run()
    assert [s for s, _ in _losses(other)] == [10, 11] == [
        s for s, _ in _losses(own)]
    for (_, a), (_, b) in zip(_losses(other), _losses(own)):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    # the two packages wrote the same leaves under the same names and dtypes
    assert jstore.available_steps(str(ckpt)) == store.available_steps(
        str(tmp_path / "copy")) == [10, 12]
    files = [sorted(os.listdir(d / "step_00000012"))
             for d in (ckpt, tmp_path / "copy")]
    assert files[0] == files[1]
    assert "opt__count.npy" in files[0] and "params__embed.npy" in files[0]
    for d in (ckpt, tmp_path / "copy"):
        assert np.load(d / "step_00000012" / "opt__count.npy").dtype == np.int32


def test_the_restored_state_is_the_saved_state(tmp_path):
    t1 = _port_trainer(tmp_path, 4, ckpt_every=2)
    params, opt_state, _ = t1.run()
    step, p2, o2 = _port_trainer(tmp_path, 6).restore_or_init()
    assert step == 4
    assert o2.count.dtype == torch.int32 and int(o2.count) == 4
    for a, b in zip(store._flatten({"p": params, "o": opt_state}).values(),
                    store._flatten({"p": p2, "o": o2}).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_straggler_monitor_matches_the_reference():
    rng = np.random.default_rng(3)
    times = list(0.1 + 0.01 * rng.standard_normal(40))
    times[12] = times[30] = 0.9
    port, ref = StragglerMonitor(warmup=3), JStragglerMonitor(warmup=3)
    assert [port.observe(t) for t in times] == [ref.observe(t) for t in times]
    assert (port.flagged, port.count) == (ref.flagged, ref.count) == (2, 40)
    assert port.mean == ref.mean and port.var == ref.var


def test_train_cli_runs_in_process(tmp_path, capsys):
    rc = train_cli.main(["--arch", "qwen3-0.6b", "--scale", "0.04", "--steps",
                         "4", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[train.py] done: 4 steps, final loss" in out
    assert store.available_steps(str(tmp_path)) == [2, 4]


def test_train_lm_preset_runs_in_process(capsys):
    assert train_lm.main(["--preset", "10m", "--steps", "3",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[train_lm] qwen3-10m:" in out and "final loss" in out
    loss = float(out.split("final loss ")[1].split()[0])
    assert np.isfinite(loss)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ArchConfig(**TINY), AdamW(), _fixed_data(), TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1"])


# ------------------------------------ the reference's tests, on the port
def test_trainer_learns_and_resumes(tmp_path):
    _, _, hist = _port_trainer(tmp_path, 30).run()
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8
    _, _, h2 = _port_trainer(tmp_path, 32).run()
    assert h2[0]["step"] == 30   # resumed, not restarted


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(warmup=3, k=3.0)
    flagged = [mon.observe(t) for t in
               [0.10, 0.11, 0.10, 0.10, 0.11, 0.10, 0.95, 0.10]]
    assert flagged[6] is True
    assert sum(flagged) == 1
    assert mon.flagged == 1
