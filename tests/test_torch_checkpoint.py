"""Port parity: ``repro_torch.checkpoint.store`` against
``repro.checkpoint.store``.

Block carries (with the neighbor carry) round-trip exactly, every leaf's
dtype kept; a template whose dtype or shape differs raises instead of
casting; and a checkpoint either package writes restores in the other,
leaf for leaf, under the reference's leaf names and manifest.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.sim import ensemble as jens
from repro.sim import scenarios as jscenarios
from repro_torch.checkpoint import store
from repro_torch.core.nbody import FIELDS
from repro_torch.sim import ensemble as ens
from repro_torch.sim import scenarios

_KW = dict(t_end=0.02, n_events=4, dt_max=0.0625, n_levels=4, eta=0.02,
           order=6, eps=1e-7, block_i=16, block_j=16)


def _port_tree(sources):
    state = ens.stack_states(
        [scenarios.pad_state(scenarios.make("plummer", 24, device="cpu"), 32),
         scenarios.pad_state(scenarios.make("two_body", 2, device="cpu"),
                             32)])
    na = [24, 2]
    state = ens.ensemble_initialize(state, n_active=na)
    state, carry = ens.ensemble_run_block(state, n_active=na,
                                          sources=sources, **_KW)
    return {"state": state, "carry": carry,
            "n_active": torch.tensor(na, dtype=torch.int32)}


def _jax_tree(sources):
    state = jens.stack_states(
        [jscenarios.pad_state(jscenarios.make("plummer", 24), 32),
         jscenarios.pad_state(jscenarios.make("two_body", 2), 32)])
    na = jnp.asarray([24, 2], jnp.int32)
    state = jens.ensemble_initialize(state, n_active=na, impl="xla")
    state, carry = jens.ensemble_run_block(state, n_active=na, impl="xla",
                                           sources=sources, **_KW)
    return {"state": state, "carry": carry, "n_active": na}


def _leaves(tree):
    return store._flatten(tree)


@pytest.mark.parametrize("sources", ("full", "neighbor"))
def test_block_carry_round_trips_exactly(tmp_path, sources):
    tree = _port_tree(sources)
    path = store.save(str(tmp_path), 5, tree)
    assert os.path.basename(path) == "step_00000005"
    like = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}
    like["carry"] = ens.BlockCarry(*(
        None if x is None else
        ens.NeighborCarry(*(torch.zeros_like(y) for y in x))
        if isinstance(x, tuple) else torch.zeros_like(x)
        for x in tree["carry"]))
    like["state"] = type(tree["state"])(**{
        f: torch.zeros_like(getattr(tree["state"], f)) for f in FIELDS})
    step, back = store.restore_latest(str(tmp_path), like)
    assert step == 5
    assert isinstance(back["carry"], ens.BlockCarry)
    assert (back["carry"].nbr is None) == (sources == "full")
    want, got = _leaves(tree), _leaves(back)
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert torch.equal(want[k], got[k]), k
    assert back["carry"].n_tiles.dtype == torch.float64
    assert back["carry"].n_events.dtype == torch.int32


def test_restore_refuses_dtype_and_shape_mismatch(tmp_path):
    carry = _port_tree("full")["carry"]
    store.save(str(tmp_path), 1, {"carry": carry})
    narrow = carry._replace(n_tiles=carry.n_tiles.to(torch.float32))
    with pytest.raises(ValueError, match="restore never casts"):
        store.restore(str(tmp_path), 1, {"carry": narrow})
    wrong = carry._replace(t_last=torch.zeros(3, 32, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), 1, {"carry": wrong})
    with pytest.raises(KeyError, match="missing leaf"):
        store.restore(str(tmp_path), 1, {"other": carry.t_last})


def test_keep_prunes_and_staging_is_atomic(tmp_path):
    tree = {"x": torch.arange(4)}
    for step in range(5):
        store.save(str(tmp_path), step, tree, keep=2)
    assert store.available_steps(str(tmp_path)) == [3, 4]
    # a staging directory left by a crash is not a checkpoint
    os.makedirs(tmp_path / ".tmp-step_00000009")
    os.makedirs(tmp_path / "step_00000010")     # no manifest: incomplete
    assert store.available_steps(str(tmp_path)) == [3, 4]
    assert store.restore_latest(str(tmp_path / "none"), tree) == (None,
                                                                  None)


@pytest.mark.parametrize("sources", ("full", "neighbor"))
def test_the_packages_read_each_others_checkpoints(tmp_path, sources):
    """The same leaf names, files and manifest: a checkpoint the JAX store
    wrote restores in the port into the port's tree (values exact), and
    the reverse."""
    port, ref = _port_tree(sources), _jax_tree(sources)
    jstore.save(str(tmp_path / "jax"), 3, ref)
    store.save(str(tmp_path / "port"), 3, port)
    with open(tmp_path / "jax" / "step_00000003" / "manifest.json") as f:
        jman = json.load(f)
    with open(tmp_path / "port" / "step_00000003" / "manifest.json") as f:
        pman = json.load(f)
    assert jman["leaves"].keys() == pman["leaves"].keys()
    for k, meta in jman["leaves"].items():
        assert pman["leaves"][k] == meta, k

    # JAX wrote, the port restores into its own tree
    back = store.restore(str(tmp_path / "jax"), 3, port)
    for k, leaf in _leaves(back).items():
        assert isinstance(leaf, torch.Tensor)
        np.testing.assert_array_equal(
            leaf.numpy(), np.asarray(jstore._flatten(ref)[k]))
    # the port wrote, JAX restores into its own tree
    jback = jstore.restore(str(tmp_path / "port"), 3, ref)
    for k, leaf in jstore._flatten(jback).items():
        assert isinstance(leaf, jax.Array)
        np.testing.assert_array_equal(np.asarray(leaf),
                                      _leaves(port)[k].numpy())
