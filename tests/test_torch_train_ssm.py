"""Port parity of the training loss and its gradients for the ssm
(xlstm-1.3b) and hybrid (zamba2-7b, with and without a tail) families at
scale 0.04 and fp32: ``repro_torch.models.model.loss_fn`` and every
gradient leaf against ``repro.models.model.loss_fn`` and ``jax.grad`` on
``SyntheticLM``'s numpy batches, in chunks of 8 (four per sequence), and
the three remat modes bit for bit.

Tolerances are tests/test_torch_train_families.py's: the loss and its
metrics within 1e-6 relative, each gradient leaf within 1e-5 of its
largest element (the same fp32 arithmetic, sums from other libraries,
through the scans and back).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_spec_for
from repro.models import model as JM
from repro.models import params as JP
from repro_torch import tree as tree_util
from repro_torch.models import params as P
from repro_torch.train.step import _value_and_grad
from test_torch_families import RULES, _rel
from test_torch_families_ssm import B, RUNS, S, _configs

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


@pytest.mark.parametrize("run", list(RUNS))
def test_loss_and_every_gradient_leaf_match_the_reference(run):
    jcfg, cfg = _configs(run)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(1))
    nb = JSyntheticLM(jcfg, batch_spec_for(jcfg, B, S), seed=1)(0)
    nb["labels"][:, 3] = -1                 # a masked label in each row
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, RULES, p, jb), has_aux=True)(jp)
    tl, tm, tg = _value_and_grad(
        cfg, P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
        tb)
    assert float(tm["tokens"]) == float(jm["tokens"]) == nb["labels"].size - B
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    for key in ("ce", "z"):
        assert abs(float(tm[key]) - float(jm[key])) <= LOSS_TOL * abs(
            float(jm[key])), key
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    tleaves, jleaves = list(tree_util.leaves(tg)), jax.tree.leaves(jg)
    assert len(tleaves) == len(jleaves) == len(
        list(tree_util.leaves(P.param_defs(cfg))))
    for name, t, j in zip(names, tleaves, jleaves):
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
        assert _rel(t.detach(), j) <= GRAD_TOL, name


@pytest.mark.parametrize("run", ["xlstm", "zamba2-tail"])
def test_remat_modes_give_the_same_loss_and_gradients(run):
    """none / full / dots recompute the same ops in the Mamba2, mLSTM and
    sLSTM blocks and the shared block, so the loss and every gradient are
    bit for bit the same."""
    _, cfg = _configs(run)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 16))
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    out = {}
    for remat in ("none", "full", "dots"):
        loss, _, grads = _value_and_grad(
            dataclasses.replace(cfg, remat=remat), pp, tb)
        out[remat] = (loss, list(tree_util.leaves(grads)))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
