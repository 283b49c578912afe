"""Port parity of the training loss and its gradients for the moe, vlm and
audio families: ``repro_torch.models.model.loss_fn`` (ce, the router's aux
loss, z) and every gradient leaf against ``repro.models.model.loss_fn`` and
``jax.grad``, for phi3.5-moe-42b-a6.6b, deepseek-v2-236b, qwen2-vl-2b and
seamless-m4t-medium at scale 0.04 and fp32, on ``SyntheticLM``'s numpy
batches (the frontend's patches or frames included).

Tolerances are tests/test_torch_train.py's: the loss and its metrics
within 1e-6 relative, each gradient leaf within 1e-5 of its largest
element (the same fp32 arithmetic, sums from other libraries, through two
layers and back).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_spec_for
from repro.distributed.shardings import MeshRules
from repro.launch.train import scaled_config as jscaled_config
from repro.models import config as JC
from repro.models import model as JM
from repro.models import params as JP
from repro_torch import tree as tree_util
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import params as P
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step
from repro_torch.train.step import _value_and_grad

RULES = MeshRules.single_device()
SCALE, B, S = 0.04, 2, 32
TOL, LOSS_TOL = 1e-5, 1e-6
ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "qwen2-vl-2b",
         "seamless-m4t-medium")


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _rel(got, want):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_the_reference(arch):
    jcfg = jscaled_config(JC.get(arch), SCALE)
    cfg = scaled_config(C.get(arch), SCALE)
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
    assert _rel(tl, jl) <= LOSS_TOL
    for key in ("ce", "z"):
        assert _rel(tm[key], jm[key]) <= LOSS_TOL, key
    if cfg.family == "moe":
        assert float(tm["aux"]) > 0
        assert _rel(tm["aux"], jm["aux"]) <= LOSS_TOL
    else:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0

    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    tleaves, jleaves = list(tree_util.leaves(tg)), jax.tree.leaves(jg)
    assert len(tleaves) == len(jleaves) == len(
        list(tree_util.leaves(P.param_defs(cfg))))
    for name, t, j in zip(names, tleaves, jleaves):
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
        assert _rel(t, j) <= TOL, (name, _rel(t, j))


def test_moe_remat_modes_give_the_same_loss_and_gradients():
    """none / full / dots recompute the same ops, the routing and the
    capacity dispatch included, so the loss and every gradient are bit for
    bit the same."""
    cfg = scaled_config(C.get("deepseek-v2-236b"), SCALE)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    nb = JSyntheticLM(jscaled_config(JC.get("deepseek-v2-236b"), SCALE),
                      batch_spec_for(cfg, B, 16), seed=2)(0)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()}
    out = {}
    for remat in ("none", "full", "dots"):
        loss, _, grads = _value_and_grad(
            dataclasses.replace(cfg, remat=remat), pp, tb)
        out[remat] = (loss, list(tree_util.leaves(grads)))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_a_stack_of_zero_layers_takes_a_zero_gradient_as_in_the_reference():
    """deepseek-v2 cut to its dense first layer (``n_layers ==
    first_k_dense``): the MoE stack holds zero layers, which the loss never
    reads.  ``jax.grad`` gives those leaves empty gradients and trains the
    rest; the port's loss and every leaf match it, and a whole train step
    (AdamW included) runs at that depth."""
    arch = "deepseek-v2-236b"
    jcfg = dataclasses.replace(jscaled_config(JC.get(arch), SCALE), n_layers=1)
    cfg = dataclasses.replace(scaled_config(C.get(arch), SCALE), n_layers=1)
    assert cfg.n_layers == cfg.first_k_dense
    jp = JP.init_params(jcfg, jax.random.PRNGKey(1))
    nb = JSyntheticLM(jcfg, batch_spec_for(jcfg, B, S), seed=1)(0)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, RULES, p, jb), has_aux=True)(jp)
    tp = P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tl, _, tg = _value_and_grad(cfg, tp, tb)
    assert _rel(tl, jl) <= LOSS_TOL
    empty = 0
    for t, j in zip(tree_util.leaves(tg), jax.tree.leaves(jg)):
        assert tuple(t.shape) == tuple(j.shape)
        if t.numel() == 0:
            empty += 1
            continue
        assert _rel(t, j) <= TOL
    assert empty == len(tp["blocks"])

    opt = AdamW(learning_rate=1e-3)
    params, _, metrics = make_train_step(cfg, opt)(tp, opt.init(tp), tb)
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(x).all()) for x in tree_util.leaves(params))
