"""Port parity of the optimizer: ``repro_torch.optim`` against
``repro.optim`` on the same trees, plus the reference's own optimizer
tests (``tests/test_substrate.py``) mirrored on the port.

Trees are made from a seed with numpy and handed to both packages.  The
reference runs eagerly here, op by op, as its tests call it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import global_norm as jglobal_norm
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import tree as tree_util
from repro_torch.optim import AdamW, AdamWState, apply_updates, global_norm
from repro_torch.optim import warmup_cosine

#: one step of AdamW, port vs reference, max |port - ref| / max |ref| per
#: leaf: the same fp32 arithmetic, with pow, sqrt and the sums of
#: global_norm from other libraries (measured <= 2.6e-7 over 5 steps)
TOL = 1e-6


def _tree(rng, n_layers=3, d=16, vocab=40):
    """Matrices, stacked per-layer norm weights (2-D) and a 1-D norm, with
    the LM's keys."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": a(vocab, d), "final_norm": 1 + 0.1 * a(d),
            "blocks": {"ln1": 1 + 0.1 * a(n_layers, d), "q": a(n_layers, d, d),
                       "wd": a(n_layers, 2 * d, d)}}


def _torch(tree):
    return tree_util.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pairs(ttree, jtree):
    return list(zip(tree_util.leaves(ttree), jax.tree.leaves(jtree)))


def test_warmup_cosine_matches_the_reference_to_the_ulp():
    """Warmup steps equal the reference's bits.  On the cosine, the two
    libraries' float32 cos may differ by an ulp (2**-24 below 1), which
    ``(1 - floor) * peak * 0.5 * (1 + cos)`` carries into lr; beyond that,
    two roundings (measured: at most 2 ulps of lr, at step 82)."""
    peak = 3e-4
    for kw in (dict(warmup=10, total=100, floor=0.1), dict(warmup=0, total=7),
               dict(warmup=100, total=10_000, floor=0.1)):
        jlr, lr = jwarmup_cosine(peak, **kw), warmup_cosine(peak, **kw)
        cos_ulp = (1 - kw.get("floor", 0.1)) * peak * 0.5 * 2.0 ** -24
        for step in range(121):
            want = np.float32(jlr(step))
            for arg in (step, torch.tensor(step, dtype=torch.int32)):
                got = lr(arg)
                assert got.dtype == torch.float32 and got.shape == ()
                got = np.float32(got)
                if step < kw["warmup"]:
                    assert got == want, (kw, step)
                else:
                    assert abs(got - want) <= cos_ulp + 2 * np.spacing(want), (
                        kw, step)


def test_global_norm_clip_and_five_updates_match_the_reference():
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    opt = AdamW(learning_rate=warmup_cosine(1e-2, warmup=2, total=10),
                clip_norm=1.0)
    jopt = JAdamW(learning_rate=jwarmup_cosine(1e-2, warmup=2, total=10),
                  clip_norm=1.0)
    tp, jp = _torch(p0), _jax(p0)
    ts, js = opt.init(tp), jopt.init(jp)
    assert ts.count.dtype == torch.int32 and ts.count.shape == ()
    for step in range(5):
        # gradients large enough that clipping acts on the odd steps
        g = _tree(rng)
        g = tree_util.map(lambda x: x * (3.0 if step % 2 else 0.01), g)
        assert _rel(global_norm(_torch(g)), jglobal_norm(_jax(g))) <= TOL
        tu, ts, tm = opt.update(_torch(g), ts, tp)
        ju, js, jm = jopt.update(_jax(g), js, jp)
        assert _rel(tm["gnorm"], jm["gnorm"]) <= TOL
        assert float(tm["lr"]) == float(jm["lr"])
        for t, j in _pairs(tu, ju) + _pairs(ts.m, js.m) + _pairs(ts.v, js.v):
            assert t.dtype == torch.float32
            assert _rel(t, j) <= TOL
        tp = apply_updates(tp, tu)
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        for t, j in _pairs(tp, jp):
            assert _rel(t, j) <= TOL
        assert int(ts.count) == int(js.count) == step + 1


def test_weight_decay_follows_the_stacked_leaf_rule():
    """With zero gradients the update is the decay alone: -lr * wd * p on
    every leaf of two or more dimensions, the stacked norm weights
    ``blocks.ln1`` included, and 0 on ``final_norm``."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    zeros = tree_util.map(np.zeros_like, p0)
    opt = AdamW(learning_rate=0.5, weight_decay=0.1)
    jopt = JAdamW(learning_rate=0.5, weight_decay=0.1)
    tu, _, _ = opt.update(_torch(zeros), opt.init(_torch(p0)), _torch(p0))
    ju, _, _ = jopt.update(_jax(zeros), jopt.init(_jax(p0)), _jax(p0))
    lr_wd = np.float32(0.5) * np.float32(0.1)
    np.testing.assert_allclose(tu["blocks"]["ln1"].numpy(),
                               -lr_wd * p0["blocks"]["ln1"], rtol=1e-6)
    np.testing.assert_allclose(tu["embed"].numpy(), -lr_wd * p0["embed"],
                               rtol=1e-6)
    assert not tu["final_norm"].any()
    for t, j in _pairs(tu, ju):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_update_writes_the_moments_and_the_params_in_place():
    rng = np.random.default_rng(2)
    tp = _torch(_tree(rng))
    opt = AdamW(learning_rate=1e-3)
    state = opt.init(tp)
    m_ptr = state.m["blocks"]["q"].data_ptr()
    p_ptr = tp["blocks"]["q"].data_ptr()
    updates, new, _ = opt.update(_torch(_tree(rng)), state, tp)
    assert isinstance(new, AdamWState) and new.m is state.m
    assert new.m["blocks"]["q"].data_ptr() == m_ptr
    out = apply_updates(tp, updates)
    assert out is tp and out["blocks"]["q"].data_ptr() == p_ptr


# ------------------------------------ the reference's tests, on the port
def test_adamw_reduces_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        upd, state, _ = opt.update(grads, state, params)
        params = {"w": params["w"] + upd["w"]}
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_bounds_update():
    opt = AdamW(learning_rate=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, _, m = opt.update({"w": torch.full((4,), 1e6)}, state, params)
    assert float(m["gnorm"]) > 1e5  # raw norm reported pre-clip


def test_warmup_cosine_shape():
    lr = warmup_cosine(1e-3, warmup=10, total=100, floor=0.1)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(lr(55)) < float(lr(20))
