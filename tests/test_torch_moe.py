"""Port parity of the top-k MoE FFN: ``repro_torch.models.layers.moe_ffn``
(and its router ``route``, ``top_k`` and ``capacity_slots``) against
``repro.models.layers.moe_ffn`` on the same weights and inputs, drawn with
numpy.

The reference's routing is internal to its ``moe_ffn``; the tests that
need its top-k experts compute them with its own lines (``layers.py:398-
400``) on the same inputs.  Tolerances: max |port - ref| / max |ref|.
fp32 1e-5: the same arithmetic with matmul sums from other libraries.
bf16 3e-2: a value one fp32 ulp apart before a bf16 cast rounds to the
neighbouring bf16 value, 2**-8 of it (tests/test_torch_lm.py's tiers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.shardings import MeshRules
from repro.models import layers as jlayers
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

RULES = MeshRules.single_device()
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
BASE = dict(name="moe-small", family="moe", n_layers=1, d_model=64,
            n_heads=2, n_kv_heads=2, d_ff=128, moe_d_ff=96, vocab_size=256,
            n_experts=8, top_k=2, dtype="float32")


def _configs(**kw):
    return (dataclasses.replace(JArchConfig(**BASE), **kw),
            dataclasses.replace(ArchConfig(**BASE), **kw))


def _params(cfg, seed=0):
    """numpy weights of one MoE FFN (router, routed and shared experts)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    p = {"router": w(d, e), "we_g": w(e, d, f), "we_u": w(e, d, f),
         "we_d": w(e, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p.update({"ws_g": w(d, fs), "ws_u": w(d, fs), "ws_d": w(fs, d)})
    return p


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _run(jcfg, cfg, p, x):
    """(port out, port aux), (ref out, ref aux), inputs cast to cfg.dtype."""
    dt, jdt = getattr(torch, cfg.dtype), jnp.dtype(jcfg.dtype)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = layers.moe_ffn(cfg, tp, torch.from_numpy(x).to(dt))
    want = jlayers.moe_ffn(jcfg, RULES, jp, jnp.asarray(x).astype(jdt))
    return got, want


def _ref_top_i(jcfg, p, x):
    """The reference's routing: its lines 398-400 on the same inputs."""
    xj = jnp.asarray(x).astype(jnp.dtype(jcfg.dtype))
    logits = jnp.einsum("bsd,de->bse", xj,
                        jnp.asarray(p["router"]).astype(xj.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _gshard_slots(top_i, n_experts, cap):
    """The dispatch's semantics, written out: in each sequence the (token,
    choice) entries, in flat order t * k + j, fill their expert's slots
    in turn; an entry past ``cap`` is dropped (slot n_experts * cap)."""
    b, s, k = top_i.shape
    out = np.full((b, s * k), n_experts * cap)
    for bi in range(b):
        used = np.zeros(n_experts, int)
        for n, ex in enumerate(top_i[bi].reshape(-1)):
            if used[ex] < cap:
                out[bi, n] = ex * cap + used[ex]
                used[ex] += 1
    return out.reshape(b, s, k)


@pytest.mark.parametrize("label,kw,s,dtype", [
    ("default capacity", {}, 32, "float32"),
    ("tight capacity", {"capacity_factor": 0.5}, 32, "float32"),
    ("shared experts", {"n_shared_experts": 2}, 32, "float32"),
    ("top-6 of 16", {"n_experts": 16, "top_k": 6}, 40, "float32"),
    ("decode s=1", {}, 1, "float32"),
    ("decode s=1 shared", {"n_shared_experts": 2}, 1, "float32"),
    ("bf16", {}, 32, "bfloat16"),
    ("bf16 decode", {"n_shared_experts": 2}, 1, "bfloat16"),
])
def test_moe_ffn_matches_the_reference(label, kw, s, dtype):
    """Output and aux loss, the capacity dispatch at s > 1 and the dense
    combine at s == 1."""
    jcfg, cfg = _configs(dtype=dtype, **kw)
    p = _params(cfg)
    x = _x(3, s, cfg.d_model)
    (out, aux), (jout, jaux) = _run(jcfg, cfg, p, x)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert _rel(out, jout) <= TOL[dtype], label
    assert abs(float(aux) - float(jaux)) <= TOL[dtype] * abs(float(jaux))
    assert float(aux) > 0


def test_no_drop_capacity_equals_the_dense_combine():
    """With capacity for every entry (cap >= s k), the dispatch drops
    nothing and gives the dense combine's output (each token alone through
    the s == 1 path) to fp32 rounding: the same products, summed in
    another order."""
    jcfg, cfg = _configs(capacity_factor=8.0)
    p = _params(cfg)
    b, s = 2, 16
    x = _x(b, s, cfg.d_model)
    cap = layers.capacity(cfg, s)
    assert cap >= s * cfg.top_k
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    _, _, top_i = layers.route(cfg, tp, xt)
    slots = layers.capacity_slots(top_i, cfg.n_experts, cap)
    assert bool((slots < cfg.n_experts * cap).all())
    out, _ = layers.moe_ffn(cfg, tp, xt)
    dense, _ = layers.moe_ffn(cfg, tp, xt.reshape(b * s, 1, -1))
    assert _rel(out, dense.reshape(b, s, -1).numpy()) <= TOL["float32"]
    (_, _), (jout, _) = _run(jcfg, cfg, p, x)
    assert _rel(out, jout) <= TOL["float32"]


@pytest.mark.parametrize("cf", (0.5, 1.25))
def test_tight_capacity_drops_the_reference_slots(cf):
    """The port's slots are the dispatch's semantics applied to the
    reference's top-k experts, slot for slot, dropped entries included,
    and each sequence is its own group.  A dropped set that differed would
    move a token's output by a whole expert's contribution, far past the
    fp32 tolerance the outputs are held to."""
    jcfg, cfg = _configs(capacity_factor=cf)
    p = _params(cfg, seed=5)
    b, s = 4, 48
    x = _x(b, s, cfg.d_model, seed=6)
    cap = layers.capacity(cfg, s)
    _, _, top_i = layers.route(cfg, {k: torch.from_numpy(v)
                                     for k, v in p.items()},
                               torch.from_numpy(x))
    ref_i = _ref_top_i(jcfg, p, x)
    np.testing.assert_array_equal(top_i.numpy(), ref_i)
    slots = layers.capacity_slots(top_i, cfg.n_experts, cap).numpy()
    np.testing.assert_array_equal(slots, _gshard_slots(ref_i, cfg.n_experts,
                                                       cap))
    dropped = int((slots == cfg.n_experts * cap).sum())
    if cf < 1:
        assert dropped > 0.2 * b * s * cfg.top_k
    # one group per sequence: the batch flattened into one group would fill
    # each expert's slots across sequences
    flat = _gshard_slots(ref_i.reshape(1, b * s, -1), cfg.n_experts, cap)
    assert (flat.reshape(slots.shape) != slots).any()
    (out, _), (jout, _) = _run(jcfg, cfg, p, x)
    assert _rel(out, jout) <= TOL["float32"]


def test_top_k_tie_goes_to_the_lower_index():
    """A constructed exact tie at the top-k boundary: the router's logits
    are (3, 1, 0, 2, 0, 2, 0, 0) for every token, so experts 3 and 5 tie
    for the second place; jax.lax.top_k takes the lower index, and so must
    the port (torch.topk promises no order among equal values)."""
    jcfg, cfg = _configs()
    p = _params(cfg)
    p["router"] = np.zeros_like(p["router"])
    p["router"][0] = [3, 1, 0, 2, 0, 2, 0, 0]
    x = _x(2, 16, cfg.d_model)
    x[..., 0] = 1.0
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    probs, _, top_i = layers.route(cfg, tp, torch.from_numpy(x))
    assert bool((probs[..., 3] == probs[..., 5]).all())
    ref_i = _ref_top_i(jcfg, p, x)
    assert (ref_i == [0, 3]).all()
    np.testing.assert_array_equal(top_i.numpy(), ref_i)
    vals, idx = layers.top_k(torch.tensor([[1.0, 2.0, 2.0, 0.5, 2.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[2.0, 2.0, 2.0]]
    (out, aux), (jout, jaux) = _run(jcfg, cfg, p, x)
    assert _rel(out, jout) <= TOL["float32"]
    assert abs(float(aux) - float(jaux)) <= TOL["float32"] * float(jaux)


@pytest.mark.parametrize("e,k", ((16, 2), (160, 6)))
def test_top_i_equals_the_reference_at_fp32(e, k):
    """At fp32 the port's experts are the reference's, in the same order."""
    jcfg, cfg = _configs(n_experts=e, top_k=k)
    p = _params(cfg, seed=7)
    x = _x(4, 64, cfg.d_model, seed=8)
    _, top_p, top_i = layers.route(cfg, {k_: torch.from_numpy(v)
                                         for k_, v in p.items()},
                                   torch.from_numpy(x))
    np.testing.assert_array_equal(top_i.numpy(), _ref_top_i(jcfg, p, x))
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_combine_gives_the_same_bits_twice():
    jcfg, cfg = _configs(capacity_factor=0.75, n_shared_experts=1)
    tp = {k: torch.from_numpy(v) for k, v in _params(cfg).items()}
    x = torch.from_numpy(_x(2, 40, cfg.d_model))
    a, b = layers.moe_ffn(cfg, tp, x), layers.moe_ffn(cfg, tp, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("cf", (0.5, 1.25))
def test_recorded_routes_are_the_reference_dispatch(cf):
    """``layers.recording_routes`` gives, per ``moe_ffn`` call over more
    than one token, the reference's top-k experts, the entries its
    dispatch drops and the router's probabilities; a single-token call
    and a call outside the block record nothing."""
    jcfg, cfg = _configs(capacity_factor=cf)
    p = _params(cfg, seed=5)
    b, s = 4, 48
    x = _x(b, s, cfg.d_model, seed=6)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    cap = layers.capacity(cfg, s)
    with layers.recording_routes() as routes:
        layers.moe_ffn(cfg, tp, xt)
        layers.moe_ffn(cfg, tp, xt[:, :1])
    layers.moe_ffn(cfg, tp, xt)
    assert len(routes) == 1
    top_i, dropped, probs = routes[0]
    ref_i = _ref_top_i(jcfg, p, x)
    np.testing.assert_array_equal(top_i.numpy(), ref_i)
    np.testing.assert_array_equal(
        dropped.numpy(),
        _gshard_slots(ref_i, cfg.n_experts, cap) == cfg.n_experts * cap)
    assert torch.equal(probs, layers.route(cfg, tp, xt)[0])
