"""Port parity of ``_attn_streamed``, the xla route at S >=
``attn_chunked_above``: ``repro_torch.models.layers._attn_streamed`` against
``repro.models.layers._attn_streamed`` on the same numpy inputs, and the
route through ``model.forward`` and ``prefill`` of a small dense config
with ``attn_chunked_above`` lowered.

Tolerances, as max |port - ref| / max |ref|: fp32 1e-5, the same
arithmetic with sums in other orders (measured <= 5e-7); bf16 3e-2,
tests/test_torch_lm.py's tier (scores rounded to bf16 before the fp32
softmax, p rounded to bf16 for P V: a value one fp32 ulp apart before a
bf16 cast takes the other neighbour; measured <= 4e-3 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.shardings import MeshRules
from repro.launch.train import scaled_config as jscaled_config
from repro.models import config as JC
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import params as JP
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import layers, model, params as P

RULES = MeshRules.single_device()
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
NEG_INF = layers.NEG_INF


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _qkv(b, sq, sk, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _every_block(q, k, v, *, causal, q_chunk):
    """The reference's loop transcribed as it is: every KV block, masked
    ones too (layers.py:138-187)."""
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    kv_chunk = min(sk, max(q_chunk, 512))
    f32 = torch.float32
    outs = []
    for qi in range(sq // q_chunk):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(b, q_chunk, kv, g,
                                                          hd)
        m = torch.full((b, kv, g, q_chunk), NEG_INF, dtype=f32)
        l = torch.zeros_like(m)
        o = torch.zeros((b, kv, g, q_chunk, vd), dtype=f32)
        for ki in range(sk // kv_chunk):
            kb = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb).to(f32) * hd ** -0.5
            if causal:
                qp = qi * q_chunk + torch.arange(q_chunk)
                kp = ki * kv_chunk + torch.arange(kv_chunk)
                s = torch.where((qp[:, None] >= kp[None, :])[None, None, None],
                                s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(q.dtype), vb).to(f32)
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(3, 1).reshape(b, q_chunk, h, vd).to(q.dtype))
    return torch.cat(outs, dim=1)


CASES = [  # b, sq, sk, h, kv, d, q_chunk, causal
    (2, 1024, 1024, 4, 4, 16, 128, True),      # KV blocks of 512 over 8 q
    (2, 1024, 1024, 4, 4, 16, 128, False),     # blocks of 128
    (1, 1024, 1024, 8, 2, 32, 256, True),      # grouped-query, g = 4
    (1, 512, 1536, 6, 2, 16, 128, False),      # rectangular, g = 3
    (1, 2048, 2048, 4, 1, 16, 1024, True),     # MQA, KV blocks of q_chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,q_chunk,causal", CASES)
def test_streamed_matches_the_reference(b, sq, sk, h, kv, d, q_chunk, causal,
                                        dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, sq, sk, h, kv, d, dtype)
    want = jlayers._attn_streamed(jq, jk, jv, causal=causal, q_chunk=q_chunk)
    got = layers._attn_streamed(tq, tk, tv, causal=causal, q_chunk=q_chunk)
    assert got.dtype == tq.dtype
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skipping_the_blocks_above_the_diagonal_keeps_the_bits(dtype):
    """Causal: the port skips the KV blocks wholly above a query block, the
    reference runs them; the outputs are equal bit for bit."""
    _, (q, k, v) = _qkv(1, 2048, 2048, 4, 2, 32, dtype, seed=3)
    for q_chunk in (128, 512, 1024):
        got = layers._attn_streamed(q, k, v, causal=True, q_chunk=q_chunk)
        want = _every_block(q, k, v, causal=True, q_chunk=q_chunk)
        assert torch.equal(got, want), q_chunk


def test_streamed_agrees_with_full_attention():
    _, (q, k, v) = _qkv(2, 1024, 1024, 8, 2, 32, "float32", seed=5)
    torch.testing.assert_close(
        layers._attn_streamed(q, k, v, causal=True, q_chunk=256),
        layers._attn_full(q, k, v, causal=True), rtol=1e-5, atol=1e-6)


def test_keys_past_the_last_whole_block_raise():
    """The reference runs Sk // kv_chunk blocks and drops the rest; the port
    raises.  So does a query block that does not divide Sq (the reference
    fails inside a reshape)."""
    _, (q, k, v) = _qkv(1, 1024, 1280, 2, 2, 16, "float32")
    with pytest.raises(ValueError, match="KV block 512 must divide Sk=1280"):
        layers._attn_streamed(q, k, v, causal=False, q_chunk=256)
    _, (q, k, v) = _qkv(1, 1000, 1024, 2, 2, 16, "float32")
    with pytest.raises(ValueError, match="must divide Sq=1000"):
        layers._attn_streamed(q, k, v, causal=False, q_chunk=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_take_the_streamed_route(dtype, monkeypatch):
    """qwen3-0.6b at scale 0.04 with ``attn_chunked_above`` lowered to the
    prompt length: ``forward`` and ``prefill`` run ``_attn_streamed`` in every
    layer, and match the reference's, which does the same."""
    s = 512
    jcfg = dataclasses.replace(jscaled_config(JC.get("qwen3-0.6b"), 0.04),
                               dtype=dtype, attn_chunked_above=s,
                               attn_chunk=128)
    cfg = dataclasses.replace(scaled_config(C.get("qwen3-0.6b"), 0.04),
                              dtype=dtype, attn_chunked_above=s,
                              attn_chunk=128)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    pp = P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, s)).astype(np.int32)
    calls = []
    real = layers._attn_streamed

    def spy(*a, **kw):
        calls.append(kw["q_chunk"])
        return real(*a, **kw)

    monkeypatch.setattr(layers, "_attn_streamed", spy)
    jl, _ = JM.forward(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                       train=False)
    tl, _ = model.forward(cfg, pp, {"tokens": torch.from_numpy(toks)})
    assert calls == [128] * cfg.n_layers
    assert _rel(tl, jl) <= TOL[dtype]
    calls.clear()
    jlog, jc = JM.prefill(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                          max_len=s + 8)
    tlog, tc = model.prefill(cfg, pp, {"tokens": torch.from_numpy(toks)},
                             max_len=s + 8)
    assert calls == [128] * cfg.n_layers
    assert _rel(tlog, jlog) <= TOL[dtype]
    for name in ("k", "v"):
        assert _rel(tc["layers"][name], jc["layers"][name]) <= TOL[dtype]
