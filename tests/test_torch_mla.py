"""Port parity of multi-head latent attention (deepseek-v2):
``repro_torch.models.layers.mla_attention`` against
``repro.models.layers.mla_attention`` on the same weights and inputs,
drawn with numpy: the prefill output and its padded (c_kv, k_rope) cache,
then three absorbed-form decode steps, each with its cache.

Tolerances (tests/test_torch_lm.py's tiers), max |port - ref| / max |ref|:
fp32 1e-5, the same arithmetic with sums from other libraries; bf16 3e-2,
one bf16 ulp (2**-8) where a value lands on the other side of a rounding
boundary, spread through the projections.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.shardings import MeshRules
from repro.models import layers as jlayers
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

RULES = MeshRules.single_device()
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: q and k heads of head_dim + rope_head_dim = 48, v heads of 24, as
#: deepseek-v2's 192 against 128
BASE = dict(name="mla-small", family="moe", n_layers=1, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=32,
            v_head_dim=24, rope_head_dim=16, kv_lora_rank=32, q_lora_rank=48,
            dtype="float32")
B, S, MAX_LEN = 2, 24, 32


def _configs(**kw):
    return (dataclasses.replace(JArchConfig(**BASE), **kw),
            dataclasses.replace(ArchConfig(**BASE), **kw))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.n_heads
    hd, vhd, rhd = cfg.head_dim, cfg.v_head_dim, cfg.rope_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank

    def w(*shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(
            np.float32)

    return {"q_a": w(d, qlr), "q_b": w(qlr, h * (hd + rhd)),
            "kv_a": w(d, kvlr + rhd), "kv_b": w(kvlr, h * (hd + vhd)),
            "o": w(h * vhd, d),
            "q_norm": (1 + 0.1 * rng.standard_normal(qlr)).astype(np.float32),
            "kv_norm": (1 + 0.1 * rng.standard_normal(kvlr)).astype(
                np.float32)}


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_mla_prefill_cache_and_decode_match_the_reference(dtype):
    jcfg, cfg = _configs(dtype=dtype)
    p = _params(cfg)
    rng = np.random.default_rng(1)
    dt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tol = TOL[dtype]

    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    out, cache = layers.mla_attention(
        cfg, tp, torch.from_numpy(x).to(dt), positions=torch.arange(S),
        prefill_len=MAX_LEN)
    jout, jcache = jlayers.mla_attention(
        jcfg, RULES, jp, jnp.asarray(x).astype(jdt), positions=jnp.arange(S),
        prefill_len=MAX_LEN)
    assert out.dtype == dt and out.shape == x.shape
    assert _rel(out, jout) <= tol
    assert set(cache) == set(jcache) == {"c_kv", "k_rope"}
    assert cache["c_kv"].shape == (B, MAX_LEN, cfg.kv_lora_rank)
    assert cache["k_rope"].shape == (B, MAX_LEN, cfg.rope_head_dim)
    for name in cache:
        assert _rel(cache[name], jcache[name]) <= tol, name
        assert not cache[name][:, S:].any()       # the padding

    for step in range(3):
        cur = S + step
        xs = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = np.full((1, 1), cur, np.int32)
        out, new = layers.mla_attention(
            cfg, tp, torch.from_numpy(xs).to(dt),
            positions=torch.from_numpy(pos), cache=dict(cache, len=cur))
        jout, jcache = jlayers.mla_attention(
            jcfg, RULES, jp, jnp.asarray(xs).astype(jdt),
            positions=jnp.asarray(pos), cache=dict(jcache, len=cur))
        assert all(new[n] is cache[n] for n in cache)   # updated in place
        assert _rel(out, jout) <= tol, step
        for name in cache:
            assert _rel(cache[name], jcache[name]) <= tol, (step, name)


def test_mla_decode_refuses_a_full_cache():
    _, cfg = _configs()
    tp = {k: torch.from_numpy(v) for k, v in _params(cfg).items()}
    cache = {"c_kv": torch.zeros(B, S, cfg.kv_lora_rank),
             "k_rope": torch.zeros(B, S, cfg.rope_head_dim), "len": S}
    with pytest.raises(ValueError, match="KV cache full"):
        layers.mla_attention(cfg, tp, torch.zeros(B, 1, cfg.d_model),
                             positions=torch.full((1, 1), S), cache=cache)


def test_mla_prefill_refuses_the_flash_route():
    """MLA's q/k heads (48) are wider than its v heads (24): the flash
    kernel takes one head dimension, so the flash route raises before
    anything runs, naming the route that serves it; nothing pads or falls
    back."""
    _, cfg = _configs(attn_impl="flash")
    tp = {k: torch.from_numpy(v) for k, v in _params(cfg).items()}
    x = torch.zeros(B, S, cfg.d_model)
    launches = fa.flash_attention.launches
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        layers.mla_attention(cfg, tp, x, positions=torch.arange(S),
                             prefill_len=MAX_LEN)
    assert fa.flash_attention.launches == launches
    # the flash wrapper itself refuses v heads narrower than q's
    q = torch.zeros(B, S, 4, 48)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, torch.zeros(B, S, 4, 24), causal=True,
                           block_q=S, block_k=S)
