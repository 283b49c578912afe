"""Port parity of the LM serve slice: ``repro_torch.models`` and
``repro_torch.serve`` against ``repro.models`` and ``repro.serve`` on the
same weights and tokens.

The reference's ``init_params`` tree is carried across with
``params_from_jax``, so both packages compute the same function; prompts
are drawn with numpy.  On the CPU the reference's ``attn_impl="flash"``
runs ``_attn_full`` (its Pallas kernel is TPU-only there) while the port's
runs the plain version of its flash kernel, so each route is compared.
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
from repro.models import model as JM
from repro.models import params as JP
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve.engine import decode_step as jdecode_step
from repro.serve.engine import prefill_step as jprefill_step
from repro_torch import serve
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import layers, model, params as P
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import Engine, ServeConfig

RULES = MeshRules.single_device()
ARCH, SCALE = "qwen3-0.6b", 0.04
B, S, MAX_LEN, N_GEN = 2, 32, 48, 6

#: port vs reference, as max |port - ref| / max |ref| per output.  fp32:
#: the same fp32 arithmetic with matmul sums, pow, sin/cos and exp from
#: other libraries, through two layers (measured <= 4e-7).  bf16: the
#: same, but a value one ulp apart before a bf16 cast rounds to the
#: neighbouring bf16 value, one bf16 ulp (2**-8) of it, and such flips
#: propagate through the layers (measured <= 7.1e-3 on logits and cache)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: port, flash route vs xla route, fp32: the plain flash version sums its
#: softmax in 512-key blocks with an online rescale, the xla route in one
#: pass, so they agree to fp32 rounding but not bitwise
FLASH_VS_XLA_TOL = 2e-5

#: the test_serving.py tiny config: 4 query heads on 2 kv heads (G = 2)
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_chunked_above=10 ** 9,
            dtype="float32")


def _configs(dtype, impl):
    jcfg = dataclasses.replace(jscaled_config(JC.get(ARCH), SCALE),
                               dtype=dtype, attn_impl=impl)
    cfg = dataclasses.replace(scaled_config(C.get(ARCH), SCALE), dtype=dtype,
                              attn_impl=impl)
    return jcfg, cfg


def _ref_params(jcfg, seed=0):
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(vocab, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_scaled_config_fields_equal_the_reference():
    jcfg = jscaled_config(JC.get(ARCH), SCALE)
    cfg = scaled_config(C.get(ARCH), SCALE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (
        2, 64, 2, 2)


def test_full_config_and_parameter_count_equal_the_reference():
    jcfg, cfg = JC.get(ARCH), C.get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert P.count_params(cfg) == JP.count_params(jcfg) == 596_180_992
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab == 152_064
    # the registry holds the reference's ten configs, ARCH among them
    assert C.available() == JC.available()
    assert len(C.available()) == 10 and ARCH in C.available()


def test_params_from_jax_keeps_the_tree_and_the_bits():
    jcfg, cfg = _configs("float32", "xla")
    jp, pp = _ref_params(jcfg)
    defs = P.param_defs(cfg)
    assert set(pp) == set(jp) == set(defs)
    for key in defs["blocks"]:
        x = pp["blocks"][key]
        assert tuple(x.shape) == defs["blocks"][key].shape
        assert tuple(x.shape)[0] == cfg.n_layers
        np.testing.assert_array_equal(x.numpy(), np.asarray(jp["blocks"][key]))
    np.testing.assert_array_equal(pp["embed"].numpy(), np.asarray(jp["embed"]))


def test_init_params_follows_the_reference_law():
    """Norms are ones; every other leaf is normal with std = min(0.02,
    fan_in ** -0.5), fan_in = shape[-2] (params.py:223-241)."""
    cfg = scaled_config(C.get(ARCH), 0.25)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    defs = P.param_defs(cfg)
    assert torch.equal(pp["final_norm"], torch.ones(cfg.d_model))
    for key, d in defs["blocks"].items():
        x = pp["blocks"][key]
        assert x.dtype == torch.float32 and tuple(x.shape) == d.shape
        if d.init == "ones":
            assert torch.equal(x, torch.ones_like(x))
            continue
        std = min(d.scale, d.shape[-2] ** -0.5)
        assert abs(float(x.std()) / std - 1) < 0.05, key
        assert abs(float(x.mean())) < 0.05 * std, key


@pytest.mark.parametrize("impl", ("xla", "flash"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_serve_slice_matches_the_reference(dtype, impl):
    """forward logits; prefill logits and the filled cache; three decode
    steps; and, at fp32, Engine.generate's greedy tokens bit for bit."""
    jcfg, cfg = _configs(dtype, impl)
    jp, pp = _ref_params(jcfg)
    toks = _prompts(cfg.vocab_size)
    tol = TOL[dtype]

    jl, _ = JM.forward(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                       train=False)
    tl, aux = model.forward(cfg, pp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    assert _rel(tl, jl) <= tol

    jlog, jc = JM.prefill(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                          max_len=MAX_LEN)
    tlog, tc = model.prefill(cfg, pp, {"tokens": torch.from_numpy(toks)},
                             max_len=MAX_LEN)
    assert _rel(tlog, jlog) <= tol
    for name in ("k", "v"):
        assert _rel(tc["layers"][name], jc["layers"][name]) <= tol
    assert (tc["len"], tc["offset"]) == (int(jc["len"]), int(jc["offset"]))

    nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for _ in range(3):
        jlog, jc = JM.decode_step(jcfg, RULES, jp, jc, jnp.asarray(nxt[:, None]))
        tlog, tc = model.decode_step(cfg, pp, tc, torch.from_numpy(nxt[:, None]))
        assert tlog.shape == (B, cfg.padded_vocab)
        assert _rel(tlog, jlog) <= tol
        assert tc["len"] == int(jc["len"])
        nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for name in ("k", "v"):
        assert _rel(tc["layers"][name], jc["layers"][name]) <= tol

    if dtype == "float32":
        jout, _ = JEngine(jcfg, RULES, jp, JServeConfig(max_len=MAX_LEN)
                          ).generate({"tokens": jnp.asarray(toks)}, N_GEN)
        out, stats = Engine(cfg, pp, ServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": toks}, N_GEN)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0



def test_bare_prefill_and_decode_steps_match_the_reference():
    """``serve.prefill_step(cfg)`` and ``serve.decode_step(cfg)``, the bare
    closures of the reference's ``serve/engine.py``, on the same qwen3 smoke
    weights: the prefill's logits and cache, then three decode steps."""
    jcfg, cfg = _configs("float32", "xla")
    jp, pp = _ref_params(jcfg)
    toks = _prompts(cfg.vocab_size)
    jprefill, jdecode = jprefill_step(jcfg, RULES), jdecode_step(jcfg, RULES)
    prefill, decode = serve.prefill_step(cfg), serve.decode_step(cfg)
    jlog, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tc = prefill(pp, {"tokens": torch.from_numpy(toks)})
    assert tlog.shape == (B, cfg.padded_vocab)
    assert _rel(tlog, jlog) <= TOL["float32"]
    for name in ("k", "v"):
        assert _rel(tc["layers"][name], jc["layers"][name]) <= TOL["float32"]
    # the bare prefill's cache is the prompt's length, full (the port
    # refuses a step there, the reference clamps); decode from a cache
    # with room for the steps
    jlog, jc = JM.prefill(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                          max_len=MAX_LEN)
    _, tc = model.prefill(cfg, pp, {"tokens": torch.from_numpy(toks)},
                          max_len=MAX_LEN)
    nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for _ in range(3):
        jlog, jc = jdecode(jp, jc, jnp.asarray(nxt[:, None]))
        tlog, tc = decode(pp, tc, torch.from_numpy(nxt[:, None]))
        assert _rel(tlog, jlog) <= TOL["float32"]
        assert tc["len"] == int(jc["len"])
        nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)


@pytest.mark.parametrize("tiny", (False, True), ids=("qwen3-x0.04", "tiny-g2"))
def test_flash_route_matches_xla_route_in_the_port(tiny):
    base = ArchConfig(**TINY) if tiny else scaled_config(C.get(ARCH), SCALE)
    cfgs = {impl: dataclasses.replace(base, attn_impl=impl)
            for impl in ("xla", "flash")}
    pp = P.init_params(base, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(_prompts(base.vocab_size, seed=1))
    out = {}
    for impl, cfg in cfgs.items():
        logits, _ = model.forward(cfg, pp, {"tokens": toks})
        last, cache = model.prefill(cfg, pp, {"tokens": toks}, max_len=MAX_LEN)
        step, _ = model.decode_step(cfg, pp, cache, toks[:, :1])
        out[impl] = (logits, last, step)
    for got, want in zip(out["flash"], out["xla"]):
        assert _rel(got, want) <= FLASH_VS_XLA_TOL


def test_prefill_runs_the_flash_wrapper_once_per_layer(monkeypatch):
    """On CPU tensors the wrapper runs its plain version (launch count
    stays 0), once per layer in prefill and never in decode."""
    calls = []
    real = layers.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    cfg = dataclasses.replace(scaled_config(C.get(ARCH), SCALE),
                              attn_impl="flash")
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab_size))
    _, cache = model.prefill(cfg, pp, {"tokens": toks}, max_len=MAX_LEN)
    assert len(calls) == cfg.n_layers
    model.decode_step(cfg, pp, cache, toks[:, :1])
    assert len(calls) == cfg.n_layers
    assert fa.flash_attention.launches == 0


def test_temperature_sampling_is_seeded():
    """Temperature sampling draws from a torch.Generator: it cannot match
    jax.random.categorical bit for bit, so it is held to its own seed and
    to the vocabulary."""
    cfg = scaled_config(C.get(ARCH), SCALE)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _prompts(cfg.vocab_size)
    runs = [Engine(cfg, pp, ServeConfig(max_len=MAX_LEN, temperature=1.0,
                                        seed=seed)).generate(
        {"tokens": toks}, N_GEN)[0] for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert all(tuple(r.shape) == (B, N_GEN) for r in runs)
    assert all(bool(((r >= 0) & (r < cfg.padded_vocab)).all()) for r in runs)


def test_decode_refuses_a_full_cache():
    cfg = scaled_config(C.get(ARCH), SCALE)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab_size))
    _, cache = model.prefill(cfg, pp, {"tokens": toks}, max_len=S)
    with pytest.raises(ValueError, match="KV cache full"):
        model.decode_step(cfg, pp, cache, toks[:, :1])


def test_routes_still_refused_raise():
    """Every family and ``_attn_streamed`` are ported; what the port still
    refuses raises before any work: MLA under the flash route (its q/k and
    v heads differ, ``tests/test_torch_mla.py``), and a prompt whose keys
    the streamed route's KV block does not divide (the reference drops the
    keys past the last whole block)."""
    mla = dataclasses.replace(scaled_config(C.get("deepseek-v2-236b"), SCALE),
                              attn_impl="flash")
    pm = P.init_params(mla, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_prompts(mla.vocab_size))
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        model.prefill(mla, pm, {"tokens": toks})
    cfg = dataclasses.replace(scaled_config(C.get(ARCH), SCALE),
                              attn_chunked_above=16, attn_chunk=128)
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab_size, s=640))
    with pytest.raises(ValueError, match="KV block 512 must divide Sk=640"):
        model.forward(cfg, pp, {"tokens": toks})
    with pytest.raises(ValueError, match="KV block 512 must divide Sk=640"):
        model.prefill(cfg, pp, {"tokens": toks})