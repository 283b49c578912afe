"""Port parity of the ssm (xlstm-1.3b: mLSTM and sLSTM) and hybrid
(zamba2-7b: Mamba2 with a shared attention block) families at scale 0.04:
``repro_torch.models`` and ``repro_torch.serve`` against ``repro.models``
and ``repro.serve`` on the same weights and batches.

The reference's ``init_params`` tree is carried across with
``params_from_jax``; prompts are ``SyntheticLM``'s numpy draws.
``chunk_size`` is cut to 8, so the 32-token prompts run four chunks and
the carries cross chunk boundaries; zamba2 also runs with 8 layers and
``attn_every`` 3 (two groups and a tail of two Mamba2 layers; at scale 0.04
it has 6 layers and no tail).  xlstm has no attention, so it runs under
``attn_impl="xla"`` only; zamba2 under both routes (on the CPU the
reference's flash route is ``_attn_full``, the port's the plain version of
its kernel).

Tolerances are tests/test_torch_families.py's tiers, as max |port - ref| /
max |ref| per output: fp32 1e-5 (measured <= 1.5e-6); bf16 3e-2 (a value
one fp32 ulp apart before a bf16 cast takes the other neighbour, and the
fp32 scans in other orders move their bf16 outputs so; measured <= 2.1e-2
on zamba2, 4.8e-3 on xlstm).  The loss and gradients are held in
``tests/test_torch_train_ssm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_spec_for
from repro.launch.train import scaled_config as jscaled_config
from repro.models import config as JC
from repro.models import model as JM
from repro.models import params as JP
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import tree as tree_util
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import layers, model, params as P
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_families import RULES, TOL, _f32, _rel, _spy_flash

SCALE, B, S, MAX_LEN, N_GEN = 0.04, 2, 32, 48, 6
CHUNK = 8
#: (arch, config overrides): zamba2 with a tail as well as without
RUNS = {"xlstm": ("xlstm-1.3b", {}),
        "zamba2": ("zamba2-7b", {}),
        "zamba2-tail": ("zamba2-7b", dict(n_layers=8, attn_every=3))}
CASES = [(run, dtype, impl) for run in RUNS
         for dtype in ("float32", "bfloat16") for impl in ("xla", "flash")
         if not (run == "xlstm" and impl == "flash")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(run, dtype="float32", impl="xla"):
    arch, kw = RUNS[run]
    kw = dict(kw, dtype=dtype, attn_impl=impl, chunk_size=CHUNK)
    return (dataclasses.replace(jscaled_config(JC.get(arch), SCALE), **kw),
            dataclasses.replace(scaled_config(C.get(arch), SCALE), **kw))


def _ref_params(jcfg, seed=0):
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(jcfg, seed=0):
    return JSyntheticLM(jcfg, batch_spec_for(jcfg, B, S), seed=seed)(0)[
        "tokens"]


def _leaves(cache):
    """(name, leaf) of every tensor leaf of a cache, nested ones included."""
    for key in sorted(cache):
        leaf = cache[key]
        if isinstance(leaf, dict):
            for name in sorted(leaf):
                yield f"{key}/{name}", leaf[name]
        elif not isinstance(leaf, int):
            yield key, leaf


@pytest.mark.parametrize("run,dtype,impl", CASES)
def test_family_serves_as_the_reference(run, dtype, impl, monkeypatch):
    """forward logits; prefill logits and every cache leaf; three decode
    steps and the cache after them; the flash wrapper's calls per prefill
    (one per application of the shared block) and per decode step (none)."""
    jcfg, cfg = _configs(run, dtype, impl)
    jp, pp = _ref_params(jcfg)
    toks = _tokens(jcfg)
    tol = TOL[dtype]
    calls = _spy_flash(monkeypatch)

    jl, _ = JM.forward(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                       train=False)
    tl, ta = model.forward(cfg, pp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, cfg.padded_vocab) and float(ta) == 0.0
    assert _rel(tl, jl) <= tol

    calls.clear()
    jlog, jc = JM.prefill(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                          max_len=MAX_LEN)
    tlog, tc = model.prefill(cfg, pp, {"tokens": torch.from_numpy(toks)},
                             max_len=MAX_LEN)
    n_app = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert len(calls) == (n_app if impl == "flash" else 0)
    assert _rel(tlog, jlog) <= tol
    names = dict(_leaves(tc))
    assert set(names) == {n for n, _ in _leaves(
        {k: v if isinstance(v, dict) else np.asarray(v)
         for k, v in jc.items() if k not in ("len", "offset")})}
    for name, leaf in names.items():
        key, _, sub = name.partition("/")
        want = jc[key][sub] if sub else jc[key]
        assert leaf.dtype == getattr(torch, str(np.asarray(want).dtype)), name
        assert _rel(leaf, want) <= tol, name
    assert (tc["len"], tc["offset"]) == (int(jc["len"]), int(jc["offset"]))

    nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for _ in range(3):
        jlog, jc = JM.decode_step(jcfg, RULES, jp, jc,
                                  jnp.asarray(nxt[:, None]))
        calls.clear()
        tlog, tc = model.decode_step(cfg, pp, tc,
                                     torch.from_numpy(nxt[:, None]))
        assert not calls
        assert tlog.shape == (B, cfg.padded_vocab)
        assert _rel(tlog, jlog) <= tol
        assert tc["len"] == int(jc["len"])
        nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for name, leaf in _leaves(tc):
        key, _, sub = name.partition("/")
        assert _rel(leaf, jc[key][sub] if sub else jc[key]) <= tol, name


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_greedy_tokens_equal_the_reference(run):
    """At fp32, ``Engine.generate``'s greedy tokens equal the reference
    Engine's bit for bit."""
    jcfg, cfg = _configs(run)
    jp, pp = _ref_params(jcfg)
    toks = _tokens(jcfg, seed=1)
    jout, _ = JEngine(jcfg, RULES, jp, JServeConfig(max_len=MAX_LEN)).generate(
        {"tokens": jnp.asarray(toks)}, N_GEN)
    out, stats = Engine(cfg, pp, ServeConfig(max_len=MAX_LEN)).generate(
        {"tokens": toks}, N_GEN)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_configs_and_counts_equal_the_reference(arch):
    jcfg, cfg = JC.get(arch), C.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert P.count_params(cfg) == JP.count_params(jcfg) == {
        "xlstm-1.3b": 1_841_436_672, "zamba2-7b": 6_750_498_384}[arch]
    assert P.count_active(cfg) == JP.count_active(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.attn_impl == "xla"            # as registered
    run = "xlstm" if arch == "xlstm-1.3b" else "zamba2"
    jscfg, scfg = _configs(run)
    assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)
    jp, pp = _ref_params(jscfg)
    defs = P.param_defs(scfg)
    assert set(pp) == set(jp) == set(defs)
    for key, sub in defs.items():
        subs = sub.items() if isinstance(sub, dict) else ((None, sub),)
        for name, d in subs:
            got = pp[key][name] if name else pp[key]
            want = jp[key][name] if name else jp[key]
            assert tuple(got.shape) == d.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("run", ["xlstm", "zamba2"])
def test_init_params_follows_the_reference_law(run):
    """The port's own draws: ones, zeros, Mamba2's a_log and dt_bias (fp32;
    within two ulps of the reference's: linspace, exp, expm1 and log come
    from other libraries), normal leaves with the reference's std."""
    jcfg, cfg = _configs(run)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    pp = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    defs = P.param_defs(cfg)
    for key, sub in defs.items():
        subs = sub.items() if isinstance(sub, dict) else ((None, sub),)
        for name, d in subs:
            got = (pp[key][name] if name else pp[key]).numpy()
            want = np.asarray(jp[key][name] if name else jp[key])
            assert got.shape == want.shape and got.dtype == np.float32
            if d.init == "normal":
                std = min(d.scale, d.shape[-2] ** -0.5)
                assert abs(got.std() / std - 1) < 0.1, (key, name)
            else:
                np.testing.assert_allclose(got, want, rtol=5e-7, atol=0,
                                           err_msg=f"{key}/{name}")


def test_cast_params_keeps_the_leaves_used_in_fp32():
    """Serving casts each leaf once to the dtype its every use casts it
    to: the mLSTM's wq/wk/wv, the sLSTM's r and Mamba2's a_log, d_skip and
    dt_bias stay fp32 and unrounded; every other leaf is cast to bf16."""
    fp32 = {"blocks": {"a_log", "d_skip", "dt_bias", "wq", "wk", "wv"},
            "slstm_blocks": {"r"}}
    for run in ("xlstm", "zamba2"):
        _, cfg = _configs(run, "bfloat16")
        pp = P.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
        # values that bf16 cannot hold: rounding them would show
        pp = tree_util.map(lambda x: x + 1e-5 * torch.rand_like(x), pp)
        cast = P.cast_params(pp, "bfloat16")
        kept = 0
        for key, sub in cast.items():
            subs = sub.items() if isinstance(sub, dict) else ((None, sub),)
            for name, x in subs:
                orig = pp[key][name] if name else pp[key]
                if name in fp32.get(key, ()):
                    assert x.dtype == torch.float32
                    assert torch.equal(x, orig), (key, name)
                    kept += 1
                else:
                    assert x.dtype == torch.bfloat16, (key, name)
        assert kept == (4 if run == "xlstm" else 3)
    # a dense config casts every leaf
    dense = scaled_config(C.get("qwen3-0.6b"), SCALE)
    pp = P.init_params(dense, torch.Generator().manual_seed(3), device="cpu")
    assert all(x.dtype == torch.bfloat16 for x in tree_util.leaves(
        P.cast_params(pp, "bfloat16")))


def test_bf16_engine_serves_the_fp32_leaves_unrounded():
    """At bf16, the engine's logits equal the reference's cast-at-use model
    to bf16's tier, while the same engine fed a_log, d_skip and dt_bias
    rounded to bf16 first leaves it: the kept leaves are what the reference
    computes with."""
    jcfg, cfg = _configs("zamba2", "bfloat16")
    jp, pp = _ref_params(jcfg)
    # a_log etc. as trained values, not the initialiser's round numbers
    rng = np.random.default_rng(4)
    for name in ("a_log", "dt_bias", "d_skip"):
        x = np.asarray(jp["blocks"][name]) + rng.uniform(
            0.0, 0.3, jp["blocks"][name].shape).astype(np.float32)
        jp["blocks"][name] = jnp.asarray(x)
        pp["blocks"][name] = torch.from_numpy(x)
    toks = _tokens(jcfg)
    jlog, _ = JM.prefill(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)},
                         max_len=MAX_LEN)
    engine = Engine(cfg, pp, ServeConfig(max_len=MAX_LEN))
    tlog, _ = model.prefill(cfg, engine.params,
                            {"tokens": torch.from_numpy(toks)},
                            max_len=MAX_LEN)
    rounded = dict(engine.params, blocks={
        k: (v.to(torch.bfloat16).float() if k in ("a_log", "dt_bias",
                                                  "d_skip") else v)
        for k, v in engine.params["blocks"].items()})
    rlog, _ = model.prefill(cfg, rounded, {"tokens": torch.from_numpy(toks)},
                            max_len=MAX_LEN)
    assert _rel(tlog, jlog) <= TOL["bfloat16"]
    assert _rel(rlog, tlog) > 0.0


def test_layers_silu_rounds_as_the_reference():
    """``layers.silu`` in bf16 gives ``jax.nn.silu``'s bits (exp, add and
    divide each rounded to bf16)."""
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32) * 4
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = layers.silu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
