"""Port parity of the moe, vlm and audio families' serve path:
``repro_torch.models`` and ``repro_torch.serve`` against ``repro.models``
and ``repro.serve`` on the same weights and batches, for the four configs
phi3.5-moe-42b-a6.6b, deepseek-v2-236b (MLA), qwen2-vl-2b (M-RoPE over a
patch prefix) and seamless-m4t-medium (encoder-decoder), at scale 0.04.

The reference's ``init_params`` tree is carried across with
``params_from_jax``; batches are ``SyntheticLM``'s numpy draws (tokens,
and the stub frontends' patches or frames), handed to both packages.  On
the CPU the reference's ``attn_impl="flash"`` runs ``_attn_full`` while
the port's runs the plain version of its flash kernel, so each route is
compared; deepseek-v2 serves through ``_attn_full`` only (its MLA prefill
raises under ``"flash"``, ``tests/test_torch_mla.py``).

Routing.  At fp32 every token is held to ``TOL``, which a token routed
differently would leave.  At bf16 a token may route differently where its
k-th and (k+1)-th probabilities lie within bf16 noise (``ROUTE_NOISE``),
so both packages' top-k experts are recorded at every MoE layer (the
reference's under ``jax.disable_jit``, so its scans run eagerly and a spy
on ``moe_ffn`` sees values).  Such tokens are counted and printed, and
held apart: the forward logits from that token on in its sequence, and
its whole sequence in the prefill, cache and decode checks.
"""

import contextlib
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
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import params as JP
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import layers, model, params as P
from repro_torch.serve.engine import Engine, ServeConfig

RULES = MeshRules.single_device()
SCALE = 0.04
B, S, MAX_LEN, N_GEN = 2, 32, 48, 6
ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "qwen2-vl-2b",
         "seamless-m4t-medium")
#: port vs reference, as max |port - ref| / max |ref| per output
#: (tests/test_torch_lm.py's tiers).  fp32: the same arithmetic with sums
#: from other libraries (measured <= 1.3e-6 over the four configs).  bf16:
#: a value one fp32 ulp apart before a bf16 cast rounds to the other
#: neighbour, one bf16 ulp (2**-8), and such flips spread through the
#: layers (measured <= 9e-3 away from routing differences)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: bf16 noise in the router: its logits are bf16, and p_k / p_(k+1) =
#: exp(l_k - l_(k+1)); logits of magnitude 2 to 4 have an ulp of 2**-6,
#: and the two contenders each rounded to the other neighbour part by two
#: of them.  A token routes differently only if (p_k - p_(k+1)) / p_k is
#: at most this (measured 2.0e-3 and 4.4e-3 on the two flips seen here;
#: chip_smoke.py phase 15 holds the card against the CPU to the same)
ROUTE_NOISE = {"float32": 0.0, "bfloat16": 2.0 ** -5}



def cases(archs):
    """(arch, dtype, impl): both dtypes, and both routes where the config
    runs flash (deepseek-v2's MLA has no flash route)."""
    return [(arch, dtype, impl) for arch in archs
            for dtype in ("float32", "bfloat16")
            for impl in ("xla", "flash")
            if not (arch == "deepseek-v2-236b" and impl == "flash")]


def _configs(arch, dtype="float32", impl="xla"):
    jcfg = dataclasses.replace(jscaled_config(JC.get(arch), SCALE),
                               dtype=dtype, attn_impl=impl)
    cfg = dataclasses.replace(scaled_config(C.get(arch), SCALE), dtype=dtype,
                              attn_impl=impl)
    return jcfg, cfg


def _ref_params(jcfg, seed=0):
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(jcfg, seed=0):
    """SyntheticLM's serving inputs: tokens and the frontend's patches or
    frames, as numpy arrays."""
    nb = JSyntheticLM(jcfg, batch_spec_for(jcfg, B, S), seed=seed)(0)
    nb.pop("labels")
    return nb


def _both(nb):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in nb.items()})


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want, keep=None):
    """max |got - want| / max |want|, the numerator over the ``keep``
    entries of the leading axes only."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    if keep is not None:
        d = d[keep]
    return float(d.max() / np.abs(want).max())


class Routes:
    """Both packages' top-k experts at every MoE layer since ``reset``."""

    def __init__(self, monkeypatch, dtype):
        self.dtype, self.ref, self.port = dtype, [], []
        ref_moe, port_route = jlayers.moe_ffn, layers.route

        def ref_spy(cfg, rules, p, x):
            # the reference's router, model.py's lines :398-400
            logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(x.dtype))
            probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
            self.ref.append(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
            return ref_moe(cfg, rules, p, x)

        def port_spy(cfg, p, x):
            out = port_route(cfg, p, x)
            self.port.append((out[0].numpy(), out[2].numpy()))
            return out

        monkeypatch.setattr(jlayers, "moe_ffn", ref_spy)
        monkeypatch.setattr(layers, "route", port_spy)

    def reset(self):
        self.ref.clear()
        self.port.clear()

    def flips(self):
        """(B, S) bool: tokens routed differently at some layer; each must
        be a near tie on the port's probabilities."""
        assert len(self.ref) == len(self.port) > 0
        out = None
        for ri, (probs, pi) in zip(self.ref, self.port):
            diff = np.any(np.sort(ri, -1) != np.sort(pi, -1), axis=-1)
            k = pi.shape[-1]
            ranked = -np.sort(-probs, axis=-1)
            gap = (ranked[..., k - 1] - ranked[..., k]) / ranked[..., k - 1]
            assert (gap[diff] <= ROUTE_NOISE[self.dtype]).all(), gap[diff]
            out = diff if out is None else out | diff
        return out


def _eager(moe):
    """The reference runs eagerly where its routing is recorded."""
    return jax.disable_jit() if moe else contextlib.nullcontext()


def _spy_flash(monkeypatch):
    calls = []
    real = layers.flash_attention

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    return calls


def _expected_flash(cfg):
    """The flash wrapper's calls per prefill and per decode step: one per
    self-attention layer in prefill; for audio also one per encoder layer
    and one per cross-attention, the latter in every decode step too."""
    if cfg.attn_impl != "flash":
        return 0, 0
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.n_layers, cfg.n_layers
    return cfg.n_layers, 0


@pytest.mark.parametrize("arch,dtype,impl",
                         cases(("qwen2-vl-2b", "seamless-m4t-medium")))
def test_family_serves_as_the_reference(arch, dtype, impl, monkeypatch):
    """vlm and audio; the moe family's configs run the same check in
    ``tests/test_torch_families_moe.py``."""
    serve_parity(arch, dtype, impl, monkeypatch)


def serve_parity(arch, dtype, impl, monkeypatch):
    """forward logits and aux; prefill logits and every cache leaf; three
    decode steps; the flash wrapper's calls per prefill and decode step."""
    jcfg, cfg = _configs(arch, dtype, impl)
    jp, pp = _ref_params(jcfg)
    jb, tb = _both(_batch(jcfg))
    tol = TOL[dtype]
    # routing is recorded at bf16; at fp32 every token is held to TOL, which
    # a token routed differently would leave (tests/test_torch_moe.py holds
    # top_i equal at fp32)
    moe = cfg.family == "moe" and dtype == "bfloat16"
    routes = Routes(monkeypatch, dtype) if moe else None
    calls = _spy_flash(monkeypatch)
    s_text = jb["tokens"].shape[1]

    with _eager(moe):
        jl, ja = JM.forward(jcfg, RULES, jp, jb, train=False)
    tl, ta = model.forward(cfg, pp, tb)
    assert tl.shape == (B, s_text, cfg.padded_vocab)
    keep = np.ones((B, s_text), bool)
    held = np.zeros(B, bool)
    if moe:
        flips = routes.flips()
        first = np.where(flips.any(-1), flips.argmax(-1), s_text)
        keep = np.arange(s_text)[None] < first[:, None]
        held |= flips.any(-1)
        print(f"{arch} {dtype} forward: {int(flips.sum())} token(s) routed "
              f"differently (near ties); positions held apart from "
              f"{first.tolist()} of {s_text} per sequence")
    if cfg.family == "moe":
        assert float(ta) > 0
        assert abs(float(ta) - float(ja)) <= tol * abs(float(ja))
    else:
        assert float(ta) == float(ja) == 0.0
    assert _rel(tl, jl, keep) <= tol

    if moe:
        routes.reset()
    with _eager(moe):
        jlog, jc = JM.prefill(jcfg, RULES, jp, jb, max_len=MAX_LEN)
    calls.clear()
    tlog, tc = model.prefill(cfg, pp, tb, max_len=MAX_LEN)
    assert len(calls) == _expected_flash(cfg)[0]
    if moe:
        held |= routes.flips().any(-1)
    assert not held.all()
    rows = ~held
    assert _rel(tlog, jlog, rows) <= tol
    assert set(tc) == set(jc)
    for key, leaf in tc.items():
        if isinstance(leaf, dict):
            assert set(leaf) == set(jc[key])
            for name, t in leaf.items():
                assert _rel(t, jc[key][name], (slice(None), rows)) <= tol, \
                    (key, name)
        elif key == "memory":
            assert _rel(leaf, jc[key], rows) <= tol
        else:
            assert leaf == int(jc[key]), key
    f = tb.get("patches", torch.zeros(B, 0)).shape[1]
    assert (tc["len"], tc["offset"]) == (s_text + f, f)

    nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for _ in range(3):
        if moe:
            routes.reset()
        with _eager(moe):
            jlog, jc = JM.decode_step(jcfg, RULES, jp, jc,
                                      jnp.asarray(nxt[:, None]))
        calls.clear()
        tlog, tc = model.decode_step(cfg, pp, tc,
                                     torch.from_numpy(nxt[:, None]))
        assert len(calls) == _expected_flash(cfg)[1]
        if moe:
            held |= routes.flips()[:, 0]
        assert not held.all()
        assert tlog.shape == (B, cfg.padded_vocab)
        assert _rel(tlog, jlog, ~held) <= tol
        assert tc["len"] == int(jc["len"])
        nxt = np.argmax(_f32(jlog), axis=-1).astype(np.int32)
    for key in ("layers", "dense_layers"):
        for name, t in tc.get(key, {}).items():
            assert _rel(t, jc[key][name], (slice(None), ~held)) <= tol


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_the_reference(arch):
    """At fp32, ``Engine.generate``'s greedy tokens equal the reference
    Engine's bit for bit, the frontend's patches or frames passed with the
    tokens."""
    jcfg, cfg = _configs(arch)
    jp, pp = _ref_params(jcfg)
    nb = _batch(jcfg, seed=1)
    jout, _ = JEngine(jcfg, RULES, jp, JServeConfig(max_len=MAX_LEN)).generate(
        {k: jnp.asarray(v) for k, v in nb.items()}, N_GEN)
    out, stats = Engine(cfg, pp, ServeConfig(max_len=MAX_LEN)).generate(
        nb, N_GEN)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_equal_the_reference(arch):
    jcfg, cfg = JC.get(arch), C.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert arch in C.available()
    assert P.count_params(cfg) == JP.count_params(jcfg)
    assert P.count_active(cfg) == JP.count_active(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.attn_impl == "xla"            # as registered
    # the scaled config and the carried-over tree
    jscfg, scfg = _configs(arch)
    assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)
    assert P.count_active(scfg) == JP.count_active(jscfg)
    jp, pp = _ref_params(jscfg)
    defs = P.param_defs(scfg)
    assert set(pp) == set(jp) == set(defs)
    for key, sub in defs.items():
        if isinstance(sub, dict):
            assert set(sub) == set(pp[key])
            for name, d in sub.items():
                assert tuple(pp[key][name].shape) == d.shape
                np.testing.assert_array_equal(pp[key][name].numpy(),
                                              np.asarray(jp[key][name]))


def test_registry_holds_the_ported_families():
    assert set(P.PORTED_FAMILIES) == {JC.get(n).family
                                      for n in JC.available()}
    assert C.available() == JC.available()
    assert len(C.available()) == 10


def test_audio_without_frames_raises_as_the_reference():
    jcfg, cfg = _configs("seamless-m4t-medium")
    jp, pp = _ref_params(jcfg)
    toks = _batch(jcfg)["tokens"]
    with pytest.raises(KeyError):
        JM.prefill(jcfg, RULES, jp, {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="frames"):
        model.prefill(cfg, pp, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(KeyError, match="frames"):
        model.forward(cfg, pp, {"tokens": torch.from_numpy(toks)})


def test_mrope_band_gather_gives_the_one_hot_einsum_bits():
    """The reference picks each band's stream with a one-hot einsum in fp32
    (layers.py:76-80); the port's gather gives the same bits."""
    rng = np.random.default_rng(3)
    sections = (8, 12, 12)
    ang_all = (rng.standard_normal((3, 2, 40, 32)) * 1e3).astype(np.float32)
    sec_id = jnp.repeat(jnp.arange(3), jnp.asarray(sections),
                        total_repeat_length=32)
    onehot = jax.nn.one_hot(sec_id, 3, dtype=jnp.float32)
    want = np.asarray(jnp.einsum("p...h,hp->...h", jnp.asarray(ang_all), onehot))
    got = layers.mrope_select(torch.from_numpy(ang_all), sections).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="mrope_sections"):
        layers.mrope_select(torch.from_numpy(ang_all), (8, 8, 8))


def test_mrope_positions_and_rotation_match_the_reference():
    """vlm and text position streams bit for bit; the rotation to fp32
    rounding (cos/sin from other libraries)."""
    want = np.asarray(jlayers.vlm_mrope_positions(2, 16, 24, 4))
    got = layers.vlm_mrope_positions(2, 16, 24, 4).numpy()
    np.testing.assert_array_equal(got, want)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    np.testing.assert_array_equal(
        layers.text_mrope_positions(torch.from_numpy(pos.copy())).numpy(),
        np.asarray(jlayers.text_mrope_positions(jnp.asarray(pos))))
    x = np.random.default_rng(4).standard_normal((2, 40, 3, 64)).astype(
        np.float32)
    sections = (16, 8, 8)
    jr = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(want), sections, 1e6)
    tr = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(got),
                            sections, 1e6)
    assert _rel(tr, jr) <= 1e-6
