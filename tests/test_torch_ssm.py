"""Port parity of the SSM cells: ``repro_torch.models.ssm`` against
``repro.models.ssm`` on the same numpy inputs, function by function, and
the port's own step forms against its parallel forms.

Tolerances, as max |port - ref| / max |ref| per output: the same fp32
arithmetic with sums in other orders (the port's pairwise products in
place of XLA's contractions, its cumulative sums in another order) and
exp/log from other libraries, carried through a few chunks (measured <=
6e-7 here).  Step form against chunked form: the reference's own
tests/test_ssm.py bounds (rtol 1e-4, atol 1e-5; the sLSTM's 1e-5, 1e-6).
The mLSTM's outputs take MLSTM_TOL: its weights are exp(F_t - F_s + i_s)
of a cumulative log-forget sum F over the chunk, which the two packages
add in other orders, so F carries an absolute error of a few ulp of |F|
(tens here) into every weight (measured 3e-6 in chunks of 8 and 16, 2.8e-5
in one chunk of 64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

TOL = 5e-6
MLSTM_TOL = 1e-4


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _ssd_inputs(bsz=2, s=64, h=3, p=4, n=5, seed=0, state=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal((bsz, s, h, p)).astype(f),
           rng.uniform(0.01, 0.2, (bsz, s, h)).astype(f),
           -rng.uniform(0.5, 2.0, (h,)).astype(f),
           rng.standard_normal((bsz, s, n)).astype(f),
           rng.standard_normal((bsz, s, n)).astype(f)]
    if state:
        out.append(rng.standard_normal((bsz, h, n, p)).astype(f))
    return out


def _mlstm_inputs(bsz=2, s=64, h=2, k=8, seed=1, carry=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal((bsz, s, h, k)).astype(f) for _ in range(3)]
    out += [(rng.standard_normal((bsz, s, h)) * 2.0).astype(f)
            for _ in range(2)]
    if carry:
        out += [rng.standard_normal((bsz, h, k, k)).astype(f),
                rng.standard_normal((bsz, h, k)).astype(f),
                rng.standard_normal((bsz, h)).astype(f)]
    return out


@pytest.mark.parametrize("chunk,state", [(16, False), (16, True), (8, True),
                                         (64, False)])
def test_ssd_chunked_matches_the_reference(chunk, state):
    """S = 64 in chunks of 16 or 8 carries the state over several chunks;
    a given state0 enters the first."""
    j, t = _both(*_ssd_inputs(state=state))
    jy, js = jssm.ssd_chunked(*j[:5], chunk=chunk,
                              state0=j[5] if state else None)
    ty, ts = ssm.ssd_chunked(*t[:5], chunk=chunk,
                             state0=t[5] if state else None)
    assert _rel(ty, jy) <= TOL and _rel(ts, js) <= TOL


def test_ssd_step_matches_the_reference_and_continues_the_scan():
    j, t = _both(*_ssd_inputs(s=17, state=True))
    jy, js = jssm.ssd_step(j[0][:, 0], j[1][:, 0], j[2], j[3][:, 0],
                           j[4][:, 0], j[5])
    ty, ts = ssm.ssd_step(t[0][:, 0], t[1][:, 0], t[2], t[3][:, 0],
                          t[4][:, 0], t[5])
    assert _rel(ty, jy) <= TOL and _rel(ts, js) <= TOL
    # the port's step after its chunked scan of 16 == its scan of 17
    _, st = ssm.ssd_chunked(*(a[:, :16] for a in (t[0], t[1])), t[2],
                            *(a[:, :16] for a in (t[3], t[4])), chunk=8)
    y1, st1 = ssm.ssd_step(t[0][:, 16], t[1][:, 16], t[2], t[3][:, 16],
                           t[4][:, 16], st)
    y_all, st_all = ssm.ssd_chunked(*t[:5], chunk=17)
    torch.testing.assert_close(y1, y_all[:, -1], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(st1, st_all, rtol=1e-4, atol=1e-5)


def test_causal_conv_matches_the_reference_padded_and_streaming():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, 6)).astype(np.float32)
    (jx, jw, jc), (tx, tw, tc) = _both(x, w, c0)
    assert _rel(ssm.causal_conv(tx, tw), jssm.causal_conv(jx, jw)) <= TOL
    jy, jcache = jssm.causal_conv(jx, jw, cache=jc)
    ty, tcache = ssm.causal_conv(tx, tw, cache=tc)
    assert _rel(ty, jy) <= TOL
    np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))
    # the port's streaming form in two pieces == its padded form
    y1, cache = ssm.causal_conv(tx[:, :9], tw, cache=torch.zeros(2, 3, 6))
    y2, _ = ssm.causal_conv(tx[:, 9:], tw, cache=cache)
    torch.testing.assert_close(torch.cat([y1, y2], 1), ssm.causal_conv(tx, tw),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk,carry", [(16, False), (16, True), (8, True),
                                         (64, False)])
def test_mlstm_chunked_matches_the_reference(chunk, carry):
    j, t = _both(*_mlstm_inputs(carry=carry))
    jh, jc = jssm.mlstm_chunked(*j[:5], chunk=chunk,
                                carry0=tuple(j[5:]) if carry else None)
    th, tc = ssm.mlstm_chunked(*t[:5], chunk=chunk,
                               carry0=tuple(t[5:]) if carry else None)
    assert _rel(th, jh) <= MLSTM_TOL
    for a, b in zip(tc, jc):
        assert _rel(a, b) <= TOL


def test_mlstm_step_matches_the_reference_and_the_chunked_form():
    j, t = _both(*_mlstm_inputs(s=12, carry=True))
    jh, jc = jssm.mlstm_step(*(a[:, 0] for a in j[:5]), tuple(j[5:]))
    th, tc = ssm.mlstm_step(*(a[:, 0] for a in t[:5]), tuple(t[5:]))
    assert _rel(th, jh) <= MLSTM_TOL
    for a, b in zip(tc, jc):
        assert _rel(a, b) <= TOL
    # the port's steps from a zero carry == its chunked form
    q, k, v, gi, gf = t[:5]
    bsz, s, h, kk = q.shape
    carry = (torch.zeros(bsz, h, kk, kk), torch.zeros(bsz, h, kk),
             torch.zeros(bsz, h))
    outs = []
    for i in range(s):
        o, carry = ssm.mlstm_step(q[:, i], k[:, i], v[:, i], gi[:, i],
                                  gf[:, i], carry)
        outs.append(o)
    h_par, _ = ssm.mlstm_chunked(q, k, v, gi, gf, chunk=4)
    torch.testing.assert_close(torch.stack(outs, 1), h_par, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shift", [(40.0, -40.0), (-40.0, 40.0)])
def test_gates_stay_finite_extreme(shift):
    """The reference's log-space check, on both packages: extreme gate
    pre-activations stay finite and agree."""
    j, t = _both(*_mlstm_inputs(s=16))
    jh, _ = jssm.mlstm_chunked(*j[:3], j[3] + shift[0], j[4] + shift[1],
                               chunk=8)
    th, _ = ssm.mlstm_chunked(*t[:3], t[3] + shift[0], t[4] + shift[1],
                              chunk=8)
    assert bool(torch.isfinite(th).all())
    assert _rel(th, jh) <= MLSTM_TOL


@pytest.mark.parametrize("carry", [False, True])
def test_slstm_scan_and_step_match_the_reference(carry):
    rng = np.random.default_rng(2)
    bsz, s, h, hd = 2, 10, 2, 4
    gx = rng.standard_normal((bsz, s, h, 4, hd)).astype(np.float32)
    r = (rng.standard_normal((h, hd, 4 * hd)) * 0.2).astype(np.float32)
    c0 = [rng.standard_normal((bsz, h, hd)).astype(np.float32)
          for _ in range(4)]
    c0[1] = np.abs(c0[1]) + 0.5                 # the normaliser n > 0
    (jg, jr, *jc), (tg, tr, *tc) = _both(gx, r, *c0)
    jh, jcar = jssm.slstm_scan(jg, jr, n_heads=h,
                               carry0=tuple(jc) if carry else None)
    th, tcar = ssm.slstm_scan(tg, tr, n_heads=h,
                              carry0=tuple(tc) if carry else None)
    assert _rel(th, jh) <= TOL
    for a, b in zip(tcar, jcar):
        assert _rel(a, b) <= TOL
    jh1, jc1 = jssm.slstm_step(jg[:, 0], jr, tuple(jc))
    th1, tc1 = ssm.slstm_step(tg[:, 0], tr, tuple(tc))
    assert _rel(th1, jh1) <= TOL
    for a, b in zip(tc1, jc1):
        assert _rel(a, b) <= TOL


def test_softplus_is_the_exact_logaddexp():
    """``jax.nn.softplus`` is log(1 + e^x) to fp32 everywhere (normal
    results; below e^-87 both round subnormals their own way); ``F.softplus``
    returns x above its threshold of 20, which the port does not use."""
    x = np.concatenate([np.linspace(-80, 90, 1701),
                        [15.0, 20.0, 20.5, 30.0]]).astype(np.float32)
    want = np.logaddexp(x.astype(np.float64), 0.0)
    got = ssm.softplus(torch.from_numpy(x)).double().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    jref = np.asarray(jssm.jax.nn.softplus(jnp.asarray(x)), np.float64)
    np.testing.assert_allclose(got, jref, rtol=2e-7, atol=0)


@pytest.mark.parametrize("fn", ["ssd", "mlstm"])
def test_a_chunk_that_does_not_divide_the_sequence_raises(fn):
    if fn == "ssd":
        args = [torch.from_numpy(a) for a in _ssd_inputs(s=24)]
        with pytest.raises(ValueError, match="chunk 16"):
            ssm.ssd_chunked(*args, chunk=16)
    else:
        args = [torch.from_numpy(a) for a in _mlstm_inputs(s=24)]
        with pytest.raises(ValueError, match="chunk 16"):
            ssm.mlstm_chunked(*args, chunk=16)
