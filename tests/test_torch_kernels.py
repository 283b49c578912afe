"""Port parity of the kernel layer: ``repro_torch.kernels.{ref, nbody_force,
ops}`` against ``repro.kernels`` on the same inputs.

The Pallas kernels run under ``interpret=True`` as ``tests/test_kernels.py``
runs them; on a CPU tensor the port's packed wrappers run their plain
PyTorch versions (the CUDA kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Inputs are made from
a seed with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import nbody_force as jnf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import nbody_force, ops, ref

F32 = np.float32

#: oracle at float64: the same float64 terms summed in other orders; the
#: measured gap is ~5e-16 of each output group's largest value
REF64_TOL = 1e-14
#: oracle in mixed mode (float32 inputs, bf16-rounded terms, Neumaier
#: sums): both packages round the same float32 terms and run the same
#: sequential two-sum, so only float32 rounding of the terms can differ
REF_MIXED_TOL = 1e-6
#: packed plain version vs the interpreted Pallas kernel, as a share of
#: each output group's largest value.  fp32: jnp.sum and torch.sum add a
#: j-block's float32 terms in other orders and rsqrt may differ by an ulp
#: (measured <= 4e-7).  mixed: most rows agree bit for bit, but a float32
#: term one ulp apart can round to the neighbouring bfloat16 value, which
#: moves that row by one bf16 ulp of the term (<= 2**-7 of it).  So mixed
#: bounds the worst row by 2**-7 and lets at most 5% of rows differ by
#: more than 1e-6; leaving the bf16 rounding out of one side moves every
#: row by ~1e-3 and fails.
PACKED_TOL = {None: 2e-6, "bfloat16": 2.0 ** -7}
ROW_TOL, ROW_SHARE = 1e-6, 0.05


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)), 0.1 * rng.standard_normal((n, 3)),
            rng.uniform(0.5, 1.5, n) / n)


def _rect(n_t, n_s, seed=0):
    """Targets and sources with self-pairs (the first targets are sources)
    and zero-mass pads (the last sources)."""
    pt, vt, _ = _cloud(n_t, seed + 1)
    ps, vs, ms = _cloud(n_s, seed + 2)
    k = min(n_t, n_s) // 4
    pt[:k], vt[:k] = ps[:k], vs[:k]
    ms[-(n_s // 8):] = 0.0
    rng = np.random.default_rng(seed + 3)
    return (pt, vt, ps, vs, ms, rng.standard_normal((n_t, 3)),
            rng.standard_normal((n_s, 3)))


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _assert_packed_close(got, want, groups, compute_dtype):
    """Per output column group: the worst normalised error within
    PACKED_TOL and, in mixed mode, few rows off by more than ROW_TOL."""
    for lo, hi in groups:
        g, w = got[:, lo:hi].astype(np.float64), want[:, lo:hi]
        assert _norm_err(g, w) <= PACKED_TOL[compute_dtype]
        scale = max(np.abs(w).max(), 1e-30)
        rows = np.abs(g - w).max(axis=1) / scale
        assert np.mean(rows > ROW_TOL) <= ROW_SHARE


def _j(x, dtype):
    return jnp.asarray(x, dtype)


def _t(x, dtype):
    return torch.tensor(np.asarray(x), dtype=dtype)


# --------------------------------------------------------------------------
# kernels/ref.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_t,n_s", [(40, 70), (64, 64), (33, 8)])
def test_ref_fp64_matches_reference(n_t, n_s):
    pt, vt, ps, vs, ms, at, as_ = _rect(n_t, n_s)
    want = jref.acc_jerk_pot_rect(*(_j(x, jnp.float64)
                                    for x in (pt, vt, ps, vs, ms)))
    got = ref.acc_jerk_pot_rect(*(_t(x, torch.float64)
                                  for x in (pt, vt, ps, vs, ms)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == w.shape
        assert _norm_err(g.numpy(), w) <= REF64_TOL
    want = jref.snap_rect(*(_j(x, jnp.float64)
                            for x in (pt, vt, at, ps, vs, as_, ms)))
    got = ref.snap_rect(*(_t(x, torch.float64)
                          for x in (pt, vt, at, ps, vs, as_, ms)))
    assert _norm_err(got.numpy(), want) <= REF64_TOL


def test_ref_self_pairs_and_zero_mass_are_exact_zero():
    """A target alone with itself and zero-mass sources gets exact zeros,
    the potential included."""
    pt, vt, ps, vs, ms, at, as_ = _rect(16, 16)
    ms[:] = 0.0
    ms[0] = 1.0
    pos = _t(ps[:1], torch.float64)
    acc, jerk, pot = ref.acc_jerk_pot_rect(
        pos, _t(vs[:1], torch.float64), _t(ps, torch.float64),
        _t(vs, torch.float64), _t(ms, torch.float64))
    assert not acc.any() and not jerk.any() and not pot.any()


def test_ref_mixed_matches_reference():
    pt, vt, ps, vs, ms, at, as_ = _rect(40, 70, seed=4)
    want = jref.acc_jerk_pot_rect(*(_j(x, jnp.float32)
                                    for x in (pt, vt, ps, vs, ms)),
                                  compute_dtype="bfloat16")
    got = ref.acc_jerk_pot_rect(*(_t(x, torch.float32)
                                  for x in (pt, vt, ps, vs, ms)),
                                compute_dtype="bfloat16")
    for g, w in zip(got, want):
        assert _norm_err(g.numpy(), w) <= REF_MIXED_TOL
    want = jref.snap_rect(*(_j(x, jnp.float32)
                            for x in (pt, vt, at, ps, vs, as_, ms)),
                          compute_dtype="bfloat16")
    got = ref.snap_rect(*(_t(x, torch.float32)
                          for x in (pt, vt, at, ps, vs, as_, ms)),
                        compute_dtype="bfloat16")
    assert _norm_err(got.numpy(), want) <= REF_MIXED_TOL


@pytest.mark.parametrize("seed", (2, 3))
def test_compensated_sum_matches_reference(seed):
    """Adversarial wide-magnitude float32 input: the same sequential
    Neumaier two-sum gives the same float32 result, bit for bit."""
    rng = np.random.default_rng(seed)
    x = (10.0 ** rng.uniform(-4, 4, 4096)
         * rng.choice([-1.0, 1.0], 4096)).astype(F32)
    want = np.asarray(jref.compensated_sum(jnp.asarray(x)))
    got = ref.compensated_sum(torch.from_numpy(x)).numpy()
    assert got == want
    true = np.sum(x.astype(np.float64))
    assert abs(float(got) - true) <= np.spacing(np.float32(abs(true)))


def test_compensated_sum_axis_matches_reference():
    x = np.random.default_rng(0).standard_normal((5, 7, 3)).astype(F32)
    for axis in (0, 1, 2):
        want = np.asarray(jref.compensated_sum(jnp.asarray(x), axis=axis))
        got = ref.compensated_sum(torch.from_numpy(x), axis=axis).numpy()
        np.testing.assert_array_equal(got, want)


def test_row_chunked_oracle_matches_dense(monkeypatch):
    """Above DENSE_PAIR_LIMIT the oracle evaluates chunks of target rows;
    each row's reduction is unchanged, so the results are shape-exact and
    equal to the dense path."""
    pt, vt, ps, vs, ms, at, as_ = (_t(x, torch.float64)
                                   for x in _rect(100, 64))
    dense = ref.acc_jerk_pot_rect(pt, vt, ps, vs, ms)
    dense_s = ref.snap_rect(pt, vt, at, ps, vs, as_, ms)
    monkeypatch.setattr(ref, "DENSE_PAIR_LIMIT", 1 << 9)  # 8-row chunks
    chunked = ref.acc_jerk_pot_rect(pt, vt, ps, vs, ms)
    chunked_s = ref.snap_rect(pt, vt, at, ps, vs, as_, ms)
    for d, c in zip(dense + (dense_s,), chunked + (chunked_s,)):
        assert d.shape == c.shape
        np.testing.assert_allclose(c.numpy(), d.numpy(), rtol=0,
                                   atol=1e-15 * float(d.abs().max()))


# --------------------------------------------------------------------------
# kernels/nbody_force.py: the plain versions against the Pallas functions
# --------------------------------------------------------------------------
def _packed_operands(n_t, n_s, masked, seed=5):
    pt, vt, ps, vs, ms, at, as_ = _rect(n_t, n_s, seed)
    mask = None
    if masked:
        mask = np.random.default_rng(seed).uniform(size=n_t) < 0.5
        mask[:32] = False          # one fully inactive i-block of 32
    f = jnp.float32
    jt = jops.pack_targets(_j(pt, f), _j(vt, f), n_t,
                           None if mask is None else jnp.asarray(mask))
    js = jops.pack_sources(_j(ps, f), _j(vs, f), _j(ms, f), n_s)
    jta = jops.pack_acc_targets(_j(at, f), n_t)
    jsa = jops.pack_acc_sources(_j(as_, f), n_s)
    return (jt, js, jta, jsa), tuple(
        torch.from_numpy(np.array(x)) for x in (jt, js, jta, jsa))


PACKED_CASES = [(96, 96, False), (64, 160, True)]


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
@pytest.mark.parametrize("n_t,n_s,masked", PACKED_CASES)
def test_acc_jerk_plain_matches_pallas(n_t, n_s, masked, compute_dtype):
    (jt, js, _, _), (tt, ts, _, _) = _packed_operands(n_t, n_s, masked)
    kw = dict(block_i=32, block_j=32, compute_dtype=compute_dtype)
    want = np.asarray(jnf.acc_jerk_pot_packed(jt, js, interpret=True, **kw))
    got = nbody_force._acc_jerk_plain(tt, ts, eps=1e-7, **kw).numpy()
    assert got.shape == want.shape == (n_t, 8)
    _assert_packed_close(got, want, ((0, 3), (3, 6), (6, 7)), compute_dtype)
    assert not got[:, 7].any()
    inactive = tt[:, 3].numpy() == 0
    assert not got[inactive].any() and not want[inactive].any()


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
@pytest.mark.parametrize("n_t,n_s,masked", PACKED_CASES)
def test_snap_plain_matches_pallas(n_t, n_s, masked, compute_dtype):
    jx, tx = _packed_operands(n_t, n_s, masked)
    kw = dict(block_i=32, block_j=32, compute_dtype=compute_dtype)
    want = np.asarray(jnf.snap_packed(*jx, interpret=True, **kw))
    got = nbody_force._snap_plain(*tx, eps=1e-7, **kw).numpy()
    assert got.shape == want.shape == (n_t, 8)
    _assert_packed_close(got, want, ((0, 3),), compute_dtype)
    assert not got[:, 3:].any()
    assert not got[tx[0][:, 3].numpy() == 0].any()


def test_packed_wrappers_on_cpu_are_the_plain_versions():
    _, (tt, ts, tta, tsa) = _packed_operands(64, 160, True)
    for cdt in (None, "bfloat16"):
        kw = dict(block_i=32, block_j=32, compute_dtype=cdt)
        assert torch.equal(
            nbody_force.acc_jerk_pot_packed(tt, ts, **kw),
            nbody_force._acc_jerk_plain(tt, ts, eps=1e-7, **kw))
        assert torch.equal(
            nbody_force.snap_packed(tt, ts, tta, tsa, **kw),
            nbody_force._snap_plain(tt, ts, tta, tsa, eps=1e-7, **kw))


def test_batched_operands_stack_single_systems():
    """A leading batch axis evaluates each system on its own."""
    systems = [_packed_operands(64, 96, masked, seed)[1]
               for seed, masked in ((1, False), (2, True))]
    batched = [torch.stack(xs) for xs in zip(*systems)]
    kw = dict(block_i=32, block_j=32)
    out = nbody_force.acc_jerk_pot_packed(*batched[:2], **kw)
    snp = nbody_force.snap_packed(*batched, **kw)
    for b, (tt, ts, tta, tsa) in enumerate(systems):
        assert torch.equal(out[b], nbody_force.acc_jerk_pot_packed(tt, ts, **kw))
        assert torch.equal(snp[b],
                           nbody_force.snap_packed(tt, ts, tta, tsa, **kw))


def test_zero_mass_sources_contribute_exact_zero():
    """Zero-mass sources in the alignment padding change nothing, bit for
    bit: every term they add is an exact zero."""
    pos, vel, mass = (_t(x, torch.float32) for x in _cloud(200, 0))
    a1 = ops.acc_jerk_pot_rect(pos, vel, pos, vel, mass, block_i=32,
                               block_j=64)
    extra = _t(np.random.default_rng(9).standard_normal((56, 3)),
               torch.float32)
    a2 = ops.acc_jerk_pot_rect(pos, vel, torch.cat([pos, extra]),
                               torch.cat([vel, torch.zeros_like(extra)]),
                               torch.cat([mass, torch.zeros(56)]),
                               block_i=32, block_j=64)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)


def test_grid_tiles_matches_reference():
    for args in ((256, 512, 256, 512), (300, 1000, 128, 256),
                 (1, 1, 8, 128), (16384, 16384, 256, 512)):
        assert nbody_force.grid_tiles(*args) == jnf.grid_tiles(*args)
    assert (nbody_force.DEFAULT_BLOCK_I, nbody_force.DEFAULT_BLOCK_J) == (
        jnf.DEFAULT_BLOCK_I, jnf.DEFAULT_BLOCK_J)


@pytest.mark.parametrize("bad", ["shape", "dtype", "align", "layout",
                                 "compute_dtype", "device"])
def test_packed_wrapper_rejects_bad_operands(bad):
    _, (tt, ts, tta, tsa) = _packed_operands(64, 96, False)
    kw = dict(block_i=32, block_j=32)
    if bad == "shape":
        tt = tt[:, :7].contiguous()
    elif bad == "dtype":
        ts = ts.double()
    elif bad == "align":
        kw["block_j"] = 64
    elif bad == "layout":
        ts = ts.T.contiguous().T
    elif bad == "compute_dtype":
        kw["compute_dtype"] = "float16"
    elif bad == "device":       # a device the wrapper has no path for
        with FakeTensorMode():
            tt, ts = (torch.empty(x.shape, device="xla") for x in (tt, ts))
    with pytest.raises((ValueError, TypeError)):
        nbody_force.acc_jerk_pot_packed(tt, ts, **kw)


# --------------------------------------------------------------------------
# kernels/ops.py
# --------------------------------------------------------------------------
def test_packing_layouts_match_reference():
    pt, vt, ps, vs, ms, at, as_ = _rect(130, 130)
    mask = np.random.default_rng(1).uniform(size=130) < 0.5
    f = jnp.float32
    pairs = [
        (jops.pack_targets(_j(pt, f), _j(vt, f), 256),
         ops.pack_targets(_t(pt, torch.float32), _t(vt, torch.float32), 256)),
        (jops.pack_targets(_j(pt, jnp.float64), _j(vt, jnp.float64), 256,
                           jnp.asarray(mask)),
         ops.pack_targets(_t(pt, torch.float64), _t(vt, torch.float64), 256,
                          torch.from_numpy(mask))),
        (jops.pack_sources(_j(ps, f), _j(vs, f), _j(ms, f), 256),
         ops.pack_sources(_t(ps, torch.float32), _t(vs, torch.float32),
                          _t(ms, torch.float32), 256)),
        (jops.pack_acc_targets(_j(at, f), 256),
         ops.pack_acc_targets(_t(at, torch.float32), 256)),
        (jops.pack_acc_sources(_j(as_, f), 256),
         ops.pack_acc_sources(_t(as_, torch.float32), 256)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask_rows_matches_reference():
    rng = np.random.default_rng(2)
    a, p = rng.standard_normal((20, 3)), rng.standard_normal(20)
    mask = rng.uniform(size=20) < 0.5
    want = jops._mask_rows(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(p))
    got = ops._mask_rows(torch.from_numpy(mask), torch.from_numpy(a),
                         torch.from_numpy(p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compute_dtype_for_matches_reference():
    assert ops.DTYPES == jops.DTYPES
    for d in ("fp32", "mixed"):
        assert ops.compute_dtype_for(d) == jops.compute_dtype_for(d)
    for d in ("fp64", "bf16"):
        with pytest.raises(ValueError):
            ops.compute_dtype_for(d)


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
@pytest.mark.parametrize("n_t,n_s,masked", [(50, 50, False), (70, 40, True)])
def test_rect_ops_match_reference_xla(n_t, n_s, masked, dtype):
    """The port's rect wrappers (packing + the plain packed version) against
    the reference's ``impl="xla"`` oracle path at float32."""
    pt, vt, ps, vs, ms, at, as_ = _rect(n_t, n_s, seed=7)
    mask = (np.random.default_rng(8).uniform(size=n_t) < 0.5) if masked \
        else None
    kw = dict(eps=1e-7, block_i=32, block_j=32, dtype=dtype)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    f = jnp.float32
    want = jops.acc_jerk_pot_rect(
        *(_j(x, f) for x in (pt, vt, ps, vs, ms)), mask_t=jm, impl="xla",
        **kw)
    got = ops.acc_jerk_pot_rect(
        *(_t(x, torch.float32) for x in (pt, vt, ps, vs, ms)), mask_t=tm,
        **kw)
    cdt = ops.compute_dtype_for(dtype)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        g, w = g.numpy().reshape(n_t, -1), np.asarray(w).reshape(n_t, -1)
        _assert_packed_close(g, w, ((0, g.shape[1]),), cdt)
    want = jops.snap_rect(
        *(_j(x, f) for x in (pt, vt, at, ps, vs, as_, ms)), mask_t=jm,
        impl="xla", **kw)
    got = ops.snap_rect(
        *(_t(x, torch.float32) for x in (pt, vt, at, ps, vs, as_, ms)),
        mask_t=tm, **kw)
    assert tuple(got.shape) == want.shape
    _assert_packed_close(got.numpy(), np.asarray(want), ((0, 3),), cdt)
