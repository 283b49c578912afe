"""Port parity: the compaction layer of ``repro_torch.kernels.ops`` and the
gather evaluator of ``repro_torch.core.evaluate`` against ``repro``.

The capacity schedule and the tile accounting must equal the reference's;
the gather evaluator must equal the port's own dense masked evaluator bit
for bit (each target row is a row-local sum over the same sources in the
same order, whatever block it sits in) and the JAX gather evaluator to the
precision tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hermite as jhermite
from repro.core.evaluate import make_block_evaluator as jax_block_evaluator
from repro.kernels import ops as jops
from repro_torch.core import evaluate, hermite
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small tensor operations; with the default
    thread pool in each of several test workers, idle pool threads spin
    and starve the other workers, so each test here takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRID = [(n, bi) for n in (1, 7, 24, 100, 200, 256, 1000, 16384)
        for bi in (8, 16, 32, 128, 256)]


@pytest.mark.parametrize("n,block_i", GRID)
def test_capacity_schedule_matches_the_reference(n, block_i):
    caps = ops.capacity_buckets(n, block_i)
    assert caps == jops.capacity_buckets(n, block_i)
    plan = ops.CapacityPlan(n, n, block_i, 2 * block_i)
    jplan = jops.CapacityPlan(n, n, block_i, 2 * block_i)
    assert plan.caps == jplan.caps
    assert plan.tiles_by_cap == jplan.tiles_by_cap
    assert plan.dense_tiles == jplan.dense_tiles
    assert plan.tile_io_bytes == jplan.tile_io_bytes
    assert plan.io_bytes_per_element == jplan.io_bytes_per_element
    counts = np.arange(n + 1)
    got = ops.bucket_index(torch.as_tensor(counts), caps).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.bucket_index(jnp.asarray(counts), caps)))
    assert (np.asarray(caps)[got] >= counts).all()
    for idx in range(len(caps)):
        assert plan.tiles(idx) == int(jplan.tiles(idx))
    for ceiling in sorted({1, caps[0], caps[-1] // 2 + 1, caps[-1]}):
        assert plan.restrict(ceiling).caps == jplan.restrict(ceiling).caps
    with pytest.raises(ValueError, match="outside"):
        plan.restrict(caps[-1] + 1)


@pytest.mark.parametrize("dtype", ops.DTYPES)
def test_plan_dtype_bytes(dtype):
    plan = ops.CapacityPlan(256, 256, 32, 256, dtype=dtype)
    jplan = jops.CapacityPlan(256, 256, 32, 256, dtype=dtype)
    assert plan.tile_io_bytes == jplan.tile_io_bytes
    with pytest.raises(ValueError, match="plan dtype"):
        ops.CapacityPlan(256, 256, 32, 256, dtype="fp16")


def _mask(rng, shape, frac):
    return torch.as_tensor(rng.uniform(size=shape) < frac)


def _perm(mask):
    return torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("batch", (0, 3))
def test_compact_then_scatter_is_identity_on_active_rows(seed, batch):
    rng = np.random.default_rng(seed)
    n, block_i = int(rng.integers(2, 60)), int(rng.integers(1, 17))
    shape = (batch, n) if batch else (n,)
    x = torch.as_tensor(rng.standard_normal(shape + (3,)))
    mask = _mask(rng, shape, rng.uniform())
    caps = ops.capacity_buckets(n, block_i)
    cap = caps[int(ops.bucket_index(mask.sum(-1).max(), caps))]
    perm = _perm(mask)
    x_c, m_c = ops.compact_targets(perm, cap, x, mask)
    assert x_c.shape[-2] == min(cap, n)
    (back,) = ops.scatter_outputs(perm, cap, n, x_c * m_c[..., None])
    np.testing.assert_array_equal(back[mask].numpy(), x[mask].numpy())
    assert not back[~mask].any()
    # the inputs are read, never written
    assert x_c.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batch", (0, 2))
def test_scatter_sources_is_where_of_scatter_outputs(seed, batch):
    rng = np.random.default_rng(seed + 10)
    n, block_i = 40, 8
    shape = (batch, n) if batch else (n,)
    base = torch.as_tensor(rng.standard_normal(shape + (3,)))
    keep = base.clone()
    upd_full = torch.as_tensor(rng.standard_normal(shape + (3,)),
                               dtype=torch.float32)
    mask = _mask(rng, shape, 0.3)
    perm = _perm(mask)
    caps = ops.capacity_buckets(n, block_i)
    cap = caps[int(ops.bucket_index(mask.sum(-1).max(), caps))]
    upd, m_c = ops.compact_targets(perm, cap, upd_full, mask)
    got = ops.scatter_sources(perm, cap, base, upd, m_c)
    (dense,) = ops.scatter_outputs(perm, cap, n, upd)
    want = torch.where(mask[..., None], dense.to(base.dtype), base)
    assert torch.equal(got, want)
    assert torch.equal(base, keep)


def test_batched_packing_is_the_stack_of_members():
    rng = np.random.default_rng(3)
    pos, vel, acc = (torch.as_tensor(rng.standard_normal((3, 20, 3)))
                     for _ in range(3))
    mass = torch.as_tensor(rng.uniform(size=(3, 20)))
    mask = _mask(rng, (3, 20), 0.5)
    cases = [(ops.pack_targets, (pos, vel, 32, mask)),
             (ops.pack_sources, (pos, vel, mass, 64)),
             (ops.pack_acc_targets, (acc, 32)),
             (ops.pack_acc_sources, (acc, 64))]
    for fn, args in cases:
        got = fn(*args)
        want = torch.stack([fn(*(a[b] if isinstance(a, torch.Tensor) else a
                                 for a in args)) for b in range(3)])
        assert torch.equal(got, want) and got.is_contiguous(), fn.__name__
    (a,) = ops._mask_rows(mask, acc)
    assert torch.equal(a, acc * mask[..., None])


def _operands(rng, shape):
    def t(x):
        return torch.as_tensor(x)
    pos = t(rng.standard_normal(shape + (3,)))
    vel = t(rng.standard_normal(shape + (3,)))
    ap = t(rng.standard_normal(shape + (3,)))
    mass = t(rng.uniform(0.1, 1.0, shape))
    return pos, vel, ap, mass


@pytest.mark.parametrize("dtype", ops.DTYPES)
@pytest.mark.parametrize("frac", (0.0, 0.1, 0.5, 1.0))
@pytest.mark.parametrize("batch,n,block_i,block_j", [
    (0, 24, 8, 128), (0, 200, 32, 64), (3, 100, 16, 32), (2, 48, 8, 8)])
def test_gather_evaluator_bitwise_equals_dense(batch, n, block_i, block_j,
                                               frac, dtype):
    rng = np.random.default_rng(n + block_i)
    shape = (batch, n) if batch else (n,)
    pos, vel, ap, mass = _operands(rng, shape)
    mask = _mask(rng, shape, frac)
    kw = dict(eps=1e-7, order=6, block_i=block_i, block_j=block_j,
              dtype=dtype)
    dense = evaluate.make_block_evaluator(**kw)(pos, vel, ap, mass, mask)
    caps = ops.capacity_buckets(n, block_i)
    plan = ops.CapacityPlan(n, n, block_i, block_j)
    ci = int(evaluate.shared_cap_index(plan, mask.sum(-1)))
    assert caps[ci] >= int(mask.sum(-1).max())
    packed = evaluate.make_block_evaluator(compaction="gather", **kw)(
        pos, vel, ap, mass, mask, _perm(mask), ci)
    for name, a, b in zip(dense._fields, dense, packed):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
        assert not b[~mask].any(), name


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
def test_gather_evaluator_any_bucket_holding_the_count(dtype):
    """A wider bucket than the count needs (a group's shared cap) gives the
    same bits: the extra gathered rows are inactive fill."""
    rng = np.random.default_rng(5)
    n, block_i = 64, 8
    pos, vel, ap, mass = _operands(rng, (n,))
    mask = _mask(rng, (n,), 0.1)
    kw = dict(block_i=block_i, block_j=16, dtype=dtype)
    gather = evaluate.make_block_evaluator(compaction="gather", **kw)
    caps = ops.capacity_buckets(n, block_i)
    first = int(ops.bucket_index(mask.sum(), caps))
    outs = [gather(pos, vel, ap, mass, mask, _perm(mask), ci)
            for ci in range(first, len(caps))]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], out))
    # n_caps truncates the schedule: index 0 of a 2-bucket group is caps[0]
    two = evaluate.make_block_evaluator(compaction="gather", n_caps=2, **kw)
    if first <= 1:
        got = two(pos, vel, ap, mass, mask, _perm(mask), first)
        assert all(torch.equal(a, b) for a, b in zip(outs[0], got))


@pytest.mark.parametrize("dtype,tol", [("fp64", 1e-12), ("fp32", 1e-5),
                                       ("mixed", 1e-2)])
def test_gather_evaluator_matches_jax(dtype, tol):
    rng = np.random.default_rng(11)
    n, block_i, block_j = 40, 8, 128
    pos, vel, ap, mass = _operands(rng, (n,))
    mask = _mask(rng, (n,), 0.3)
    perm = _perm(mask)
    caps = ops.capacity_buckets(n, block_i)
    ci = int(ops.bucket_index(mask.sum(), caps))
    got = evaluate.make_block_evaluator(
        compaction="gather", block_i=block_i, block_j=block_j, dtype=dtype)(
            pos, vel, ap, mass, mask, perm, ci)
    jkw = dict(impl="xla", block_i=block_i, block_j=block_j,
               compaction="gather")
    jkw.update(precision="fp64" if dtype == "fp64" else "fp32",
               dtype=None if dtype == "fp64" else dtype)
    want = jax_block_evaluator(**jkw)(
        *(jnp.asarray(x.numpy()) for x in (pos, vel, ap, mass, mask)),
        jnp.asarray(perm.numpy()), ci)
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a.numpy() - b).max()) <= tol * scale, name


def test_shared_cap_index_clamps_and_takes_the_max():
    plan = ops.CapacityPlan(100, 100, 16, 32)
    assert plan.caps == (16, 32, 64, 112)
    assert int(evaluate.shared_cap_index(plan, torch.tensor([3, 40, 0]))) == 2
    assert int(evaluate.shared_cap_index(plan, torch.tensor([[0]]))) == 0
    assert int(evaluate.shared_cap_index(plan, torch.tensor([500]))) == 3


@pytest.mark.parametrize("dt_max,dtype,want", [
    (0.0625, None, torch.float64),
    (np.float32(0.0625), None, torch.float32),
    (torch.tensor(0.0625, dtype=torch.float32), None, torch.float32),
    (torch.tensor(0.0625, dtype=torch.float64), None, torch.float64),
    (0.0625, torch.float32, torch.float32),
    (torch.tensor(0.0625, dtype=torch.float64), torch.float32,
     torch.float32),
])
def test_block_level_dt_dtype_follows_the_reference(dt_max, dtype, want):
    """A Python number is taken at float64 (the reference's default float
    under x64), a tensor or numpy scalar keeps its own dtype, an explicit
    dtype wins."""
    levels = torch.tensor([0, 1, 3, 7], dtype=torch.int32)
    got = hermite.block_level_dt(levels, dt_max, dtype)
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}
    jarg = (jnp.asarray(dt_max.numpy()) if isinstance(dt_max, torch.Tensor)
            else dt_max)
    ref = jhermite.block_level_dt(jnp.asarray(levels.numpy()), jarg,
                                  None if dtype is None else jdt[dtype])
    assert got.dtype == want
    assert np.asarray(ref).dtype == got.numpy().dtype
    # values to an ulp: the port scales by an exact power of two, XLA's
    # exp2 of a negative integer may land one ulp off it
    eps = float(torch.finfo(want).eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=eps,
                               atol=0)
    exact = np.ldexp(got.numpy()[0], -levels.numpy())
    np.testing.assert_array_equal(got.numpy(), exact)
