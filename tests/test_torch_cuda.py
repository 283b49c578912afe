"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (and without JAX, which ``tests/conftest.py`` imports):

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \
        -m cuda tests/test_torch_cuda.py

The shapes are small and ragged on purpose: targets that do not fill a
thread block, sources that do not fill a shared-memory tile, a batch of
three, a partial mask; for the flash kernel, lengths that do not fill its
query or key tiles and group sizes that do not divide its rows.
``chip_smoke.py`` holds the kernels at the main paths' full shapes.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nbody_force, ops

pytestmark = pytest.mark.cuda

#: fp32: sums in other orders, rsqrtf and FMA contraction; mixed: a term on
#: the other side of a bfloat16 rounding boundary (see chip_smoke.py TOL)
TOL = {None: 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels run only there")
    return torch.device("cuda", 0)


def _operands(dev, batch, n_t, n_s, block_i, block_j, seed):
    rng = np.random.default_rng(seed)

    def one():
        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)
        ps, vs = t(rng.standard_normal((n_s, 3))), t(0.1 * rng.standard_normal((n_s, 3)))
        ms = t(rng.uniform(0.5, 1.5, n_s) / n_s)
        ms[-3:] = 0.0
        pt, vt = t(rng.standard_normal((n_t, 3))), t(0.1 * rng.standard_normal((n_t, 3)))
        k = min(n_t, n_s) // 3
        pt[:k], vt[:k] = ps[:k], vs[:k]
        mask = torch.as_tensor(rng.uniform(size=n_t) < 0.7, device=dev)
        nt = -(-n_t // block_i) * block_i
        ns = -(-n_s // block_j) * block_j
        return (ops.pack_targets(pt, vt, nt, mask),
                ops.pack_sources(ps, vs, ms, ns),
                ops.pack_acc_targets(t(rng.standard_normal((n_t, 3))), nt),
                ops.pack_acc_sources(t(rng.standard_normal((n_s, 3))), ns))

    systems = [one() for _ in range(max(batch, 1))]
    if not batch:
        return systems[0]
    return tuple(torch.stack(xs) for xs in zip(*systems))


def _plain(fn, operands, **kw):
    batch = operands[0].shape[0] if operands[0].dim() == 3 else 0
    return nbody_force._plain(fn, operands, batch, eps=1e-7, **kw)


def _assert_close(got, want, tgt, cols, tol):
    assert torch.isfinite(got).all()
    for lo, hi in cols:
        d = (got[..., lo:hi] - want[..., lo:hi]).abs().max()
        assert float(d) <= tol * float(want[..., lo:hi].abs().max())
    assert (got[..., cols[-1][1]:] == 0).all()
    assert (got[tgt[..., 3] == 0] == 0).all()


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
@pytest.mark.parametrize("batch,n_t,n_s,block_i,block_j", [
    (0, 8, 96, 8, 32),        # fewer targets than a thread block
    (0, 200, 300, 8, 32),     # ragged against both kernel tiles
    (0, 1024, 2048, 256, 512),
    (3, 64, 160, 32, 32),     # leading batch axis on gridDim.y
])
def test_kernels_match_plain(cuda, batch, n_t, n_s, block_i, block_j,
                             compute_dtype):
    tgt, src, tacc, sacc = _operands(cuda, batch, n_t, n_s, block_i,
                                     block_j, seed=n_t + n_s)
    kw = dict(block_i=block_i, block_j=block_j, compute_dtype=compute_dtype)
    got = nbody_force.acc_jerk_pot_packed(tgt, src, **kw)
    want = _plain(nbody_force._acc_jerk_plain, (tgt, src), **kw)
    torch.cuda.synchronize()
    _assert_close(got, want, tgt, ((0, 3), (3, 6), (6, 7)),
                  TOL[compute_dtype])
    got = nbody_force.snap_packed(tgt, src, tacc, sacc, **kw)
    want = _plain(nbody_force._snap_plain, (tgt, src, tacc, sacc), **kw)
    torch.cuda.synchronize()
    _assert_close(got, want, tgt, ((0, 3),), TOL[compute_dtype])


#: the kernels' split of the source axis (``k*Slices`` lanes per target
#: group and ``k*Targets`` targets per block in csrc/nbody_force.cu, for
#: K1 ``kAcc*`` and for K2 ``kSnap*``); the cases below are cut against them
ACC_SLICES = 16
ACC_TARGETS = 128
SNAP_SLICES = 16
SNAP_TARGETS = 128


def _split_case(dev, batch, n_t, n_s, block, seed, slices, zero_slice=None,
                inactive=0):
    """Operands whose sources in lane ``zero_slice``'s interleave (every
    ``slices``-th source) have zero mass and whose first ``inactive``
    targets are inactive."""
    tgt, src, tacc, sacc = _operands(dev, batch, n_t, n_s, block, block, seed)
    if zero_slice is not None:
        src[..., 3, zero_slice::slices] = 0.0
    tgt[..., :inactive, 3] = 0.0
    return tgt, src, tacc, sacc


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
@pytest.mark.parametrize("batch,n_t,n_s,block,zero_slice,inactive", [
    (0, 200, 200, 8, None, 0),         # N_s not a multiple of the slices
    (0, 300, 1100, 4, None, 0),        # two full source tiles and a ragged one
    (0, 96, 264, 8, 5, 0),             # one lane's sources all massless
    (0, 400, 128, 8, None, 2 * ACC_TARGETS),  # whole blocks inactive
    (3, 200, 136, 8, 3, ACC_TARGETS),  # batch of three
])
def test_acc_jerk_kernel_split_matches_plain(cuda, batch, n_t, n_s, block,
                                             zero_slice, inactive,
                                             compute_dtype):
    ops_ = _split_case(cuda, batch, n_t, n_s, block, seed=n_t * n_s,
                       slices=ACC_SLICES, zero_slice=zero_slice,
                       inactive=inactive)[:2]
    kw = dict(block_i=block, block_j=block, compute_dtype=compute_dtype)
    got = nbody_force.acc_jerk_pot_packed(*ops_, **kw)
    want = _plain(nbody_force._acc_jerk_plain, ops_, **kw)
    torch.cuda.synchronize()
    _assert_close(got, want, ops_[0], ((0, 3), (3, 6), (6, 7)),
                  TOL[compute_dtype])
    if inactive:
        assert (got[..., :inactive, :] == 0).all()


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
def test_acc_jerk_kernel_is_deterministic(cuda, compute_dtype):
    """The slices' partials meet in a fixed order and no atomics: two
    launches on the same inputs give the same bits."""
    ops_ = _split_case(cuda, 0, 1000, 4096, 8, seed=3,
                       slices=ACC_SLICES)[:2]
    kw = dict(block_i=8, block_j=8, compute_dtype=compute_dtype)
    first = nbody_force.acc_jerk_pot_packed(*ops_, **kw)
    second = nbody_force.acc_jerk_pot_packed(*ops_, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
@pytest.mark.parametrize("batch,n_t,n_s,block,zero_slice,inactive", [
    (0, 200, 200, 8, None, 0),         # N_s not a multiple of the slices
    (0, 96, 264, 8, 5, 0),             # one lane's sources all massless
    (0, 400, 128, 8, None, 2 * SNAP_TARGETS),  # whole blocks inactive
    (3, 200, 136, 8, 3, SNAP_TARGETS),  # batch of three
])
def test_snap_kernel_split_matches_plain(cuda, batch, n_t, n_s, block,
                                         zero_slice, inactive, compute_dtype):
    ops_ = _split_case(cuda, batch, n_t, n_s, block, seed=n_t * n_s,
                       slices=SNAP_SLICES, zero_slice=zero_slice,
                       inactive=inactive)
    kw = dict(block_i=block, block_j=block, compute_dtype=compute_dtype)
    got = nbody_force.snap_packed(*ops_, **kw)
    want = _plain(nbody_force._snap_plain, ops_, **kw)
    torch.cuda.synchronize()
    _assert_close(got, want, ops_[0], ((0, 3),), TOL[compute_dtype])
    if inactive:
        assert (got[..., :inactive, :] == 0).all()


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
def test_snap_kernel_is_deterministic(cuda, compute_dtype):
    """The slices' partials meet in a fixed order and no atomics: two
    launches on the same inputs give the same bits."""
    ops_ = _split_case(cuda, 0, 1000, 4096, 8, seed=3, slices=SNAP_SLICES)
    kw = dict(block_i=8, block_j=8, compute_dtype=compute_dtype)
    first = nbody_force.snap_packed(*ops_, **kw)
    second = nbody_force.snap_packed(*ops_, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("compute_dtype", (None, "bfloat16"))
@pytest.mark.parametrize("batch,n_t,n_s,block,frac", [
    (0, 200, 16384, 32, 0.3),   # capacity 224: not a multiple of 128
    (0, 64, 4096, 8, 0.05),     # capacity 8: one block, 8 live rows
    (0, 1000, 2048, 32, 0.2),   # capacity 256: two blocks
    (3, 300, 1024, 8, 0.1),     # a batch, one capacity for all members
    (0, 512, 512, 8, 1.0),      # every row active: only the order moves
])
def test_kernels_give_a_row_its_bits_in_any_block(cuda, batch, n_t, n_s,
                                                  block, frac,
                                                  compute_dtype):
    """Gather compaction's contract on the card: a target row gets the same
    bits whatever block and lane group it lands in.  The targets are
    permuted (active rows first, in a random order) and cut to the
    capacity bucket holding the active count, and both kernels on that
    shrunk extent must equal the dense launch row for row, bit for bit."""
    tgt, src, tacc, sacc = _operands(cuda, batch, n_t, n_s, block, block,
                                     seed=n_t + n_s)
    gen = torch.Generator(device="cpu").manual_seed(n_t)
    act = torch.rand(tgt.shape[:-1], generator=gen).to(cuda) < frac
    tgt[..., 3] = act.to(torch.float32)
    kw = dict(block_i=block, block_j=block, compute_dtype=compute_dtype)
    dense = (nbody_force.acc_jerk_pot_packed(tgt, src, **kw),
             nbody_force.snap_packed(tgt, src, tacc, sacc, **kw))
    # active rows first, each group in a random order
    key = (~act).to(torch.float32) + 0.5 * torch.rand(
        act.shape, generator=gen).to(cuda)
    perm = torch.argsort(key, dim=-1)
    caps = ops.capacity_buckets(n_t, block)
    cap = caps[int(ops.bucket_index(int(act.sum(-1).max()), caps))]
    idx = perm[..., :min(cap, n_t)]

    def rows(x):
        x = torch.gather(x, -2, idx[..., None].expand(idx.shape + (8,)))
        return torch.nn.functional.pad(x, (0, 0, 0, cap - x.shape[-2]))

    shrunk = (nbody_force.acc_jerk_pot_packed(rows(tgt), src, **kw),
              nbody_force.snap_packed(rows(tgt), src, rows(tacc), sacc, **kw))
    torch.cuda.synchronize()
    live = torch.gather(act, -1, idx)
    for got, want in zip(shrunk, dense):
        back = torch.gather(want, -2, idx[..., None].expand(idx.shape + (8,)))
        assert torch.equal(got[..., :idx.shape[-1], :][live], back[live])
        assert not got[..., :idx.shape[-1], :][~live].any()


def test_wrappers_count_their_launches(cuda):
    tgt, src, tacc, sacc = _operands(cuda, 0, 64, 64, 32, 32, seed=1)
    a0, s0 = (nbody_force.acc_jerk_pot_packed.launches,
              nbody_force.snap_packed.launches)
    nbody_force.acc_jerk_pot_packed(tgt, src, block_i=32, block_j=32)
    nbody_force.snap_packed(tgt, src, tacc, sacc, block_i=32, block_j=32)
    nbody_force._acc_jerk_plain(tgt, src, eps=1e-7, block_i=32, block_j=32,
                                compute_dtype=None)
    assert nbody_force.acc_jerk_pot_packed.launches == a0 + 1
    assert nbody_force.snap_packed.launches == s0 + 1


@pytest.mark.parametrize("batch,n_t,block", [(0, 64, 32), (0, 224, 32),
                                             (0, 256, 256), (3, 4096, 256)])
def test_wrappers_record_their_grids(cuda, batch, n_t, block):
    """Each launch adds one to its grid size in the wrapper's ``blocks``:
    the launcher's grid, a block per ACC_TARGETS (SNAP_TARGETS) targets of
    each member."""
    tgt, src, tacc, sacc = _operands(cuda, batch, n_t, 512, block, 512,
                                     seed=2)
    for wrapper, x, per in (
            (nbody_force.acc_jerk_pot_packed, (tgt, src), ACC_TARGETS),
            (nbody_force.snap_packed, (tgt, src, tacc, sacc), SNAP_TARGETS)):
        blocks = -(-n_t // per) * max(batch, 1)
        before = dict(wrapper.blocks)
        wrapper(*x, block_i=block, block_j=512)
        after = dict(wrapper.blocks)
        assert after.pop(blocks) == before.pop(blocks, 0) + 1
        assert after == before


def test_refused_launch_raises(cuda):
    """A grid the card cannot launch (gridDim.y above 65535) is reported
    by the wrapper, not dropped."""
    tgt = torch.zeros(70000, 8, 8, device=cuda)
    src = torch.zeros(70000, 8, 8, device=cuda)
    before = nbody_force.acc_jerk_pot_packed.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        nbody_force.acc_jerk_pot_packed(tgt, src, block_i=8, block_j=8)
    assert nbody_force.acc_jerk_pot_packed.launches == before


#: flash kernel vs its plain version (see chip_smoke.py FLASH_TOL).  fp32:
#: max |kernel - plain| / max |plain|, the JAX package's own flash
#: tolerance (tests/test_flash_attention.py): the same fp32 products summed
#: in other orders and tile sizes.  bf16, element by element: |kernel -
#: plain| <= 2**-7 (|plain| + A), with A the attention of |v|: the two
#: roundings of each p to bf16 differ by at most one ulp (2**-7 of p), and
#: the two rounded outputs by at most one ulp (2**-7 |plain|).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
#: bf16 against the plain version at the kernel's own key tile
#: (``kBf16Keys`` in csrc/flash_attention.cu): the same running maxima, so
#: the same p up to a flip from the scores' summation order; at most this
#: share of the outputs may differ
KERNEL_KEY_TILE = 64
TILE_SHARE_TOL = 8e-3


def _assert_flash_close(got, want, q, k, v, causal, bq, bk):
    assert got.dtype == q.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    d = (got.float() - want.float()).abs()
    if q.dtype == torch.float32:
        assert float(d.max()) <= FLASH_TOL[q.dtype] * float(want.abs().max())
    else:
        mean_abs_v = fa._flash_plain(q.float(), k.float(), v.float().abs(),
                                     causal=causal, block_q=bq, block_k=bk)
        lim = FLASH_TOL[q.dtype] * (want.float().abs() + mean_abs_v)
        assert bool((d <= lim).all()), float((d / lim).max())


def _flash_operands(dev, b, sq, sk, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                 device=dev)
                 for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))


FLASH_SHAPES = [  # b, sq, sk, h, kv, d, block_q, block_k, causal
    (2, 256, 256, 8, 2, 64, 128, 128, True),
    (2, 256, 256, 8, 2, 64, 128, 128, False),
    (1, 512, 512, 4, 4, 64, 256, 128, True),     # MHA (g=1)
    (2, 128, 512, 8, 1, 32, 64, 256, False),     # MQA, rectangular
    (1, 256, 256, 16, 2, 128, 128, 64, True),    # wide heads
    (1, 48, 48, 6, 2, 16, 48, 48, True),         # g=3: rows left idle
    (1, 200, 200, 4, 1, 96, 200, 40, True),      # ragged tiles, d=96
    (1, 1024, 1024, 16, 8, 128, 512, 512, True),  # the model's heads
    (1, 8192, 8192, 16, 8, 128, 512, 512, True),    # long rows: the error
    (1, 32768, 32768, 16, 8, 128, 512, 512, True),  # grows with the keys
    (1, 2048, 2048, 32, 8, 128, 512, 512, True),    # phi3.5-moe: g=4
    (1, 2048, 2048, 12, 2, 128, 512, 512, True),    # qwen2-vl-2b: g=6
    (1, 1024, 1024, 16, 16, 64, 512, 512, False),   # seamless: encoder,
    (1, 512, 1024, 16, 16, 64, 512, 512, False),    # cross-attention,
    (1, 1, 1024, 16, 16, 64, 1, 512, False),        # its decode step
    (2, 200, 200, 6, 2, 112, 200, 40, True),        # d=112, ragged, g=3
    (1, 2048, 2048, 32, 32, 112, 512, 512, True),   # zamba2-7b: d=112,
    (1, 8192, 8192, 32, 32, 112, 512, 512, True),   # and its long prompt
    (2, 2048, 2048, 8, 4, 128, 512, 512, True),     # qwen3 on a (2, 2)
                                                    # mesh: one rank's heads
    # the other families on the (2, 2) mesh, one rank's heads and batch:
    (2, 512, 512, 16, 4, 128, 512, 512, True),      # phi3.5-moe, g = 4
    (2, 512, 512, 6, 1, 128, 512, 512, True),       # qwen2-vl-2b, g = 6
    (2, 512, 512, 8, 8, 64, 512, 512, False),       # seamless: encoder,
    (2, 128, 512, 8, 8, 64, 128, 512, False),       # cross-attention,
    (2, 1, 512, 8, 8, 64, 1, 512, False),           # its decode step
    (2, 512, 512, 16, 16, 112, 512, 512, True),     # zamba2-7b's shared
                                                    # block on the mesh
]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,bq,bk,causal", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, bq, bk,
                                    causal, dtype):
    q, k, v = _flash_operands(cuda, b, sq, sk, h, kv, d, dtype,
                              seed=sq + h + d)
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    want = fa._flash_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, q, k, v, causal, bq, bk)


#: the tile-share limit was set on rows of at most 2048 keys.  Over longer
#: rows a difference in the last bits of p moves more outputs: a plain
#: version that forms p as the kernel does (``flash_long_rows.py``,
#: ``kernel_p``) differs from the one at the kernel's tile in 0.15%, 0.33%
#: and 0.72% of the outputs at 2048, 8192 and 32768 keys (the kernel in
#: 0.32%, 0.73% and 1.45%), while summing in another order moves 0.013%,
#: 0.025% and 0.044%.  So FLASH_SHAPES' long cases are held to the
#: element-wise limit, to rows summing to one and to LEAN_TOL, not to it
TILE_SHARE_MAX_KEYS = 2048


@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,bq,bk,causal",
    [s for s in FLASH_SHAPES
     if (s[2] < KERNEL_KEY_TILE or s[2] % KERNEL_KEY_TILE == 0)
     and s[2] <= TILE_SHARE_MAX_KEYS])
def test_flash_kernel_rounds_p_as_plain_at_its_tile(cuda, b, sq, sk, h, kv,
                                                    d, bq, bk, causal):
    """bf16: against the plain version at the kernel's own key tile, p is
    rounded against the same running max, so all but a few outputs (fp32
    summation order) are equal bit for bit."""
    q, k, v = _flash_operands(cuda, b, sq, sk, h, kv, d, torch.bfloat16,
                              seed=sq + h + d)
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    bk = min(KERNEL_KEY_TILE, sk)
    want = fa._flash_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, q, k, v, causal, bq, bk)
    assert float((got != want).float().mean()) <= TILE_SHARE_TOL


def _long_rows():
    """``flash_long_rows.py`` at the root of the repository."""
    path = Path(__file__).resolve().parent.parent / "flash_long_rows.py"
    spec = importlib.util.spec_from_file_location("flash_long_rows", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: bf16 over long rows: of the outputs that differ from a version whose
#: sums run in float64, at most this share may lie nearer zero.  Rounding
#: differences lean neither way (about half; of the 10^5 to 10^6 outputs
#: that differ here, noise moves the share by about 0.1%); a P V sum
#: carried over the whole row on the tensor core, whose accumulation
#: truncates, read 53.8% at 8192 keys and 57.9% at 32768
#: (``flash_long_rows.py``)
LEAN_TOL = 0.52


@pytest.mark.parametrize("sk", (8192, 32768))
def test_flash_kernel_long_rows_lean_neither_way(cuda, sk):
    """bf16 over rows of 8192 and 32768 keys (the model's heads, causal):
    against the plain version at the kernel's key tile with l and P V
    summed in float64 (``flash_long_rows.plain``), the kernel's differing
    outputs lie nearer zero no more often than farther from it."""
    q, k, v = _flash_operands(cuda, 1, sk, sk, 16, 8, 128, torch.bfloat16,
                              seed=sk)
    got = fa.flash_attention(q, k, v, causal=True).float()
    exact = _long_rows().plain(q, k, v, acc=torch.float64).float()
    torch.cuda.synchronize()
    diff = got != exact
    assert int(diff.sum()) > 10 ** 4
    lean = float((diff & (got.abs() < exact.abs())).sum()) / float(diff.sum())
    assert lean <= LEAN_TOL


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)],
                         ids=("fp32", "bf16"))
def test_flash_kernel_rows_sum_to_one(cuda, dtype, tol):
    """With v = 1 each output is sum(p) / l.  fp32: exactly one up to
    rounding.  bf16: p enters the PV product rounded to bf16 while l sums
    it unrounded, and the output is rounded to bf16, so a row lands within
    a bf16 ulp or two of one."""
    q, k, _ = _flash_operands(cuda, 2, 256, 256, 4, 2, 64, dtype, seed=5)
    v = torch.ones_like(k)
    out = fa.flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    torch.cuda.synchronize()
    assert float((out.float() - 1.0).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("sk", (8192, 32768))
def test_flash_kernel_long_rows_sum_to_one(cuda, sk, dtype, tol):
    """Rows of 8192 and 32768 keys (the model's heads, causal) still sum to
    one within the short rows' limits: the tensor core's truncating
    accumulation must not build up over a long row."""
    q, k, _ = _flash_operands(cuda, 1, sk, sk, 16, 8, 128, dtype, seed=5)
    out = fa.flash_attention(q, k, torch.ones_like(k), causal=True)
    torch.cuda.synchronize()
    assert float((out.float() - 1.0).abs().max()) <= tol


def test_flash_kernel_counts_its_launches(cuda):
    q, k, v = _flash_operands(cuda, 1, 64, 64, 4, 2, 32, torch.bfloat16)
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v, block_q=64, block_k=64)
    fa._flash_plain(q, k, v, causal=True, block_q=64, block_k=64)
    assert fa.flash_attention.launches == before + 1


def test_flash_refused_launch_raises(cuda):
    """A head dimension the kernel has no instantiation for is refused by
    the launcher and reported by the wrapper, not dropped."""
    q, k, v = _flash_operands(cuda, 1, 64, 64, 2, 1, 256, torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention(q, k, v, block_q=64, block_k=64)
    assert fa.flash_attention.launches == before


def test_api_runs_equal_the_engines_bit_for_bit(cuda):
    """The simulation API drives the same engines: its single run is
    ``hermite.evolve`` on the same state, its block run the engine's own
    ``evolve_ensemble_block``, bit for bit, with one launch of each kernel
    per step or event and one for the bootstrap."""
    from repro_torch.core import hermite
    from repro_torch.core.evaluate import make_evaluator
    from repro_torch.obs import metrics
    from repro_torch.sim import api, scenarios
    from repro_torch.sim import ensemble as ens

    def drive(cfg):
        with metrics.use():
            runner = api.get_runner(api.resolve_kind(cfg))
            h = runner.build(cfg)
            while not runner.step(h):
                pass
            return h, runner.collect(h)

    fields = ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot", "time")
    before = nbody_force.acc_jerk_pot_packed.launches
    h, rep = drive(api.SimConfig(scenario="plummer", n=512, t_end=1 / 64,
                                 validate_ic=False))
    assert nbody_force.acc_jerk_pot_packed.launches - before == \
        rep["steps"] + 1
    st = scenarios.make("plummer", 512, seed=0, device=cuda, validate=False)
    ref = hermite.evolve(st, make_evaluator(), t_end=1 / 64)
    for f in fields:
        assert torch.equal(getattr(h.state, f), getattr(ref, f)), f

    kw = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=6, eta=0.02)
    h, rep = drive(api.SimConfig(scenario="binary_plummer", n=512,
                                 stepper="block", compaction="gather",
                                 validate_ic=False, **kw))
    st = scenarios.make("binary_plummer", 512, seed=0, device=cuda,
                        validate=False)
    ref, carry = ens.evolve_ensemble_block([st], compaction="gather", **kw)
    assert rep["steps"] == int(carry.n_events[0])
    assert rep["grid_tiles_total"] == float(carry.n_tiles[0])
    for f in fields:
        assert torch.equal(getattr(h.batched, f), getattr(ref, f)), f


@pytest.mark.parametrize("strategy", ("replicated", "two_level",
                                      "mesh_sharded", "ring"))
def test_strategies_on_card_slots_match_the_single_path(cuda, strategy):
    """Each strategy over four slots of the card against the one-card
    evaluation (relative 1e-5 per field: the sum over sources runs in
    another order under the ring; the resident strategies give its bits),
    with p (resident) or p**2 (ring) launches of each kernel."""
    from repro_torch.core import nbody, strategies
    from repro_torch.core.evaluate import make_evaluator

    st = nbody.plummer(2001, seed=5, device=cuda)
    want = make_evaluator()(st.pos, st.vel, st.mass)
    ev = strategies.make_strategy_evaluator(strategy, devices=[cuda] * 4)
    before = nbody_force.acc_jerk_pot_packed.launches
    got = ev(st.pos, st.vel, st.mass)
    torch.cuda.synchronize()
    per_eval = 16 if strategy == "ring" else 4
    assert nbody_force.acc_jerk_pot_packed.launches - before == per_eval
    for f in ("acc", "jerk", "snap", "pot"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.device == b.device and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), f
        if strategy != "ring":
            assert torch.equal(a, b), f


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
def test_ring_schedules_give_the_same_bits_on_the_card(cuda, dtype):
    from repro_torch.core import hermite, nbody, strategies
    from repro_torch.obs import metrics

    st = nbody.plummer(1500, seed=6, device=cuda)
    outs, shifts = {}, {}
    for mode in strategies.RING_MODES:
        with metrics.use() as reg:
            ev = strategies.make_strategy_evaluator(
                "ring", devices=[cuda] * 3, dtype=dtype, ring_mode=mode)
            outs[mode] = hermite.initialize(st, ev)
            shifts[mode] = reg.counter("ring.shifts_issued").value
    assert shifts == {"overlap": 4, "sync": 6}
    for f in ("acc", "jerk", "snap", "pot"):
        assert torch.equal(getattr(outs["overlap"], f),
                           getattr(outs["sync"], f)), f


@pytest.mark.parametrize("strategy", ("replicated", "two_level",
                                      "mesh_sharded", "ring"))
def test_strategy_block_gather_gives_none_bits_on_the_card(cuda, strategy):
    """Shard-local compaction on two slots of the card: the gather run has
    the none run's events and bits, no shard launches more tiles, and the
    shards launch fewer in all (a shard whose particles are all active at
    every event keeps its full window)."""
    from repro_torch.sim import ensemble as ens
    from repro_torch.sim import scenarios

    st = scenarios.make("binary_plummer", 1024, seed=0, device=cuda,
                        validate=False)
    kw = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=6, eta=0.02,
              block_i=32, block_j=256, devices=[cuda] * 2)
    a, ca = ens.evolve_strategy_block(st, strategy=strategy,
                                      compaction="none", **kw)
    b, cb = ens.evolve_strategy_block(st, strategy=strategy,
                                      compaction="gather", **kw)
    assert int(ca.n_events) == int(cb.n_events) > 0
    assert (cb.n_tiles <= ca.n_tiles).all()
    assert float(cb.n_tiles.sum()) < float(ca.n_tiles.sum())
    for f in ("pos", "vel", "acc", "jerk", "snap", "crackle", "pot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# --------------------------------------------------------------------------
# the Ahmad-Cohen neighbor scheme and the simulation server on the card
# --------------------------------------------------------------------------
def _near_case(dev, dtype):
    """A sorted Plummer 4096, its windows at radius 0.25, and a seeded 30%
    of the rows of the blocks whose windows fit below the full extent (the
    first block inactive); returns the evaluator pair, its arguments and
    the bucket that holds every active block's window."""
    from repro_torch.core.evaluate import make_neighbor_block_evaluator
    from repro_torch.kernels import neighbor
    from repro_torch.sim import ensemble as ens
    from repro_torch.sim import scenarios

    n, b = 4096, 32
    st = ens.spatial_sort_batched(ens.stack_states(
        [scenarios.make("plummer", n, seed=0, device=dev, validate=False)]),
        leaf=b)
    st = ens.ensemble_initialize(st)
    real = torch.ones(1, n, dtype=torch.bool, device=dev)
    win_idx, win_cnt = neighbor.build_windows(st.pos, real, block_i=b,
                                              block_j=b, radius=0.25)
    plan = ops.CapacityPlan(n, n, b, b, sources="neighbor")
    fits = win_cnt * b <= plan.source_caps[-2]
    rng = np.random.default_rng(3)
    mask = torch.as_tensor(rng.uniform(size=(1, n)) < 0.3, device=dev)
    mask &= fits.repeat_interleave(b, dim=1)
    mask[:, :b] = False
    w = int(plan.source_bucket(torch.where(fits, win_cnt, 0).max() * b))
    near = make_neighbor_block_evaluator(n=n, eps=1e-7, block_i=b,
                                         block_j=b, dtype=dtype)
    args1 = (st.pos, st.vel, st.mass, mask, win_idx, win_cnt)
    args2 = (st.pos, st.vel, st.acc, st.acc, st.mass, mask, win_idx,
             win_cnt)
    return near, args1, args2, w, mask


@pytest.mark.parametrize("dtype,compute_dtype", [("fp32", None),
                                                 ("mixed", "bfloat16")])
def test_near_passes_match_plain(cuda, monkeypatch, dtype, compute_dtype):
    """``near1``/``near2`` through K1/K2 (one launch per pass for every
    target block) against the same evaluator with the kernels' plain
    versions on the same windows."""
    (near1, near2), args1, args2, w, mask = _near_case(cuda, dtype)
    before = nbody_force.acc_jerk_pot_packed.launches
    got = near1(*args1, w) + (near2(*args2, w),)
    assert nbody_force.acc_jerk_pot_packed.launches - before == 1
    for name, fn in (("acc_jerk_pot_packed", nbody_force._acc_jerk_plain),
                     ("snap_packed", nbody_force._snap_plain)):
        monkeypatch.setattr(
            nbody_force, name,
            lambda *x, _fn=fn, **kw: _plain(
                _fn, x, **{k: v for k, v in kw.items() if k != "eps"}))
    want = near1(*args1, w) + (near2(*args2, w),)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - p).abs().max()) <= \
            TOL[compute_dtype] * float(p.abs().max())
        assert (g[~mask] == 0).all()


@pytest.mark.parametrize("dtype", ("fp32", "mixed"))
def test_near_bucket_growth_is_bit_for_bit(cuda, dtype):
    """A window evaluated at its bucket and at the next one up: the extra
    slots are zero-mass tail rows of K1's lane-strided tiles, so they add
    exact zeros."""
    (near1, near2), args1, args2, w, _ = _near_case(cuda, dtype)
    a = near1(*args1, w) + (near2(*args2, w),)
    b = near1(*args1, w + 1) + (near2(*args2, w + 1),)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_neighbor_golden_replays_through_the_kernels(cuda):
    """binary_plummer_neighbor.json at fp32 through K1/K2 on the card: the
    golden's event count, positions and velocities within BLOCK_TOL fp32."""
    import json
    import os

    from repro_torch.sim import ensemble as ens
    from repro_torch.sim import scenarios

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "binary_plummer_neighbor.json")
    with open(path) as f:
        doc = json.load(f)
    m = doc["meta"]
    st = scenarios.make(m["scenario"], m["n"], seed=m["seed"], device=cuda)
    before = nbody_force.acc_jerk_pot_packed.launches
    out, carry = ens.evolve_ensemble_block(
        [st], t_end=m["t_end"], dt_max=m["dt_max"], n_levels=m["n_levels"],
        eta=m["eta"], order=m["order"], eps=m["eps"], sources="neighbor",
        neighbor_radius=m["neighbor_radius"],
        refresh_levels=m["refresh_levels"], block_i=m["block_i"],
        block_j=m["block_j"], dtype="fp32")
    assert nbody_force.acc_jerk_pot_packed.launches > before
    assert int(carry.n_events[0]) == doc["n_events"]
    assert int(carry.nbr.n_refresh[0]) > 0
    assert float((out.pos[0].cpu() - torch.tensor(doc["pos"])).abs().max()) \
        <= 1e-6
    assert float((out.vel[0].cpu() - torch.tensor(doc["vel"])).abs().max()) \
        <= 1e-5


@pytest.mark.parametrize("sources", ("full", "neighbor"))
def test_server_suspend_resume_is_bit_for_bit_on_the_card(cuda, tmp_path,
                                                          sources):
    """A server suspended after two ticks and resumed in a fresh one ends
    every request in the uninterrupted run's state, bit for bit."""
    from repro_torch.serve import ServerConfig, SimRequest, SimServer
    from repro_torch.sim.scenarios import ScenarioSpec

    cfg = ServerConfig(slots_per_pod=2, n_max=512, chunk_events=8,
                       block_i=32, block_j=32, sources=sources,
                       neighbor_radius=0.25)

    def build():
        s = SimServer(cfg)
        for i, (tok, stepper) in enumerate((
                ("plummer:512", "block"), ("king:256", "adaptive"),
                ("binary_plummer:384", "block"), ("merger:512", "adaptive"),
                ("plummer:300", "block"))):
            s.submit(SimRequest(spec=ScenarioSpec.parse(tok, seed=i),
                                stepper=stepper, t_end=1 / 256), now=0.0)
        return s

    finals = {}
    straight = build()
    for r in straight.run_until_drained():
        finals[r["request_id"]] = (r["steps"], r["e1"], r["t_final"])
    paused = build()
    paused.step(now=0.0)
    paused.step(now=1.0)
    paused.suspend(str(tmp_path))
    resumed = SimServer.resume(str(tmp_path))
    for pod in resumed.pods.values():
        assert pod.batched.pos.device.type == "cuda"
    got = {r["request_id"]: (r["steps"], r["e1"], r["t_final"])
           for r in paused.reports + resumed.run_until_drained()}
    assert got == finals


def _plummer_batch(dev, b, n, seed=0):
    from repro_torch.sim import ensemble as ens
    from repro_torch.sim import scenarios
    return ens.stack_states([scenarios.make("plummer", n, seed=seed + i,
                                            device=dev, validate=False)
                             for i in range(b)])


def test_batch_layout_over_card_slots_is_one_slot_bitwise(cuda):
    """chip_smoke phase 13 (a) at a small N: a batch of three over two
    slots of the card (padded to four) gives the one-slot run's bits and
    counters, fixed dt and block gather alike, and launches on each slot."""
    from repro_torch.sim import ensemble as ens
    batched = _plummer_batch(cuda, 3, 512)
    slots = [cuda] * 2
    one = ens.evolve_ensemble(batched, n_steps=3, dt=2.0 ** -10)
    two = ens.evolve_ensemble(batched, n_steps=3, dt=2.0 ** -10,
                              devices=slots)
    for f in ("pos", "vel", "acc", "jerk", "snap", "pot", "time"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    kw = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=4, compaction="gather",
              block_i=64, block_j=128)
    a, ca = ens.evolve_ensemble_block(batched, **kw)
    before = nbody_force.acc_jerk_pot_packed.launches
    b, cb = ens.evolve_ensemble_block(batched, devices=slots, **kw)
    assert nbody_force.acc_jerk_pot_packed.launches > before
    for f in ("pos", "vel", "acc", "jerk", "snap", "pot", "time"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(ca[:7], cb[:7]):
        assert torch.equal(x, y)


def test_fused_mesh_on_card_slots_is_the_1d_and_solo_runs(cuda):
    """chip_smoke phase 13 (b) at a small N: the fused 2x2 mesh over four
    slots of the card equals the 1-D layout over two and each member's
    solo mesh_sharded run at p = 2, bit for bit, one K1 launch per slot
    per event."""
    from repro_torch.sim import ensemble as ens
    batched = _plummer_batch(cuda, 4, 1024)
    init = ens.ensemble_initialize(batched, eps=4 / 1024)
    kw = dict(t_end=1 / 16, dt_max=1 / 16, n_levels=4, eps=4 / 1024,
              compaction="gather", n_events=64)
    before = nbody_force.acc_jerk_pot_packed.launches
    f, cf = ens.ensemble_run_block(init, mesh=(2, 2), devices=[cuda] * 4,
                                   **kw)
    launched = nbody_force.acc_jerk_pot_packed.launches - before
    assert launched == 4 * int(cf.n_events.max())
    o, co = ens.ensemble_run_block(init, devices=[cuda] * 2, **kw)
    fields = ("pos", "vel", "acc", "jerk", "snap", "pot", "time")
    for name in fields:
        assert torch.equal(getattr(f, name), getattr(o, name)), name
    assert torch.equal(cf.n_events, co.n_events)
    for i in range(4):
        m = type(init)(**{k: getattr(init, k)[i] for k in
                          ("pos", "vel", "acc", "jerk", "snap", "crackle",
                           "mass", "pot", "time")})
        s, cs = ens.strategy_run_block(m, strategy="mesh_sharded",
                                       devices=[cuda] * 2, **kw)
        for name in fields:
            assert torch.equal(getattr(f, name)[i], getattr(s, name)), \
                (i, name)
        assert int(cs.n_events) == int(cf.n_events[i])


@pytest.mark.parametrize("sources", ("full", "neighbor"))
def test_mesh_server_on_card_slots_is_one_slot_bitwise(cuda, tmp_path,
                                                       monkeypatch, sources):
    """chip_smoke phase 13 (c) at a small N: a server on the fused mesh of
    four slots of the card ends every request in a one-slot server's
    state, and a suspend/resume under the mesh continues bit for bit."""
    from repro_torch.serve import ServerConfig, SimRequest, SimServer
    from repro_torch.sim.scenarios import ScenarioSpec

    base = dict(slots_per_pod=4, n_max=512, chunk_events=4, block_i=32,
                block_j=32, sources=sources, neighbor_radius=0.25,
                eps=4 / 512, devices=4, mesh=(2, 2))
    # four slots of the one card, where the server would take four cards
    monkeypatch.setattr(ServerConfig, "slots", lambda self: (
        None if self.devices == 1 else [cuda] * self.devices))

    def run(cfg, pause=False):
        s = SimServer(cfg)
        for seed in (1, 2, 3):
            s.submit(SimRequest(spec=ScenarioSpec.parse("plummer:512",
                                                         seed=seed),
                                stepper="block", t_end=1 / 256), now=0.0)
        if pause:
            s.step(now=0.0)
            s.suspend(str(tmp_path))
            s = SimServer.resume(str(tmp_path))
        s.run_until_drained()
        (pod,) = s.pods.values()
        return {f: getattr(pod.batched, f) for f in ("pos", "vel", "acc",
                                                     "snap", "time")}

    mesh = run(ServerConfig(**base))
    one = run(ServerConfig(**dict(base, devices=1, mesh=None)))
    resumed = run(ServerConfig(**base), pause=True)
    for f in mesh:
        assert torch.equal(mesh[f], one[f]), f
        assert torch.equal(mesh[f], resumed[f]), f


def test_flash_refuses_a_gradient_on_the_card(cuda):
    """The kernel has no backward (the reference kernel has no VJP): a call
    autograd would record raises instead of training with a silently zero
    attention gradient; under no_grad, or with no input requiring a
    gradient, it launches."""
    import dataclasses

    from repro_torch.launch.train import scaled_config
    from repro_torch.models import config as C
    from repro_torch.models import model, params as P
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    q, k, v = _flash_operands(cuda, 1, 64, 64, 4, 2, 32, torch.bfloat16)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        fa.flash_attention(q, k, v, block_q=64, block_k=64)
    before = fa.flash_attention.launches
    with torch.no_grad():
        fa.flash_attention(q, k, v, block_q=64, block_k=64)
    fa.flash_attention(q.detach(), k, v, block_q=64, block_k=64)
    assert fa.flash_attention.launches == before + 2
    cfg = dataclasses.replace(scaled_config(C.get("qwen3-0.6b"), 0.04),
                              attn_impl="flash", dtype="bfloat16")
    pp = P.init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW(learning_rate=1e-3)
    with pytest.raises(NotImplementedError, match="no VJP"):
        make_train_step(cfg, opt)(pp, opt.init(pp), batch)
    logits, _ = model.forward(cfg, pp, batch)   # no parameter needs a grad
    assert bool(torch.isfinite(logits).all())


def test_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """tests/test_substrate.py's TINY config, fp32, one step of the same
    parameters and batch on the card and on the CPU: the same function
    summed in other orders (TF32 off).  Loss and gnorm within 1e-5
    relative, the parameters within test_substrate.py's accum bound."""
    from repro_torch import tree as tree_util
    from repro_torch.models import params as P
    from repro_torch.models.config import ArchConfig
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                     attn_chunked_above=10 ** 9, dtype="float32")
    cpu = P.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = tree_util.map(lambda x: x.to(cuda), cpu)
    toks = np.random.default_rng(0).integers(0, 256, (4, 33), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(cfg, opt)
    cpu, _, mc = step(cpu, opt.init(cpu), batch)
    card, _, mg = step(card, opt.init(card),
                       {k: v.to(cuda) for k, v in batch.items()})
    for key in ("loss", "gnorm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(float(mc[key]))
    for a, b in zip(tree_util.leaves(card), tree_util.leaves(cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-3,
                                   atol=5e-5)


def test_moe_prefill_and_decode_give_the_same_bits_twice(cuda):
    """The MoE combine sums each token's slots in a fixed order (no
    atomics): two prefills of one batch, and two decode steps from equal
    caches, give the same bits on the card."""
    import dataclasses

    from repro_torch.launch.train import scaled_config
    from repro_torch.models import config as C
    from repro_torch.models import model, params as P

    cfg = dataclasses.replace(
        scaled_config(C.get("phi3.5-moe-42b-a6.6b"), 0.25),
        dtype="bfloat16", param_dtype="bfloat16", attn_impl="flash")
    pp = P.init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    runs = [model.prefill(cfg, pp, {"tokens": toks}, max_len=520)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for name in runs[0][1]["layers"]:
        assert torch.equal(runs[0][1]["layers"][name],
                           runs[1][1]["layers"][name])
    nxt = runs[0][0].argmax(-1)[:, None]
    steps = [model.decode_step(cfg, pp, cache, nxt)[0] for _, cache in runs]
    assert torch.equal(steps[0], steps[1])


FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "qwen2-vl-2b",
                "seamless-m4t-medium", "xlstm-1.3b", "zamba2-7b")


def _family_batch(cfg, b, s, seed):
    from repro_torch.data import SyntheticLM, batch_spec_for

    nb = SyntheticLM(cfg, batch_spec_for(cfg, b, s), seed=seed)(0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                       arch):
    """Each non-dense family at scale 0.04 (fp32, a few layers), at the
    CPU parity tests' size (B = 2, S = 32; the scans in chunks of 8, as
    tests/test_torch_train_ssm.py runs them): the loss and every gradient
    leaf of the same parameters and batch on the card and on the CPU,
    within those tests' fp32 tolerance (the loss to 1e-6 relative, a leaf
    to 1e-5 of its largest element; TF32 off), then one whole train step
    on each, whose loss and gnorm agree to 1e-5 relative."""
    import dataclasses

    from repro_torch import tree as tree_util
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import config as C
    from repro_torch.models import params as P
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step
    from repro_torch.train.step import _value_and_grad

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = scaled_config(C.get(arch), 0.04)
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, chunk_size=8)
    cpu = P.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = tree_util.map(lambda x: x.to(cuda), cpu)
    batch = _family_batch(cfg, 2, 32, seed=1)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    lc, _, gc = _value_and_grad(cfg, cpu, batch)
    lg, _, gg = _value_and_grad(cfg, card, on_card)
    assert abs(float(lg) - float(lc)) <= 1e-6 * abs(float(lc))
    for g, c in zip(tree_util.leaves(gg), tree_util.leaves(gc)):
        if c.numel():
            scale = max(float(c.abs().max()), 1e-30)
            assert float((g.cpu() - c).abs().max()) <= 1e-5 * scale
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(cfg, opt)
    _, _, mc = step(cpu, opt.init(cpu), batch)
    _, _, mg = step(card, opt.init(card), on_card)
    for key in ("loss", "gnorm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(float(mc[key]))


@pytest.mark.parametrize("arch", ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"))
def test_moe_gradients_give_the_same_bits_twice(cuda, arch):
    """The MoE dispatch gathers each token into up to top_k slots; the
    gather's backward adds those slots' gradients into one row.  Two
    gradient calls from the same parameters and batch (bf16 activations)
    give the same loss and the same bits in every leaf on the card."""
    import dataclasses

    from repro_torch import tree as tree_util
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import config as C
    from repro_torch.models import params as P
    from repro_torch.train.step import _value_and_grad

    cfg = dataclasses.replace(scaled_config(C.get(arch), 0.25),
                              dtype="bfloat16")
    pp = P.init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda)
    batch = {k: v.to(cuda) for k, v in _family_batch(cfg, 2, 512, 2).items()}
    l1, _, g1 = _value_and_grad(cfg, pp, batch)
    l2, _, g2 = _value_and_grad(cfg, pp, batch)
    assert torch.equal(l1, l2)
    for a, b in zip(tree_util.leaves(g1), tree_util.leaves(g2)):
        assert torch.equal(a, b)


def _spawned(world, backend, device, jobs, out):
    from repro_torch.distributed import mesh_runs, process_mesh

    process_mesh.spawn(mesh_runs.strategy_rank, world, backend, device, jobs,
                       str(out))
    return mesh_runs.load_ranks(str(out), world)


def _assert_in_process_bits(ranks, ref):
    """Every rank's tensors are the in-process mesh's; each rank launches
    its one slot's share of the mesh's launches and issues its shifts."""
    for res in ranks:
        for got, want in zip(res, ref, strict=True):
            for name, t in want["tensors"].items():
                assert torch.equal(got["tensors"][name], t), name
            c, w = got["counts"], want["counts"]
            assert c["shifts"] == w["shifts"]
            for k in ("acc_jerk_pot", "snap"):
                assert len(ranks) * c[k] == w[k], k


def test_nccl_at_one_rank_gives_the_one_slot_bits(cuda, tmp_path):
    """One nccl rank on the card (``chip_smoke.py`` phase 20 (c)): the
    bootstrap, two steps and the launches equal the one-slot in-process
    mesh's."""
    from repro_torch.distributed import mesh_runs

    jobs = [dict(kind="lockstep", strategy="replicated", n=1000, seed=3,
                 steps=2)]
    ranks = _spawned(1, "nccl", "cuda", jobs, tmp_path)
    _assert_in_process_bits(ranks, mesh_runs.in_process([cuda], jobs))
    assert ranks[0][0]["counts"]["acc_jerk_pot"] == 3


def test_nccl_refuses_two_ranks_on_one_card(cuda):
    """Phase 20 (d): more nccl ranks than cards raise ``ValueError``
    naming the visible count, before any process group exists."""
    import torch.distributed as dist

    from repro_torch.distributed import mesh_runs, process_mesh

    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{visible} cards visible"):
        process_mesh.spawn(mesh_runs.strategy_rank, visible + 1, "nccl",
                           "cuda", [], "unused")
    assert not dist.is_initialized()


@pytest.mark.parametrize("strategy,mode", [("two_level", "overlap"),
                                           ("ring", "sync")])
def test_gloo_ranks_on_one_card_give_the_in_process_bits(cuda, tmp_path,
                                                         strategy, mode):
    """Two gloo ranks on ``cuda:0``, their tensors staged through host
    memory, against ``[cuda:0] * 2`` in this process: a bootstrap and a
    step, and one block evaluation in each compaction."""
    from repro_torch.core import hermite, nbody
    from repro_torch.core.evaluate import make_evaluator
    from repro_torch.distributed import mesh_runs

    st = hermite.initialize(nbody.plummer(999, seed=4, device=cuda),
                            make_evaluator())
    mask = torch.arange(999, device=cuda) % 3 == 0
    inputs = tuple(t.cpu() for t in (st.pos, st.vel, st.acc, st.mass, mask))
    kw = dict(strategy=strategy, ring_mode=mode)
    jobs = [dict(kind="lockstep", n=999, steps=1, **kw)] + [
        dict(kind="block", compaction=c, inputs=inputs, **kw)
        for c in ("none", "gather")]
    ranks = _spawned(2, "gloo", cuda, jobs, tmp_path)
    _assert_in_process_bits(ranks, mesh_runs.in_process([cuda] * 2, jobs))
