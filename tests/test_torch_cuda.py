"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (and without JAX, which ``tests/conftest.py`` imports):

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \
        -m cuda tests/test_torch_cuda.py

The shapes are small and ragged on purpose: targets that do not fill a
thread block, sources that do not fill a shared-memory tile, a batch of
three, a partial mask.  ``chip_smoke.py`` holds the kernels at the main
path's full shape.
"""

import numpy as np
import pytest
import torch

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


def test_refused_launch_raises(cuda):
    """A grid the card cannot launch (gridDim.y above 65535) is reported
    by the wrapper, not dropped."""
    tgt = torch.zeros(70000, 8, 8, device=cuda)
    src = torch.zeros(70000, 8, 8, device=cuda)
    before = nbody_force.acc_jerk_pot_packed.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        nbody_force.acc_jerk_pot_packed(tgt, src, block_i=8, block_j=8)
    assert nbody_force.acc_jerk_pot_packed.launches == before
