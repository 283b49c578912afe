"""Port parity of the gradient compression: ``repro_torch.distributed.
compression`` against ``repro.distributed.compression``.

The unkeyed path (round half to even, float32 division) gives the
reference's bits on the same inputs; the reference runs eagerly here, as
its tests call it.  The keyed (stochastic) path draws from a
``torch.Generator``: it is held to its distribution, not to
``jax.random``'s bits.  Inputs come from a seed with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcompression
from repro_torch import tree as tree_util
from repro_torch.distributed import compression


def _inputs():
    rng = np.random.default_rng(5)
    # levels that land exactly on .5 (scale 1): ties round to even
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 0.0],
                    np.float32)
    return {"normal": rng.standard_normal(1000).astype(np.float32),
            "small": (1e-6 * rng.standard_normal((7, 33))).astype(np.float32),
            "ties": ties,
            "zeros": np.zeros(16, np.float32),
            "bf16": rng.standard_normal(64).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_quantize_and_dequantize_equal_the_reference_bit_for_bit(name):
    x = _inputs()[name]
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if name == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = compression.quantize(tx)
    jq, js = jcompression.quantize(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    d = compression.dequantize(q, s)
    np.testing.assert_array_equal(d.numpy(), np.asarray(
        jcompression.dequantize(jq, js)))
    if name == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 126, 0]


def test_compress_leaf_and_tree_equal_the_reference_over_rounds():
    """Five error-feedback rounds on a tree: g_hat and the residual equal
    the reference's bit for bit at every round."""
    rng = np.random.default_rng(7)
    shapes = {"embed": (40, 8), "final_norm": (8,),
              "blocks": {"q": (2, 8, 8), "ln1": (2, 8)}}

    def draw(scale):
        return tree_util.map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes)

    terr = compression.zeros_error(tree_util.map(torch.zeros, shapes))
    jerr = jcompression.zeros_error(tree_util.map(jnp.zeros, shapes))
    for r in range(5):
        g = draw(10.0 ** -r)
        tg, terr = compression.compress_tree(
            tree_util.map(torch.from_numpy, g), terr)
        jg, jerr = jcompression.compress_tree(
            tree_util.map(jnp.asarray, g), jerr)
        for a, b in zip(tree_util.leaves(tg), tree_util.leaves(jg)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_util.leaves(terr), tree_util.leaves(jerr)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    leaf = rng.standard_normal(50).astype(np.float32)
    e = (0.01 * rng.standard_normal(50)).astype(np.float32)
    got = compression.compress_leaf(torch.from_numpy(leaf), torch.from_numpy(e))
    want = jcompression.compress_leaf(jnp.asarray(leaf), jnp.asarray(e))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_error_feedback_telescopes():
    """Sum of compressed grads + final error == sum of true grads
    (the reference's test, on the port)."""
    rng = np.random.default_rng(6)
    gs = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
          * 10 ** (-i) for i in range(6)]
    e = torch.zeros(64)
    total_hat = torch.zeros(64)
    for g in gs:
        g_hat, e = compression.compress_leaf(g, e)
        total_hat = total_hat + g_hat
    total = sum(gs)
    np.testing.assert_allclose((total_hat + e).numpy(), total.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_quantize_roundtrip_bound():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, scale = compression.quantize(x)
    err = (compression.dequantize(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-7


def test_stochastic_rounding_is_unbiased_and_seeded():
    """Each draw rounds y = x / scale to floor(y) or floor(y) + 1, up with
    probability frac(y): the error has mean 0 and variance at most
    scale**2 / 4.  So the mean of R draws sits within 5 standard errors,
    5 * scale / (2 sqrt(R)), of x at every element (a failure chance
    below 1e-6 per element).  The same generator seed gives the same
    draws."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    reps = 2000
    draws = []
    for _ in range(reps):
        q, scale = compression.quantize(x, generator=gen)
        y = x / scale
        assert bool(((q.float() == torch.floor(y))
                     | (q.float() == torch.floor(y) + 1)).all())
        draws.append(compression.dequantize(q, scale))
    mean = torch.stack(draws).mean(0)
    assert float((mean - x).abs().max()) <= 5 * float(scale) / (2 * reps ** 0.5)
    a = compression.quantize(x, generator=torch.Generator().manual_seed(3))
    b = compression.quantize(x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0])


def _submesh_rank(device, xs, out_dir):
    """Four ranks, two meshes of two ([0, 1] and [2, 3]): each rank
    quantizes its mesh's leaf, split in two over that mesh, and saves its
    block's levels and the scale."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    rank = dist.get_rank()
    meshes = [DeviceMesh("cpu", [0, 1]), DeviceMesh("cpu", [2, 3])]
    k = rank // 2
    x = torch.from_numpy(xs[k]).chunk(2)[rank % 2].contiguous()
    leaf = DTensor.from_local(x, meshes[k], [Shard(0)], run_check=False)
    q, scale = compression.quantize(leaf)
    torch.save({"q": q.to_local(), "scale": scale},
               f"{out_dir}/rank{rank}.pt")


def test_quantize_takes_the_scale_over_the_leafs_own_mesh(tmp_path):
    """A split leaf's scale is the largest |x| over its own mesh's ranks,
    not over every rank of the process group: two meshes of two ranks in
    a world of four, each with a leaf of another magnitude, each give one
    device's levels and scale for their leaf."""
    from repro_torch.distributed import process_mesh
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(64).astype(np.float32),
          (1e-3 * rng.standard_normal(64)).astype(np.float32)]
    process_mesh.spawn(_submesh_rank, 4, "gloo", "cpu", xs, str(tmp_path))
    for k, x in enumerate(xs):
        want_q, want_s = compression.quantize(torch.from_numpy(x))
        got = [torch.load(tmp_path / f"rank{r}.pt") for r in (2 * k, 2 * k + 1)]
        assert all(torch.equal(g["scale"], want_s) for g in got)
        assert torch.equal(torch.cat([g["q"] for g in got]), want_q)
