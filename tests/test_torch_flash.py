"""Port parity of the flash-attention kernel layer:
``repro_torch.kernels.flash_attention`` against ``repro.kernels.
flash_attention`` and ``repro.models.layers._attn_full`` on the same inputs.

The Pallas kernel runs under ``interpret=True`` as
``tests/test_flash_attention.py`` runs it; on CPU tensors the port's wrapper
runs its plain PyTorch version (the CUDA kernel is held against that on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Inputs are
made from a seed with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa

#: fp32, against the interpreted Pallas kernel and the XLA oracle: the same
#: fp32 products summed in other orders (the JAX package's own flash
#: tolerance; measured <= 1e-6)
TOL = 2e-5
#: bf16 against the XLA oracle: the oracle rounds its scores to bf16 before
#: the softmax, the flash algorithm keeps them in fp32 (the JAX package's
#: bf16 tolerance)
BF16_ORACLE_TOL = 3e-2
#: bf16 against the interpreted Pallas kernel: the same algorithm and
#: blocks; an exp one ulp apart can round p or the output to the
#: neighbouring bf16 value, one bf16 ulp (2**-8 relative) of an output
#: below 2 in magnitude
BF16_KERNEL_TOL = 2.0 ** -8 * 2

SHAPES = [  # b, sq, sk, h, kv, d, bq, bk: the grid of test_flash_attention.py
    (2, 256, 256, 8, 2, 64, 128, 128),
    (1, 512, 512, 4, 4, 64, 256, 128),    # MHA (g=1)
    (2, 128, 512, 8, 1, 32, 64, 256),     # MQA, rectangular
    (1, 256, 256, 16, 2, 128, 128, 64),   # wide heads
    (1, 256, 256, 4, 4, 112, 128, 128),   # zamba2-7b's head dim (not there)
]
CASES = [(*s, causal) for s in SHAPES for causal in (True, False)
         if not causal or s[1] == s[2]]  # causal needs square, as there


def _qkv(b, sq, sk, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in arrays)


def _jax(arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(x, dtype) for x in arrays)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,bq,bk,causal", CASES)
def test_flash_matches_pallas_and_oracle(b, sq, sk, h, kv, d, bq, bk, causal):
    arrays = _qkv(b, sq, sk, h, kv, d)
    got = fa.flash_attention(*_torch(arrays), causal=causal, block_q=bq,
                             block_k=bk).numpy()
    pallas = jflash(*_jax(arrays), causal=causal, block_q=bq, block_k=bk,
                    interpret=True)
    oracle = jlayers._attn_full(*_jax(arrays), causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=TOL, atol=TOL)


def test_flash_bf16_inputs():
    arrays = _qkv(1, 256, 256, 4, 2, 64)
    out = fa.flash_attention(*_torch(arrays, torch.bfloat16), causal=True,
                             block_q=128, block_k=128)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    jq = _jax(arrays, jnp.bfloat16)
    pallas = jflash(*jq, causal=True, block_q=128, block_k=128, interpret=True)
    oracle = jlayers._attn_full(*jq, causal=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=BF16_KERNEL_TOL, atol=BF16_KERNEL_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               rtol=BF16_ORACLE_TOL, atol=BF16_ORACLE_TOL)


def test_flash_softmax_rows_sum_to_one_property():
    q, k, _ = _qkv(2, 256, 256, 4, 2, 64, seed=5)
    v = np.ones((2, 256, 2, 64), np.float32)
    out = fa.flash_attention(*_torch((q, k, v)), causal=True, block_q=128,
                             block_k=128)
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5, atol=1e-5)


def test_flash_refuses_lengths_the_blocks_do_not_divide():
    """The reference's grid is Sq // block_q, so a ragged length leaves
    rows unwritten; the port raises instead."""
    q, k, v = _torch(_qkv(1, 96, 96, 4, 2, 32))
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q, k, v, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q, k, v, block_q=32, block_k=64)


def test_flash_refuses_what_it_does_not_take():
    q, k, v = _torch(_qkv(1, 64, 64, 4, 2, 32))
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half(), block_q=64,
                           block_k=64)
    with pytest.raises(ValueError, match="KV dividing H"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v, block_q=64,
                           block_k=64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, block_q=64, block_k=64)
    with FakeTensorMode():   # a device the wrapper has no path for
        other = tuple(torch.empty(x.shape, device="xla") for x in (q, k, v))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(*other, block_q=64, block_k=64)
    # meta is the dry-run's: an empty result of the kernel's shape, and no
    # launch counted
    launches = fa.flash_attention.launches
    meta = tuple(x.to("meta") for x in (q, k, v))
    out = fa.flash_attention(*meta, block_q=64, block_k=64)
    assert out.device.type == "meta" and out.shape == q.shape
    assert fa.flash_attention.launches == launches


def test_cpu_path_leaves_the_launch_counter_at_zero(monkeypatch):
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    q, k, v = _torch(_qkv(1, 64, 64, 4, 2, 32))
    fa.flash_attention(q, k, v, block_q=32, block_k=32)
    assert fa.flash_attention.launches == 0
