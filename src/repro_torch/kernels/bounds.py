"""The kernels' work and the card's least time for it.

Each kernel's operations and bytes per launch, the bounds the kernel
table reports (``chip_smoke.py``) and the hook through which a launch on
``meta`` tensors reports that work to an op counter
(``launch.hlo_analysis``).  One copy serves both: a dry-run counts a
launch with the same formula that bounds its time on the card.

Constants: the H100 SXM data sheet at its full 700 W limit.
"""

from __future__ import annotations

import torch

#: H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores and HBM3 bandwidth, at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: H100 SXM dense bf16 and TF32 tensor-core peaks (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

#: operations per pair, counted from src/repro_torch/csrc/nbody_force.cu
#: (FMA = 2, rsqrtf = 1); mixed replaces each accumulate-add by a two-sum
FLOPS_PER_PAIR = {("acc_jerk_pot", "fp32"): 43, ("acc_jerk_pot", "mixed"): 85,
                  ("snap", "fp32"): 62, ("snap", "mixed"): 80}

#: per-element weight of the softmax around K3's two products (max,
#: subtract, exp, sum, scale; exp at 8 as the dry-run's elementwise table)
ATTN_SOFTMAX_FLOPS = 12


#: targets per CUDA block of K1 and K2 (``kAccTargets``, ``kSnapTargets``
#: in csrc/nbody_force.cu): each block streams every source once
KERNEL_TARGETS = 128


def nbody_bytes(name, n_t, n_s, batch=1) -> int:
    """Least bytes of one K1 (``acc_jerk_pot``) or K2 (``snap``) launch:
    each packed operand read once, the output written once."""
    operands = 2 if name == "acc_jerk_pot" else 4
    return batch * (4 * 8 * (n_t + n_s) * (operands // 2) + 4 * 8 * n_t)


def nbody_stream_bytes(name, n_t, n_s, batch=1) -> int:
    """Bytes one K1 or K2 launch moves as the card runs it: the target
    operands read and the output written once, the source operands once
    per block of KERNEL_TARGETS targets."""
    halves = 1 if name == "acc_jerk_pot" else 2
    blocks = -(-n_t // KERNEL_TARGETS)
    return batch * 4 * 8 * (halves * (n_t + blocks * n_s) + n_t)


def bound_ms(name, dtype, n_t_active, n_t, n_s, batch=1):
    """Least time for the work: flops of the active pairs (``n_t_active``
    over all members) over the fp32 peak, or each operand read once and
    the output written once over HBM bandwidth, whichever is larger."""
    flops = FLOPS_PER_PAIR[(name, dtype)] * n_t_active * n_s
    nbytes = nbody_bytes(name, n_t, n_s, batch)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def window_bound_ms(name, dtype, x):
    """Least time of one launch on window operands ``x`` (batched packed
    K1 or K2 operands): the operations of the pairs this data needs
    (active targets against the sources of nonzero mass, per member) over
    the fp32 peak, or each operand read once and the output written once
    over HBM bandwidth, whichever is larger."""
    tgt, src = x[0], x[1]
    act = (tgt[..., 3] != 0).sum(-1).to(torch.float64)
    real = (src[:, 3, :] != 0).sum(-1).to(torch.float64)
    pairs = float((act * real).sum())
    flops = FLOPS_PER_PAIR[(name, dtype)] * pairs
    nbytes = sum(t.numel() * 4 for t in x) + tgt.numel() * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", pairs)


def attn_pairs(sq, sk, causal) -> int:
    """Live score pairs of one head: causal, a query at position i sees
    min(i + 1, Sk) keys."""
    if causal:
        n = min(sq, sk)
        return n * (n + 1) // 2 + (sq - n) * sk
    return sq * sk


def attn_flops(b, sq, sk, h, d, causal) -> int:
    """K3's product operations: q K^T and P V over the live pairs, two per
    multiply-add."""
    return 4 * b * h * d * attn_pairs(sq, sk, causal)


def attn_bytes(b, sq, sk, h, kv, d, size) -> int:
    """K3's bytes: q, k, v read once and the output written once."""
    return size * (2 * b * sq * h * d + 2 * b * sk * kv * d)


def flash_bound_ms(b, s, h, kv, d, dtype, exact_fp32=False):
    """Least time of one causal K3 launch at Sq = Sk = S
    (``attn_bound_ms``)."""
    return attn_bound_ms(b, s, s, h, kv, d, dtype, True, exact_fp32)


def attn_bound_ms(b, sq, sk, h, kv, d, dtype, causal, exact_fp32=False):
    """Least time of one K3 launch: 4 B H D P operations (q K^T and P V
    over the P live score pairs, two per multiply-add; causal, a query at
    position i sees min(i + 1, Sk) keys) over the tensor-core bf16 peak,
    or for fp32 three times as many (3xTF32: three TF32 products per
    product) over the TF32 peak, or with ``exact_fp32`` the operations as
    fp32 FMAs over the fp32 peak; or q, k, v read once and the output
    written once over HBM bandwidth, whichever is larger."""
    flops = attn_flops(b, sq, sk, h, d, causal)
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = attn_bytes(b, sq, sk, h, kv, d, size)
    if dtype == torch.bfloat16:
        peak = PEAK_BF16_FLOPS
    elif exact_fp32:
        peak = PEAK_FP32_FLOPS
    else:
        flops, peak = 3 * flops, PEAK_TF32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --------------------------------------------------------------------------
# launches on meta tensors
# --------------------------------------------------------------------------
#: the op counters listening, innermost last (``launch.hlo_analysis``)
COUNTERS: list = []


def meta_launch(name, *, flops, dot_flops, nbytes, plain):
    """One kernel launch on ``meta`` tensors: the innermost op counter
    either tallies it as one op with the kernel's work (``None`` returned;
    the caller makes the empty result) or asks for the kernel's plain
    version, which then runs on ``meta`` under the counter and is
    returned.  Without a counter, ``None``."""
    if not COUNTERS:
        return None
    counter = COUNTERS[-1]
    if counter.expand_kernels:
        return plain()
    counter.kernel(name, flops=flops, dot_flops=dot_flops, nbytes=nbytes)
    return None
