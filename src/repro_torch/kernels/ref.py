"""Plain-PyTorch oracle for the all-pairs N-body force kernels.

Port of ``repro/kernels/ref.py``: a naive, brute-force direct-summation
evaluation of accelerations, jerks, snaps and potentials, run at the
precision of its inputs (float64 reproduces the paper's CPU golden run).

Conventions (G = 1, N-body units):
    acc_i  = sum_j m_j * r_ij / (r^2 + eps^2)^{3/2}
    jerk_i = sum_j m_j * [ v_ij / d3 + q * r_ij / d3 ],  q = -3 (r.v)/d2
    snap_i = sum_j [ m_j * a_ij / d3 - 6 alpha * J_ij - 3 beta * P_ij ]
with r_ij = r_j - r_i, v_ij = v_j - v_i, a_ij = a_j - a_i,
     d2 = r^2 + eps^2, alpha = (r.v)/d2, beta = (v.v + r.a)/d2 + alpha^2,
     P_ij / J_ij the pairwise acc/jerk contributions.
The potential phi_i = -sum_j m_j / sqrt(d2) is returned alongside.

``compute_dtype="bfloat16"`` rounds every per-pair contribution through
bfloat16 (round to nearest even, as ``jnp.astype``) and sums over the
source axis with a Neumaier compensated sum; ``None`` is full precision.
"""

from __future__ import annotations

import torch

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16}


def compensated_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Neumaier compensated sum along ``axis``.

    Each add is a two-sum (``t = s + v``; its rounding error recovered as
    ``(s - t) + v`` or ``(v - t) + s`` by which operand dominates), and the
    carried error is folded back in at the end, so the result carries
    O(1 ulp) error whatever the number of summands.

    The source axis is walked in a Python loop, the counterpart of the
    reference's ``lax.scan``: six elementwise operations per summand.  At
    N_s = 16384 that is 16384 sequential steps, about 98k small tensor
    operations per reduction and seven reductions per acc/jerk/pot call, so
    the mixed-precision oracle suits test sizes; the main path's mixed mode
    runs the kernels of ``nbody_force.py`` instead.
    """
    x = torch.movedim(x, axis, 0)
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for v in x:
        t = s + v
        err = torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
        s, c = t, c + err
    return s + c


def _precision_ops(compute_dtype):
    """(round-per-pair, reduce-over-axis) pair for a compute dtype.

    ``None`` keeps the full-precision expressions; otherwise per-pair terms
    round through ``compute_dtype`` (float32 in and out) and reductions run
    compensated in float32.
    """
    if compute_dtype is None:
        return (lambda x: x), (lambda x, axis: torch.sum(x, dim=axis))
    cdt = _COMPUTE_DTYPES[compute_dtype]

    def rnd(x):
        return x.to(cdt).to(torch.float32)

    return rnd, compensated_sum


#: pair-count ceiling of one dense rectangle evaluation.  Larger rectangles
#: are evaluated in chunks of target rows: each output row is a row-local
#: reduction over the full source axis, so chunking the rows never reorders
#: any sum.
DENSE_PAIR_LIMIT = 1 << 26


def _map_row_chunks(fn, targets, n_s):
    """``fn(*targets)`` evaluated over row chunks of the target-side arrays
    when the rectangle exceeds :data:`DENSE_PAIR_LIMIT` pairs."""
    n_t = targets[0].shape[0]
    if n_t * max(n_s, 1) <= DENSE_PAIR_LIMIT:
        return fn(*targets)
    rows = min(n_t, max(1, DENSE_PAIR_LIMIT // n_s))
    outs = [fn(*(a[i:i + rows] for a in targets))
            for i in range(0, n_t, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _pairwise_geometry(pos_t, pos_s, eps):
    """Displacements r_ij = r_j - r_i and softened inverse distances.

    Axis 0 = target i (N_t), axis 1 = source j (N_s).  A pair at exactly
    zero displacement (a target that is also a source) contributes nothing:
    the guard uses the unsoftened distance, so the potential gains no
    spurious -m/eps.
    """
    dr = pos_s[None, :, :] - pos_t[:, None, :]
    r2 = torch.sum(dr * dr, dim=-1)
    d2 = r2 + torch.tensor(eps, dtype=pos_t.dtype) ** 2
    safe = r2 > 0
    one = torch.ones_like(d2)
    inv_r = torch.where(safe, 1.0 / torch.sqrt(torch.where(safe, d2, one)),
                        torch.zeros_like(d2))
    return dr, d2, inv_r


def acc_jerk_pot_rect(pos_t, vel_t, pos_s, vel_s, mass_s, *,
                      eps: float = 1e-7, compute_dtype=None):
    """Brute-force acc/jerk/potential of targets due to sources.

    Args:
        pos_t, vel_t: (N_t, 3) target positions/velocities.
        pos_s, vel_s: (N_s, 3) source positions/velocities.
        mass_s: (N_s,) source masses.
        eps: Plummer softening length (paper Appendix A: 1e-7).
        compute_dtype: reduced per-pair precision (``"bfloat16"``) with
            compensated float32 accumulation; ``None`` = full precision.

    Returns:
        acc (N_t, 3), jerk (N_t, 3), pot (N_t,) in ``pos_t.dtype``.
    """
    rnd, sum_ = _precision_ops(compute_dtype)

    def dense(pt, vt):
        dr, d2, inv_r = _pairwise_geometry(pt, pos_s, eps)
        inv_r3 = inv_r * inv_r * inv_r
        dv = vel_s[None, :, :] - vt[:, None, :]

        t = mass_s[None, :] * inv_r3                 # m_j / d^3
        rv = torch.sum(dr * dv, dim=-1)              # r_ij . v_ij
        q = -3.0 * rv / torch.where(d2 > 0, d2, torch.ones_like(d2))

        acc = sum_(rnd(t[:, :, None] * dr), axis=1)
        jerk = sum_(rnd(t[:, :, None] * (dv + q[:, :, None] * dr)), axis=1)
        pot = -sum_(rnd(mass_s[None, :] * inv_r), axis=1)
        return acc, jerk, pot

    return _map_row_chunks(dense, (pos_t, vel_t), pos_s.shape[0])


def acc_jerk_pot(pos, vel, mass, *, eps: float = 1e-7, compute_dtype=None):
    """Symmetric all-pairs form (targets == sources)."""
    return acc_jerk_pot_rect(pos, vel, pos, vel, mass, eps=eps,
                             compute_dtype=compute_dtype)


def snap_rect(
    pos_t, vel_t, acc_t, pos_s, vel_s, acc_s, mass_s, *,
    eps: float = 1e-7, compute_dtype=None,
):
    """Brute-force snap of targets due to sources, given accelerations.

    The second evaluation pass of the 6th-order Hermite scheme: it needs
    the acceleration of *both* partners (a_ij = a_j - a_i).
    """
    rnd, sum_ = _precision_ops(compute_dtype)

    def dense(pt, vt, at):
        dr, d2, inv_r = _pairwise_geometry(pt, pos_s, eps)
        inv_r3 = inv_r * inv_r * inv_r
        d2s = torch.where(d2 > 0, d2, torch.ones_like(d2))
        dv = vel_s[None, :, :] - vt[:, None, :]
        da = acc_s[None, :, :] - at[:, None, :]

        t = mass_s[None, :] * inv_r3
        alpha = torch.sum(dr * dv, dim=-1) / d2s
        beta = (torch.sum(dv * dv, dim=-1) + torch.sum(dr * da, dim=-1)) \
            / d2s + alpha * alpha

        p_pair = t[:, :, None] * dr                                    # A0
        j_pair = t[:, :, None] * dv - 3.0 * alpha[:, :, None] * p_pair  # A1
        s_pair = t[:, :, None] * da - 6.0 * alpha[:, :, None] * j_pair \
            - 3.0 * beta[:, :, None] * p_pair                           # A2
        return sum_(rnd(s_pair), axis=1)

    return _map_row_chunks(dense, (pos_t, vel_t, acc_t), pos_s.shape[0])


def snap(pos, vel, acc, mass, *, eps: float = 1e-7, compute_dtype=None):
    """Symmetric all-pairs snap (targets == sources)."""
    return snap_rect(pos, vel, acc, pos, vel, acc, mass, eps=eps,
                     compute_dtype=compute_dtype)


def acc_jerk_snap_pot(pos, vel, mass, *, eps: float = 1e-7,
                      compute_dtype=None):
    """Full two-pass evaluation: (acc, jerk, snap, pot)."""
    acc, jerk, pot = acc_jerk_pot(pos, vel, mass, eps=eps,
                                  compute_dtype=compute_dtype)
    snp = snap(pos, vel, acc, mass, eps=eps, compute_dtype=compute_dtype)
    return acc, jerk, snp, pot
