"""Sequence-mixing cells of the ssm and hybrid families.

Port of ``repro/models/ssm.py``, function by function:

* **Mamba2 SSD** (zamba2-7b): ``ssd_chunked`` splits the sequence into
  ``chunk``-length blocks; inside a block the interactions are a masked,
  decay-weighted product, across blocks they flow through a recurrent
  (H, N, P) state; ``ssd_step`` is one token of the same recurrence.
* ``causal_conv``: the depthwise causal 1-D convolution in front of SSD,
  zero-padded or streaming from a cache of the last W - 1 inputs.
* **mLSTM** (xlstm-1.3b): ``mlstm_chunked`` is the chunkwise-parallel
  matrix LSTM with exponential input gating and log-space (m)
  stabilisation, carrying (C, n, m) per head; ``mlstm_step`` one token.
* **sLSTM** (xlstm-1.3b): ``slstm_scan`` is the scalar LSTM with a
  per-head recurrent block-diagonal R, a true time recurrence;
  ``slstm_step`` one step of it.

Every recurrence and statistic is in fp32, whatever the activation dtype.
The reference's ``lax.scan`` over chunks and steps becomes a Python loop on
the tensor's device.  Its three-operand einsums are written as pairwise
products in an order that keeps each intermediate at (B, L, L, H) or
(B, L, H, P), so the memory does not depend on a contraction planner; the
sums run in other orders than XLA's, which the tests hold to fp32
tolerances.  Where the reference reshapes a sequence into chunks that do
not divide it (and fails inside the reshape), these functions raise a
``ValueError`` naming the chunk.
"""

from __future__ import annotations

import torch

F32 = torch.float32
#: the reference's clip bounds on log decays, and its masked log-weight
CLIP = -60.0
NEG = -1e30


def _logsigmoid(x):
    """-softplus(-x), with softplus the exact ``logaddexp(x, 0)``
    (``jax.nn.softplus``; ``F.softplus`` returns x above 20)."""
    return -softplus(-x)


def softplus(x):
    """``jax.nn.softplus``: the exact ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _chunks(s: int, chunk: int, what: str) -> int:
    if chunk <= 0 or s % chunk:
        raise ValueError(f"{what}: chunk {chunk} must divide the sequence "
                         f"length {s}")
    return s // chunk


# ===========================================================================
# Mamba2 SSD
# ===========================================================================
def ssd_chunked(x, dt, a_neg, b_mat, c_mat, *, chunk: int, state0=None):
    """Chunked SSD scan.

    Args:
        x:      (B, S, H, P) fp32 inputs (heads x head_dim).
        dt:     (B, S, H) fp32 positive step sizes (already softplus'd).
        a_neg:  (H,) fp32 negative continuous-time decay (-exp(a_log)).
        b_mat:  (B, S, N) fp32 input->state projection (shared across heads).
        c_mat:  (B, S, N) fp32 state->output projection.
        chunk:  block length L (S % L == 0, else ``ValueError``).
        state0: optional (B, H, N, P) initial state.

    Returns:
        y: (B, S, H, P) fp32, state: (B, H, N, P) final state.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = _chunks(s, chunk, "ssd_chunked")
    l = chunk
    xr = x.reshape(bsz, nc, l, h, p)
    dtr = dt.reshape(bsz, nc, l, h)
    br = b_mat.reshape(bsz, nc, l, n)
    cr = c_mat.reshape(bsz, nc, l, n)
    big_g = torch.cumsum(dtr * a_neg, dim=2)  # inclusive cumulative log decay
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))

    state = state0 if state0 is not None else torch.zeros(
        (bsz, h, n, p), dtype=F32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xr[:, c], dtr[:, c], br[:, c], cr[:, c]
        gc = big_g[:, c]
        # intra: w[t, s, h] = exp(G_t - G_s) dt_s for t >= s   (B, L, L, H)
        dec = torch.exp(torch.clamp(gc[:, :, None, :] - gc[:, None, :, :],
                                    CLIP, 0.0))
        w = torch.where(mask[None, :, :, None], dec * dtc[:, None, :, :], 0.0)
        scores = torch.einsum("bln,bmn->blm", cc, bc)        # C_t . B_s
        y_intra = torch.einsum("blmh,bmhp->blhp", scores[..., None] * w, xc)
        # inter: the carried state's contribution
        eg = torch.exp(torch.clamp(gc, min=CLIP))            # (B, L, H)
        y_inter = torch.einsum("bln,bhnp->blhp", cc, state) * eg[..., None]
        # S' = exp(G_L) S + sum_s exp(G_L - G_s) dt_s B_s x_s^T
        g_last = gc[:, -1:, :]
        a_term = torch.exp(torch.clamp(g_last - gc, CLIP, 0.0)) * dtc
        st = torch.einsum("bln,blhp->bhnp", bc, xc * a_term[..., None])
        state = state * torch.exp(torch.clamp(g_last[:, 0, :], CLIP, 0.0))[
            :, :, None, None] + st
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(bsz, s, h, p), state


def ssd_step(x, dt, a_neg, b_mat, c_mat, state):
    """Single-token SSD update.

    x: (B, H, P), dt: (B, H), b_mat/c_mat: (B, N), state: (B, H, N, P).
    Returns (y: (B, H, P), new_state).
    """
    g = torch.exp(torch.clamp(dt * a_neg, CLIP, 0.0))        # (B, H)
    upd = b_mat[:, None, :, None] * (x * dt[..., None])[:, :, None, :]
    state = state * g[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_mat, state)
    return y, state


def causal_conv(x, w, *, cache=None):
    """Depthwise causal 1-D conv.  x: (B, S, D), w: (W, D).

    With ``cache`` ((B, W-1, D) trailing context) performs the streaming form
    and returns (y, new_cache); otherwise zero-pads on the left.
    """
    width = w.shape[0]
    if cache is not None:
        ctx = torch.cat([cache, x], dim=1)                   # (B, W-1+S, D)
        new_cache = ctx[:, -(width - 1):, :] if width > 1 else cache
    else:
        ctx = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
        new_cache = None
    s = x.shape[1]
    y = torch.zeros_like(x)
    for k in range(width):
        y = y + ctx[:, k:k + s, :] * w[k]
    return (y, new_cache) if cache is not None else y


# ===========================================================================
# mLSTM (xLSTM matrix cell)
# ===========================================================================
def mlstm_chunked(q, k, v, gi, gf, *, chunk: int, carry0=None):
    """Chunkwise-parallel mLSTM with log-space stabilisation.

    Args:
        q, k, v: (B, S, H, K) fp32 (K = key = value dim here).
        gi, gf:  (B, S, H) fp32 raw input/forget gate pre-activations.
        chunk:   block length L (S % L == 0, else ``ValueError``).
        carry0:  optional (C, n, m) with C (B,H,K,K), n (B,H,K), m (B,H).

    Returns:
        h: (B, S, H, K), carry: (C, n, m).

    Inside a chunk the work runs head-major, (B, H, L, L), so each product
    is one batched matrix product.
    """
    bsz, s, h, kk = q.shape
    l = chunk
    nc = _chunks(s, chunk, "mlstm_chunked")
    scale = kk ** -0.5

    def heads(a):  # (B, S, H, ...) -> (B, H, nc, L, ...)
        return a.reshape(bsz, nc, l, h, *a.shape[3:]).movedim(3, 1)

    qr, kr, vr = heads(q * scale), heads(k), heads(v)
    lir, lfr = heads(gi), heads(_logsigmoid(gf))
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))

    if carry0 is None:
        carry0 = (torch.zeros((bsz, h, kk, kk), dtype=F32, device=q.device),
                  torch.zeros((bsz, h, kk), dtype=F32, device=q.device),
                  torch.zeros((bsz, h), dtype=F32, device=q.device))
    big_c, nvec, m_in = carry0
    hs = []
    for c in range(nc):
        qc, kc, vc = qr[:, :, c], kr[:, :, c], vr[:, :, c]  # (B, H, L, K)
        lic, lfc = lir[:, :, c], lfr[:, :, c]                # (B, H, L)
        f_cum = torch.cumsum(lfc, dim=-1)                    # inclusive
        # intra log-weights w[t, s] = F_t - F_s + i_s (t >= s)  (B, H, L, L)
        wlog = f_cum[..., :, None] - f_cum[..., None, :] + lic[..., None, :]
        wlog = torch.where(mask, wlog, NEG)
        m_intra = wlog.amax(dim=-1)                          # (B, H, L)
        m_t = torch.maximum(m_in[..., None] + f_cum, m_intra)
        d = torch.exp(wlog - m_t[..., None])
        scores = (qc @ kc.transpose(-1, -2)) * d
        num = scores @ vc
        # inter-chunk via the carried state
        inter_w = torch.exp(m_in[..., None] + f_cum - m_t)  # (B, H, L)
        num = num + (qc @ big_c) * inter_w[..., None]
        # denominator: |TOTAL normaliser| (intra + carried summed before abs)
        den_raw = scores.sum(dim=-1) + (qc @ nvec[..., None])[..., 0] * inter_w
        den = torch.maximum(torch.abs(den_raw), torch.exp(-m_t))
        hc = num / den[..., None]
        hs.append(hc)
        # carry to the chunk's end
        f_tot = f_cum[..., -1:]                              # (B, H, 1)
        a_log = f_tot - f_cum + lic                          # (B, H, L)
        m_out = torch.maximum(m_in + f_tot[..., 0], a_log.amax(dim=-1))
        cw = torch.exp(a_log - m_out[..., None])
        decay = torch.exp(m_in + f_tot[..., 0] - m_out)      # (B, H)
        kw = kc * cw[..., None]
        big_c = big_c * decay[..., None, None] + kw.transpose(-1, -2) @ vc
        nvec = nvec * decay[..., None] + kw.sum(dim=-2)
        m_in = m_out
    h_all = torch.stack(hs, dim=2).reshape(bsz, h, s, kk).movedim(1, 2)
    return h_all, (big_c, nvec, m_in)


def mlstm_step(q, k, v, gi, gf, carry):
    """Single-token mLSTM update.  q/k/v: (B,H,K), gi/gf: (B,H)."""
    big_c, nvec, m = carry
    kk = q.shape[-1]
    lf = _logsigmoid(gf)
    m_new = torch.maximum(lf + m, gi)
    f_eff = torch.exp(lf + m - m_new)[..., None]
    i_eff = torch.exp(gi - m_new)[..., None]
    big_c = big_c * f_eff[..., None] + i_eff[..., None] * (
        k[..., :, None] * v[..., None, :])
    nvec = nvec * f_eff + i_eff * k
    qs = q * (kk ** -0.5)
    num = (qs[..., None, :] @ big_c)[..., 0, :]
    den = torch.abs((qs * nvec).sum(dim=-1))
    hvec = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return hvec, (big_c, nvec, m_new)


# ===========================================================================
# sLSTM (xLSTM scalar cell, per-head recurrent R)
# ===========================================================================
def slstm_scan(gx, r, *, n_heads: int, carry0=None):
    """Sequential sLSTM over a sequence.

    Args:
        gx: (B, S, H, 4, hd) fp32 input-gate pre-activations (i, f, z, o).
        r:  (H, hd, 4*hd) recurrent weights (block-diagonal per head).
        carry0: optional (c, n, hvec, m), each (B, H, hd).

    Returns:
        h: (B, S, H, hd), carry.
    """
    bsz, s, h, _, hd = gx.shape
    if carry0 is None:
        z = torch.zeros((bsz, h, hd), dtype=F32, device=gx.device)
        carry0 = (z, z, z, z)
    carry, ys = carry0, []
    for t in range(s):
        hv, carry = slstm_step(gx[:, t], r, carry)
        ys.append(hv)
    return torch.stack(ys, dim=1), carry


def slstm_step(g_t, r, carry):
    """One sLSTM step; g_t: (B, H, 4, hd)."""
    c, n, hv, m = carry
    bsz, h, _, hd = g_t.shape
    # rec[b, h] = hv[b, h] @ r[h]: one batched product over the heads
    rec = (hv.transpose(0, 1) @ r).transpose(0, 1).reshape(bsz, h, 4, hd)
    pre = g_t + rec
    gi, gf, gz, go = pre.unbind(dim=2)
    fm = gf + m
    m_new = torch.maximum(fm, gi)
    i_eff = torch.exp(gi - m_new)
    f_eff = torch.exp(fm - m_new)
    c = f_eff * c + i_eff * torch.tanh(gz)
    n = f_eff * n + i_eff
    hv = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return hv, (c, n, hv, m_new)
