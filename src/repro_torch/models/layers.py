"""Model layers of the dense family: RMS norm, embeddings, RoPE, grouped-query
attention with a KV cache, and the gated FFN.

Port of ``repro/models/layers.py``.  Numerics as in the reference:
activations in ``cfg.dtype``; softmax, norm statistics and the rotary
rotation in fp32.  The reference's ``MeshRules`` argument is dropped: on
one card ``rules.shard`` is the identity (``shardings.py:108-113``).

The other families' layers (M-RoPE, cross-attention, MLA, MoE, the SSM
blocks) are not here: their configs raise ``NotImplementedError`` in
``params.param_defs``.  ``_attn_streamed`` (the xla route at S >=
``attn_chunked_above``) raises too; both name their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ArchConfig

NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms / embeddings
# --------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    """Statistics in fp32, cast to the activation dtype, then times ``w``
    in that dtype (the reference's cast order)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def embed(tokens, table, dtype):
    return table[tokens].to(dtype)


def unembed(x, table_or_head, *, tied: bool):
    w = table_or_head.to(x.dtype)
    if tied:
        return torch.einsum("...d,vd->...v", x, w)
    return torch.einsum("...d,dv->...v", x, w)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integers.  Half-split
    rotation in fp32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------
def _attn_full(q, k, v, *, causal: bool, kv_len=None):
    """Grouped-query einsum attention: q (B,Sq,H,hd), k/v (B,Sk,KV,hd).

    Queries are reshaped to (KV, group) and contracted against the kv heads
    directly; the kv heads are never repeated.  Scores come out of the
    einsum in q's dtype and are then taken to fp32, as in the reference.
    The reference's ``q_pos``/``kv_pos`` overrides have no caller and are
    left out: positions count from 0 for q and k alike.
    """
    b, sq, h, hd = q.shape
    kv, vd = k.shape[2], v.shape[-1]
    g = h // kv
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) * scale
    mask = None
    if causal:
        qp = torch.arange(sq, device=q.device)
        kp = torch.arange(k.shape[1], device=q.device)
        mask = qp[:, None] >= kp[None, :]
    if kv_len is not None:
        valid = torch.arange(k.shape[1], device=q.device)[None, :] < kv_len
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, h, vd)


def _attn_dispatch(cfg: ArchConfig, q, k, v, *, causal: bool):
    """Route to the configured attention implementation.

    ``flash``: the flash kernel on a CUDA tensor, its plain version on a
    CPU tensor, with the reference's blocks ``min(512, S)``.  ``xla``:
    ``_attn_full``.
    """
    if cfg.attn_impl == "flash":
        bq = min(512, q.shape[1])
        bk = min(512, k.shape[1])
        return flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    if q.shape[1] >= cfg.attn_chunked_above:
        raise NotImplementedError(
            f"_attn_streamed (S={q.shape[1]} >= attn_chunked_above="
            f"{cfg.attn_chunked_above}) is not yet ported to repro_torch; "
            f"use attn_impl='flash', see ROADMAP.md queue 1 item 11")
    return _attn_full(q, k, v, causal=causal)


def attention(cfg: ArchConfig, p: dict, x, *, positions, causal: bool = True,
              cache: Optional[dict] = None,
              prefill_len: Optional[int] = None):
    """GQA self-attention with optional qk-norm and KV cache.

    ``cache`` (decode): {"k", "v": (B, max_len, KV, hd), "len": int}.  This
    step's k/v are written into the cache IN PLACE at ``len`` and the query
    attends over the cache with a ``kv_len`` mask.
    ``prefill_len``: plain causal attention, and also return the post-RoPE
    k/v padded to that length (the prefill cache fill).

    Returns (out, new_cache_slice | None).
    """
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not yet ported to repro_torch; "
                                  "see ROADMAP.md queue 1 item 11")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    q = (x @ p["q"].to(dt)).reshape(b, s, h, hd)
    k = (x @ p["k"].to(dt)).reshape(b, s, kv, hd)
    v = (x @ p["v"].to(dt)).reshape(b, s, kv, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck, cv, cur = cache["k"], cache["v"], cache["len"]
        if cur + s > ck.shape[1]:
            raise ValueError(f"KV cache full: {cur} + {s} > max_len "
                             f"{ck.shape[1]}")
        ck[:, cur:cur + s] = k.to(ck.dtype)
        cv[:, cur:cur + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        # the query is the newest token: the kv_len mask IS the causal mask
        out = _attn_full(q, ck.to(dt), cv.to(dt), causal=False,
                         kv_len=cur + s)
    else:
        if prefill_len is not None:
            pad = prefill_len - k.shape[1]
            new_cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                         "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
        out = _attn_dispatch(cfg, q, k, v, causal=causal)

    out = out.reshape(b, s, h * hd)
    return out @ p["o"].to(dt), new_cache


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------
def ffn(cfg: ArchConfig, p: dict, x):
    dt = x.dtype
    g = x @ p["wg"].to(dt)
    u = x @ p["wu"].to(dt)
    return (F.silu(g) * u) @ p["wd"].to(dt)
