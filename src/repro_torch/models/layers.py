"""Model layers: RMS norm, embeddings, RoPE and M-RoPE, grouped-query
attention (full, and streamed over KV blocks for long prompts) with a KV
cache and cross-attention, multi-head latent attention (MLA), the gated
FFN and the top-k MoE FFN.

Port of ``repro/models/layers.py``.  Numerics as in the reference:
activations in ``cfg.dtype``; softmax, router probabilities, norm
statistics and the rotary rotation in fp32.  The reference's ``MeshRules``
is the keyword ``rules`` of ``embed``, ``attention``, ``_attn_dispatch``,
``mla_attention``, ``ffn`` and ``moe_ffn``, the single-device rules by
default (``rules.shard`` the identity).  On a real device mesh the
activations are ``DTensor``s, the reference's shard points redistribute
them, and the attention cores (qk-norm, RoPE, the decode cache write and
``_attn_full`` or the flash kernel; MLA's latent kv and absorbed decode)
run on each rank's local heads through ``local_map``, self- and
cross-attention alike.  The MoE FFN routes on each rank's local batch,
whole over the experts, and runs each rank's own experts (``_moe_mesh``).
``recording_routes`` collects each MoE layer's routing for a caller that
holds one run's against another's.

The SSM cells are in ``models/ssm.py``.  MLA's prefill has no flash
route: its q and k heads are wider than its v heads, which the flash
kernel does not take, so it raises under ``attn_impl="flash"`` (the
reference's registered ``attn_impl`` for deepseek-v2 is ``"xla"``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.shardings import MeshRules, block_index
from repro_torch.kernels.flash_attention import flash_attention, local_kv
from repro_torch.models.config import ArchConfig

NEG_INF = -1e30
#: the single-device rules: every ``rules`` keyword's default
SINGLE = MeshRules.single_device()


# --------------------------------------------------------------------------
# norms / embeddings
# --------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    """Statistics in fp32, cast to the activation dtype, then times ``w``
    in that dtype (the reference's cast order).  On a DTensor whose rows
    a mesh axis splits (Mamba2's ``gnorm`` and the mLSTM's ``onorm`` over
    "d_ff"; the sLSTM's ``onorm`` over heads split on "model") the mean
    is one over the whole row: each rank's sum of squares over its part
    is reduced across the ranks before the root, never taken per rank."""
    dt = x.dtype
    xf = x.to(torch.float32)
    if _split_rows(xf):
        # each rank's sum over its part of the row (a Partial sum), reduced
        sq = torch.sum(xf * xf, dim=-1, keepdim=True)
        var = sq.redistribute(sq.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in sq.placements]) / xf.shape[-1]
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def _split_rows(x) -> bool:
    """Whether a mesh axis of more than one rank splits the last dimension
    of the DTensor ``x``."""
    return isinstance(x, DTensor) and any(
        p == Shard(x.ndim - 1) and x.device_mesh.size(a) > 1
        for a, p in enumerate(x.placements))


def embed(tokens, table, dtype, *, rules: MeshRules = SINGLE):
    """The rows of ``table`` for ``tokens``.  On a real mesh the lookup is
    ``F.embedding``, which DTensor takes on a table split by rows (a masked
    partial sum over the vocab's shards), on token ids held whole by every
    rank: ids split on "batch" are gathered first (``rules.shard`` to
    replicated), since DTensor's vocab mask does not follow a batch split.
    Under autograd the table is gathered whole over the vocab first too:
    DTensor has no backward for the masked partial sum."""
    if not rules.is_real:
        return table[tokens].to(dtype)
    tokens = rules.put(tokens, *(None,) * tokens.dim())
    if torch.is_grad_enabled() and table.requires_grad:
        table = rules.shard(table, None, "fsdp_d_model")
    return F.embedding(tokens, table).to(dtype)


def unembed(x, table_or_head, *, tied: bool):
    w = table_or_head.to(x.dtype)
    if tied:
        return torch.einsum("...d,vd->...v", x, w)
    return torch.einsum("...d,dv->...v", x, w)


# --------------------------------------------------------------------------
# RoPE / M-RoPE
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


def mrope_select(ang_all, sections):
    """The angles of M-RoPE's bands: band i of ``ang_all`` (3, ..., half)
    from position stream ``sec_id[i]``, ``sections`` bands per stream.

    The reference sums the three streams against a one-hot in fp32
    (``layers.py:76-80``); a gather gives the same bits, since x * 1 +
    0 * y + 0 * z is x exactly for finite y and z."""
    half = ang_all.shape[-1]
    if len(sections) != 3 or sum(sections) != half:
        raise ValueError(f"mrope_sections {tuple(sections)} must be three "
                         f"counts summing to head_dim / 2 = {half}")
    # sec_id from the bands' index alone: a tensor built from the host
    # list would be a copy that waits for the card at every call
    band = torch.arange(half, device=ang_all.device)
    sec_id = (band >= sections[0]).long() + (band >= sections[0]
                                             + sections[1]).long()
    idx = sec_id.view((1,) * (ang_all.dim() - 1) + (half,))
    return torch.take_along_dim(ang_all, idx, dim=0)[0]


def apply_mrope(x, positions3, sections, theta: float):
    """M-RoPE (qwen2-vl): ``positions3`` (3, ..., S) holds the (t, h, w)
    streams, and ``sections`` split the hd/2 frequency bands over them."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang_all = positions3[..., None].to(torch.float32) * freqs  # (3,...,S,half)
    ang = mrope_select(ang_all, sections)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(positions):
    """Text-only M-RoPE: all three streams equal the 1-D positions."""
    return positions[None].expand((3,) + tuple(positions.shape))


def vlm_mrope_positions(batch: int, n_patches: int, n_text: int, grid: int,
                        device=None):
    """(t, h, w) streams, (3, batch, n_patches + n_text), for [image patches
    | text] sequences: one image of ``grid``-wide raster-ordered patches at
    t = 0, then text at 1, 2, ... on all three streams."""
    i32 = torch.int32
    idx = torch.arange(n_patches, dtype=i32, device=device)
    hh, ww = idx // grid, idx % grid
    t_img = torch.zeros((n_patches,), dtype=i32, device=device)
    t_txt = torch.arange(1, n_text + 1, dtype=i32, device=device)
    pos3 = torch.stack([torch.cat([t_img, t_txt]), torch.cat([hh, t_txt]),
                        torch.cat([ww, t_txt])])               # (3, S)
    return pos3[:, None, :].expand(3, batch, pos3.shape[-1])


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


def _attn_streamed(q, k, v, *, causal: bool, q_chunk: int):
    """Memory-efficient attention: resident query blocks of ``q_chunk``,
    streamed KV blocks of ``min(Sk, max(q_chunk, 512))`` with a running
    (m, l, o) softmax state in fp32; grouped-query form (k/v carry the KV
    heads, never repeated).  Scores come out of the einsum in q's dtype
    and are then taken to fp32, and p is rounded to q's dtype for P V, as
    in the reference (``layers.py:138-187``).

    The reference reshapes the queries into blocks (failing inside the
    reshape when ``q_chunk`` does not divide Sq) and runs ``Sk // kv_chunk``
    KV blocks, silently dropping the keys past the last whole block; both
    raise ``ValueError`` here.  Under ``causal`` a KV block wholly above a
    query block's last query is skipped: every row of that query block has
    already met key 0, so its m is finite, alpha is exactly 1, p exactly 0,
    and l and o are unchanged (tests/test_torch_streamed.py holds the bits
    against the loop that runs every block).
    """
    b, sq, h, hd = q.shape
    sk, kv, vd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    scale = hd ** -0.5
    kv_chunk = min(sk, max(q_chunk, 512))
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(
            f"_attn_streamed: query block {q_chunk} must divide Sq={sq} and "
            f"KV block {kv_chunk} must divide Sk={sk} (the reference drops "
            f"the keys past the last whole KV block)")
    nq, nk = sq // q_chunk, sk // kv_chunk
    f32 = torch.float32
    outs = []
    for qi in range(nq):
        q_off = qi * q_chunk
        qb = q[:, q_off:q_off + q_chunk].reshape(b, q_chunk, kv, g, hd)
        m = torch.full((b, kv, g, q_chunk), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, kv, g, q_chunk, vd), dtype=f32, device=q.device)
        for ki in range(nk):
            k_off = ki * kv_chunk
            if causal and k_off > q_off + q_chunk - 1:
                break  # this and every later block lies above the diagonal
            kb = k[:, k_off:k_off + kv_chunk]
            vb = v[:, k_off:k_off + kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb).to(f32) * scale
            if causal:
                qp = q_off + torch.arange(q_chunk, device=q.device)
                kp = k_off + torch.arange(kv_chunk, device=q.device)
                s = torch.where((qp[:, None] >= kp[None, :])[None, None, None],
                                s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(q.dtype), vb).to(f32)
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(3, 1).reshape(b, q_chunk, h, vd).to(q.dtype))
    return torch.cat(outs, dim=1)


def _grad_placements(x: DTensor, q: DTensor) -> tuple:
    """The placements of the gradient of ``x``, an input of a local
    attention core that splits its work as q is split: ``Partial`` on a
    mesh axis where x is whole but q is split (each rank's gradient is a
    part of the sum), x's own placement elsewhere."""
    return tuple(Partial() if px == Replicate() and pq != Replicate()
                 else px for px, pq in zip(x.placements, q.placements))


def _on_local_heads(rules: MeshRules, fn, q, args: tuple, out_like: tuple):
    """``fn(*args)`` on each rank's local blocks through ``local_map``:
    ``args`` are DTensors or other values (None, ints, plain tensors held
    whole by every rank); ``out_like`` names, per output, the DTensor whose
    placements it takes, or the placements themselves (a tuple), or None
    for an output that is not a tensor.  ``q`` is the input whose split
    the work follows (``_grad_placements``)."""
    from torch.distributed.tensor.experimental import local_map

    def pl(x, grad=False):
        if not isinstance(x, DTensor):
            return None
        return list(_grad_placements(x, q) if grad else x.placements)

    def out_pl(x):
        return list(x) if isinstance(x, tuple) else pl(x)

    # one output's placements are a list: local_map reads a tuple as one
    # entry per output
    outs = tuple(out_pl(x) for x in out_like)
    return local_map(
        fn, out_placements=outs if len(outs) > 1 else outs[0],
        in_placements=tuple(pl(a) for a in args),
        in_grad_placements=tuple(pl(a, True) for a in args),
        device_mesh=rules.mesh)(*args)


def _attn_dispatch(cfg: ArchConfig, q, k, v, *, causal: bool,
                   rules: MeshRules = SINGLE):
    """Route to the configured attention implementation.

    ``flash``: the flash kernel on a CUDA tensor, its plain version on a
    CPU tensor, with the reference's blocks ``min(512, S)``.  ``xla``:
    ``_attn_streamed`` with query blocks of ``cfg.attn_chunk`` at S >=
    ``cfg.attn_chunked_above``, else ``_attn_full``.  On a real mesh q, k
    and v are DTensors split on heads, and the route runs on each rank's
    local heads (``local_kv`` picks the kv heads of the local q heads).
    """
    if rules.is_real:
        h, kv, block = q.shape[2], k.shape[2], block_index(q, 2)

        def local(ql, kl, vl):
            kl, vl = local_kv(kl, vl, h_local=ql.shape[2], h=h, kv=kv,
                              block=block)
            return _attn_dispatch(cfg, ql, kl, vl, causal=causal)

        return _on_local_heads(rules, local, q, (q, k, v), (q,))
    if cfg.attn_impl == "flash":
        bq = min(512, q.shape[1])
        bk = min(512, k.shape[1])
        return flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    if q.shape[1] >= cfg.attn_chunked_above:
        return _attn_streamed(q, k, v, causal=causal, q_chunk=cfg.attn_chunk)
    return _attn_full(q, k, v, causal=causal)


def attention(cfg: ArchConfig, p: dict, x, *, positions, causal: bool = True,
              memory=None, cache: Optional[dict] = None, prefix: str = "",
              prefill_len: Optional[int] = None, rules: MeshRules = SINGLE):
    """GQA attention with optional qk-norm, (M-)RoPE, cross-attention and
    KV cache.

    ``memory`` (B, S_mem, d): cross-attention (the encoder-decoder's); k
    and v come from the memory, the leaves are ``prefix``-ed ("x"), and
    neither RoPE nor qk-norm applies.  A cross call always takes the
    ``_attn_dispatch`` route, in decode too.
    ``cache`` (self-attention decode): {"k", "v": (B, max_len, KV, hd),
    "len": int}.  This step's k/v are written into the cache IN PLACE at
    ``len`` and the query attends over the cache with a ``kv_len`` mask.
    ``prefill_len``: plain causal attention, and also return the post-RoPE
    k/v padded to that length (the prefill cache fill).

    On a real mesh (``rules``) q, k and v are constrained to the
    reference's specs (``layers.py:248-250``) and everything between the
    projections and the output projection runs on the rank's local heads
    (``local_map``): the cache is a DTensor placed as k is, and the decode
    write goes into the rank's own block of it.

    Returns (out, new_cache_slice | None).
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    src = memory if memory is not None else x

    q = _split_heads(rules, x @ p[prefix + "q"].to(dt), h, hd, "heads")
    k = _split_heads(rules, src @ p[prefix + "k"].to(dt), kv, hd, "kv_heads")
    v = _split_heads(rules, src @ p[prefix + "v"].to(dt), kv, hd, "kv_heads")
    q = rules.shard(q, "batch", "seq_q", "heads", None)
    k = rules.shard(k, "batch", None, "kv_heads", None)
    v = rules.shard(v, "batch", None, "kv_heads", None)

    norms = (p["qn"], p["kn"]) if cfg.qk_norm and not prefix else (None,
                                                                    None)
    decode = cache is not None and memory is None
    fill = prefill_len is not None and memory is None
    ck, cv = (cache["k"], cache["v"]) if decode else (None, None)
    core = functools.partial(
        _attn_core, cfg, causal=causal,
        self_attn=memory is None, cur=cache["len"] if decode else None,
        prefill_len=prefill_len if fill else None,
        block=block_index(q, 2) if rules.is_real else 0)
    # M-RoPE's positions are a DTensor split on the batch: an argument, so
    # that the core sees the rank's block
    args = (q, k, v, ck, cv) + norms + (positions,)
    outs = (q, k, v) if fill else (q,)
    res = (_on_local_heads(rules, core, q, args, outs) if rules.is_real
           else core(*args))
    out, *kv_new = res if fill else (res,)
    new_cache = ({"k": ck, "v": cv} if decode
                 else dict(zip("kv", kv_new)) if fill else None)

    out = rules.shard(out, "batch", None, "heads", None)
    out = out.reshape(b, s, h * hd)
    out = out @ p[prefix + "o"].to(dt)
    return rules.shard(out, "batch", "seq", "d_model"), new_cache


def _split_heads(rules: MeshRules, x, n: int, d: int, axis: str):
    """``x`` (B, S, n * d) as (B, S, n, d).  Where the rules leave the n
    heads whole on a real mesh (``axis`` does not divide n) but split the
    flat n * d, the split is not one of heads and does not reshape: ``x``
    is gathered over the flat axis first."""
    if rules.is_real and rules.spec((n,), (axis,))[0] is None:
        x = rules.shard(x, "batch", None, None)
    return x.reshape(x.shape[0], x.shape[1], n, d)


def _attn_core(cfg: ArchConfig, q, k, v, ck, cv, qn, kn, positions, *,
               causal: bool, self_attn: bool, cur: Optional[int],
               prefill_len: Optional[int], block: int):
    """``attention`` between its projections: qk-norm and (M-)RoPE, then
    the decode cache write and ``_attn_full`` over the cache (``cur`` the
    cache's length), or ``_attn_dispatch``, with the padded k/v as well
    when ``prefill_len``.  On a mesh it runs on one rank's local heads,
    block ``block`` of q's heads, and the local q heads read their own kv
    heads (``local_kv``).  Returns out, or (out, k, v) for a prefill
    fill."""
    dt = q.dtype
    if qn is not None:
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    if self_attn:  # rotary embedding
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    heads = dict(h_local=q.shape[2], h=cfg.n_heads, kv=cfg.n_kv_heads,
                 block=block)

    if ck is not None:
        s = q.shape[1]
        _check_room(cur, s, ck.shape[1])
        ck[:, cur:cur + s] = k.to(ck.dtype)
        cv[:, cur:cur + s] = v.to(cv.dtype)
        kc, vc = local_kv(ck, cv, **heads)
        # the query is the newest token: the kv_len mask IS the causal mask
        return _attn_full(q, kc.to(dt), vc.to(dt), causal=False,
                          kv_len=cur + s)
    ka, va = local_kv(k, v, **heads)
    out = _attn_dispatch(cfg, q, ka, va, causal=causal)
    if prefill_len is None:
        return out
    pad = prefill_len - k.shape[1]
    return (out, F.pad(k, (0, 0, 0, 0, 0, pad)),
            F.pad(v, (0, 0, 0, 0, 0, pad)))


def _check_room(cur: int, s: int, max_len: int):
    if cur + s > max_len:
        raise ValueError(f"KV cache full: {cur} + {s} > max_len {max_len}")


# --------------------------------------------------------------------------
# MLA (deepseek-v2)
# --------------------------------------------------------------------------
def mla_attention(cfg: ArchConfig, p: dict, x, *, positions,
                  cache: Optional[dict] = None,
                  prefill_len: Optional[int] = None,
                  rules: MeshRules = SINGLE):
    """Multi-head latent attention.  The cache holds only (c_kv, k_rope):
    {"c_kv": (B, max_len, kv_lora_rank), "k_rope": (B, max_len,
    rope_head_dim), "len": int}, written IN PLACE at ``len``; decode uses
    the absorbed-projection form, with the scores in the latent space.

    Prefill attends over [q_nope | q_rope] against [k_nope | k_rope]: q and
    k heads of hd + rhd, v heads of vhd.  The flash kernel takes one head
    dimension for q, k and v, so under ``attn_impl="flash"`` prefill raises
    ``NotImplementedError`` before any launch; nothing pads the heads or
    falls back to ``_attn_full`` behind the caller's back.

    On a real mesh (``rules``) q is split on "batch" and "heads" (the
    reference's point on qf and kf, ``layers.py:361-362``) and everything
    between the projections and ``o`` runs on the rank's local heads
    (``_mla_core`` under ``local_map``): ``kv_b``'s flat ``h * (hd +
    vhd)`` axis is split as q's heads and reshaped there, while the latent
    c_kv and k_rope, which have no head axis, stay whole on "model" and
    split on the batch, as the cache does.

    Returns (out, new_cache_slice | None).
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    hd, vhd, rhd = cfg.head_dim, cfg.v_head_dim, cfg.rope_head_dim
    dt = x.dtype
    if cache is None and cfg.attn_impl == "flash":
        raise NotImplementedError(
            f"{cfg.name}: MLA's prefill has q and k heads of {hd + rhd} and "
            f"v heads of {vhd}; the flash kernel takes one head dimension "
            f"for q, k and v (16 to 128), so MLA has no flash route: use "
            f"attn_impl='xla' (layers._attn_full)")

    cq = rms_norm(x @ p["q_a"].to(dt), p["q_norm"], cfg.norm_eps)
    q = _split_heads(rules, cq @ p["q_b"].to(dt), h, hd + rhd, "heads")
    q = rules.shard(q, "batch", None, "heads", None)
    ckv_full = x @ p["kv_a"].to(dt)
    kv_b = p["kv_b"].to(dt)
    if rules.is_real:
        ckv_full = rules.shard(ckv_full, "batch", None, None)
        # kv_b's columns split as q's heads are (whole where they are)
        kv_b = kv_b.redistribute(rules.mesh, tuple(
            Shard(1) if pq == Shard(2) else Replicate()
            for pq in q.placements))
    decode = cache is not None
    fill = prefill_len is not None and not decode
    ck, kr = (cache["c_kv"], cache["k_rope"]) if decode else (None, None)
    core = functools.partial(
        _mla_core, cfg, positions=positions,
        cur=cache["len"] if decode else None,
        prefill_len=prefill_len if fill else None)
    args = (q, ckv_full, p["kv_norm"], kv_b, ck, kr)
    outs = (q, ckv_full, ckv_full) if fill else (q,)
    res = (_on_local_heads(rules, core, q, args, outs) if rules.is_real
           else core(*args))
    out, *lat = res if fill else (res,)
    new_cache = ({"c_kv": ck, "k_rope": kr} if decode
                 else dict(zip(("c_kv", "k_rope"), lat)) if fill else None)

    out = out.reshape(b, s, h * vhd)
    out = out @ p["o"].to(dt)
    return rules.shard(out, "batch", "seq", "d_model"), new_cache


def _mla_core(cfg: ArchConfig, q, ckv_full, kv_norm, kv_b, ckv_c, krope_c,
              *, positions, cur: Optional[int], prefill_len: Optional[int]):
    """``mla_attention`` between its projections, on the heads q holds
    (every head on one device, the rank's local heads on a mesh, with
    ``kv_b``'s columns for those heads): RoPE, the latent kv, and the
    absorbed decode form against the cache (``cur`` its length) or the
    prefill's attention, with the padded latent entries as well when
    ``prefill_len``.  Returns out (B, S, h_local, vhd), or (out, c_kv,
    k_rope) for a prefill fill."""
    b, s, hl = q.shape[:3]
    hd, vhd = cfg.head_dim, cfg.v_head_dim
    rhd, kvlr = cfg.rope_head_dim, cfg.kv_lora_rank
    dt = q.dtype
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = ckv_full[..., :kvlr], ckv_full[..., kvlr:]
    c_kv = rms_norm(c_kv, kv_norm, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)

    wkv_b = kv_b.reshape(kvlr, hl, hd + vhd)
    w_uk, w_uv = wkv_b[..., :hd], wkv_b[..., hd:]
    scale = (hd + rhd) ** -0.5

    if ckv_c is not None:
        _check_room(cur, s, ckv_c.shape[1])
        ckv_c[:, cur:cur + s] = c_kv.to(ckv_c.dtype)
        krope_c[:, cur:cur + s] = k_rope[:, :, 0, :].to(krope_c.dtype)
        # absorbed form: q_eff = q_nope @ W_uk -> scores in latent space
        q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        s_lat = torch.einsum("bshr,bkr->bhsk", q_eff, ckv_c.to(dt))
        s_rope = torch.einsum("bshd,bkd->bhsk", q_rope, krope_c.to(dt))
        scores = (s_lat + s_rope).to(torch.float32) * scale
        valid = torch.arange(ckv_c.shape[1], device=q.device) < cur + s
        scores = torch.where(valid, scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1).to(dt)
        o_lat = torch.einsum("bhsk,bkr->bshr", pr, ckv_c.to(dt))
        return torch.einsum("bshr,rhd->bshd", o_lat, w_uv)
    k_nope = torch.einsum("bkr,rhd->bkhd", c_kv, w_uk)
    v = torch.einsum("bkr,rhd->bkhd", c_kv, w_uv)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, hl, rhd)], dim=-1)
    out = _attn_dispatch(cfg, qf, kf, v, causal=True)
    if prefill_len is None:
        return out
    pad = prefill_len - s
    return (out, F.pad(c_kv, (0, 0, 0, pad)),
            F.pad(k_rope[:, :, 0, :], (0, 0, 0, pad)))


def silu(x):
    """``jax.nn.silu`` op by op in x's dtype: x * (1 / (1 + exp(-x))), each
    op rounded to that dtype, as the reference's bf16 graph rounds them.
    ``F.silu`` rounds once; in bf16 it moved about 30% of a Mamba2 block's
    activations by an ulp from the reference's.  The SSM blocks use this
    form; ``ffn`` keeps ``F.silu``."""
    return x * (1 / (1 + torch.exp(-x)))


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------
def ffn(cfg: ArchConfig, p: dict, x, *, keys=("wg", "wu", "wd"),
        rules: MeshRules = SINGLE):
    dt = x.dtype
    g = x @ p[keys[0]].to(dt)
    u = x @ p[keys[1]].to(dt)
    h = rules.shard(F.silu(g) * u, "batch", "seq", "d_ff")
    return rules.shard(h @ p[keys[2]].to(dt), "batch", "seq", "d_model")


def top_k(probs, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, largest first,
    equal values in index order (a tie goes to the lower index).
    ``torch.topk`` promises no order among equal values, so this takes a
    stable descending sort.  Returns (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ArchConfig, p: dict, x):
    """The MoE router: logits in the activation dtype, probabilities in
    fp32, the top-k experts and their renormalised weights.  Returns
    (probs (B, S, E), top_p (B, S, k), top_i (B, S, k))."""
    logits = x @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_i = top_k(probs, cfg.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def capacity(cfg: ArchConfig, s: int) -> int:
    """Expert slots per sequence of ``s`` tokens (the reference's cap)."""
    return max(8, int(math.ceil(s * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def capacity_slots(top_i, n_experts: int, cap: int):
    """The reference's sort-based dispatch (``dispatch_one``), per
    sequence: the (token, choice) entries in flat order t * k + j are
    sorted stably by expert, and the first ``cap`` of each expert take the
    slots e * cap + pos.  Returns (B, S, k) slots; an entry over capacity
    gets ``n_experts * cap`` (dropped)."""
    b, s, k = top_i.shape
    flat = top_i.reshape(b, s * k)
    order = torch.argsort(flat, dim=-1, stable=True)  # jnp.argsort is stable
    sorted_e = torch.gather(flat, 1, order)
    counts = torch.zeros((b, n_experts), dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = (torch.arange(s * k, device=flat.device)[None]
           - torch.gather(starts, 1, sorted_e))
    slot = torch.where(pos < cap, sorted_e * cap + pos, n_experts * cap)
    return torch.empty_like(slot).scatter_(1, order, slot).reshape(b, s, k)


#: the list ``moe_ffn`` records its routing in, within ``recording_routes``
_ROUTES: Optional[list] = None


@contextlib.contextmanager
def recording_routes():
    """Within the block, each ``moe_ffn`` call over more than one token
    appends its routing on the local sequences (a rank's own on a mesh) to
    the yielded list, as it lies on the device: the experts (``top_i``,
    (B, S, k)), the entries dropped over capacity (bool, the same shape)
    and the router's probabilities (fp32, (B, S, n_experts))."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def _record_route(probs, top_i, slots, n_experts: int, cap: int):
    if _ROUTES is not None and slots is not None:
        _ROUTES.append((top_i.detach(), slots == n_experts * cap,
                        probs.detach()))


def moe_ffn(cfg: ArchConfig, p: dict, x, *, rules: MeshRules = SINGLE):
    """Top-k MoE with sort-based capacity dispatch; returns (out, aux_loss).

    Each sequence is a dispatch group (``capacity_slots``); the experts
    run as three batched products over every sequence's slots at once, and
    each token sums its slots' weighted outputs in ascending slot order in
    the activation dtype, the order of the reference's segment sum, with
    no atomics, so two runs give the same bits.  Entries over capacity are
    dropped (GShard).  A single-token step (``s == 1``, decode) takes the
    exact dense combine instead: every expert runs on the token.

    On a real mesh (``rules``) see ``_moe_mesh``.
    """
    if rules.is_real:
        return _moe_mesh(cfg, p, x, rules)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    probs, top_p, top_i = route(cfg, p, x)

    # load-balancing aux loss (Switch-style: f_i * P_i)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1),
        torch.full((b * s * k,), 1.0 / (b * s * k), device=x.device))
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef

    we_g, we_u, we_d = (p[key].to(dt) for key in ("we_g", "we_u", "we_d"))
    slots = capacity_slots(top_i, e, capacity(cfg, s)) if s > 1 else None
    _record_route(probs, top_i, slots, e, capacity(cfg, s))
    hh, uu = _moe_up(cfg, x, slots, we_g, we_u, first=0)
    out = _moe_down(cfg, hh, uu, we_d, top_p, top_i, slots, first=0, b=b,
                    s=s)
    if cfg.n_shared_experts:
        out = out + ffn(cfg, p, x, keys=("ws_g", "ws_u", "ws_d"))
    return out, aux


def _held_slots(slots, first: int, el: int, n_experts: int, cap: int):
    """``capacity_slots``' slots (every expert's) as the slots of the
    experts ``first`` to ``first + el``, numbered from 0; any other entry
    dropped (``el * cap``).  Every expert held (one device): ``slots``."""
    if first == 0 and el == n_experts:
        return slots
    lo, n_slots = first * cap, el * cap
    return torch.where((slots >= lo) & (slots < lo + n_slots), slots - lo,
                       n_slots)


def _moe_up(cfg: ArchConfig, x, slots, we_g, we_u, *, first: int):
    """The gate and up products of the experts ``first`` to ``first +
    we_g.shape[0]`` (every expert on one device, a rank's own on a mesh):
    on the tokens dispatched to their slots, (el, B * cap, f), or on every
    token in decode (``slots`` None, S = 1), (el, B, f).  ``x`` (B, S, dx)
    holds the part of d that ``we_g`` and ``we_u`` hold (all of it on one
    device)."""
    b, s, dx = x.shape
    el = we_g.shape[0]
    if slots is None:
        xt = x.reshape(b * s, dx)
        return torch.matmul(xt, we_g), torch.matmul(xt, we_u)
    k = slots.shape[-1]
    cap = capacity(cfg, s)
    n_slots = el * cap
    slots = _held_slots(slots, first, el, cfg.n_experts, cap)
    # dispatch: each slot's token, s (a zero row) where empty; the
    # dropped entries all land in one spare column, sliced off
    tok = torch.arange(s, device=x.device).view(1, s, 1).expand(b, s, k)
    slot_tok = torch.full((b, n_slots + 1), s, dtype=tok.dtype,
                          device=x.device)
    slot_tok.scatter_(1, slots.reshape(b, s * k), tok.reshape(b, s * k))
    rows = slot_tok[:, :n_slots] + (
        torch.arange(b, device=x.device) * (s + 1))[:, None]
    x_pad = torch.cat([x, x.new_zeros((b, 1, dx))], dim=1)
    xe = x_pad.reshape(b * (s + 1), dx)[
        rows.view(b, el, cap).transpose(0, 1).reshape(el, b * cap)]
    return torch.bmm(xe, we_g), torch.bmm(xe, we_u)    # (el, b*cap, f)


def _moe_down(cfg: ArchConfig, hh, uu, we_d, top_p, top_i, slots, *,
              first: int, b: int, s: int):
    """The held experts' down products on ``_moe_up``'s (``hh``, ``uu``)
    and each token's sum of them, (B, S, dy) for the dy columns ``we_d``
    holds: in decode the dense combine (weights of unselected experts 0),
    else each token's kept slots in ascending slot order."""
    e, k = cfg.n_experts, cfg.top_k
    el, dy = we_d.shape[0], we_d.shape[-1]
    dt = hh.dtype
    if slots is None:
        w_full = torch.zeros((b * s, e), dtype=torch.float32,
                             device=hh.device).scatter(
            -1, top_i.reshape(b * s, k), top_p.reshape(b * s, k))
        yx = torch.matmul(F.silu(hh) * uu, we_d)           # (el, b*s, dy)
        return torch.einsum("etd,te->td", yx, w_full[:, first:first + el]
                            .to(dt)).reshape(b, s, dy)
    cap = capacity(cfg, s)
    n_slots = el * cap
    slots = _held_slots(slots, first, el, cfg.n_experts, cap)
    ye = torch.bmm(F.silu(hh) * uu, we_d)                  # (el, b*cap, dy)
    # combine: each token's kept slots, in ascending slot order
    ye = torch.cat([ye.reshape(el * b * cap, dy), ye.new_zeros((1, dy))])
    slots, perm = torch.sort(slots, dim=-1)
    kept = slots < n_slots
    bi = torch.arange(b, device=hh.device).view(b, 1, 1)
    row = torch.where(kept, (slots // cap) * (b * cap) + bi * cap
                      + slots % cap, el * b * cap)
    w = torch.where(kept, torch.gather(top_p, -1, perm), 0.0).to(dt)
    out = hh.new_zeros((b, s, dy))
    for j in range(k):
        out = out + ye[row[..., j]] * w[..., j, None]
    return out


def _moe_mesh(cfg: ArchConfig, p: dict, x, rules: MeshRules):
    """``moe_ffn`` on a real mesh, in three ``local_map``s.

    Routing: the router is ("fsdp_d_model", None), so its logits are whole
    over the experts on every rank, and the top-k, the renormalisation and
    the capacity slots run on each rank's local batch, whole sequences
    (the rules must not split "seq": each sequence is its own capacity
    group).  The aux loss's ``me`` and ``ce`` are the means over the whole
    batch: each rank's sums over its tokens divided by the global count,
    summed over the batch's shards (``Partial``), before their product.

    Experts: the expert weights stay where the rules put them, the experts
    split on "model" and d on "fsdp_d_model"'s axes ("data"), and the
    tokens, their experts and slots (a few MB) are gathered instead: each
    rank dispatches every sequence to its own experts, multiplies its part
    of d into the gate and up products (a partial sum over "data", reduced
    before the activation), and forms the down product's columns of its
    part of d, summed over its experts in each token's slot order.  The sum
    over the experts' ranks (``Partial`` on "model") is reduced, and d
    reassembled, at the reference's shard point ``("batch", "seq",
    "d_model")`` (``layers.py:451``).  The additions come in another order
    than one device's (equal to a tolerance, not to the bits), in a fixed
    one: two meshed runs give the same bits."""
    from torch.distributed.tensor.experimental import local_map

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt, mesh = x.dtype, rules.mesh
    spec = rules.spec(x.shape, ("batch", "seq", "d_model"))
    if spec[1] is not None or spec[2] is not None:
        raise NotImplementedError(
            f"MoE on a mesh that splits the sequence or d_model ({spec}): "
            f"each sequence is a capacity group, held whole by one rank")
    x = rules.shard(x, "batch", "seq", "d_model")
    logits = rules.shard(x @ p["router"].to(dt), "batch", "seq", None)
    n = b * s

    def routing(lg):
        probs = torch.softmax(lg.to(torch.float32), dim=-1)
        top_p, top_i = top_k(probs, k)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        me = probs.sum(dim=(0, 1)) / n
        ce = torch.zeros((e,), dtype=torch.float32, device=lg.device)
        ce.index_add_(0, top_i.reshape(-1), torch.full(
            (top_i.numel(),), 1.0 / (n * k), device=lg.device))
        slots = capacity_slots(top_i, e, capacity(cfg, s)) if s > 1 else None
        _record_route(probs, top_i, slots, e, capacity(cfg, s))
        return top_p, top_i, slots, me, ce

    tok_pl = list(x.placements)
    stat_pl = [Partial() if isinstance(pl, Shard) else Replicate()
               for pl in x.placements]
    top_p, top_i, slots, me, ce = local_map(
        routing, out_placements=(tok_pl, tok_pl,
                                 tok_pl if s > 1 else None, stat_pl, stat_pl),
        in_placements=(tok_pl,), device_mesh=mesh)(logits)
    whole = [Replicate()] * mesh.ndim
    me, ce = me.redistribute(mesh, whole), ce.redistribute(mesh, whole)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef

    we_g, we_u, we_d = (p[key].to(dt) for key in ("we_g", "we_u", "we_d"))
    g_pl = we_g.placements
    d_axes = [a for a, pl in enumerate(g_pl) if pl == Shard(1)]
    e_axes = [a for a, pl in enumerate(g_pl) if pl == Shard(0)]
    if (we_u.placements != g_pl or len(d_axes) + len(e_axes)
            != sum(pl != Replicate() for pl in g_pl)
            or we_d.placements != tuple(
                Shard(2) if a in d_axes else pl
                for a, pl in enumerate(g_pl))):
        raise NotImplementedError(
            f"MoE experts placed {g_pl}, {we_u.placements}, "
            f"{we_d.placements}: expected the experts and d split as "
            f"('experts', 'fsdp_d_model', None) places them")
    el = we_g.to_local().shape[0]
    first = block_index(we_g, 0) * el
    dl = we_g.to_local().shape[1]
    d_lo = block_index(we_g, 1) * dl
    # every sequence, its experts and slots on every rank
    xa, tpa, tia = (t.redistribute(mesh, whole) for t in (x, top_p, top_i))
    sla = slots.redistribute(mesh, whole) if s > 1 else None

    def up(xl, sl, g, u):
        return _moe_up(cfg, xl[..., d_lo:d_lo + dl], sl, g, u, first=first)

    hu_pl = [Partial() if a in d_axes else pl for a, pl in enumerate(g_pl)]
    hh, uu = local_map(
        up, out_placements=(hu_pl, hu_pl),
        in_placements=(whole, whole if s > 1 else None, g_pl, g_pl),
        in_grad_placements=(list(_grad_placements(xa, we_g)),
                            whole if s > 1 else None, g_pl, g_pl),
        device_mesh=mesh)(xa, sla, we_g, we_u)
    hu_r = [Replicate() if a in d_axes else pl for a, pl in enumerate(g_pl)]
    hh, uu = hh.redistribute(mesh, hu_r), uu.redistribute(mesh, hu_r)

    def down(h, u, dd, tp, ti, sl):
        return _moe_down(cfg, h, u, dd, tp, ti, sl, first=first, b=b, s=s)

    args = (hh, uu, we_d, tpa, tia, sla)
    out = local_map(
        down, out_placements=[Shard(2) if a in d_axes else
                              Partial() if a in e_axes else Replicate()
                              for a in range(mesh.ndim)],
        in_placements=tuple(list(a.placements) if isinstance(a, DTensor)
                            else None for a in args),
        in_grad_placements=tuple(list(_grad_placements(a, we_d))
                                 if isinstance(a, DTensor) else None
                                 for a in args),
        device_mesh=mesh)(*args)
    out = rules.shard(out, "batch", "seq", "d_model")
    if cfg.n_shared_experts:
        out = out + ffn(cfg, p, x, keys=("ws_g", "ws_u", "ws_d"), rules=rules)
    return out, aux
