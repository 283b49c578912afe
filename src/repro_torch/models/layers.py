"""Model layers: RMS norm, embeddings, RoPE and M-RoPE, grouped-query
attention (full, and streamed over KV blocks for long prompts) with a KV
cache and cross-attention, multi-head latent attention (MLA), the gated
FFN and the top-k MoE FFN.

Port of ``repro/models/layers.py``.  Numerics as in the reference:
activations in ``cfg.dtype``; softmax, router probabilities, norm
statistics and the rotary rotation in fp32.  The reference's ``MeshRules``
is the keyword ``rules`` of ``embed``, ``attention``, ``_attn_dispatch``
and ``ffn``, the single-device rules by default (``rules.shard`` the
identity).  On a real device mesh the activations are ``DTensor``s, the
reference's shard points redistribute them, and the attention core
(qk-norm, RoPE, the decode cache write and ``_attn_full``, or the flash
kernel) runs on each rank's local heads through ``local_map``.  MLA and
the MoE FFN take no rules yet: ``models.model`` refuses a family other
than dense on a real mesh.

The SSM cells are in ``models/ssm.py``.  MLA's prefill has no flash
route: its q and k heads are wider than its v heads, which the flash
kernel does not take, so it raises under ``attn_impl="flash"`` (the
reference's registered ``attn_impl`` for deepseek-v2 is ``"xla"``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

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
    in that dtype (the reference's cast order)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


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
    placements it takes (None for an output that is not a tensor)."""
    from torch.distributed.tensor.experimental import local_map

    def pl(x, grad=False):
        if not isinstance(x, DTensor):
            return None
        return list(_grad_placements(x, q) if grad else x.placements)

    # one output's placements are a list: local_map reads a tuple as one
    # entry per output
    outs = tuple(pl(x) for x in out_like)
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

    q = (x @ p[prefix + "q"].to(dt)).reshape(b, s, h, hd)
    k = (src @ p[prefix + "k"].to(dt)).reshape(b, src.shape[1], kv, hd)
    v = (src @ p[prefix + "v"].to(dt)).reshape(b, src.shape[1], kv, hd)
    q = rules.shard(q, "batch", "seq_q", "heads", None)
    k = rules.shard(k, "batch", None, "kv_heads", None)
    v = rules.shard(v, "batch", None, "kv_heads", None)

    norms = (p["qn"], p["kn"]) if cfg.qk_norm and not prefix else (None,
                                                                    None)
    decode = cache is not None and memory is None
    fill = prefill_len is not None and memory is None
    ck, cv = (cache["k"], cache["v"]) if decode else (None, None)
    core = functools.partial(
        _attn_core, cfg, positions=positions, causal=causal,
        self_attn=memory is None, cur=cache["len"] if decode else None,
        prefill_len=prefill_len if fill else None,
        block=block_index(q, 2) if rules.is_real else 0)
    args = (q, k, v, ck, cv) + norms
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


def _attn_core(cfg: ArchConfig, q, k, v, ck, cv, qn, kn, *, positions,
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
                  prefill_len: Optional[int] = None):
    """Multi-head latent attention.  The cache holds only (c_kv, k_rope):
    {"c_kv": (B, max_len, kv_lora_rank), "k_rope": (B, max_len,
    rope_head_dim), "len": int}, written IN PLACE at ``len``; decode uses
    the absorbed-projection form, with the scores in the latent space.

    Prefill attends over [q_nope | q_rope] against [k_nope | k_rope]: q and
    k heads of hd + rhd, v heads of vhd.  The flash kernel takes one head
    dimension for q, k and v, so under ``attn_impl="flash"`` prefill raises
    ``NotImplementedError`` before any launch; nothing pads the heads or
    falls back to ``_attn_full`` behind the caller's back.

    Returns (out, new_cache_slice | None).
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    hd, vhd, rhd = cfg.head_dim, cfg.v_head_dim, cfg.rope_head_dim
    kvlr = cfg.kv_lora_rank
    dt = x.dtype
    if cache is None and cfg.attn_impl == "flash":
        raise NotImplementedError(
            f"{cfg.name}: MLA's prefill has q and k heads of {hd + rhd} and "
            f"v heads of {vhd}; the flash kernel takes one head dimension "
            f"for q, k and v (16 to 128), so MLA has no flash route: use "
            f"attn_impl='xla' (layers._attn_full)")

    # --- queries ---
    cq = rms_norm(x @ p["q_a"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (cq @ p["q_b"].to(dt)).reshape(b, s, h, hd + rhd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    # --- latent kv ---
    ckv_full = x @ p["kv_a"].to(dt)
    c_kv, k_rope = ckv_full[..., :kvlr], ckv_full[..., kvlr:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)

    wkv_b = p["kv_b"].to(dt).reshape(kvlr, h, hd + vhd)
    w_uk, w_uv = wkv_b[..., :hd], wkv_b[..., hd:]
    scale = (hd + rhd) ** -0.5

    if cache is not None:
        ckv_c, krope_c, cur = cache["c_kv"], cache["k_rope"], cache["len"]
        _check_room(cur, s, ckv_c.shape[1])
        ckv_c[:, cur:cur + s] = c_kv.to(ckv_c.dtype)
        krope_c[:, cur:cur + s] = k_rope[:, :, 0, :].to(krope_c.dtype)
        new_cache = {"c_kv": ckv_c, "k_rope": krope_c}
        # absorbed form: q_eff = q_nope @ W_uk -> scores in latent space
        q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        s_lat = torch.einsum("bshr,bkr->bhsk", q_eff, ckv_c.to(dt))
        s_rope = torch.einsum("bshd,bkd->bhsk", q_rope, krope_c.to(dt))
        scores = (s_lat + s_rope).to(torch.float32) * scale
        valid = torch.arange(ckv_c.shape[1], device=x.device) < cur + s
        scores = torch.where(valid, scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1).to(dt)
        o_lat = torch.einsum("bhsk,bkr->bshr", pr, ckv_c.to(dt))
        out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)
    else:
        new_cache = None
        if prefill_len is not None:
            pad = prefill_len - s
            new_cache = {"c_kv": F.pad(c_kv, (0, 0, 0, pad)),
                         "k_rope": F.pad(k_rope[:, :, 0, :], (0, 0, 0, pad))}
        k_nope = torch.einsum("bkr,rhd->bkhd", c_kv, w_uk)
        v = torch.einsum("bkr,rhd->bkhd", c_kv, w_uv)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, k_rope.expand(b, s, h, rhd)], dim=-1)
        out = _attn_dispatch(cfg, qf, kf, v, causal=True)

    out = out.reshape(b, s, h * vhd)
    return out @ p["o"].to(dt), new_cache


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


def moe_ffn(cfg: ArchConfig, p: dict, x):
    """Top-k MoE with sort-based capacity dispatch; returns (out, aux_loss).

    Each sequence is a dispatch group (``capacity_slots``); the experts
    run as three batched products over every sequence's slots at once, and
    each token sums its slots' weighted outputs in ascending slot order in
    the activation dtype, the order of the reference's segment sum, with
    no atomics, so two runs give the same bits.  Entries over capacity are
    dropped (GShard).  A single-token step (``s == 1``, decode) takes the
    exact dense combine instead: every expert runs on the token.
    """
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
    if s == 1:
        # exact dense combine for decode (weights of unselected experts 0)
        w_full = torch.zeros((b * s, e), dtype=torch.float32,
                             device=x.device).scatter(
            -1, top_i.reshape(b * s, k), top_p.reshape(b * s, k))
        xt = x.reshape(b * s, d)
        hx = torch.matmul(xt, we_g)                        # (e, b*s, f)
        ux = torch.matmul(xt, we_u)
        yx = torch.matmul(F.silu(hx) * ux, we_d)           # (e, b*s, d)
        out = torch.einsum("etd,te->td", yx, w_full.to(dt)).reshape(b, s, d)
    else:
        cap = capacity(cfg, s)
        n_slots = e * cap
        slots = capacity_slots(top_i, e, cap)              # (b, s, k)
        # dispatch: each slot's token, s (a zero row) where empty; the
        # dropped entries all land in one spare column, sliced off
        tok = torch.arange(s, device=x.device).view(1, s, 1).expand(b, s, k)
        slot_tok = torch.full((b, n_slots + 1), s, dtype=tok.dtype,
                              device=x.device)
        slot_tok.scatter_(1, slots.reshape(b, s * k), tok.reshape(b, s * k))
        rows = slot_tok[:, :n_slots] + (
            torch.arange(b, device=x.device) * (s + 1))[:, None]
        x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
        xe = x_pad.reshape(b * (s + 1), d)[
            rows.view(b, e, cap).transpose(0, 1).reshape(e, b * cap)]
        hh = torch.bmm(xe, we_g)                           # (e, b*cap, f)
        uu = torch.bmm(xe, we_u)
        ye = torch.bmm(F.silu(hh) * uu, we_d)              # (e, b*cap, d)
        # combine: each token's kept slots, in ascending slot order
        ye = torch.cat([ye.reshape(e * b * cap, d), ye.new_zeros((1, d))])
        slots, perm = torch.sort(slots, dim=-1)
        kept = slots < n_slots
        bi = torch.arange(b, device=x.device).view(b, 1, 1)
        row = torch.where(kept, (slots // cap) * (b * cap) + bi * cap
                          + slots % cap, e * b * cap)
        w = torch.where(kept, torch.gather(top_p, -1, perm), 0.0).to(dt)
        out = torch.zeros_like(x)
        for j in range(k):
            out = out + ye[row[..., j]] * w[..., j, None]

    if cfg.n_shared_experts:
        out = out + ffn(cfg, p, x, keys=("ws_g", "ws_u", "ws_d"))
    return out, aux
