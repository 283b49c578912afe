"""Model assembly of every LM family: the training forward and its loss,
prefill and single-token decode.

Port of ``repro/models/model.py``.  The reference's ``MeshRules`` is the
keyword ``rules`` of ``transformer_block``, ``forward``, ``loss_fn``,
``init_cache``, ``prefill`` and ``decode_step``; its default, the
single-device rules, keeps every call as it was.  On a real device mesh
(``MeshRules.for_mesh`` over a ``DeviceMesh``) the parameters are
``DTensor``s placed by ``params.param_shardings``, the activations are
constrained at the reference's points (``model.py:98, 126, 139, 160,
184, 224, 258, 276, 484, 594`` and the layers'), and the cache is placed
by its logical axes (the audio memory on ("cache_batch", "cache_seq",
"d_model"), MLA's latent entries on "cache_batch", the SSM states and
carries on "cache_batch" and "heads", the conv cache on "cache_batch" and
"d_ff"; ``len`` and ``offset`` are Python ints, the same on every rank).
M-RoPE's (3, B, S) positions split on their batch axis, dim 1.  Every
family runs on a real mesh.  The SSM cells (``models/ssm.py``) run
unchanged on each rank's local heads (Mamba2's conv on its "d_ff"
channels), one ``local_map`` per call, so the sLSTM's steps pay DTensor's
dispatch once per scan; where "heads" does not divide the model axis
while "d_ff" does, their inputs are gathered whole over the heads first.
``lax.scan`` over the stacked layers becomes a Python loop over the
leading ``n_layers`` axis; ``forward`` splits each stacked leaf once
with ``torch.unbind``, so under autograd the per-layer gradients are
stacked once instead of each layer's ``select`` building a zero gradient
the size of the whole stack.

Families, as in the reference:
  dense / vlm  pre-norm decoder, GQA (vlm: M-RoPE, and a stub frontend's
               precomputed patch embeddings prepended to the tokens);
  moe          as dense with a top-k MoE FFN; deepseek-v2 adds MLA and
               leading dense layers (``dense_blocks``);
  audio        encoder-decoder: a stub frontend's frame embeddings run
               through the non-causal encoder into the memory that every
               decoder layer cross-attends;
  hybrid       zamba2: a Mamba2 (SSD) backbone with ONE shared-weight
               attention + FFN block applied after every ``attn_every``
               Mamba2 layers; the layers past the last whole group (the
               tail) run after it;
  ssm          xLSTM: groups of (slstm_every - 1) mLSTM blocks and one
               sLSTM block.

Training rematerializes each block as ``cfg.remat`` says, the reference's
``jax.checkpoint`` of the scan body (the reference remats a hybrid or
xLSTM group as a whole, the port each block of it): ``"full"`` keeps only
the block's input (``torch.utils.checkpoint``), ``"dots"`` also keeps the
outputs of the unbatched matmuls (the projections; the attention's and
the experts' batched products are recomputed, as
``checkpoint_dots_with_no_batch_dims``), ``"none"`` keeps everything.
None of them changes a value.

The decode cache is a dict as in the reference: {"layers": {"k", "v": (L,
B, max_len, KV, hd)} (MLA: {"c_kv": (L, B, max_len, kv_lora_rank),
"k_rope": (L, B, max_len, rope_head_dim)}), ["dense_layers": the same for
the leading dense layers,] ["memory": (B, enc_len, d),] "len": int,
"offset": int}, ``offset`` being the frontend (patch) span.  The hybrid
family's holds {"ssm": (L, B, nh, N, P) fp32, "conv": (L, B, W - 1,
d_inner) in the activation dtype, "attn": {"k", "v"} with one entry per
application of the shared block}, the ssm family's {"mlstm_C": (G, M, B,
H, dk, dk), "mlstm_n": (G, M, B, H, dk), "mlstm_m": (G, M, B, H),
"slstm": (G, 4, B, H, hd)}, all fp32, for G groups of M mLSTM blocks
(the sLSTM's c, n, h and m stacked on the second axis).
``decode_step`` updates it IN PLACE and returns it: the reference's engine
donates the cache to the decode step (``engine.py:47``), so it too keeps
one copy.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core.nbody import resolve_device
from repro_torch.distributed.shardings import MeshRules
from repro_torch.models import layers, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import check_ported


F32 = torch.float32
SINGLE = layers.SINGLE
def _adt(cfg: ArchConfig):
    return getattr(torch, cfg.dtype)


def _layer(stacked: dict, i: int) -> dict:
    return {k: x[i] for k, x in stacked.items()}


def _zero(device):
    return torch.zeros((), dtype=torch.float32, device=device)


# ===========================================================================
# block forward
# ===========================================================================
def transformer_block(cfg, p, x, *, positions, causal=True, memory=None,
                      cache=None, prefill_len=None,
                      rules: MeshRules = SINGLE):
    """Pre-norm attention (+ cross-attention) + FFN/MoE block.

    Returns (x, new_kv_cache_or_None, aux_loss)."""
    xa = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.uses_mla:
        out, kv = layers.mla_attention(cfg, p, xa, positions=positions,
                                       cache=cache, prefill_len=prefill_len,
                                       rules=rules)
    else:
        out, kv = layers.attention(cfg, p, xa, positions=positions,
                                   causal=causal, cache=cache,
                                   prefill_len=prefill_len, rules=rules)
    x = x + out

    if "xq" in p:  # encoder-decoder cross-attention
        xc = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        out, _ = layers.attention(cfg, p, xc, positions=positions,
                                  causal=False, memory=memory, prefix="x",
                                  rules=rules)
        x = x + out
        xf = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
    else:
        xf = layers.rms_norm(x, p["ln2"], cfg.norm_eps)

    if "router" in p:
        out, aux = layers.moe_ffn(cfg, p, xf, rules=rules)
        return x + out, kv, aux
    return x + layers.ffn(cfg, p, xf, rules=rules), kv, _zero(x.device)


def _local(rules: MeshRules, fn, q, args: tuple, outs: tuple):
    """``fn(*args)``: on one device as it is, on a real mesh on each rank's
    local blocks (``layers._on_local_heads``; ``q`` the input whose split
    the work follows, ``outs`` per output a DTensor or placements)."""
    if not rules.is_real:
        return fn(*args)
    return layers._on_local_heads(rules, fn, q, args, outs)


def _carry_placements(rules: MeshRules, shape, logical):
    """The placements of a recurrent carry made inside a core (None
    without a real mesh)."""
    return rules.placements(shape, logical) if rules.is_real else None


def _conv_core(xi, w, cache):
    """Mamba2's causal conv and silu, on the "d_ff" channels a rank
    holds; returns xi, or (xi, cache) when streaming from ``cache``."""
    if cache is not None:
        xi, cache = ssm.causal_conv(xi, w, cache=cache)
        return layers.silu(xi), cache
    return layers.silu(ssm.causal_conv(xi, w))


def _ssd_core(cfg, xh, dtv, dt_bias, a_log, d_skip, b_mat, c_mat, state):
    """Mamba2's SSD on the heads ``xh`` holds (every head on one device, a
    rank's local heads on a mesh; B and C are shared by every head): the
    step form for a single token with a ``state``, else the chunked scan.
    Returns (y (B, S, H, P) fp32 with the skip, state)."""
    s = xh.shape[1]
    dtv = ssm.softplus(dtv + dt_bias.to(F32))
    a_neg = -torch.exp(a_log.to(F32))
    if s == 1 and state is not None:
        y, state = ssm.ssd_step(xh[:, 0], dtv[:, 0], a_neg, b_mat[:, 0],
                                c_mat[:, 0], state)
        y = y[:, None]
    else:
        y, state = ssm.ssd_chunked(xh, dtv, a_neg, b_mat, c_mat,
                                   chunk=min(cfg.chunk_size, s), state0=state)
    return y + d_skip.to(F32)[:, None] * xh, state


def mamba_block(cfg, p, x, *, state=None, conv_cache=None,
                rules: MeshRules = SINGLE):
    """Mamba2 block (SSD mixer).  A single token with a ``state`` takes the
    step form; otherwise the chunked scan over chunks of ``min(chunk_size,
    S)``.  With ``conv_cache`` the convolution streams from it.  Returns
    (x, state, conv_cache).

    On a real mesh (``rules``) the conv runs on each rank's "d_ff"
    channels (the reference's point on xi, ``model.py:98``) and SSD on its
    local heads, each in one ``local_map``; where "heads" does not divide
    the model axis, xi is gathered whole over it and SSD runs on every
    head.  The gated norm over the split d_inner is one RMS over the whole
    row (``layers.rms_norm``), and the output is constrained at
    ``model.py:126``."""
    b, s, _ = x.shape
    dt = x.dtype
    di = cfg.d_inner
    nh, hp = di // cfg.ssm_head_dim, cfg.ssm_head_dim

    xn = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    xi = rules.shard(xn @ p["wx"].to(dt), "batch", "seq", "d_ff")
    res = _local(rules, _conv_core, xi, (xi, p["conv"].to(dt), conv_cache),
                 (xi, xi) if conv_cache is not None else (xi,))
    xi, conv_cache = res if conv_cache is not None else (res, None)

    b_mat = rules.shard((xn @ p["wB"].to(dt)).to(F32), "batch", "seq", None)
    c_mat = rules.shard((xn @ p["wC"].to(dt)).to(F32), "batch", "seq", None)
    dtv = rules.shard((xn @ p["wdt"].to(dt)).to(F32), "batch", "seq",
                      "heads")
    xh = layers._split_heads(rules, xi, nh, hp, "heads").to(F32)
    xh = rules.shard(xh, "batch", "seq", "heads", None)
    st_pl = (state if state is not None else _carry_placements(
        rules, (b, nh, cfg.ssm_state, hp), ("batch", "heads", None, None)))
    y, state = _local(rules, functools.partial(_ssd_core, cfg), xh,
                      (xh, dtv, p["dt_bias"], p["a_log"], p["d_skip"], b_mat,
                       c_mat, state), (xh, st_pl))
    y = rules.shard(y.reshape(b, s, di).to(dt), "batch", "seq", "d_ff")
    gate = layers.silu(rules.shard(xn @ p["wz"].to(dt), "batch", "seq",
                                   "d_ff"))
    y = layers.rms_norm(y * gate, p["gnorm"], cfg.norm_eps)
    out = rules.shard(y @ p["wo"].to(dt), "batch", "seq", "d_model")
    return x + out, state, conv_cache


def _mlstm_core(q_in, wq, wk, wv, gi, gf, c, n, m, *, chunk: int):
    """The mLSTM's per-head q/k/v maps (fp32) and cell on the heads
    ``q_in`` (B, S, H, dk) holds; the step form for a single token with a
    carry.  Returns (h, C, n, m)."""
    q, k, v = (torch.einsum("bshk,hkl->bshl", q_in, w.to(F32))
               for w in (wq, wk, wv))
    if q.shape[1] == 1 and c is not None:
        h, carry = ssm.mlstm_step(q[:, 0], k[:, 0], v[:, 0], gi[:, 0],
                                  gf[:, 0], (c, n, m))
        h = h[:, None]
    else:
        h, carry = ssm.mlstm_chunked(q, k, v, gi, gf, chunk=chunk,
                                     carry0=None if c is None else (c, n, m))
    return (h,) + tuple(carry)


def _halves(rules: MeshRules, up):
    """The mLSTM's up-projection (B, S, 2 di) as (xm, zg): on a real mesh
    gathered whole over "model" first, so each half pairs the whole rows
    (a split "d_ff" puts all of xm on one rank and all of zg on the
    other)."""
    if rules.is_real:
        up = rules.shard(up, "batch", "seq", None)
    return torch.chunk(up, 2, dim=-1)


def mlstm_block(cfg, p, x, *, carry=None, rules: MeshRules = SINGLE):
    """xLSTM mLSTM block (factor-2 up-projection, per-head cell); the
    per-head q/k/v maps run in fp32.  Returns (x, (C, n, m)).

    On a real mesh (``rules``) the up-projection is constrained on "d_ff"
    (the reference's ``model.py:139``), its halves taken whole
    (``_halves``), xm split again on the heads, and the q/k/v maps and the
    cell run on each rank's local heads in one ``local_map`` (on every
    head where "heads" does not divide the model axis); ``onorm`` over the
    split d_inner is one RMS over the whole row."""
    b, s, d = x.shape
    dt = x.dtype
    di = 2 * d
    nh = cfg.n_heads
    dk = di // nh

    xn = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    up = rules.shard(xn @ p["w_up"].to(dt), "batch", "seq", "d_ff")
    xm, zg = _halves(rules, up)
    xh = rules.shard(xm.reshape(b, s, nh, dk).to(F32), "batch", "seq",
                     "heads", None)
    gates = (xm @ p["w_if"].to(dt)).to(F32)
    gi = rules.shard(gates[..., :nh], "batch", "seq", "heads")
    gf = rules.shard(gates[..., nh:], "batch", "seq", "heads")
    c, n, m = carry if carry is not None else (None, None, None)
    if c is not None:
        pls = (c, n, m)
    else:
        lay = [((b, nh, dk, dk), ("batch", "heads", None, None)),
               ((b, nh, dk), ("batch", "heads", None)),
               ((b, nh), ("batch", "heads"))]
        pls = tuple(_carry_placements(rules, *e) for e in lay)
    core = functools.partial(_mlstm_core, chunk=min(cfg.chunk_size, s))
    h, *carry = _local(rules, core, xh,
                       (xh, p["wq"], p["wk"], p["wv"], gi, gf, c, n, m),
                       (xh,) + pls)
    h = rules.shard(h.reshape(b, s, di).to(dt), "batch", "seq", "d_ff")
    h = layers.rms_norm(h, p["onorm"], cfg.norm_eps) * layers.silu(zg)
    out = rules.shard(h @ p["w_down"].to(dt), "batch", "seq", "d_model")
    return x + out, tuple(carry)


def _slstm_core(gx, r, c, n, hv, m):
    """The sLSTM over the heads ``gx`` (B, S, H, 4, hd) holds, R in fp32:
    the step form for a single token with a carry, else the scan, all of
    it inside one call (on a mesh one ``local_map``, not one DTensor
    dispatch per step).  Returns (h, c, n, h, m)."""
    carry = None if c is None else (c, n, hv, m)
    if gx.shape[1] == 1 and carry is not None:
        h, carry = ssm.slstm_step(gx[:, 0], r.to(F32), carry)
        h = h[:, None]
    else:
        h, carry = ssm.slstm_scan(gx, r.to(F32), n_heads=gx.shape[2],
                                  carry0=carry)
    return (h,) + tuple(carry)


def slstm_block(cfg, p, x, *, carry=None, rules: MeshRules = SINGLE):
    """xLSTM sLSTM block (a true time recurrence, R in fp32).  Returns (x,
    (c, n, h, m)).

    On a real mesh (``rules``) the gate pre-activations (B, S, 4d) split
    on "d_ff" line up with the heads, since they reshape heads first to
    (H, 4, hd); the recurrence runs on each rank's local heads (every head
    where "heads" does not divide the model axis), and ``onorm`` over d,
    which the heads split, is one RMS over the whole row.  The output is
    constrained at the reference's ``model.py:184``."""
    b, s, d = x.shape
    dt = x.dtype
    nh = cfg.n_heads

    xn = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    gx = rules.shard(xn @ p["w_in"].to(dt), "batch", "seq", "d_ff")
    gx = (gx + p["b"].to(dt)).to(F32)
    gx = layers._split_heads(rules, gx, nh, 4 * (d // nh), "heads")
    gx = rules.shard(gx.reshape(b, s, nh, 4, d // nh), "batch", "seq",
                     "heads", None, None)
    if carry is None:
        pls = (_carry_placements(rules, (b, nh, d // nh),
                                 ("batch", "heads", None)),) * 4
        carry = (None,) * 4
    else:
        pls = tuple(carry)
    # h (B, S, H, hd) is placed as gx (B, S, H, 4, hd)
    h, *carry = _local(rules, _slstm_core, gx, (gx, p["r"]) + tuple(carry),
                       (gx,) + pls)
    h = layers.rms_norm(h.reshape(b, s, d).to(dt), p["onorm"], cfg.norm_eps)
    out = rules.shard(h @ p["w_down"].to(dt), "batch", "seq", "d_model")
    return x + out, tuple(carry)


# ===========================================================================
# positions
# ===========================================================================
def _positions(cfg: ArchConfig, batch: dict, s: int, b: int, device,
               rules=SINGLE):
    """The prompt's positions: (S,), or M-RoPE's (3, B, S) streams, whose
    batch axis (dim 1) a real mesh splits as the activations'."""
    if cfg.mrope:
        if "patches" in batch:
            f = batch["patches"].shape[1]
            grid = max(1, int(round(f ** 0.5)))
            pos = layers.vlm_mrope_positions(b, f, s - f, grid, device)
        else:
            pos = layers.text_mrope_positions(
                torch.arange(s, device=device).expand(b, s))
        return rules.put(pos, None, "batch", None)
    return torch.arange(s, device=device)


def _decode_positions(cfg: ArchConfig, cur: int, b: int, offset: int, device,
                      rules=SINGLE):
    """Positions of the single new token at index ``cur``; ``offset`` is the
    frontend (patch) span recorded in the cache at prefill time, a Python
    int on every rank (the reference's replicated scalar)."""
    if cfg.mrope:
        t = max(cur - offset, 0) + 1
        return rules.put(torch.full((3, b, 1), t, dtype=torch.int32,
                                    device=device), None, "batch", None)
    return torch.full((1, 1), cur, dtype=torch.int32, device=device)


def _logits(cfg, params, x, rules=SINGLE):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(
        x, params["embed"] if cfg.tie_embeddings else params["lm_head"],
        tied=cfg.tie_embeddings)
    return rules.shard(logits, "batch", "seq", "vocab")


def _frames(cfg, batch, rules=SINGLE):
    """The audio family's stub frontend: precomputed frame embeddings,
    placed on ("batch", "seq", "d_model") on a real mesh (the reference's
    ``model.py:276``)."""
    if "frames" not in batch:
        raise KeyError(f"{cfg.name} (family audio) needs batch['frames'], "
                       f"the speech frontend's (B, enc_len, d_model) frame "
                       f"embeddings: the encoder runs on them")
    return rules.put(batch["frames"].to(_adt(cfg)), "batch", "seq", "d_model")


def _embed_inputs(cfg, params, batch, rules=SINGLE):
    """Token embeddings, with a vlm batch's patch embeddings prepended (on
    a real mesh both placed on ("batch", "seq", "d_model") before the
    ``cat``)."""
    dt = _adt(cfg)
    x = layers.embed(batch["tokens"], params["embed"], dt, rules=rules)
    if cfg.family == "vlm" and "patches" in batch:
        x = rules.shard(x, "batch", "seq", "d_model")
        patches = rules.put(batch["patches"].to(dt), "batch", "seq",
                            "d_model")
        x = torch.cat([patches, x], dim=1)
    return rules.shard(x, "batch", "seq", "d_model")


# ===========================================================================
# forward (training / no cache)
# ===========================================================================
def _unstack(stacked: dict) -> list:
    """The stacked ``(n_layers, ...)`` leaves as one dict per layer."""
    parts = {k: torch.unbind(x, 0) for k, x in stacked.items()}
    return [{k: xs[i] for k, xs in parts.items()}
            for i in range(len(next(iter(parts.values()))))]


#: ops whose outputs the ``"dots"`` policy keeps: products without a batch
#: dimension (``x @ W`` lowers to ``mm``); ``bmm`` is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _block_out(cfg, p, x, positions, memory, causal, rules=SINGLE):
    x, _, aux = transformer_block(cfg, p, x, positions=positions,
                                  causal=causal, memory=memory, rules=rules)
    return x, aux


def _mamba_out(cfg, p, x, rules=SINGLE):
    return mamba_block(cfg, p, x, rules=rules)[0]


def _mlstm_out(cfg, p, x, rules=SINGLE):
    return mlstm_block(cfg, p, x, rules=rules)[0]


def _slstm_out(cfg, p, x, rules=SINGLE):
    return slstm_block(cfg, p, x, rules=rules)[0]


def _maybe_remat(cfg: ArchConfig, fn, *args, train: bool):
    """``fn(*args)``, rematerialized as ``cfg.remat`` says when ``train``."""
    if not train or cfg.remat == "none":
        return fn(*args)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_blocks(cfg, stacked, x, positions, *, train, memory=None,
                causal=True, rules=SINGLE):
    """Every layer of ``stacked`` in turn; returns (x, the layers' aux
    summed from 0 in layer order, as the reference's scan carry)."""
    aux = _zero(x.device)
    for p in _unstack(stacked):
        x, a = _maybe_remat(cfg, _block_out, cfg, p, x, positions, memory,
                            causal, rules, train=train)
        aux = aux + a
    return x, aux


def _application(cfg, i):
    """zamba2's layout: the index of the shared block's application that
    follows Mamba2 layer ``i``, or None.  It follows every ``attn_every``-th
    layer; the layers past the last whole group (the tail) have none."""
    every = cfg.attn_every
    if i % every == every - 1 and i < cfg.n_layers // every * every:
        return i // every
    return None


def _xlstm_groups(cfg):
    """xLSTM's layout: (groups, mLSTM blocks per group)."""
    k = cfg.slstm_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not whole "
                         f"groups of slstm_every {k}")
    return cfg.n_layers // k, k - 1


def _hybrid_forward(cfg, params, x, positions, train, rules=SINGLE):
    """Groups of ``attn_every`` Mamba2 layers, each followed by the ONE
    shared attention + FFN block, then the tail's Mamba2 layers."""
    for i, p in enumerate(_unstack(params["blocks"])):
        x = _maybe_remat(cfg, _mamba_out, cfg, p, x, rules, train=train)
        if _application(cfg, i) is not None:
            x, _ = _maybe_remat(cfg, _block_out, cfg, params["shared_attn"], x,
                                positions, None, True, rules, train=train)
    return x


def _xlstm_forward(cfg, params, x, train, rules=SINGLE):
    """Groups of (slstm_every - 1) mLSTM blocks and one sLSTM block."""
    n_g, m_per = _xlstm_groups(cfg)
    mlstm, slstm = _unstack(params["blocks"]), _unstack(params["slstm_blocks"])
    for gi in range(n_g):
        for p in mlstm[gi * m_per:(gi + 1) * m_per]:
            x = _maybe_remat(cfg, _mlstm_out, cfg, p, x, rules, train=train)
        x = _maybe_remat(cfg, _slstm_out, cfg, slstm[gi], x, rules,
                         train=train)
    return x


def _audio_encoder(cfg, params, batch, train, rules=SINGLE):
    x = _frames(cfg, batch, rules)
    pos = torch.arange(x.shape[1], device=x.device)
    return _run_blocks(cfg, params["enc_blocks"], x, pos, train=train,
                       causal=False, rules=rules)[0]


def forward(cfg: ArchConfig, params: dict, batch: dict, *, train: bool = False,
            rules: MeshRules = SINGLE):
    """Returns (logits (B, S_text, padded_vocab), aux_loss).  ``batch``
    carries ``tokens`` and a stub frontend's ``patches`` (vlm) or
    ``frames`` (audio).  aux sums the MoE layers' load-balancing losses (0
    without a router).  ``train=True`` rematerializes each block as
    ``cfg.remat`` says (the values are the same)."""
    check_ported(cfg)
    x = _embed_inputs(cfg, params, batch, rules)
    b, s = x.shape[:2]
    positions = _positions(cfg, batch, s, b, x.device, rules)
    if cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, positions, train, rules)
        return _logits(cfg, params, x, rules), _zero(x.device)
    if cfg.family == "ssm":
        x = _xlstm_forward(cfg, params, x, train, rules)
        return _logits(cfg, params, x, rules), _zero(x.device)
    aux = _zero(x.device)
    memory = None
    if cfg.family == "audio":
        memory = _audio_encoder(cfg, params, batch, train, rules)
        key = "dec_blocks"
    else:
        key = "blocks"
    if cfg.family == "moe" and cfg.first_k_dense:
        x, a = _run_blocks(cfg, params["dense_blocks"], x, positions,
                           train=train, rules=rules)
        aux = aux + a
    x, a = _run_blocks(cfg, params[key], x, positions, train=train,
                       memory=memory, rules=rules)
    aux = aux + a
    if cfg.family == "vlm" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]       # logits over text only
    return _logits(cfg, params, x, rules), aux


# ===========================================================================
# loss
# ===========================================================================
def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            z_coef: float = 1e-4, rules: MeshRules = SINGLE):
    """Masked CE (fp32) + router aux + z-loss.  labels < 0 are masked out.
    Returns (loss, {"ce", "aux", "z", "tokens"}).

    On a real mesh the fp32 logits are gathered whole over the vocab
    before the log-sum-exp and the label gather (``rules.shard`` to
    ("batch", "seq", None)), and the loss and its terms come out
    replicated on every rank."""
    logits, aux = forward(cfg, params, batch, train=True, rules=rules)
    labels = batch["labels"].long()
    lg = rules.shard(logits.to(torch.float32), "batch", "seq", None)
    if rules.is_real and not isinstance(labels, DTensor):
        labels = rules.put(labels, "batch", "seq")
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    zl = z_coef * ((lse * mask) ** 2).sum() / denom
    loss, terms = ce + zl + aux, {"ce": ce, "aux": aux, "z": zl,
                                  "tokens": mask.sum()}
    if rules.is_real:
        loss = rules.shard(loss)
        terms = {k: rules.shard(t) if isinstance(t, DTensor) else t
                 for k, t in terms.items()}
    return loss, terms


# ===========================================================================
# caches
# ===========================================================================
def _kv_entry(cfg, b, max_len, n):
    dt = _adt(cfg)
    seq = (None, "cache_batch", "cache_seq")
    if cfg.uses_mla:
        return {"c_kv": ((n, b, max_len, cfg.kv_lora_rank), dt, seq + (None,)),
                "k_rope": ((n, b, max_len, cfg.rope_head_dim), dt,
                           seq + (None,))}
    shape = (n, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    logical = seq + ("kv_heads", None)
    return {"k": (shape, dt, logical), "v": (shape, dt, logical)}


def cache_layout(cfg: ArchConfig, b: int, max_len: int, enc_len: int = 0):
    """(shape, dtype, logical axes) of each cache leaf, stacked over the
    layers; ``len`` and ``offset`` are ints.  The logical axes are the
    reference's, for ``cache_spec``."""
    check_ported(cfg)
    if cfg.family == "hybrid":
        di, nh = cfg.d_inner, cfg.d_inner // cfg.ssm_head_dim
        lay = {"ssm": ((cfg.n_layers, b, nh, cfg.ssm_state, cfg.ssm_head_dim),
                       F32, (None, "cache_batch", "heads", None, None)),
               "conv": ((cfg.n_layers, b, cfg.conv_width - 1, di), _adt(cfg),
                        (None, "cache_batch", None, "d_ff")),
               "attn": _kv_entry(cfg, b, max_len,
                                 cfg.n_layers // cfg.attn_every)}
    elif cfg.family == "ssm":
        n_g, m_per = _xlstm_groups(cfg)
        h = cfg.n_heads
        dk, hd = 2 * cfg.d_model // h, cfg.d_model // h
        lay = {"mlstm_C": ((n_g, m_per, b, h, dk, dk), F32,
                           (None, None, "cache_batch", "heads", None, None)),
               "mlstm_n": ((n_g, m_per, b, h, dk), F32,
                           (None, None, "cache_batch", "heads", None)),
               "mlstm_m": ((n_g, m_per, b, h), F32,
                           (None, None, "cache_batch", "heads")),
               "slstm": ((n_g, 4, b, h, hd), F32,
                         (None, None, "cache_batch", "heads", None))}
    else:
        n_layers = cfg.n_layers
        if cfg.family == "moe":
            n_layers -= cfg.first_k_dense
        lay = {"layers": _kv_entry(cfg, b, max_len, n_layers)}
    if cfg.family == "moe" and cfg.first_k_dense:
        lay["dense_layers"] = _kv_entry(cfg, b, max_len, cfg.first_k_dense)
    if cfg.family == "audio":
        lay["memory"] = ((b, enc_len or max_len, cfg.d_model), _adt(cfg),
                         ("cache_batch", "cache_seq", "d_model"))
    lay["len"] = ((), int, ())
    lay["offset"] = ((), int, ())          # frontend (patch) span
    return lay


def _make_cache(lay, leaf):
    return {k: _make_cache(e, leaf) if isinstance(e, dict) else leaf(*e)
            for k, e in lay.items()}


def init_cache(cfg: ArchConfig, b: int, max_len: int, device="cuda",
               enc_len: int = 0, rules: MeshRules = SINGLE):
    """A zero cache on ``device`` (default ``cuda``; raises without a
    card); on a real mesh each leaf a DTensor placed by its logical axes
    (``cache_batch``, ``kv_heads``), each rank allocating its block."""
    dev = resolve_device(device)

    def leaf(shape, dt, logical):
        if dt is int:
            return 0
        if rules.is_real:
            return rules.sharding(shape, logical).zeros(shape, dt, dev)
        return torch.zeros(shape, dtype=dt, device=dev)

    return _make_cache(cache_layout(cfg, b, max_len, enc_len), leaf)


def cache_spec(cfg: ArchConfig, b: int, max_len: int, rules=None,
               enc_len: int = 0):
    """The cache as ``meta`` tensors for the dry-run, ``len`` and
    ``offset`` int32 scalars as in the reference; with ``rules`` (a
    ``MeshRules``) each leaf holds one device's local shape."""

    def leaf(shape, dt, logical):
        if rules is not None:
            shape = rules.local_shape(shape, logical)
        return torch.empty(shape, dtype=torch.int32 if dt is int else dt,
                           device="meta")

    return _make_cache(cache_layout(cfg, b, max_len, enc_len), leaf)


# ===========================================================================
# prefill / decode
# ===========================================================================
def _store(stacked, i, t):
    """``stacked[i] = t`` (``i`` an int, or a tuple of leading indices).
    On a mesh the stacked cache leaf is placed as ``t`` is, as many
    dimensions to the right as ``i`` indexes, so each rank writes its own
    block."""
    if not isinstance(stacked, DTensor):
        stacked[i] = t
        return
    lead = len(i) if isinstance(i, tuple) else 1
    shifted = tuple(Shard(p.dim + lead) if isinstance(p, Shard) else p
                    for p in t.placements)
    if shifted != stacked.placements:
        raise ValueError(f"cache placed {stacked.placements}, its entry "
                         f"{t.placements}")
    stacked.to_local()[i] = t.to_local()


def _fill(cfg, stacked, kvs, x, positions, memory, max_len, rules=SINGLE):
    for i in range(next(iter(stacked.values())).shape[0]):
        x, kv, _ = transformer_block(cfg, _layer(stacked, i), x,
                                     positions=positions, memory=memory,
                                     prefill_len=max_len, rules=rules)
        for name, t in kv.items():
            _store(kvs[name], i, t)
    return x


def _hybrid_fill(cfg, params, cache, x, positions, max_len, rules=SINGLE):
    """The hybrid prefill: each Mamba2 layer from a zero state through the
    chunked scan and from a zero conv cache (the reference's prefill,
    ``model.py:513-543``), filling its state and conv cache; the shared
    block's k/v of each application."""
    b = x.shape[0]
    shape, logical = ((b, cfg.conv_width - 1, cfg.d_inner),
                      ("cache_batch", None, "d_ff"))
    conv0 = (rules.sharding(shape, logical).zeros(shape, x.dtype, x.device)
             if rules.is_real else torch.zeros(shape, dtype=x.dtype,
                                               device=x.device))
    for i in range(cfg.n_layers):
        x, st, cc = mamba_block(cfg, _layer(params["blocks"], i), x,
                                conv_cache=conv0, rules=rules)
        _store(cache["ssm"], i, st)
        _store(cache["conv"], i, cc)
        app = _application(cfg, i)
        if app is not None:
            x, kv, _ = transformer_block(cfg, params["shared_attn"], x,
                                         positions=positions,
                                         prefill_len=max_len, rules=rules)
            for name, t in kv.items():
                _store(cache["attn"][name], app, t)
    return x


def _xlstm_fill(cfg, params, cache, x, rules=SINGLE):
    """The xLSTM prefill: every block through its parallel form from a zero
    carry, filling its final carry."""
    n_g, m_per = _xlstm_groups(cfg)
    for gi in range(n_g):
        for j in range(m_per):
            x, carry = mlstm_block(cfg, _layer(params["blocks"],
                                                gi * m_per + j), x,
                                   rules=rules)
            for name, t in zip(("mlstm_C", "mlstm_n", "mlstm_m"), carry):
                _store(cache[name], (gi, j), t)
        x, carry = slstm_block(cfg, _layer(params["slstm_blocks"], gi), x,
                               rules=rules)
        for i, t in enumerate(carry):
            _store(cache["slstm"], (gi, i), t)
    return x


def prefill(cfg: ArchConfig, params: dict, batch: dict, *,
            max_len: Optional[int] = None, rules: MeshRules = SINGLE):
    """Run the full prompt; returns (last-token logits (B, padded_vocab),
    filled cache).  Attention runs through ``_attn_dispatch``, so with
    ``attn_impl="flash"`` each self-attention layer launches the flash
    kernel once, and an audio prefill launches it once more per encoder
    layer and per cross-attention.  On a real mesh each rank launches it
    on its local heads, and the logits come out split over the vocab."""
    check_ported(cfg)
    x = _embed_inputs(cfg, params, batch, rules)
    b, s = x.shape[:2]
    s_tok = batch["tokens"].shape[1]
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt length {s} > max_len {max_len}")
    positions = _positions(cfg, batch, s, b, x.device, rules)
    memory = None
    enc_len = 0
    if cfg.family == "audio":
        memory = _audio_encoder(cfg, params, batch, False, rules)
        enc_len = memory.shape[1]
    cache = init_cache(cfg, b, max_len, x.device, enc_len, rules)
    if memory is not None:
        cache["memory"] = rules.shard(memory, "cache_batch", "cache_seq",
                                      "d_model")
    if cfg.family == "hybrid":
        x = _hybrid_fill(cfg, params, cache, x, positions, max_len, rules)
    elif cfg.family == "ssm":
        x = _xlstm_fill(cfg, params, cache, x, rules)
    else:
        if cfg.family == "moe" and cfg.first_k_dense:
            x = _fill(cfg, params["dense_blocks"], cache["dense_layers"], x,
                      positions, None, max_len, rules)
        key = "dec_blocks" if cfg.family == "audio" else "blocks"
        x = _fill(cfg, params[key], cache["layers"], x, positions, memory,
                  max_len, rules)
    logits = _logits(cfg, params, x[:, -1:], rules)
    cache["len"] = s
    cache["offset"] = s - s_tok
    return logits[:, 0], cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens, *,
                rules: MeshRules = SINGLE):
    """One new token per sequence.  tokens: (B, 1) integers.

    Returns (logits (B, padded_vocab), cache), the cache updated in place
    and its ``len`` advanced by one."""
    check_ported(cfg)
    cur = cache["len"]
    x = layers.embed(tokens, params["embed"], _adt(cfg), rules=rules)
    x = rules.shard(x, "batch", None, "d_model")
    positions = _decode_positions(cfg, cur, x.shape[0], cache["offset"],
                                  x.device, rules)
    memory = cache.get("memory")
    if memory is not None:
        memory = memory.to(_adt(cfg))

    def run(stacked, kvs, x):
        for i in range(next(iter(stacked.values())).shape[0]):
            x, _, _ = transformer_block(cfg, _layer(stacked, i), x,
                                        positions=positions, memory=memory,
                                        cache=dict(_layer(kvs, i), len=cur),
                                        rules=rules)
        return x

    if cfg.family == "hybrid":
        x = _hybrid_step(cfg, params, cache, x, positions, cur, rules)
    elif cfg.family == "ssm":
        x = _xlstm_step(cfg, params, cache, x, rules)
    else:
        if cfg.family == "moe" and cfg.first_k_dense:
            x = run(params["dense_blocks"], cache["dense_layers"], x)
        key = "dec_blocks" if cfg.family == "audio" else "blocks"
        x = run(params[key], cache["layers"], x)
    logits = _logits(cfg, params, x, rules)
    cache["len"] = cur + 1
    return logits[:, 0], cache


def _hybrid_step(cfg, params, cache, x, positions, cur, rules=SINGLE):
    """One token through the hybrid stack: each Mamba2 layer's step form
    from its state and conv cache (stored in the activation dtype, cast at
    use), the shared block against its application's KV cache."""
    for i in range(cfg.n_layers):
        x, st, cc = mamba_block(cfg, _layer(params["blocks"], i), x,
                                state=cache["ssm"][i],
                                conv_cache=cache["conv"][i].to(x.dtype),
                                rules=rules)
        _store(cache["ssm"], i, st)
        _store(cache["conv"], i, cc)
        app = _application(cfg, i)
        if app is not None:
            kv = {name: t[app] for name, t in cache["attn"].items()}
            x, _, _ = transformer_block(cfg, params["shared_attn"], x,
                                        positions=positions,
                                        cache=dict(kv, len=cur), rules=rules)
    return x


def _xlstm_step(cfg, params, cache, x, rules=SINGLE):
    """One token through the xLSTM stack, each block's step form from its
    carry."""
    n_g, m_per = _xlstm_groups(cfg)
    names = ("mlstm_C", "mlstm_n", "mlstm_m")
    for gi in range(n_g):
        for j in range(m_per):
            x, carry = mlstm_block(cfg, _layer(params["blocks"],
                                                gi * m_per + j), x,
                                   carry=tuple(cache[n][gi, j] for n in names),
                                   rules=rules)
            for name, t in zip(names, carry):
                _store(cache[name], (gi, j), t)
        x, carry = slstm_block(cfg, _layer(params["slstm_blocks"], gi), x,
                               carry=tuple(cache["slstm"][gi].unbind(0)),
                               rules=rules)
        for i, t in enumerate(carry):
            _store(cache["slstm"], (gi, i), t)
    return x
