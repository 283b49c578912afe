"""Model assembly of the dense, moe, vlm and audio families: the training
forward and its loss, prefill and single-token decode.

Port of ``repro/models/model.py`` (``model.py:41-86, 190-280, 351-456,
475-581, 584-714``) for those families; the ssm and hybrid families raise
``NotImplementedError`` (ROADMAP.md queue 1 item 11c).  The reference's
``MeshRules`` argument is dropped: on one card ``rules.shard`` is the
identity.  ``lax.scan`` over the stacked layers becomes a Python loop over
the leading ``n_layers`` axis; ``forward`` splits each stacked leaf once
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
               decoder layer cross-attends.

Training rematerializes each block as ``cfg.remat`` says, the reference's
``jax.checkpoint`` of the scan body: ``"full"`` keeps only the block's
input (``torch.utils.checkpoint``), ``"dots"`` also keeps the outputs of
the unbatched matmuls (the projections; the attention's and the experts'
batched products are recomputed, as ``checkpoint_dots_with_no_batch_dims``),
``"none"`` keeps everything.  None of them changes a value.

The decode cache is a dict as in the reference: {"layers": {"k", "v": (L,
B, max_len, KV, hd)} (MLA: {"c_kv": (L, B, max_len, kv_lora_rank),
"k_rope": (L, B, max_len, rope_head_dim)}), ["dense_layers": the same for
the leading dense layers,] ["memory": (B, enc_len, d),] "len": int,
"offset": int}, ``offset`` being the frontend (patch) span.
``decode_step`` updates it IN PLACE and returns it: the reference's engine
donates the cache to the decode step (``engine.py:47``), so it too keeps
one copy.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core.nbody import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import check_ported


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
                      cache=None, prefill_len=None):
    """Pre-norm attention (+ cross-attention) + FFN/MoE block.

    Returns (x, new_kv_cache_or_None, aux_loss)."""
    xa = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.uses_mla:
        out, kv = layers.mla_attention(cfg, p, xa, positions=positions,
                                       cache=cache, prefill_len=prefill_len)
    else:
        out, kv = layers.attention(cfg, p, xa, positions=positions,
                                   causal=causal, cache=cache,
                                   prefill_len=prefill_len)
    x = x + out

    if "xq" in p:  # encoder-decoder cross-attention
        xc = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        out, _ = layers.attention(cfg, p, xc, positions=positions,
                                  causal=False, memory=memory, prefix="x")
        x = x + out
        xf = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
    else:
        xf = layers.rms_norm(x, p["ln2"], cfg.norm_eps)

    if "router" in p:
        out, aux = layers.moe_ffn(cfg, p, xf)
        return x + out, kv, aux
    return x + layers.ffn(cfg, p, xf), kv, _zero(x.device)


# ===========================================================================
# positions
# ===========================================================================
def _positions(cfg: ArchConfig, batch: dict, s: int, b: int, device):
    if cfg.mrope:
        if "patches" in batch:
            f = batch["patches"].shape[1]
            grid = max(1, int(round(f ** 0.5)))
            return layers.vlm_mrope_positions(b, f, s - f, grid, device)
        return layers.text_mrope_positions(
            torch.arange(s, device=device).expand(b, s))
    return torch.arange(s, device=device)


def _decode_positions(cfg: ArchConfig, cur: int, b: int, offset: int, device):
    """Positions of the single new token at index ``cur``; ``offset`` is the
    frontend (patch) span recorded in the cache at prefill time."""
    if cfg.mrope:
        t = max(cur - offset, 0) + 1
        return torch.full((3, b, 1), t, dtype=torch.int32, device=device)
    return torch.full((1, 1), cur, dtype=torch.int32, device=device)


def _logits(cfg, params, x):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(
        x, params["embed"] if cfg.tie_embeddings else params["lm_head"],
        tied=cfg.tie_embeddings)


def _frames(cfg, batch):
    """The audio family's stub frontend: precomputed frame embeddings."""
    if "frames" not in batch:
        raise KeyError(f"{cfg.name} (family audio) needs batch['frames'], "
                       f"the speech frontend's (B, enc_len, d_model) frame "
                       f"embeddings: the encoder runs on them")
    return batch["frames"].to(_adt(cfg))


def _embed_inputs(cfg, params, batch):
    """Token embeddings, with a vlm batch's patch embeddings prepended."""
    dt = _adt(cfg)
    x = layers.embed(batch["tokens"], params["embed"], dt)
    if cfg.family == "vlm" and "patches" in batch:
        x = torch.cat([batch["patches"].to(dt), x], dim=1)
    return x


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


def _block_out(cfg, p, x, positions, memory, causal):
    x, _, aux = transformer_block(cfg, p, x, positions=positions,
                                  causal=causal, memory=memory)
    return x, aux


def _maybe_remat(cfg: ArchConfig, p, x, positions, memory, causal, *,
                 train: bool):
    if not train or cfg.remat == "none":
        return _block_out(cfg, p, x, positions, memory, causal)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch_checkpoint.checkpoint(_block_out, cfg, p, x, positions,
                                       memory, causal, use_reentrant=False,
                                       **kw)


def _run_blocks(cfg, stacked, x, positions, *, train, memory=None,
                causal=True):
    """Every layer of ``stacked`` in turn; returns (x, the layers' aux
    summed from 0 in layer order, as the reference's scan carry)."""
    aux = _zero(x.device)
    for p in _unstack(stacked):
        x, a = _maybe_remat(cfg, p, x, positions, memory, causal, train=train)
        aux = aux + a
    return x, aux


def _audio_encoder(cfg, params, batch, train):
    x = _frames(cfg, batch)
    pos = torch.arange(x.shape[1], device=x.device)
    return _run_blocks(cfg, params["enc_blocks"], x, pos, train=train,
                       causal=False)[0]


def forward(cfg: ArchConfig, params: dict, batch: dict, *, train: bool = False):
    """Returns (logits (B, S_text, padded_vocab), aux_loss).  ``batch``
    carries ``tokens`` and a stub frontend's ``patches`` (vlm) or
    ``frames`` (audio).  aux sums the MoE layers' load-balancing losses (0
    without a router).  ``train=True`` rematerializes each block as
    ``cfg.remat`` says (the values are the same)."""
    check_ported(cfg)
    x = _embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    positions = _positions(cfg, batch, s, b, x.device)
    aux = _zero(x.device)
    memory = None
    if cfg.family == "audio":
        memory = _audio_encoder(cfg, params, batch, train)
        key = "dec_blocks"
    else:
        key = "blocks"
    if cfg.family == "moe" and cfg.first_k_dense:
        x, a = _run_blocks(cfg, params["dense_blocks"], x, positions,
                           train=train)
        aux = aux + a
    x, a = _run_blocks(cfg, params[key], x, positions, train=train,
                       memory=memory)
    aux = aux + a
    if cfg.family == "vlm" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]       # logits over text only
    return _logits(cfg, params, x), aux


# ===========================================================================
# loss
# ===========================================================================
def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            z_coef: float = 1e-4):
    """Masked CE (fp32) + router aux + z-loss.  labels < 0 are masked out.
    Returns (loss, {"ce", "aux", "z", "tokens"})."""
    logits, aux = forward(cfg, params, batch, train=True)
    labels = batch["labels"].long()
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    zl = z_coef * ((lse * mask) ** 2).sum() / denom
    return ce + zl + aux, {"ce": ce, "aux": aux, "z": zl,
                           "tokens": mask.sum()}


# ===========================================================================
# caches
# ===========================================================================
def _kv_entry(cfg, b, max_len, n):
    dt = _adt(cfg)
    if cfg.uses_mla:
        return {"c_kv": ((n, b, max_len, cfg.kv_lora_rank), dt),
                "k_rope": ((n, b, max_len, cfg.rope_head_dim), dt)}
    shape = (n, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dt), "v": (shape, dt)}


def cache_layout(cfg: ArchConfig, b: int, max_len: int, enc_len: int = 0):
    """(shape, dtype) of each cache leaf, stacked over the layers;
    ``len`` and ``offset`` are ints.  The reference's logical sharding
    axes are dropped with the mesh."""
    check_ported(cfg)
    n_layers = cfg.n_layers
    if cfg.family == "moe":
        n_layers -= cfg.first_k_dense
    lay = {"layers": _kv_entry(cfg, b, max_len, n_layers)}
    if cfg.family == "moe" and cfg.first_k_dense:
        lay["dense_layers"] = _kv_entry(cfg, b, max_len, cfg.first_k_dense)
    if cfg.family == "audio":
        lay["memory"] = ((b, enc_len or max_len, cfg.d_model), _adt(cfg))
    lay["len"] = ((), int)
    lay["offset"] = ((), int)              # frontend (patch) span
    return lay


def init_cache(cfg: ArchConfig, b: int, max_len: int, device="cuda",
               enc_len: int = 0):
    """A zero cache on ``device`` (default ``cuda``; raises without a
    card)."""
    dev = resolve_device(device)

    def make(entry):
        if isinstance(entry, dict):
            return {k: make(e) for k, e in entry.items()}
        shape, dt = entry
        return 0 if dt is int else torch.zeros(shape, dtype=dt, device=dev)

    return make(cache_layout(cfg, b, max_len, enc_len))


# ===========================================================================
# prefill / decode
# ===========================================================================
def _fill(cfg, stacked, kvs, x, positions, memory, max_len):
    for i in range(next(iter(stacked.values())).shape[0]):
        x, kv, _ = transformer_block(cfg, _layer(stacked, i), x,
                                     positions=positions, memory=memory,
                                     prefill_len=max_len)
        for name, t in kv.items():
            kvs[name][i] = t
    return x


def prefill(cfg: ArchConfig, params: dict, batch: dict, *,
            max_len: Optional[int] = None):
    """Run the full prompt; returns (last-token logits (B, padded_vocab),
    filled cache).  Attention runs through ``_attn_dispatch``, so with
    ``attn_impl="flash"`` each self-attention layer launches the flash
    kernel once, and an audio prefill launches it once more per encoder
    layer and per cross-attention."""
    check_ported(cfg)
    x = _embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    s_tok = batch["tokens"].shape[1]
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt length {s} > max_len {max_len}")
    positions = _positions(cfg, batch, s, b, x.device)
    memory = None
    enc_len = 0
    if cfg.family == "audio":
        memory = _audio_encoder(cfg, params, batch, False)
        enc_len = memory.shape[1]
    cache = init_cache(cfg, b, max_len, x.device, enc_len)
    if memory is not None:
        cache["memory"].copy_(memory)
    if cfg.family == "moe" and cfg.first_k_dense:
        x = _fill(cfg, params["dense_blocks"], cache["dense_layers"], x,
                  positions, None, max_len)
    key = "dec_blocks" if cfg.family == "audio" else "blocks"
    x = _fill(cfg, params[key], cache["layers"], x, positions, memory, max_len)
    logits = _logits(cfg, params, x[:, -1:])
    cache["len"] = s
    cache["offset"] = s - s_tok
    return logits[:, 0], cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens):
    """One new token per sequence.  tokens: (B, 1) integers.

    Returns (logits (B, padded_vocab), cache), the cache updated in place
    and its ``len`` advanced by one."""
    check_ported(cfg)
    cur = cache["len"]
    x = layers.embed(tokens, params["embed"], _adt(cfg))
    positions = _decode_positions(cfg, cur, x.shape[0], cache["offset"],
                                  x.device)
    memory = cache.get("memory")
    if memory is not None:
        memory = memory.to(_adt(cfg))

    def run(stacked, kvs, x):
        for i in range(next(iter(stacked.values())).shape[0]):
            x, _, _ = transformer_block(cfg, _layer(stacked, i), x,
                                        positions=positions, memory=memory,
                                        cache=dict(_layer(kvs, i), len=cur))
        return x

    if cfg.family == "moe" and cfg.first_k_dense:
        x = run(params["dense_blocks"], cache["dense_layers"], x)
    key = "dec_blocks" if cfg.family == "audio" else "blocks"
    x = run(params[key], cache["layers"], x)
    logits = _logits(cfg, params, x)
    cache["len"] = cur + 1
    return logits[:, 0], cache
