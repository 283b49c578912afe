"""Model assembly of the dense family: the training forward and its loss,
prefill and single-token decode.

Port of ``repro/models/model.py`` (``model.py:41-86, 190-258, 351-455,
475-578, 584-714``) for the dense family; every other family raises
``NotImplementedError`` (ROADMAP.md queue 1 item 11).  The reference's
``MeshRules`` argument is dropped: on one card ``rules.shard`` is the
identity.  ``lax.scan`` over the stacked layers becomes a Python loop over
the leading ``n_layers`` axis; ``forward`` splits each stacked leaf once
with ``torch.unbind``, so under autograd the per-layer gradients are
stacked once instead of each layer's ``select`` building a zero gradient
the size of the whole stack.

Training rematerializes each block as ``cfg.remat`` says, the reference's
``jax.checkpoint`` of the scan body: ``"full"`` keeps only the block's
input (``torch.utils.checkpoint``), ``"dots"`` also keeps the outputs of
the unbatched matmuls (the projections; the attention's batched products
are recomputed, as ``checkpoint_dots_with_no_batch_dims``), ``"none"``
keeps everything.  None of them changes a value.

The decode cache is a dict {"layers": {"k", "v": (n_layers, B, max_len,
KV, hd)}, "len": int, "offset": int}, as in the reference.  ``decode_step``
updates it IN PLACE and returns it: the reference's engine donates the
cache to the decode step (``engine.py:47``), so it too keeps one copy.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core.nbody import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import _check_dense


def _adt(cfg: ArchConfig):
    return getattr(torch, cfg.dtype)


def _layer(stacked: dict, i: int) -> dict:
    return {k: x[i] for k, x in stacked.items()}


# ===========================================================================
# block forward
# ===========================================================================
def transformer_block(cfg, p, x, *, positions, causal=True, cache=None,
                      prefill_len=None):
    """Pre-norm attention + FFN block.  Returns (x, new_kv_cache_or_None)."""
    xa = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    out, kv = layers.attention(cfg, p, xa, positions=positions, causal=causal,
                               cache=cache, prefill_len=prefill_len)
    x = x + out
    xf = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.ffn(cfg, p, xf), kv


# ===========================================================================
# positions
# ===========================================================================
def _positions(cfg: ArchConfig, s: int, device):
    _check_dense(cfg)
    return torch.arange(s, device=device)


def _decode_positions(cfg: ArchConfig, cur: int, device):
    """Position of the single new token at index ``cur`` (no M-RoPE)."""
    _check_dense(cfg)
    return torch.full((1, 1), cur, dtype=torch.int32, device=device)


def _logits(cfg, params, x):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(
        x, params["embed"] if cfg.tie_embeddings else params["lm_head"],
        tied=cfg.tie_embeddings)


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


def _block_out(cfg, p, x, positions):
    return transformer_block(cfg, p, x, positions=positions)[0]


def _maybe_remat(cfg: ArchConfig, p, x, positions, *, train: bool):
    if not train or cfg.remat == "none":
        return _block_out(cfg, p, x, positions)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch_checkpoint.checkpoint(_block_out, cfg, p, x, positions,
                                       use_reentrant=False, **kw)


def forward(cfg: ArchConfig, params: dict, batch: dict, *, train: bool = False):
    """Returns (logits (B, S, padded_vocab), aux_loss).  The dense family
    has no router, so aux is 0.  ``train=True`` rematerializes each block
    as ``cfg.remat`` says (the values are the same)."""
    tokens = batch["tokens"]
    x = layers.embed(tokens, params["embed"], _adt(cfg))
    positions = _positions(cfg, x.shape[1], x.device)
    for p in _unstack(params["blocks"]):
        x = _maybe_remat(cfg, p, x, positions, train=train)
    return (_logits(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


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
def _kv_entry(cfg, b, max_len, dtype):
    shape = (b, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def cache_layout(cfg: ArchConfig, b: int, max_len: int):
    """(shape, dtype) of each cache leaf; ``len`` and ``offset`` are ints.
    The reference's logical sharding axes are dropped with the mesh."""
    _check_dense(cfg)
    entry = _kv_entry(cfg, b, max_len, _adt(cfg))
    return {"layers": {k: ((cfg.n_layers,) + shape, dt)
                       for k, (shape, dt) in entry.items()},
            "len": ((), int), "offset": ((), int)}


def init_cache(cfg: ArchConfig, b: int, max_len: int, device="cuda"):
    """A zero cache on ``device`` (default ``cuda``; raises without a
    card)."""
    dev = resolve_device(device)
    lay = cache_layout(cfg, b, max_len)
    return {"layers": {k: torch.zeros(shape, dtype=dt, device=dev)
                       for k, (shape, dt) in lay["layers"].items()},
            "len": 0, "offset": 0}


# ===========================================================================
# prefill / decode
# ===========================================================================
def prefill(cfg: ArchConfig, params: dict, batch: dict, *,
            max_len: Optional[int] = None):
    """Run the full prompt; returns (last-token logits (B, padded_vocab),
    filled cache).  Attention runs through ``_attn_dispatch``, so with
    ``attn_impl="flash"`` each layer launches the flash kernel once."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = layers.embed(tokens, params["embed"], _adt(cfg))
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt length {s} > max_len {max_len}")
    positions = _positions(cfg, s, x.device)
    cache = init_cache(cfg, b, max_len, x.device)
    stacked = params["blocks"]
    for i in range(cfg.n_layers):
        x, kv = transformer_block(cfg, _layer(stacked, i), x,
                                  positions=positions, prefill_len=max_len)
        for name, t in kv.items():
            cache["layers"][name][i] = t
    logits = _logits(cfg, params, x[:, -1:])
    cache["len"] = s
    cache["offset"] = 0  # no frontend span in the dense family
    return logits[:, 0], cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens):
    """One new token per sequence.  tokens: (B, 1) integers.

    Returns (logits (B, padded_vocab), cache), the cache updated in place
    and its ``len`` advanced by one."""
    cur = cache["len"]
    x = layers.embed(tokens, params["embed"], _adt(cfg))
    positions = _decode_positions(cfg, cur, x.device)
    stacked, kvs = params["blocks"], cache["layers"]
    for i in range(cfg.n_layers):
        x, _ = transformer_block(cfg, _layer(stacked, i), x,
                                 positions=positions,
                                 cache=dict(_layer(kvs, i), len=cur))
    logits = _logits(cfg, params, x)
    cache["len"] = cur + 1
    return logits[:, 0], cache
