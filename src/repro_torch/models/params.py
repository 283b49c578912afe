"""Parameter definitions and initialisation of the LM stack: the dense,
moe, vlm and audio families.

Port of ``repro/models/params.py``.  Every parameter is declared once as a
``ParamDef`` (shape and initialiser); per-layer blocks are stacked along
a leading ``n_layers`` axis, as in the reference, and the tree is a plain
dict of tensors with the reference's keys, e.g. for the dense family:

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (d, V),]
     "blocks": {"ln1", "q", "k", "v", "o", ["qn", "kn",] "ln2",
                "wg", "wu", "wd"}: each (n_layers, ...)}

The moe family's blocks hold the router and the stacked experts
(``we_*``, plus ``ws_*`` for shared experts), ``dense_blocks`` its
leading dense layers; MLA replaces q/k/v/o by the latent projections;
the audio family has ``enc_blocks`` and ``dec_blocks``, the latter with
the cross-attention's ``x``-prefixed leaves.  The reference's logical
sharding axes and its SSM initialisers are left out; they come back with
the mesh and with the ssm and hybrid families, which raise
``NotImplementedError`` here (ROADMAP.md queue 1 item 11c).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.nbody import resolve_device
from repro_torch.models.config import ArchConfig

#: the families the port runs
PORTED_FAMILIES = ("dense", "moe", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | ones
    scale: float = 0.02

    def stacked(self, n: int) -> "ParamDef":
        return dataclasses.replace(self, shape=(n,) + self.shape)


def check_ported(cfg: ArchConfig):
    """Raise ``NotImplementedError`` for a family the port does not run."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family}): not yet ported to "
            f"repro_torch: the port runs the {', '.join(PORTED_FAMILIES)} "
            f"families; see ROADMAP.md queue 1 item 11c")


def _attn_defs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    pre = "x" if cross else ""
    out = {
        f"{pre}q": ParamDef((d, h * hd)),
        f"{pre}k": ParamDef((d, kv * hd)),
        f"{pre}v": ParamDef((d, kv * hd)),
        f"{pre}o": ParamDef((h * hd, d)),
    }
    if cfg.qk_norm and not cross:
        out["qn"] = ParamDef((hd,), "ones")
        out["kn"] = ParamDef((hd,), "ones")
    return out


def _mla_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h, hd, vhd, rhd = cfg.n_heads, cfg.head_dim, cfg.v_head_dim, cfg.rope_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "q_a": ParamDef((d, qlr)),
        "q_norm": ParamDef((qlr,), "ones"),
        "q_b": ParamDef((qlr, h * (hd + rhd))),
        "kv_a": ParamDef((d, kvlr + rhd)),
        "kv_norm": ParamDef((kvlr,), "ones"),
        "kv_b": ParamDef((kvlr, h * (hd + vhd))),
        "o": ParamDef((h * vhd, d)),
    }


def _ffn_defs(d: int, f: int) -> dict:
    return {
        "wg": ParamDef((d, f)),
        "wu": ParamDef((d, f)),
        "wd": ParamDef((f, d)),
    }


def _moe_defs(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    out = {
        "router": ParamDef((d, e)),
        "we_g": ParamDef((e, d, f)),
        "we_u": ParamDef((e, d, f)),
        "we_d": ParamDef((e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        out.update({f"ws_{k[-1]}": v for k, v in _ffn_defs(d, fs).items()})
    return out


def _block_defs(cfg: ArchConfig, kind: str) -> dict:
    """One pre-norm block of kind "attn" (attention + FFN), "moe"
    (attention + MoE FFN) or "cross_attn" (self-, then cross-attention +
    FFN); attention is MLA where the config says so."""
    d = cfg.d_model
    out = {"ln1": ParamDef((d,), "ones")}
    out.update(_mla_defs(cfg) if cfg.uses_mla else _attn_defs(cfg))
    out["ln2"] = ParamDef((d,), "ones")
    if kind == "moe":
        out.update(_moe_defs(cfg))
    elif kind == "cross_attn":
        out.update(_attn_defs(cfg, cross=True))
        out["lnx"] = ParamDef((d,), "ones")
        out.update(_ffn_defs(d, cfg.d_ff))
    else:
        out.update(_ffn_defs(d, cfg.d_ff))
    return out


def _stack(defs: dict, n: int) -> dict:
    return {k: p.stacked(n) for k, p in defs.items()}


def param_defs(cfg: ArchConfig) -> dict:
    check_ported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    tree: dict = {
        "embed": ParamDef((v, d)),
        "final_norm": ParamDef((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((d, v))
    if cfg.family in ("dense", "vlm"):
        tree["blocks"] = _stack(_block_defs(cfg, "attn"), cfg.n_layers)
    elif cfg.family == "moe":
        tree["blocks"] = _stack(_block_defs(cfg, "moe"),
                                cfg.n_layers - cfg.first_k_dense)
        if cfg.first_k_dense:
            tree["dense_blocks"] = _stack(_block_defs(cfg, "attn"),
                                          cfg.first_k_dense)
    else:  # audio
        tree["enc_blocks"] = _stack(_block_defs(cfg, "attn"),
                                    cfg.encoder_layers)
        tree["dec_blocks"] = _stack(_block_defs(cfg, "cross_attn"),
                                    cfg.n_layers)
    return tree


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(p.shape) for p in tree_util.leaves(param_defs(cfg)))


def count_active(cfg: ArchConfig) -> int:
    """Active (per-token) parameters: a routed expert leaf counts top_k of
    its n_experts, embeddings and lm_head are left out (the 6ND
    convention)."""
    total = 0
    for key, sub in param_defs(cfg).items():
        if key in ("embed", "lm_head"):
            continue
        leaves = sub.items() if isinstance(sub, dict) else ((key, sub),)
        for name, p in leaves:
            n = math.prod(p.shape)
            if name.startswith("we_"):  # routed experts: top_k of E active
                n = n * cfg.top_k // cfg.n_experts
            total += n
    return total


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``.

    The reference's law (``params.py:223-241``): norms are ones, every other
    leaf is normal with ``std = min(scale, fan_in ** -0.5)``, ``fan_in =
    shape[-2]``.  The draws come from ``generator`` on its own device, so
    they have the reference's distribution but not its bits; to compute
    what the reference computes, carry its parameters over with
    ``params_from_jax``.  Each leaf is drawn in fp32 and cast on its own,
    so no fp32 copy of the whole tree exists.  ``device`` defaults to
    ``cuda`` and raises without a card.
    """
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def one(p: ParamDef):
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = min(p.scale, fan_in ** -0.5)
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(std).to(device=dev, dtype=dtype)

    return tree_util.map(one, param_defs(cfg))


def params_from_jax(tree: Mapping, device="cuda") -> dict:
    """The reference's ``init_params`` tree, leaves as numpy arrays, as the
    port's parameters on ``device``: the same keys, the same stacked
    ``(n_layers, ...)`` leaves, the same values bit for bit."""
    dev = resolve_device(device)
    return tree_util.map(lambda x: torch.from_numpy(np.array(x)).to(dev), tree)


def cast_params(params: Mapping, dtype: str) -> dict:
    """Every leaf cast to ``dtype`` once, as a serving checkpoint is cast.

    The reference casts each weight to the activation dtype at every use
    (``p["q"].astype(dt)``); casting once at load gives the same bits, since
    every use in the ported families casts to that one dtype."""
    dt = getattr(torch, dtype)
    return tree_util.map(lambda x: x.to(dt), params)
