"""Parameter definitions and initialisation of the LM stack, dense family.

Port of ``repro/models/params.py``.  Every parameter is declared once as a
``ParamDef`` (shape and initialiser); per-layer blocks are stacked along
a leading ``n_layers`` axis, as in the reference, and the tree is a plain
dict of tensors with the reference's keys:

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (d, V),]
     "blocks": {"ln1", "q", "k", "v", "o", ["qn", "kn",] "ln2",
                "wg", "wu", "wd"}: each (n_layers, ...)}

The reference's logical sharding axes and its "zeros" initialiser (used by
no dense leaf) are left out; they come back with the mesh and the families
that need them.  Only the dense family is ported: the other families' blocks
raise ``NotImplementedError`` (ROADMAP.md queue 1 item 11).
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

_NOT_PORTED = ("not yet ported to repro_torch: the port runs the dense "
               "family only; see ROADMAP.md queue 1 item 11")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | ones
    scale: float = 0.02

    def stacked(self, n: int) -> "ParamDef":
        return dataclasses.replace(self, shape=(n,) + self.shape)


def _check_dense(cfg: ArchConfig):
    if cfg.family != "dense" or cfg.uses_mla or cfg.mrope:
        raise NotImplementedError(f"{cfg.name} (family {cfg.family}): "
                                  f"{_NOT_PORTED}")


def _attn_defs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    out = {
        "q": ParamDef((d, h * hd)),
        "k": ParamDef((d, kv * hd)),
        "v": ParamDef((d, kv * hd)),
        "o": ParamDef((h * hd, d)),
    }
    if cfg.qk_norm:
        out["qn"] = ParamDef((hd,), "ones")
        out["kn"] = ParamDef((hd,), "ones")
    return out


def _ffn_defs(d: int, f: int) -> dict:
    return {
        "wg": ParamDef((d, f)),
        "wu": ParamDef((d, f)),
        "wd": ParamDef((f, d)),
    }


def _block_defs(cfg: ArchConfig) -> dict:
    """One pre-norm attention + FFN block (the reference's kind "attn")."""
    _check_dense(cfg)
    d = cfg.d_model
    out = {"ln1": ParamDef((d,), "ones")}
    out.update(_attn_defs(cfg))
    out["ln2"] = ParamDef((d,), "ones")
    out.update(_ffn_defs(d, cfg.d_ff))
    return out


def param_defs(cfg: ArchConfig) -> dict:
    _check_dense(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    tree: dict = {
        "embed": ParamDef((v, d)),
        "final_norm": ParamDef((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((d, v))
    tree["blocks"] = {k: p.stacked(cfg.n_layers)
                      for k, p in _block_defs(cfg).items()}
    return tree


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(p.shape) for p in tree_util.leaves(param_defs(cfg)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``.

    The reference's law (``params.py:223-241``): norms are ones, every other
    leaf is normal with ``std = min(scale, fan_in ** -0.5)``, ``fan_in =
    shape[-2]``.  The draws come from ``generator`` on its own device, so
    they have the reference's distribution but not its bits; to compute
    what the reference computes, carry its parameters over with
    ``params_from_jax``.  ``device`` defaults to ``cuda`` and raises
    without a card.
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
        return (x * std).to(device=dev, dtype=dtype)

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
    every use in the dense path casts to that one dtype."""
    dt = getattr(torch, dtype)
    return tree_util.map(lambda x: x.to(dt), params)
