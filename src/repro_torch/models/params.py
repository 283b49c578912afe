"""Parameter definitions and initialisation of the LM stack: every family
(dense, moe, vlm, audio, hybrid and ssm).

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
the cross-attention's ``x``-prefixed leaves; the hybrid family has
``blocks`` of Mamba2 leaves and ONE ``shared_attn`` block, the ssm family
``blocks`` of mLSTM and ``slstm_blocks`` of sLSTM leaves.  Each
``ParamDef`` carries the reference's logical sharding axes, which
``distributed.shardings.MeshRules`` maps onto a mesh: an abstract one for
the dry-run (``abstract_params``, ``param_specs``), or a real device mesh,
where ``param_shardings`` gives each leaf's layout and ``init_params`` /
``params_from_jax`` with ``rules`` return the leaves as ``DTensor``s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.nbody import resolve_device
from repro_torch.models.config import ArchConfig

#: the families the port runs
PORTED_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
#: leaves that every use casts to fp32, whatever the activation dtype: the
#: mLSTM's per-head q/k/v maps (``model.py:139-141``), the sLSTM's recurrent
#: R (:176, :179) and Mamba2's decay, skip and step bias (:107-110, :122)
FP32_LEAVES = frozenset({"wq", "wk", "wv", "r", "a_log", "d_skip",
                         "dt_bias"})


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | a_log | dt_bias
    scale: float = 0.02

    def stacked(self, n: int) -> "ParamDef":
        return dataclasses.replace(self, shape=(n,) + self.shape,
                                   logical=("layers",) + self.logical)


def check_ported(cfg: ArchConfig):
    """Raise ``ValueError`` for a family that is none of the reference's."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"expected one of {', '.join(PORTED_FAMILIES)}")


def _attn_defs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    pre = "x" if cross else ""
    out = {
        f"{pre}q": ParamDef((d, h * hd), ("fsdp_d_model", "heads")),
        f"{pre}k": ParamDef((d, kv * hd),
                            ("fsdp_d_model", "kv_heads")),
        f"{pre}v": ParamDef((d, kv * hd),
                            ("fsdp_d_model", "kv_heads")),
        f"{pre}o": ParamDef((h * hd, d), ("heads", "fsdp_d_model")),
    }
    if cfg.qk_norm and not cross:
        out["qn"] = ParamDef((hd,), ("head_dim",), "ones")
        out["kn"] = ParamDef((hd,), ("head_dim",), "ones")
    return out


def _mla_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h, hd, vhd, rhd = cfg.n_heads, cfg.head_dim, cfg.v_head_dim, cfg.rope_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "q_a": ParamDef((d, qlr), ("fsdp_d_model", None)),
        "q_norm": ParamDef((qlr,), (None,), "ones"),
        "q_b": ParamDef((qlr, h * (hd + rhd)), (None, "heads")),
        "kv_a": ParamDef((d, kvlr + rhd), ("fsdp_d_model", None)),
        "kv_norm": ParamDef((kvlr,), (None,), "ones"),
        "kv_b": ParamDef((kvlr, h * (hd + vhd)), (None, "heads")),
        "o": ParamDef((h * vhd, d), ("heads", "fsdp_d_model")),
    }


def _ffn_defs(d: int, f: int) -> dict:
    return {
        "wg": ParamDef((d, f), ("fsdp_d_model", "d_ff")),
        "wu": ParamDef((d, f), ("fsdp_d_model", "d_ff")),
        "wd": ParamDef((f, d), ("d_ff", "fsdp_d_model")),
    }


def _moe_defs(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    out = {
        "router": ParamDef((d, e), ("fsdp_d_model", None)),
        "we_g": ParamDef((e, d, f),
                         ("experts", "fsdp_d_model", None)),
        "we_u": ParamDef((e, d, f),
                         ("experts", "fsdp_d_model", None)),
        "we_d": ParamDef((e, f, d),
                         ("experts", None, "fsdp_d_model")),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        out.update({f"ws_{k[-1]}": v for k, v in _ffn_defs(d, fs).items()})
    return out


def _mamba_defs(cfg: ArchConfig) -> dict:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    return {
        "ln": ParamDef((d,), ("d_model",), "ones"),
        "wz": ParamDef((d, di), ("fsdp_d_model", "d_ff")),
        "wx": ParamDef((d, di), ("fsdp_d_model", "d_ff")),
        "wB": ParamDef((d, ns), ("fsdp_d_model", None)),
        "wC": ParamDef((d, ns), ("fsdp_d_model", None)),
        "wdt": ParamDef((d, nh), ("fsdp_d_model", "heads")),
        "conv": ParamDef((cfg.conv_width, di), (None, "d_ff")),
        "a_log": ParamDef((nh,), ("heads",), "a_log"),
        "d_skip": ParamDef((nh,), ("heads",), "ones"),
        "dt_bias": ParamDef((nh,), ("heads",), "dt_bias"),
        "gnorm": ParamDef((di,), ("d_ff",), "ones"),
        "wo": ParamDef((di, d), ("d_ff", "fsdp_d_model")),
    }


def _mlstm_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    dk = di // nh
    return {
        "ln": ParamDef((d,), ("d_model",), "ones"),
        "w_up": ParamDef((d, 2 * di), ("fsdp_d_model", "d_ff")),
        # q/k/v are block-diagonal per head (the mLSTM cell's layout)
        "wq": ParamDef((nh, dk, dk), ("heads", None, None)),
        "wk": ParamDef((nh, dk, dk), ("heads", None, None)),
        "wv": ParamDef((nh, dk, dk), ("heads", None, None)),
        "w_if": ParamDef((di, 2 * nh), ("fsdp_d_model", None)),
        "onorm": ParamDef((di,), ("d_ff",), "ones"),
        "w_down": ParamDef((di, d), ("d_ff", "fsdp_d_model")),
    }


def _slstm_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    return {
        "ln": ParamDef((d,), ("d_model",), "ones"),
        "w_in": ParamDef((d, 4 * d), ("fsdp_d_model", "d_ff")),
        "r": ParamDef((nh, hd, 4 * hd), ("heads", None, None)),
        "b": ParamDef((4 * d,), ("d_ff",), "zeros"),
        "onorm": ParamDef((d,), ("d_model",), "ones"),
        "w_down": ParamDef((d, d), ("fsdp_d_model", "d_model")),
    }


def _block_defs(cfg: ArchConfig, kind: str) -> dict:
    """One block of kind "attn" (attention + FFN), "moe" (attention + MoE
    FFN), "cross_attn" (self-, then cross-attention + FFN), "mamba",
    "mlstm" or "slstm"; attention is MLA where the config says so."""
    if kind == "mamba":
        return _mamba_defs(cfg)
    if kind == "mlstm":
        return _mlstm_defs(cfg)
    if kind == "slstm":
        return _slstm_defs(cfg)
    d = cfg.d_model
    out = {"ln1": ParamDef((d,), ("d_model",), "ones")}
    out.update(_mla_defs(cfg) if cfg.uses_mla else _attn_defs(cfg))
    out["ln2"] = ParamDef((d,), ("d_model",), "ones")
    if kind == "moe":
        out.update(_moe_defs(cfg))
    elif kind == "cross_attn":
        out.update(_attn_defs(cfg, cross=True))
        out["lnx"] = ParamDef((d,), ("d_model",), "ones")
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
        "embed": ParamDef((v, d), ("vocab", "fsdp_d_model")),
        "final_norm": ParamDef((d,), ("d_model",), "ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((d, v), ("fsdp_d_model", "vocab"))
    if cfg.family in ("dense", "vlm"):
        tree["blocks"] = _stack(_block_defs(cfg, "attn"), cfg.n_layers)
    elif cfg.family == "moe":
        tree["blocks"] = _stack(_block_defs(cfg, "moe"),
                                cfg.n_layers - cfg.first_k_dense)
        if cfg.first_k_dense:
            tree["dense_blocks"] = _stack(_block_defs(cfg, "attn"),
                                          cfg.first_k_dense)
    elif cfg.family == "hybrid":
        tree["blocks"] = _stack(_block_defs(cfg, "mamba"), cfg.n_layers)
        tree["shared_attn"] = _block_defs(cfg, "attn")  # ONE shared block
    elif cfg.family == "ssm":
        n_s = cfg.n_layers // cfg.slstm_every
        tree["blocks"] = _stack(_block_defs(cfg, "mlstm"), cfg.n_layers - n_s)
        tree["slstm_blocks"] = _stack(_block_defs(cfg, "slstm"), n_s)
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


def _leaf_shape(p: ParamDef, rules) -> tuple:
    return tuple(p.shape) if rules is None else rules.local_shape(
        p.shape, p.logical)


def abstract_params(cfg: ArchConfig, rules=None, dtype=None) -> dict:
    """The parameter tree as ``meta`` tensors: no allocation.  With
    ``rules`` (a ``MeshRules``) each leaf holds one device's local shape.

    ``dtype`` overrides ``cfg.param_dtype``: serving runs bf16 weights
    (the inference checkpoint's cast), training the fp32 masters."""
    dt = getattr(torch, dtype or cfg.param_dtype)
    return tree_util.map(
        lambda p: torch.empty(_leaf_shape(p, rules), dtype=dt, device="meta"),
        param_defs(cfg))


def param_specs(cfg: ArchConfig, rules) -> dict:
    """Each leaf's partition spec under ``rules`` (``MeshRules.spec``)."""
    return tree_util.map(lambda p: rules.spec(p.shape, p.logical),
                         param_defs(cfg))


def param_shardings(cfg: ArchConfig, rules) -> dict:
    """Each leaf's ``NamedSharding`` on the rules' real mesh (None leaves
    without one), as the reference's ``param_shardings``."""
    return tree_util.map(lambda p: rules.sharding(p.shape, p.logical),
                         param_defs(cfg))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", rules=None) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``.

    The reference's law (``params.py:221-241``): norms and Mamba2's skip
    are ones, the sLSTM's bias zeros, Mamba2's ``a_log`` the log of
    ``linspace(1, 16, nh)`` and ``dt_bias`` softplus^-1 of step sizes
    log-spaced over [1e-3, 1e-1] (both computed in fp32 and broadcast over
    the layers), every other leaf normal with ``std = min(scale, fan_in **
    -0.5)``, ``fan_in = shape[-2]``.  The draws come from ``generator`` on
    its own device, so they have the reference's distribution but not its
    bits; to compute what the reference computes, carry its parameters
    over with ``params_from_jax``.  Each leaf is drawn in fp32 and cast on its own,
    so no fp32 copy of the whole tree exists.  ``device`` defaults to
    ``cuda`` and raises without a card.

    With ``rules`` on a real mesh every rank draws each leaf whole, as
    above, and keeps its block (``param_shardings``): the values do not
    depend on the mesh, and only one whole leaf is held at a time.
    """
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def one(p: ParamDef):
        if p.init in ("zeros", "ones"):
            fill = torch.zeros if p.init == "zeros" else torch.ones
            return fill(p.shape, dtype=dtype, device=dev)
        if p.init in ("a_log", "dt_bias"):
            return _ssm_init(p, dev).to(dtype)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = min(p.scale, fan_in ** -0.5)
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(std).to(device=dev, dtype=dtype)

    if rules is None or not rules.is_real:
        return tree_util.map(one, param_defs(cfg))
    return tree_util.map(
        lambda p: rules.sharding(p.shape, p.logical).place(one(p)),
        param_defs(cfg))


def _ssm_init(p: ParamDef, dev):
    """Mamba2's ``a_log`` or ``dt_bias`` in fp32, as ``_init_one``."""
    nh = p.shape[-1]
    f32 = torch.float32
    if p.init == "a_log":
        base = torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev))
    else:  # softplus^-1 of dt in [1e-3, 1e-1], log-spaced
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), nh,
                                      dtype=f32, device=dev))
        base = torch.log(torch.expm1(dt))
    return base.expand(p.shape).clone()


def params_from_jax(tree: Mapping, device="cuda", rules=None, *,
                    cfg: Optional[ArchConfig] = None) -> dict:
    """The reference's ``init_params`` tree, leaves as numpy arrays, as the
    port's parameters on ``device``: the same keys, the same stacked
    ``(n_layers, ...)`` leaves, the same values bit for bit.  With
    ``rules`` on a real mesh (and the tree's ``cfg``) each leaf is placed
    per ``param_shardings``."""
    dev = resolve_device(device)
    out = tree_util.map(lambda x: torch.from_numpy(np.array(x)).to(dev), tree)
    if rules is not None and rules.is_real:
        if cfg is None:
            raise ValueError("params_from_jax on a real mesh needs the "
                             "tree's cfg for its shardings")
        out = tree_util.map(lambda x, sh: sh.place(x), out,
                            param_shardings(cfg, rules))
    return out


def cast_params(params: Mapping, dtype: str) -> dict:
    """Every leaf cast once, as a serving checkpoint is cast: to fp32 for
    the leaves of ``FP32_LEAVES``, to ``dtype`` for every other.

    The reference casts each weight at every use, to the activation dtype
    (``p["q"].astype(dt)``) or, for the ``FP32_LEAVES``, to fp32; casting
    once at load gives the same bits, since every use of a leaf casts it to
    that one dtype.  (A fp32 leaf rounded to bf16 first would give another
    function: ``a_log`` rounded to 2**-8 moves every decay.)  A ``DTensor``
    leaf keeps its placements: each rank casts its block."""
    dt = getattr(torch, dtype)

    def cast(tree):
        return {k: cast(x) if isinstance(x, Mapping)
                else x.to(torch.float32 if k in FP32_LEAVES else dt)
                for k, x in tree.items()}

    return cast(params)
