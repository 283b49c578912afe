"""Assigned input shapes and abstract input specs for the dry-run.

Port of ``repro/launch/shapes.py``.  Four LM shapes (seq_len x
global_batch), each mapping to a step:

  train_4k     (4096, 256)   -> train step
  prefill_32k  (32768, 32)   -> prefill step (full-prompt forward + cache)
  decode_32k   (32768, 128)  -> decode step (1 new token, seq_len-deep cache)
  long_500k    (524288, 1)   -> decode step; SUB-QUADRATIC ONLY (zamba2-7b,
                                xlstm-1.3b) — full-attention archs are
                                recorded as skipped

``input_specs`` returns every model input as a ``meta`` tensor (one
device's local shape when given rules): no allocation; the dry-run runs
the step on them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed.shardings import MeshRules
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

SUBQUADRATIC = ("zamba2-7b", "xlstm-1.3b")

# Default gradient-accumulation factor per arch for the train_4k cell, chosen
# so the stored per-layer residual stream (b_local x seq x d_model x 2B x
# n_layers / accum under full remat) stays within a ~4 GiB budget on the
# (16,16) mesh (b_local = 16).  decode/prefill cells never accumulate.
TRAIN_ACCUM = {
    "stablelm-3b": 4,
    "deepseek-67b": 16,
    "qwen3-0.6b": 2,
    "stablelm-12b": 8,
    "zamba2-7b": 8,
    "seamless-m4t-medium": 2,
    "xlstm-1.3b": 4,
    "phi3.5-moe-42b-a6.6b": 8,
    "deepseek-v2-236b": 8,
    "qwen2-vl-2b": 2,
}


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(supported, reason).  long_500k needs sub-quadratic sequence mixing."""
    if shape == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("full-attention architecture: O(S^2) attention at "
                       "S=524288 is intentionally unsupported (DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype, rules: Optional[MeshRules], logical):
    if rules is not None:
        shape = rules.local_shape(shape, logical)
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_splits(cfg: ArchConfig, case: ShapeCase):
    """(text_len, patch_len, enc_len) for the shape."""
    if cfg.family == "vlm":
        f = min(cfg.frontend_len, case.seq_len // 2)
        return case.seq_len - f, f, 0
    if cfg.family == "audio":
        return case.seq_len, 0, case.seq_len
    return case.seq_len, 0, 0


def train_specs(cfg: ArchConfig, case: ShapeCase,
                rules: Optional[MeshRules] = None) -> dict:
    b = case.global_batch
    s_txt, f, enc = _frontend_splits(cfg, case)
    batch = {
        "tokens": _meta((b, s_txt), torch.int32, rules, ("batch", "seq")),
        "labels": _meta((b, s_txt), torch.int32, rules, ("batch", "seq")),
    }
    if f:
        batch["patches"] = _meta((b, f, cfg.d_model), torch.float32, rules,
                                 ("batch", "seq", "d_model"))
    if enc:
        batch["frames"] = _meta((b, enc, cfg.d_model), torch.float32, rules,
                                ("batch", "seq", "d_model"))
    return batch


def prefill_specs(cfg: ArchConfig, case: ShapeCase,
                  rules: Optional[MeshRules] = None) -> dict:
    return train_specs(cfg, case, rules)  # same inputs; labels are ignored


def decode_specs(cfg: ArchConfig, case: ShapeCase,
                 rules: Optional[MeshRules] = None) -> dict:
    b, s = case.global_batch, case.seq_len
    enc = s if cfg.family == "audio" else 0
    cache = M.cache_spec(cfg, b, s, rules, enc_len=enc)
    tokens = _meta((b, 1), torch.int32, rules, ("batch", None))
    return {"cache": cache, "tokens": tokens}


def input_specs(cfg: ArchConfig, shape: str,
                rules: Optional[MeshRules] = None) -> dict:
    """All abstract inputs for (arch x shape); raises on unsupported cells."""
    case = SHAPES[shape]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    if case.kind == "train":
        return {"batch": train_specs(cfg, case, rules)}
    if case.kind == "prefill":
        return {"batch": prefill_specs(cfg, case, rules)}
    return decode_specs(cfg, case, rules)
