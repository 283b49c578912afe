"""Architecture configuration of the LM stack.

Port of ``repro/models/config.py``: ``ArchConfig`` is the reference's
dataclass, copied whole (every family's fields, ``padded_vocab`` and
``param_count``), so a config compares field for field with the
reference's.  The registry loads the reference's ten configs from the
port's own copies (``repro_torch.configs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default: d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    first_k_dense: int = 0            # leading dense layers (deepseek-v2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0            # decoupled rope dims per head
    v_head_dim: int = 0

    # --- SSM / hybrid / xLSTM ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256             # SSD / mLSTM chunk length
    attn_every: int = 0               # zamba2: shared attn block period
    slstm_every: int = 0              # xlstm: sLSTM block period (else mLSTM)

    # --- enc-dec / frontends ---
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    frontend: str = "none"            # none | audio_frames | vision_patches
    frontend_len: int = 0             # stub frontend sequence length
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = ()

    # --- numerics / perf knobs ---
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"               # none | full | dots
    scan_layers: bool = True
    attn_chunk: int = 1024            # query-block size for chunked attention
    attn_chunked_above: int = 8192    # use chunked attention for S >= this
    attn_impl: str = "xla"            # xla | flash (Pallas kernel on TPU;
    #                                   VMEM-marked region on the CPU dry-run)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "moe" and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.kv_lora_rank and not self.v_head_dim:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    # ---------------- derived quantities ----------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the 'model' mesh axis always divides it."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def uses_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def block_kind(self, i: int) -> str:
        """Block type at depth i (mixed-family archs)."""
        if self.family == "hybrid":
            return "mamba"            # shared attn handled inside the scan
        if self.family == "ssm" and self.slstm_every:
            return "slstm" if (i % self.slstm_every == self.slstm_every - 1) \
                else "mlstm"
        return "attn"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        kv = self.n_kv_heads
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm", "hybrid"):
            if self.uses_mla:
                qd = self.q_lora_rank or d
                attn = (d * self.q_lora_rank if self.q_lora_rank else 0)
                attn += qd * self.n_heads * (hd + self.rope_head_dim)
                attn += d * (self.kv_lora_rank + self.rope_head_dim)
                attn += self.kv_lora_rank * self.n_heads * (hd + self.v_head_dim)
                attn += self.n_heads * self.v_head_dim * d
            else:
                attn = d * self.n_heads * hd + 2 * d * kv * hd \
                    + self.n_heads * hd * d
        if self.family == "moe":
            dense_ff = 3 * d * self.d_ff if not self.first_k_dense else 0
            expert_ff = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            router = d * self.n_experts
            per_layer = attn + expert_ff + router
            total_layers = per_layer * self.n_layers
            if self.first_k_dense:
                # first k layers use a dense FFN of width ~= top_k * moe_d_ff * 4
                total_layers += self.first_k_dense * 3 * d * (self.moe_d_ff * 8)
            return n + total_layers + 2 * d
        if self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            nh = di // self.ssm_head_dim
            mamba = d * (2 * di + 2 * ns + nh) + di * d + di * self.conv_width
            shared_attn = attn  # one shared block, counted once below
            return n + mamba * self.n_layers + shared_attn + 2 * d
        if self.family == "ssm":
            # mLSTM: qkv + gates + up/down proj (factor-2 inner)
            di = 2 * d
            mlstm = d * di * 2 + di * 3 * di // 1 + di * d  # coarse
            return n + mlstm * self.n_layers + 2 * d
        ffn = 3 * d * self.d_ff
        layers = self.n_layers + self.encoder_layers
        total = n + (attn + ffn) * layers + 2 * d
        if self.is_encoder_decoder:
            total += self.n_layers * attn  # cross-attention
        return total


_REGISTRY: dict = {}

#: the configs of ``repro_torch.configs``: the dense family's four, the moe
#: family's two, the vlm's, the audio's, the hybrid's and the ssm's
_PORTED = ("deepseek_67b", "qwen3_0_6b", "stablelm_12b", "stablelm_3b",
           "phi35_moe", "deepseek_v2_236b", "qwen2_vl_2b",
           "seamless_m4t_medium", "zamba2_7b", "xlstm_1_3b")


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib

    for mod in _PORTED:
        importlib.import_module(f"repro_torch.configs.{mod}")
