"""Training launcher: only ``scaled_config`` so far.

Port of ``scaled_config`` from ``repro/launch/train.py``, copied as it is:
it builds the reduced configs that the tests and ``launch/serve_lm.py
--scale`` run.  The trainer itself (mesh, data pipeline, optimizer,
checkpoints) arrives with the training slice (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import dataclasses


def scaled_config(cfg, scale: float):
    """Reduced config of the same family for CPU-scale runs."""
    if scale >= 1.0:
        return cfg
    d = max(64, int(cfg.d_model * scale) // 16 * 16)
    heads = max(2, min(cfg.n_heads, d // 64))
    kv = max(1, min(cfg.n_kv_heads, heads))
    layers = max(2, int(cfg.n_layers * scale))
    if cfg.family == "hybrid":
        layers = max(cfg.attn_every, layers // cfg.attn_every * cfg.attn_every)
    if cfg.family == "ssm":
        layers = max(cfg.slstm_every,
                     layers // cfg.slstm_every * cfg.slstm_every)
    hd = 64 if cfg.uses_mla else d // heads
    sections = ()
    if cfg.mrope:
        half = hd // 2
        sections = (half - half // 4 - half // 4, half // 4, half // 4)
    return dataclasses.replace(
        cfg,
        name=cfg.name + f"-x{scale}",
        n_layers=layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=None if not cfg.uses_mla else 64,
        mrope_sections=sections if cfg.mrope else cfg.mrope_sections,
        d_ff=max(128, int(cfg.d_ff * scale) // 16 * 16) if cfg.d_ff else 0,
        moe_d_ff=max(64, int(cfg.moe_d_ff * scale) // 16 * 16)
        if cfg.moe_d_ff else 0,
        vocab_size=min(cfg.vocab_size, 8192),
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        q_lora_rank=96 if cfg.q_lora_rank else 0,
        rope_head_dim=16 if cfg.rope_head_dim else 0,
        v_head_dim=64 if cfg.v_head_dim else 0,
        encoder_layers=max(2, int(cfg.encoder_layers * scale))
        if cfg.encoder_layers else 0,
        frontend_len=min(cfg.frontend_len, 64),
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        chunk_size=min(cfg.chunk_size, 64),
        attn_chunk=128,
        attn_chunked_above=10 ** 9,
        dtype="float32",
    )
