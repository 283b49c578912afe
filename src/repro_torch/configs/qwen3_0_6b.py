"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. Qwen3 uses an
explicit head_dim=128 (q/k/v projections wider than d_model/n_heads).
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
