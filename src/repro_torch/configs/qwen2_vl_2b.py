"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision frontend
is a STUB: ``input_specs()`` provides precomputed patch embeddings
(B, frontend_len, d_model) that are prepended to the token embeddings; the
backbone applies M-RoPE with (t, h, w) position streams over the image span.
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    frontend="vision_patches",
    frontend_len=256,        # 16x16 patch grid stub
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
