"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 (padded to 256256).
The speech frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, frontend_len, d_model) consumed by the encoder directly.
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,             # decoder layers
    encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio_frames",
    rope_theta=10_000.0,
))
