"""stablelm-3b [dense] — hf:stabilityai/stablelm-2-1_6b family (unverified).

32L d_model=2560 32H (GQA kv=32, i.e. MHA) d_ff=6912 vocab=50304.
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    rope_theta=10_000.0,
))
