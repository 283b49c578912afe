"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
One *shared-weight* attention block is applied every ``attn_every`` Mamba2
layers (the Zamba2 weight-sharing trick). Sub-quadratic: runs long_500k.
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    chunk_size=256,
))
