"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 vocab=50304. 7:1 mLSTM:sLSTM block ratio (every
8th block is sLSTM); mLSTM blocks carry their own factor-2 up/down projection
(d_ff=0: no separate FFN). Sub-quadratic: runs long_500k.
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    chunk_size=256,
    tie_embeddings=True,
))
