"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H (kv=128 => MHA semantics under MLA) per-expert
d_ff=1536 vocab=102400. First layer uses a dense FFN (DeepSeek-V2 paper).
MLA: q_lora=1536, kv_lora=512, decoupled rope dim 64, v_head_dim=128.
"""

from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,             # dense-FFN width for the first_k_dense layers
    moe_d_ff=1536,
    vocab_size=102400,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    first_k_dense=1,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    head_dim=128,           # nope head dim
    v_head_dim=128,
    rope_theta=10_000.0,
))
