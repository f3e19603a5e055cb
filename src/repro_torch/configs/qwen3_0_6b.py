"""qwen3-0.6b  [dense]  [hf:Qwen/Qwen3-8B family; hf]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 -- qk_norm, GQA,
head_dim=128 (explicit, 16*128 != d_model).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=1e6,
    max_seq_len=32768,
)
