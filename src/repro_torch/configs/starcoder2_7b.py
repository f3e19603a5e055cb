"""starcoder2-7b  [dense]  [arXiv:2402.19173; hf]

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152, GQA, RoPE,
non-gated GELU MLP (d_ff = 4*d).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    activation="gelu",
    gated_mlp=False,
    rope_theta=1e6,
    max_seq_len=32768,
)
