"""llama-2-7b  [dense]  [arXiv:2307.09288; hf]

The paper's own serving model (Touvron et al. 2023): 32L d_model=4096
32H (MHA) d_ff=11008 vocab=32000.  Used by the reproduction experiments
(profiling gradients, router training) and as the 11th config.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-2-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    max_seq_len=4096,
)
