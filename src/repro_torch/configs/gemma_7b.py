"""gemma-7b  [dense]  [arXiv:2403.08295; hf]

28L d_model=3072 16H (GQA kv=16, i.e. MHA) d_ff=24576 vocab=256000,
GeGLU, head_dim=256, RoPE.  Gemma scales embeddings by sqrt(d_model) and
softcaps final logits.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    activation="gelu",         # GeGLU
    gated_mlp=True,
    scale_embeddings=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    rope_theta=10000.0,
    max_seq_len=32768,
)
