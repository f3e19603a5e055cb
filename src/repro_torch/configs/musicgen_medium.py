"""musicgen-medium  [audio]  [arXiv:2306.05284; hf]

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 -- decoder-only
over EnCodec tokens.  BACKBONE ONLY: the EnCodec frontend is a stub;
``input_specs()`` provides precomputed frame embeddings [B,S,d] (sum of
the 4 codebook embeddings), and the head predicts the 2048-way codebook.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    input_mode="embeddings",
    n_codebooks=4,
    activation="gelu",
    gated_mlp=False,
    max_seq_len=32768,
)
