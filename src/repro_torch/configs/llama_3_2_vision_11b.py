"""llama-3.2-vision-11b  [vlm]  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 -- gated
cross-attention image layers every 5th layer (8 of 40).  BACKBONE ONLY:
the vision tower is a stub; ``input_specs()`` provides precomputed patch
embeddings [B, 1024, 1280] consumed via a linear projection.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    layer_pattern=("attn", "attn", "attn", "attn", "cross"),
    moe_pattern=(False,) * 5,
    vision_tokens=1024,
    vision_dim=1280,
    activation="silu",
    gated_mlp=True,
    rope_theta=5e5,
    max_seq_len=32768,
)
