"""jamba-v0.1-52b  [hybrid]  [arXiv:2403.19887; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; Mamba+attention
1:7 interleave (attention at offset 4 of every 8-layer block), MoE 16
experts top-2 on every other layer.  Sub-quadratic enough for long_500k:
only 4/32 layers hold KV (SP-sharded); the rest carry O(1) SSM state.
"""
from repro_torch.common.config import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, impl="ep"),
    mamba=MambaConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    activation="silu",
    gated_mlp=True,
    subquadratic=True,
    max_seq_len=524288,
)
