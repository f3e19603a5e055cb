"""deepseek-moe-16b  [moe]  [arXiv:2401.06066; hf]

28L d_model=2048 16H (MHA kv=16) vocab=102400; fine-grained MoE:
64 routed experts (d_expert=1408) top-6 + 2 shared experts; first layer
is a dense FFN (d_ff=10944).
"""
from repro_torch.common.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    dense_first_layer=True,
    dense_first_d_ff=10944,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  impl="ep"),
    moe_pattern=(True,),
    activation="silu",
    gated_mlp=True,
    max_seq_len=32768,
)
