"""grok-1-314b  [moe]  [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2, logit softcap.  Expert-parallel (EP over the data axis) + TP.
"""
from repro_torch.common.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768, impl="ep"),
    moe_pattern=(True,),
    logit_softcap=30.0,
    activation="gelu",
    gated_mlp=True,
    max_seq_len=32768,
)
