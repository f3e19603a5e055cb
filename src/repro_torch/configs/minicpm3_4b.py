"""minicpm3-4b  [dense, MLA]  [hf:openbmb/MiniCPM3-4B; hf]

62L d_model=2560 40H d_ff=6400 vocab=73448 -- multi-head latent attention
(compressed KV cache: kv_lora_rank=256 + 32 rope dims per token).
"""
from repro_torch.common.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=96,               # qk_nope(64) + qk_rope(32)
    attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64),
    activation="silu",
    gated_mlp=True,
    max_seq_len=32768,
)
