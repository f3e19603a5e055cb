"""falcon-mamba-7b  [ssm]  [arXiv:2410.05355; unverified]

64L d_model=4096, attention-free mamba-1 blocks (d_inner=8192,
ssm_state=16, d_conv=4, dt_rank=256), vocab=65024.  Sub-quadratic:
runs the long_500k cell (decode state is O(1) in context length).
"""
from repro_torch.common.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,                    # pure SSM: no FFN sub-block
    vocab_size=65024,
    head_dim=64,
    attention="none",
    layer_pattern=("mamba",),
    mamba=MambaConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    subquadratic=True,
    max_seq_len=524288,
)
