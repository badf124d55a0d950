"""falcon-mamba-7b — attention-free Mamba-1 SSM stack.

[arXiv:2410.05355; unverified]  64L d_model=4096 vocab=65024, ssm_state=16,
expand=2 (d_inner=8192), conv=4, dt_rank=d_model/16=256.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    head_dim=64,
    activation="swiglu",  # unused
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
)
