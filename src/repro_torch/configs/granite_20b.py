"""granite-20b — code model with MQA (kv=1), 2-matrix GELU MLP.

[arXiv:2405.04324; hf]  52L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152.  (gpt-bigcode-style MQA + non-gated MLP reproduces the 20B
param count; a gated swiglu MLP at d_ff=24576 would be 28B.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    head_dim=128,
    activation="gelu",
    rope_theta=10_000.0,
)
