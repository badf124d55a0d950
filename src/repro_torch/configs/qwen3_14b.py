"""qwen3-14b — dense GQA with QK-norm.

[hf:Qwen/Qwen3-8B; hf]  40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17_408,
    vocab_size=151_936,
    head_dim=128,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
)
