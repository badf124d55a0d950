"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf]  28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    head_dim=128,
    activation="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
)
