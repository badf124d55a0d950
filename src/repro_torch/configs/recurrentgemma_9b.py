"""recurrentgemma-9b — hybrid: RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; sliding window 2048 on the attention blocks.
Pattern: (rglru, rglru, attn) repeating — the paper's 1 attention per 2
recurrent blocks.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    head_dim=256,
    activation="swiglu",
    rope_theta=10_000.0,
    attn_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
)
