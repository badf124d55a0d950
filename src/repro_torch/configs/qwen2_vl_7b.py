"""qwen2-vl-7b — VLM backbone with M-RoPE; vision frontend is a STUB
(input_specs provides precomputed patch embeddings merged into the stream).

[arXiv:2409.12191; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064. M-RoPE sections (temporal, h, w) = (16, 24, 24) of head_dim/2.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    head_dim=128,
    activation="swiglu",
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    vision_stub=True,
    max_vision_tokens=1024,
)
