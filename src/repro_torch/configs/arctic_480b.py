"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + dense residual branch.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    head_dim=128,
    activation="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864, num_shared=0,
                  dense_residual=True),
)
