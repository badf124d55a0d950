"""nemotron-4-340b — dense GQA with squared-ReLU MLP (2-matrix, non-gated).

[arXiv:2402.16819; unverified]  96L d_model=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    head_dim=192,
    activation="relu2",
    rope_theta=10_000.0,
)
