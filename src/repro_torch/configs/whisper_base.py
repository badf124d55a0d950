"""whisper-base — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings of shape (B, S, d_model)).

[arXiv:2212.04356; unverified]  6L d_model=512 8H (kv=8) d_ff=2048
vocab=51865.  6 encoder layers + 6 decoder layers, cross attention,
sinusoidal positions, non-gated GELU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    head_dim=64,
    activation="gelu",
    encoder_layers=6,
    cross_attention=True,
)
