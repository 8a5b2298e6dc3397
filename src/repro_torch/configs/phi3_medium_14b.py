"""Phi-3-medium-14B — dense RoPE/SwiGLU/GQA transformer.

[arXiv:2404.14219] 40L, d_model=5120, 40 heads GQA kv=10, d_ff=17920,
vocab 100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
    norm_type="rmsnorm",
    act="swiglu",
    source="arXiv:2404.14219",
)
