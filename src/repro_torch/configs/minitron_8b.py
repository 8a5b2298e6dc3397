"""Minitron-8B — width-pruned + distilled Nemotron-4 15B.

[arXiv:2407.14679] 32L, d_model=4096, 32 heads GQA kv=8, d_ff=16384,
vocab 256000.  Nemotron lineage: squared-ReLU MLP (no gating), RoPE,
LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256_000,
    norm_type="layernorm",
    act="relu2",
    source="arXiv:2407.14679",
)
