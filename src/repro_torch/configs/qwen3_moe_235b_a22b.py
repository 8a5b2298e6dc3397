"""Qwen3-MoE-235B-A22B — large mixture-of-experts (22B active).

[hf:Qwen/Qwen3-30B-A3B family] 94L, d_model=4096, 64 heads head_dim 128
GQA kv=4, 128 experts top-8 with expert d_ff=1536, vocab 151936, QK-norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    n_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="swiglu",
    source="hf:Qwen/Qwen3-30B-A3B",
)
