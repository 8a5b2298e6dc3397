"""H2O-Danube-1.8B — Llama/Mistral-style with sliding-window attention.

[arXiv:2401.16818] 24L, d_model=2560, 32 heads (head_dim 80) GQA kv=8,
d_ff=6912, vocab 32000.  Mistral-style sliding-window attention
(window 4096) makes it eligible for the long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    sliding_window=4096,
    norm_type="rmsnorm",
    act="swiglu",
    source="arXiv:2401.16818",
)
