"""OLMoE-1B-7B — fully open mixture-of-experts LM (1B active / 7B total).

[arXiv:2409.02060] 16L, d_model=2048, 16 heads (MHA kv=16), 64 experts
with top-8 routing, expert d_ff=1024, vocab 50304, QK-norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    n_experts=64,
    experts_per_token=8,
    qk_norm=True,
    norm_type="rmsnorm",
    act="swiglu",
    source="arXiv:2409.02060",
)
