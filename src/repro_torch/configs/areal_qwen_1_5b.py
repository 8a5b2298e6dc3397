"""R1-Distill-Qwen-1.5B-shaped config — the paper's own base model.

AReaL trains DeepSeek-R1-Distill-Qwen models (Sec 7.1); the 1.5B variant
(Qwen2.5-1.5B skeleton: 28L, d_model=1536, 12 heads GQA kv=2, d_ff=8960,
vocab 151936, tied embeddings) is the model used for the staleness /
decoupled-PPO ablations in Table 2 and Fig. 5.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="areal-qwen-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    tie_embeddings=True,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    act="swiglu",
    source="arXiv:2412.15115 / DeepSeek-R1 distill",
)
