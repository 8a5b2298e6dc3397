"""RecurrentGemma-9B — Griffin architecture: RG-LRU + local attention (2:1).

[arXiv:2402.19427] 38 blocks, d_model=4096, 16 heads head_dim 256 with
MQA (kv=1), d_ff=12288 (GeGLU), vocab 256000.  Pattern: two RG-LRU
recurrent blocks followed by one local-attention block (window 2048);
38 = 12 x (rec,rec,local) + (rec,rec) remainder.  Bounded state ->
runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "local"),
    local_window=2048,
    norm_type="rmsnorm",
    act="geglu",
    lru_width=4096,
    source="arXiv:2402.19427",
)
