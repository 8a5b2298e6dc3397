"""OLMo-1B — fully open dense LM with non-parametric LayerNorm.

[arXiv:2402.00838] 16L, d_model=2048, 16 heads (MHA kv=16), d_ff=8192,
vocab 50304.  OLMo uses non-parametric LayerNorm (no scale/bias) and
SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    norm_type="layernorm",
    parametric_norm=False,
    act="swiglu",
    source="arXiv:2402.00838",
)
