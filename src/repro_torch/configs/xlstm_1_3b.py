"""xLSTM-1.3B — sLSTM + mLSTM recurrent blocks (attention-free).

[arXiv:2405.04517] 48 blocks, d_model=2048, 4 heads, no separate FFN
(d_ff=0; blocks carry their own up/down projections), vocab 50304.
Ratio 7:1 mLSTM:sLSTM per the paper's xLSTM[7:1] configuration -> pattern
of 8 blocks repeated 6 times.  O(1) recurrent state -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    norm_type="layernorm",
    act="gelu",
    source="arXiv:2405.04517",
)
