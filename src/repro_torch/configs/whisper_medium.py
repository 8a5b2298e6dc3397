"""Whisper-medium — encoder-decoder speech transformer.

[arXiv:2212.04356] 24 encoder + 24 decoder layers, d_model=1024,
16 heads (MHA, kv=16), d_ff=4096, vocab 51865.  The mel-spectrogram +
2-layer conv frontend is the stubbed modality frontend: ``input_specs()``
provides 1500 post-conv frame embeddings of dim 1024.  The decoder is the
RL policy; the encoder runs once at prefill time and its cross-KV is
immutable under AReaL weight-update interruptions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    norm_type="layernorm",
    act="gelu",
    encoder_layers=24,
    encoder_seq_len=1500,
    n_prefix_tokens=1500,         # conv-frontend frames (encoder input)
    prefix_dim=1024,
    rope_theta=0.0,               # whisper uses learned/sinusoidal positions
    source="arXiv:2212.04356",
)
