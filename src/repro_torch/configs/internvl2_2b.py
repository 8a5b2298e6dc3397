"""InternVL2-2B — InternViT-300M vision encoder + InternLM2-1.8B LLM.

[arXiv:2404.16821] We implement the language backbone (InternLM2-1.8B:
24L, d_model=2048, 16 heads with GQA kv=8, d_ff=8192, vocab 92553).  The
InternViT encoder + MLP projector is the stubbed modality frontend: with
448x448 inputs and pixel-unshuffle, each image contributes 256 visual
tokens whose projected embeddings are supplied by ``input_specs()``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="swiglu",
    n_prefix_tokens=256,          # one 448x448 tile after pixel-unshuffle
    prefix_dim=1024,              # InternViT-300M hidden size
    source="arXiv:2404.16821",
)
