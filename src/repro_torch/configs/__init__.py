"""Architecture/config registry.

``get_model_config("<arch-id>")`` resolves the assigned-pool ids (and the
paper's own model).  ``reduced(cfg)`` produces the CPU smoke-test variant
(<=2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import (ExperimentConfig, MeshConfig, ModelConfig,
                                RLConfig, ShapeConfig, round_up)
from repro_torch.configs.shapes import SHAPES

_ARCH_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "whisper-medium": "whisper_medium",
    "minitron-8b": "minitron_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "xlstm-1.3b": "xlstm_1_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "olmo-1b": "olmo_1b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "areal-qwen-1.5b": "areal_qwen_1_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)
ASSIGNED_ARCHS = tuple(a for a in ARCH_IDS if a != "areal-qwen-1.5b")


def get_model_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def reduced(cfg: ModelConfig, seq_cap: int = 128) -> ModelConfig:
    """Reduced smoke-test variant: same family/pattern, tiny dims."""
    pat = cfg.block_pattern
    if len(pat) > 2:                     # keep one block of each type
        seen = []
        for bt in pat:
            if bt not in seen:
                seen.append(bt)
        pat = tuple(seen[:2])
    n_layers = max(2, len(pat))
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 16),
        n_prefix_tokens=min(cfg.n_prefix_tokens, 8),
        prefix_dim=min(cfg.prefix_dim, 64) if cfg.prefix_dim else 0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        local_window=min(cfg.local_window, 32),
        lru_width=d_model,
        block_pattern=pat,
        max_position_embeddings=max(seq_cap, 512),
    )


__all__ = [
    "ARCH_IDS", "ASSIGNED_ARCHS", "SHAPES", "ExperimentConfig", "MeshConfig",
    "ModelConfig", "RLConfig", "ShapeConfig", "get_model_config", "get_shape",
    "reduced", "round_up",
]
