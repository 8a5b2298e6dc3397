"""Model facade: build the model of a config's family."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import FAMILIES, LM


def build_model(cfg: ModelConfig, *, device="cuda", dtype=torch.float32) -> LM:
    """The decoder of ``cfg`` (a dense, MoE or VLM family, or the RG-LRU
    hybrid) with uninitialised weights on ``device``; call
    ``.init(generator)`` or load weights into it.  The enc-dec (audio) and
    xLSTM (ssm) families are later parts of the port and raise
    ``NotImplementedError``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported; only {FAMILIES} are")
    return LM(cfg, device=device, dtype=dtype)
