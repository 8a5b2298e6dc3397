"""Model facade: build the model of a config's family."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, *, device="cuda",
                dtype=torch.float32) -> Union[LM, EncDecLM]:
    """The model of ``cfg`` with uninitialised weights on ``device``: the
    enc-dec ``EncDecLM`` for a config with encoder layers (the audio
    family), else the decoder-only ``LM`` (dense, MoE, VLM, the RG-LRU
    hybrid and xLSTM), as the reference's ``build_model``.  Call
    ``.init(generator)`` or load weights into it."""
    if cfg.is_encdec:
        return EncDecLM(cfg, device=device, dtype=dtype)
    return LM(cfg, device=device, dtype=dtype)
