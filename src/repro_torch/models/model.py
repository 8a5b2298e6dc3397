"""Model facade: build the model of a config's family, and the dry run's
stand-ins of its inputs on the ``meta`` device (``repro/models/model.py``)."""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, *, remat: bool = False, remat_policy: str = "none",
                device="cuda", dtype=torch.float32) -> Union[LM, EncDecLM]:
    """The model of ``cfg`` with uninitialised weights on ``device``: the
    enc-dec ``EncDecLM`` for a config with encoder layers (the audio
    family), else the decoder-only ``LM`` (dense, MoE, VLM, the RG-LRU
    hybrid and xLSTM), as the reference's ``build_model``.  ``remat``
    checkpoints each unit of the training forward under ``remat_policy``
    ("none" or "dots"); the default is off, where the reference's is on:
    every caller here but the dry run is a serving path or
    ``run_training``, which the reference builds without it.  Call
    ``.init(generator)`` or load weights into it."""
    kw = dict(remat=remat, remat_policy=remat_policy, device=device, dtype=dtype)
    if cfg.is_encdec:
        return EncDecLM(cfg, **kw)
    return LM(cfg, **kw)


def needs_prefix(cfg: ModelConfig) -> bool:
    return bool(cfg.n_prefix_tokens and cfg.prefix_dim)


# ---------------------------------------------------------------------------
# meta-device stand-ins (the dry run; never allocates), the counterparts of
# the reference's ShapeDtypeStructs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The PPO train-step batch: packed trajectories (tokens, positions,
    segment ids) and the RL fields (advantages, the behaviour and proximal
    logprobs, the loss mask on generated tokens), as the reference's."""
    b, s = shape.global_batch, shape.seq_len
    specs = {name: _meta((b, s), torch.int32) for name in ("tokens", "positions", "segment_ids")}
    specs.update({name: _meta((b, s), torch.float32)
                  for name in ("advantages", "behav_logprob", "prox_logprob", "loss_mask")})
    if needs_prefix(cfg):
        specs["prefix_embeds"] = _meta((b, cfg.n_prefix_tokens, cfg.prefix_dim), dtype)
    return specs


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                        dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32), "length": _meta((b,), torch.int32)}
    if needs_prefix(cfg):
        specs["prefix_embeds"] = _meta((b, cfg.n_prefix_tokens, cfg.prefix_dim), dtype)
    return specs


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    return {"token": _meta((shape.global_batch,), torch.int32)}


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16, **remat):
    """The model of ``cfg`` on the meta device: its parameters are the
    stand-ins (in ``dtype``; the RG-LRU's ``lam`` stays f32, as in the
    reference's init); ``remat`` / ``remat_policy`` as ``build_model``'s."""
    return build_model(cfg, device="meta", dtype=dtype, **remat)


def cache_specs(model, cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The decode cache of a model on the meta device, by its own
    ``init_cache``."""
    return model.init_cache(batch, max_len, dtype)


def paged_cache_specs(model, cfg: ModelConfig, batch: int, max_len: int, block_size: int,
                      n_blocks: int, dtype=torch.bfloat16):
    """The paged decode cache of a model on the meta device and the (B,
    E) block-table stand-in, E = ceil(max_len / block_size)."""
    cache = model.init_paged_cache(batch, n_blocks, block_size, dtype)
    entries = -(-max_len // block_size)
    return cache, _meta((batch, max(entries, 1)), torch.int32)
