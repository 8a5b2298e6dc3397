"""Load the JAX reference's parameter tree into the port's modules.

The tree arrives flat: a dict from '/'-joined paths to numpy arrays, the
key scheme of ``repro/core/weights.py::tree_items`` and
``repro/checkpoint/io.py``.  The reference stacks the repeating units'
leaves on a leading ``n_units`` axis (``units/<j>/attn/wq`` is
(n_units, d, q_dim)); each slice along it is one layer here.  Layer
``i`` is unit ``i // p`` at pattern position ``i % p`` (p = pattern
length), and the layers past ``n_units * p`` are ``rem/<j>``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import LM


def _jax_path(model: LM, name: str):
    """(path in the reference tree, unit index or None) of a parameter."""
    if not name.startswith("blocks."):
        return name.replace(".", "/"), None
    _, i, rest = name.split(".", 2)
    i = int(i)
    p = len(model.pattern)
    rest = rest.replace(".", "/")
    if i < model.n_units * p:
        return f"units/{i % p}/{rest}", i // p
    return f"rem/{i - model.n_units * p}/{rest}", None


def _as_float_array(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":        # ml_dtypes bfloat16 and the like
        a = a.astype(np.float32)
    return a


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, flat: Dict[str, np.ndarray], *, device="cuda",
                    dtype: Optional[torch.dtype] = torch.float32) -> LM:
    """A new ``LM`` holding the reference's weights.  Fails on any path it
    does not consume and on any parameter whose path is missing."""
    model = LM(cfg, device=device, dtype=dtype)
    used = set()
    for name, param in model.named_parameters():
        path, unit = _jax_path(model, name)
        if path not in flat:
            raise KeyError(f"no reference leaf {path!r} for parameter {name!r}")
        arr = _as_float_array(flat[path])
        if unit is not None:
            arr = arr[unit]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not fit {name} "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr)))     # a writable copy
        used.add(path)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"reference leaves not consumed: {extra}")
    return model
