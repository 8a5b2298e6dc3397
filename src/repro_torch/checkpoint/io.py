"""Versioned checkpointing, in the format of ``repro/checkpoint/io.py``:
one ``np.savez`` archive of flat '/'-joined keys, ``p:<name>`` for the
weights and ``o:<name>`` for the optimizer state, plus a JSON sidecar at
``path + ".meta.json"`` (policy version, step, ...).

The port's weights are a state dict, so a weight's key is its state-dict
name (``p:blocks.0.attn.wq``); the optimizer state ({"m": [...], "v":
[...], "step": n}) flattens by dict key and list index (``o:m/0``).
bf16 is written as f32, as the reference writes every dtype numpy lacks,
and restored to the dtype of the ``like`` template on load.

``load_reference`` reads a checkpoint that the JAX reference wrote
(``p:units/0/attn/wq``: layers stacked on a leading axis) into the
port's model (``LM`` or ``EncDecLM``) through ``models/convert.py::params_from_jax``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: str = ""):
    """(key, leaf) of a nested dict / list, '/'-joined keys."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def to_host(tree) -> Dict[str, np.ndarray]:
    """Every leaf as a numpy array under its flat key: tensors copied to
    the host (bf16 widened to f32: numpy has no bf16), scalars as 0-d
    arrays."""
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            flat[key] = t.to("cpu", copy=True).numpy()
        else:
            flat[key] = np.asarray(leaf)
    return flat


def save(path: str, weights, *, opt_state=None, meta: Optional[Dict] = None) -> None:
    """Write ``weights`` (a state dict, an ``LM``, or a host copy from
    ``to_host``) and optionally ``opt_state`` to ``path`` (an ``.npz``),
    and ``meta`` to ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"p:{k}": v for k, v in to_host(weights).items()}
    if opt_state is not None:
        arrays.update({f"o:{k}": v for k, v in to_host(opt_state).items()})
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f, indent=2)


def _open(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return np.load(path), meta


def _restore(like, data, tag: str, prefix: str = ""):
    """``like``'s structure, each tensor leaf read from ``data`` and cast
    to the dtype and device of the leaf it replaces."""
    if isinstance(like, torch.nn.Module):
        like = like.state_dict()
    if isinstance(like, dict):
        return {k: _restore(v, data, tag, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, list):
        return [_restore(v, data, tag, f"{prefix}{i}/") for i, v in enumerate(like)]
    arr = data[f"{tag}:{prefix[:-1]}"]
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr)).reshape(like.shape)
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(arr.item())                      # a scalar, e.g. the step


def load(path: str, like, opt_state_like=None) -> Tuple[Dict[str, torch.Tensor], Any, Dict]:
    """(weights, opt_state, meta) of the checkpoint at ``path``, each
    shaped like its template: ``like`` a state dict or an ``LM`` (the
    weights come back as a state dict), ``opt_state_like`` an optimizer
    state or None."""
    data, meta = _open(path)
    weights = _restore(like, data, "p")
    opt_state = _restore(opt_state_like, data, "o") if opt_state_like is not None else None
    return weights, opt_state, meta


def load_reference(path: str, cfg, *, device="cuda", dtype: torch.dtype = torch.float32):
    """(the model, meta) from a checkpoint that the JAX reference's
    ``repro.checkpoint.save`` wrote: its ``p:`` leaves, in the
    reference's tree paths, go through ``params_from_jax``."""
    from repro_torch.models.convert import params_from_jax

    data, meta = _open(path)
    flat = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
    return params_from_jax(cfg, flat, device=device, dtype=dtype), meta
