"""Disaggregated generation/training placement, after
``repro/launch/disaggregated.py``.

The paper decouples rollout and trainer workers onto disjoint GPU pools
(Sec 4, Sec 7.1: 75/25 inference/training).  Here the pool is the CUDA
devices of one host: ``split_devices`` gives the rollout engine and the
trainer their own lists, ``push_weights`` copies a published state dict
onto the rollout device (the analogue of AReaL's parameter push over
NVLink), and trajectories flow rollout -> trainer on the host (the
replay buffer is host memory, as in the paper).  With one card both
roles share it, each thread on its own CUDA stream
(``core/runtime.py``).

``host_weights`` (kept in ``core/weights.py`` beside the codecs that
own its format) and ``stream_weights`` are the host-side forms of a
publication: a state dict as numpy arrays, and its chunked delta stream.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.weights import encode_stream, host_weights

__all__ = ["host_weights", "push_weights", "split_devices", "stream_weights"]


def split_devices(train_fraction: float = 0.25,
                  devices: Optional[Sequence] = None) -> Tuple[List[torch.device],
                                                               List[torch.device]]:
    """Partition the device pool into (rollout devices, trainer devices):
    the first ``n - n_train`` for rollout, the rest for the trainer, with
    ``n_train = max(1, round(n * train_fraction))``.  ``devices``
    defaults to every visible CUDA device; a pure function of that list."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    n_train = max(1, int(round(n * train_fraction)))
    n_roll = n - n_train
    if n_roll <= 0:
        raise ValueError(f"a pool of {n} device(s) is too small to split at "
                         f"train_fraction={train_fraction}")
    return devices[:n_roll], devices[n_roll:]


def stream_weights(weights, *, version: int, base=None, base_version=None,
                   encoding: str = "delta", chunk_elems: int = 65536):
    """Streaming form of the trainer→rollout publication (DESIGN.md
    §Streaming weight publication, §Chunk framing): device→host copy of
    the state dict plus delta encoding against ``base`` — the previous
    published HOST tree — framed as a ``WeightStream`` of chunk
    messages.  Returns ``(host_tree, stream)``; the caller keeps
    ``host_tree`` as the next publication's base and ships the stream's
    messages to the rollout side (``ThreadedRuntime``'s queue).  With
    ``base=None`` (first publication) the stream falls back to
    base-free ``full`` chunks."""
    host = host_weights(weights)
    stream = encode_stream(host, version=version, base=base, base_version=base_version,
                           encoding=encoding, chunk_elems=chunk_elems)
    return host, stream


def push_weights(weights, device) -> Dict[str, torch.Tensor]:
    """Trainer -> rollout weight publication across cards: a copy of the
    state dict (or an ``LM``'s) on the rollout ``device``, made on the
    calling (trainer) thread, off the generation path.  Used only when
    the engine and the trainer are on different cards."""
    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    device = torch.device(device)
    with torch.no_grad():
        return {name: t.detach().to(device, copy=True) for name, t in weights.items()}
