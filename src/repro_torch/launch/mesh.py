"""Production mesh description, the counterpart of ``repro/launch/mesh.py``.

A ``Mesh`` here is only its axis names and sizes: everything in ``dist/``
(the partition rules and the per-device shapes) reads nothing else, and
the port builds no sharded program yet, so no device is attached.

The reference lays its 256 and 512 devices out for TPU v5e pods: (16,
16) over ("data", "model") and (2, 16, 16) over ("pod", "data",
"model").  The port keeps the device counts and the axis names and lays
them out for HGX H100 nodes of 8 cards: (32, 8) over ("data", "model"),
and (2, 32, 8) over ("pod", "data", "model").
Tensor parallelism exchanges activations at every layer, so the "model"
axis belongs inside one node's NVLink domain (450 GB/s each way a card);
a 16-wide model axis, as on the v5e pod, would cross the nodes'
InfiniBand.  The data axes, whose gradient all-reduce comes once a step,
span the nodes.

Functions, not module constants, and nothing here touches device state
when it is imported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 32, 8))
    return Mesh(("data", "model"), (32, 8))


def make_host_mesh(model: int = 2, device="cuda") -> Mesh:
    """A (n // model, model) mesh over the local CUDA devices (one device
    for ``device="cpu"``), as the reference's over its local devices."""
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a "
                           "one-device mesh")
    model = min(model, n)
    return Mesh(("data", "model"), (n // model, model))
