"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """Return ``device`` as a ``torch.device``.  A CUDA device is the
    default of every entry point; asking for one where CUDA is absent is
    an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            # name the card, so that it compares equal to a tensor's device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
