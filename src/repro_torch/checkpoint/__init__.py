"""Checkpoints in the reference's format (``checkpoint/io.py``)."""
from repro_torch.checkpoint.io import load, load_reference, save, to_host

__all__ = ["load", "load_reference", "save", "to_host"]
