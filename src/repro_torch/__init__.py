"""PyTorch/CUDA port of the AReaL reproduction.

A package beside ``repro`` (the JAX reference) with the same layout:
``configs``, ``data``, ``core``, ``models`` and ``kernels``.  It imports
``torch`` and never ``jax`` or ``repro``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; kernels written for
Hopper (``csrc/``) run on CUDA tensors and their plain PyTorch versions
on CPU tensors.
"""
