"""PyTorch/CUDA port of the ISGD reproduction (``repro``), module for module.

``repro_torch.core.control`` mirrors ``repro.core.control`` and so on. The
port imports ``torch`` and numpy only, never ``jax`` and never ``repro``:
where it needs a jax-free module of the JAX package it keeps its own copy.
Kernels on the training path are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use (``kernels/build.py``).

Every entry point defaults to ``device="cuda"`` and raises when no CUDA
device is present, unless the caller passes ``device="cpu"`` explicitly.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
