"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper computes its plain version for a tensor on the CPU and, for a
CUDA tensor, launches its kernel (built from ``csrc/`` by ``build.py``) or
raises; on meta tensors it records its ``cost()`` (``repro_torch.analysis``)
and runs nothing. ``<wrapper>.launches`` counts kernel launches and nothing else, on
the host; ``launch_count`` also counts them on the device, where CUDA-graph
replays count too.
"""
KERNEL_CHOICES = ("cuda", "reference")
