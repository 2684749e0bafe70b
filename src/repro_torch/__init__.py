"""repro_torch: the PyTorch/CUDA port of the NCCL EP reproduction.

It sits beside the JAX package ``repro``, which stays the reference; it
imports torch and numpy and nothing of JAX or ``repro``. This slice covers
the LL (low-latency) expert-parallel decode path served by
``runtime.server.DecodeServer``, with its four EP kernels hand-written for
Hopper (``kernels/``, sources in ``csrc/``).
"""
from repro_torch.device import disable_tf32, resolve_device  # noqa: F401
