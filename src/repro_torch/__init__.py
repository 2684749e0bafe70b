"""repro_torch: the PyTorch/CUDA port of the NCCL EP reproduction.

It sits beside the JAX package ``repro``, which stays the reference; it
imports torch and numpy and nothing of JAX or ``repro``. It covers the LL
(low-latency) expert-parallel decode path served by
``runtime.server.DecodeServer``, with its four EP kernels hand-written for
Hopper, and continuous batching over paged KV served by
``runtime.server.ContinuousDecodeServer``, with its split-KV paged decode
attention hand-written for Hopper, and the HT-mode prefill forward
``models.get_model(cfg).forward``, with its flash attention hand-written for
Hopper (``kernels/``, sources in ``csrc/``). On the card both servers step
through a CUDA graph captured once (``runtime.steps.CompiledStep``). The
model stack covers GQA (DBRX-132B) and DeepSeek-V3's Multi-head Latent
Attention (``models/mla.py``), whose paged decode runs the same paged
kernel over one shared latent pool.
"""
from repro_torch.device import disable_tf32, resolve_device  # noqa: F401
