"""flash_attention on Hopper: causal (optionally sliding-window) GQA
attention for forwards without a KV cache (prefill, training).

Replaces ``src/repro/kernels/flash_attention.py:86 flash_attention`` (Pallas,
KV tiles walked innermost with m, l and the accumulator in VMEM scratch,
fully masked tiles skipped). At prefill lengths it is bound by the tensor
cores. The kernel (``csrc/flash_attention.cu``) runs one block of 4 warps
per (batch, query head, 64-row query tile), heaviest causal tiles first,
keeps Q and the f32 accumulator in registers, streams 64-key K/V tiles
through a two-stage cp.async ring and multiplies with mma.sync (bf16 in,
f32 accumulate; the probabilities are rounded to bf16 for the PV product,
where the reference keeps them in f32). f32 inputs take a CUDA-core path
in exact f32. It reads q, k and v through their strides in the
``[B, S, H, d]`` layout the model gives, so it needs no transposes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches by this wrapper (chip_smoke reads it)

_DT = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, window: int | None = None,
                         causal: bool = True) -> torch.Tensor:
    """q [B, Sq, Hq, d], k/v [B, Sk, Hkv, d] on the card, bf16 or f32, d in
    (64, 128); returns [B, Sq, Hq, d]. The function of
    ``ref.flash_attention`` on the [B, H, S, d] transposes."""
    global launches
    name = "flash_attention"
    _build.check_cuda(name, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: want 4-d q and k/v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[-1] != d or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    dt = _build.dtype_code(name, q.dtype, _DT)
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported (takes {_HEAD_DIMS})")
    if not _build.aligned16(q, k, v):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be positive, got {window}")
    out = torch.empty_like(q)
    qs, ks = q.stride(), k.stride()
    # strides by (batch, head, seq), as the C entry takes them
    _build.launch("ep_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Hq, Hkv, Sq, Sk, d, qs[0], qs[2], qs[1],
                  ks[0], ks[2], ks[1], float(scale), int(window or 0),
                  int(causal), dt)
    launches += 1
    return out
