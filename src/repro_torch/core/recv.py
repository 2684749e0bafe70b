"""The single recv-side unpack site (port of ``src/repro/core/recv.py``):
one fused ``recv_unpack`` pass through a slot map, dequantizing an fp8
payload in the same pass."""
from __future__ import annotations

import torch

from repro_torch.core import slots as S
from repro_torch.kernels import ops as K


def unpack_recv(recv: torch.Tensor, gmap: torch.Tensor,
                scales: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """recv: [..., H] received blocks (leading dims collapse to the rows the
    map addresses); gmap: int32 map of any shape; scales: [..., H/block] for
    an fp8 payload. Returns gmap.shape + (H,)."""
    s_flat = S.flat_rows(scales) if scales is not None else None
    return K.recv_unpack(S.flat_rows(recv), gmap, s_flat, out_dtype)
