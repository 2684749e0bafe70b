"""The kernels on the training path as ``torch.autograd.Function``s.

A hand-written kernel records no autograd graph (it writes into a tensor
made with ``torch.empty`` through ``ctypes``), and the TPU kernels have no
backward of their own: the reference differentiates their plain forms by
AD. Each Function here runs its forward through the device-routed entry of
``kernels/ops.py`` and its backward through the entries of the transposes,
so the CPU tests run the same backward formulas, on the plain versions,
that run as kernels on the card:

* ``grouped_gemm``: dX = grouped_gemm(dY, Wᵀ) (B3 itself, over a contiguous
  [L, F, H] copy of the weights; rows past the counts come out zero) and
  dW = ``grouped_gemm_dw`` (the live rows of X and dY).
* ``flash_attention_bshd``: the forward also writes each row's
  log-sum-exp; the backward is the dQ and dK/dV kernel pair.

The entry points below always go through the Function: where no input
requires grad, ``apply`` records nothing and keeps nothing saved, so the
same kernels run with the same launches. The combine's gather-reduce is
differentiated inside the EP combine's Function (``core/ll.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as K


class GroupedGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return K.grouped_gemm(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = K.grouped_gemm(dy, w.transpose(1, 2).contiguous(), counts)
        if ctx.needs_input_grad[1]:
            dw = K.grouped_gemm_dw(x, dy, counts).to(w.dtype)
        return dx, dw, None


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``ops.grouped_gemm``, differentiable in x and w."""
    return GroupedGemm.apply(x, w, counts)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, window, causal):
        if not any(ctx.needs_input_grad[:3]):
            # nothing to differentiate: the forward without its row LSE
            return K.flash_attention_bshd(q, k, v, scale=scale, window=window, causal=causal)
        out, lse = K.flash_attention_fwd(q, k, v, scale=scale, window=window, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(scale=scale, window=window, causal=causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = K.flash_attention_bwd(q, k, v, out, do.to(q.dtype), lse, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, window: int | None = None,
                         causal: bool = True) -> torch.Tensor:
    """``ops.flash_attention_bshd``, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, scale, window, causal)
