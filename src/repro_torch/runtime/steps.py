"""Serve-step factories (port of ``make_serve_step`` and
``make_paged_serve_step`` in ``src/repro/runtime/steps.py``).

Both steps share one signature, (params, state, batch) -> (next tokens
[B, 1] int32, state), so the servers treat the dense and the paged engine
alike. PyTorch runs eagerly: the factories return plain functions, where
JAX jits them.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import lm_decode_step, lm_paged_decode_step


def _greedy(decode_step, cfg: ArchConfig, comm):
    def serve_step(params, state, batch):
        logits, state = decode_step(params, state, batch, cfg, comm)
        next_tok = logits[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)
        return next_tok[:, None], state

    return serve_step


def make_serve_step(cfg: ArchConfig, comm):
    """Greedy step over the dense KV caches. batch: {tokens [B, 1]}."""
    return _greedy(lm_decode_step, cfg, comm)


def make_paged_serve_step(cfg: ArchConfig, comm):
    """Greedy step over the paged pools. batch: {tokens [B, 1], page_tbl
    [B, max_pages], kv_lens [B], active [B]}."""
    return _greedy(lm_paged_decode_step, cfg, comm)
