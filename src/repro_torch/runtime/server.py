"""Decode serving loop (port of ``DecodeServer`` in
``src/repro/runtime/server.py``): batched greedy decoding against dense KV
caches, with the serving metrics of the paper's Table VII (output tok/s,
TTFT, ITL).

The EP ranks of the MoE layers are hosted in this process by a
``LocalComm(ep_size)``; with ``ep_size=1`` the MoE layers take the dense
reference path, as the JAX server does off-mesh. The clock stops after
``torch.cuda.synchronize()`` where the JAX server calls
``block_until_ready``. EPLB, fault tolerance, preemption, telemetry and
``pipeline_depth > 1`` are not ported yet (ROADMAP A6, A9, A10).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.comm import LocalComm
from repro_torch.device import disable_tf32, resolve_device, synchronize
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (check_supported, init_decode_state,
                                            lm_decode_step)
from repro_torch.weights import init_params


@dataclasses.dataclass
class ServeMetrics:
    ttft_s: float
    itl_mean_s: float
    itl_p99_s: float
    output_tok_s: float
    total_tokens: int

    def as_dict(self):
        return dataclasses.asdict(self)


class DecodeServer:
    def __init__(self, cfg: ArchConfig, batch: int, max_len: int, *,
                 ep_size: int = 1, params=None, seed: int = 0, device=None,
                 pipeline_depth: int = 1):
        if pipeline_depth != 1:
            raise NotImplementedError("pipelined decode (pipeline_depth > 1) "
                                      "is not ported yet (ROADMAP A6)")
        check_supported(cfg)
        self.device = resolve_device(device)
        disable_tf32()                    # the router matmul stays full f32
        self.cfg, self.batch = cfg, batch
        self.comm = LocalComm(ep_size) if ep_size > 1 else None
        if self.comm is not None and batch % ep_size:
            raise ValueError(f"batch {batch} must divide by ep_size {ep_size}")
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params)
        self.state = init_decode_state(cfg, batch, max_len, self.device)
        self.last_tokens: np.ndarray | None = None

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One greedy decode step: [B, 1] tokens in, [B, 1] next tokens out."""
        logits, self.state = lm_decode_step(self.params, self.state,
                                            {"tokens": tokens}, self.cfg,
                                            self.comm)
        return logits[:, -1, :self.cfg.vocab].argmax(-1).to(torch.int32)[:, None]

    def prefill(self, prompts):
        """Token-by-token prefill through the decode step (as the JAX
        harness does). Returns (first generated token [B, 1], seconds)."""
        prompts = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        tok = None
        for i in range(prompts.shape[1]):
            tok = self.step(prompts[:, i:i + 1])
        synchronize(self.device)
        return tok, time.perf_counter() - t0

    def decode(self, first_tok: torch.Tensor, steps: int):
        """``steps`` greedy steps. Returns (tokens [B, steps+1] numpy, the
        first token included, and the per-step latencies in seconds)."""
        tok = first_tok
        outs, itls = [tok], []
        for _ in range(steps):
            t0 = time.perf_counter()
            tok = self.step(tok)
            synchronize(self.device)
            itls.append(time.perf_counter() - t0)
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy(), np.asarray(itls)

    def serve(self, prompts, gen_steps: int) -> ServeMetrics:
        first, ttft = self.prefill(prompts)
        t0 = time.perf_counter()
        toks, itls = self.decode(first, gen_steps)
        decode_wall = time.perf_counter() - t0
        self.last_tokens = toks           # [B, gen_steps+1] generated stream
        total = toks.shape[0] * toks.shape[1]
        return ServeMetrics(
            ttft_s=ttft, itl_mean_s=float(itls.mean()),
            itl_p99_s=float(np.percentile(itls, 99)),
            output_tok_s=total / (ttft + decode_wall), total_tokens=total)
