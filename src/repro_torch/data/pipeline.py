"""Deterministic, resumable synthetic token pipeline (port of
``src/repro/data/pipeline.py``).

Any step's batch is a pure function of (seed, step): the pipeline's state in
a checkpoint is two integers, and a restart resumes mid-epoch exactly. The
tokens are drawn from the reference's Zipf-like unigram (probability of
rank r proportional to r ** -1.1, normalised), so losses move like real
text's rather than uniform noise's.

The draws come from an explicit ``torch.Generator`` on the CPU, seeded from
(seed, step) (``step_seed``), then moved to the pipeline's device, so a
batch does not depend on the device either. torch cannot reproduce
``jax.random``'s threefry draws, so the two packages' batches differ for
the same (seed, step); tests that hold the port against the reference feed
both the reference's batches as numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    microbatch: int = 1
    seed: int = 0


def step_seed(seed: int, step: int) -> int:
    """The generator seed of batch ``step``: (seed, step) mixed into the 32
    bits that seed the CPU generator (splitmix64's finaliser over the pair
    packed into 64 bits)."""
    x = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 31)) & 0xFFFFFFFF


class DataPipeline:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.step = 0
        ranks = np.arange(1, cfg.vocab + 1)
        p = 1.0 / ranks ** 1.1
        self._probs = torch.from_numpy((p / p.sum()).astype(np.float32))

    def state(self) -> dict:
        return dict(step=self.step, seed=self.cfg.seed)

    def restore(self, state: dict):
        assert state["seed"] == self.cfg.seed, "seed mismatch on resume"
        self.step = int(state["step"])

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): {tokens, targets}, int32
        [microbatch, global_batch / microbatch, seq_len] on the device."""
        c = self.cfg
        g = max(c.microbatch, 1)
        gen = torch.Generator().manual_seed(step_seed(c.seed, step))
        shape = (g, c.global_batch // g, c.seq_len + 1)
        n = int(np.prod(shape))
        toks = torch.multinomial(self._probs, n, replacement=True, generator=gen)
        toks = toks.to(torch.int32).view(shape).to(self.device)
        return dict(tokens=toks[..., :-1], targets=toks[..., 1:])

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self):
        return self
