"""Model registry (port of ``src/repro/models/registry.py``): family ->
(params_spec, forward, decode_state_spec, decode_step, and the paged
decode pair where the family has one), for the families the port has:
``lm``, ``vlm`` (``lm``'s functions) and ``gemma3`` (no paged path, as in
the reference)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelFns:
    params_spec: Callable        # (cfg) -> ParamSpec tree
    forward: Callable            # (params, batch, cfg, comm) -> (loss, aux)
    decode_state_spec: Callable  # (cfg, batch, max_len) -> spec tree
    decode_step: Callable        # (params, state, batch, cfg, comm) -> (logits, state)
    paged_decode_state_spec: Callable | None = None  # (cfg, num_pages, page_size)
    paged_decode_step: Callable | None = None


_LM = ModelFns(T.lm_spec, T.lm_forward, T.lm_decode_state_spec, T.lm_decode_step,
               T.lm_paged_decode_state_spec, T.lm_paged_decode_step)
_REGISTRY = {
    "lm": _LM,
    "vlm": _LM,
    "gemma3": ModelFns(T.gemma3_spec, T.gemma3_forward, T.gemma3_decode_state_spec,
                       T.gemma3_decode_step),
}


def get_model(cfg: ArchConfig) -> ModelFns:
    """The family's functions; refuses what the port lacks
    (``transformer.check_supported``: a family's queue item, an attention
    the family cannot take)."""
    T.check_supported(cfg)
    return _REGISTRY[cfg.family]
