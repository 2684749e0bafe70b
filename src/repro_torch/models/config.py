"""Architecture configuration schema (port of ``src/repro/models/config.py``)
with torch dtypes, plus ``ParamSpec``, the shape/dtype/initializer of one
parameter (``src/repro/parallel/sharding.py:ParamSpec`` without the sharding
axes, which the port has no use for yet)."""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + initializer for one parameter."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"       # normal | zeros | ones | embed
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv: int
    head_dim: int
    kind: Literal["gqa", "mla"] = "gqa"
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    window: int | None = None
    qk_norm: bool = False
    logit_softcap: float | None = None
    kv_chunk: int = 1024
    decode_kv_splits: int = 4


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0
    first_k_dense: int = 0
    gating: Literal["softmax", "sigmoid"] = "softmax"
    n_groups: int = 1
    topk_groups: int = 1
    use_selection_bias: bool = False
    routed_scaling: float = 1.0
    norm_topk: bool = True
    aux_loss_weight: float = 1e-3
    # --- EP communication (the paper's knobs) ---
    ep_mode: Literal["ll", "ht", "baseline", "auto"] = "auto"
    ll_layout: Literal["nccl_ep", "deepep"] = "nccl_ep"
    ep_axis: tuple[str, ...] = ("model",)
    capacity_factor: float | None = 1.25
    expert_capacity_factor: float | None = 1.25
    ht_hierarchical: bool = False
    ht_num_chunks: int = 1
    quantize_dispatch: bool = False
    # --- EPLB (ROADMAP A10: only the defaults are ported) ---
    placement: object | None = None
    params_physical: bool = False
    track_expert_heat: bool = False


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["lm", "gemma3", "hybrid", "ssm", "encdec", "vlm"]
    num_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnSpec | None = None
    mla: MLASpec | None = None
    moe: MoESpec | None = None
    ssm: object | None = None
    local_global: tuple[int, int] | None = None
    local_window: int = 1024
    shared_attn_period: int | None = None
    enc_layers: int = 0
    dec_layers: int = 0
    cross_attn: bool = False
    src_len: int = 4096
    img_tokens: int = 0
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    mtp: bool = False
    remat: bool = True
    microbatch: int = 1

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def padded_heads(self, multiple: int = 16) -> int:
        n = self.attn.n_heads if self.attn else 0
        return ((n + multiple - 1) // multiple) * multiple
