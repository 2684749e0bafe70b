"""EpGroup / EpHandle: the two-tier resources (port of
``src/repro/core/group.py``).

``EpGroup`` is long-lived: mode, expert count, capacities (buffer sizes) and
the communicator, created once per model by ``ep_create_group`` (the
analogue of ``ncclEpCreateGroup``, which also takes a communicator).
``EpHandle`` is per forward pass and per rank: the rank's routing, the
gathered routing of the whole group and the precomputed slot maps.

All capacities are static, computed exactly as in the JAX package
(``slot_align=8`` included) so every buffer has the reference's shape.
``capacity_factor=None`` means zero-drop sizing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EpGroupConfig:
    """User-facing configuration (``ncclEpGroupConfig_t``)."""

    num_experts: int
    max_tokens_per_rank: int                  # B_cap: per-EP-rank token budget
    hidden: int
    top_k: int
    mode: Literal["ll", "ht", "baseline", "auto"] = "auto"
    ll_layout: Literal["nccl_ep", "deepep"] = "nccl_ep"
    capacity_factor: float | None = None      # None = zero-drop capacities
    # LL 3D expert-region factor; None = num_ranks * max_tokens_per_rank rows
    expert_capacity_factor: float | None = None
    payload_dtype: torch.dtype = torch.bfloat16
    quantize_dispatch: bool = False           # fp8 payload + f32 scales
    quant_block: int = 128
    # HT hierarchy: the EP mesh's axes, outermost ("pod") first; with more
    # than one axis and ``ht_hierarchical`` HT runs two stages, the inner
    # axis's exchange then the outer's. Otherwise HT is flat over all ranks.
    ep_axis: tuple[str, ...] = ("data",)
    ht_hierarchical: bool = False
    # chunks of the hierarchical pipeline: the token dim splits into this
    # many static slices that stream through the two stages (1 = monolithic;
    # bitwise equal for any value at zero-drop capacities)
    ht_num_chunks: int = 1
    # EPLB placement and fault domains come with ROADMAP A10; only None
    placement: object | None = None
    num_redundant_experts: int = 0
    fault_domains: object | None = None
    slot_align: int = 8

    LL_BATCH_THRESHOLD = 128  # paper: LL targets 1-128 tokens/rank

    def resolved_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        return "ll" if self.max_tokens_per_rank <= self.LL_BATCH_THRESHOLD else "ht"


@dataclasses.dataclass(frozen=True)
class EpGroup:
    """Resolved, validated group."""

    cfg: EpGroupConfig
    ep_size: int                 # N: total EP ranks
    local_experts: int           # L = E / N
    ll_disp_cap: int             # C_d: slots per (src, dst) pair, dispatch
    ll_comb_cap: int             # C_c: slots per (src, dst) pair, combine
    ll_expert_cap: int           # A: rows per local expert in the 3D output
    ht_pair_cap: int
    ht_expert_cap: int
    ht_stage1_cap: int
    ht_stage2_cap: int
    inner_size: int
    outer_size: int
    comm: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def mode(self) -> str:
        return self.cfg.resolved_mode()

    @property
    def placement_salt(self) -> int:
        """Placement fingerprint mixed into the routing hash: 0 for the
        contiguous layout, the only one this slice has."""
        return 0

    @property
    def hierarchical(self) -> bool:
        """Whether HT takes the two-stage path: asked for, over more than
        one EP axis, across more than one pod (``src/repro/core/ht.py
        _hierarchical``)."""
        return (self.mode == "ht" and self.cfg.ht_hierarchical
                and len(self.cfg.ep_axis) > 1 and self.outer_size > 1)

    def ht_chunks(self, num_tokens: int) -> int:
        """Static chunk count for a ``num_tokens``-token hierarchical handle
        (the handle may carry fewer tokens than ``max_tokens_per_rank``, but
        the chunk grid must still tile it exactly)."""
        nc = self.cfg.ht_num_chunks
        if num_tokens % nc != 0:
            raise ValueError(f"ht_num_chunks={nc} must divide the handle's "
                             f"token count {num_tokens}")
        return nc

    # ---- buffer byte accounting (the paper's Eq. 3) ----
    def payload_bytes_per_token(self) -> int:
        """Bytes one dispatched token takes: fp8 plus an f32 scale per
        ``quant_block`` when quantizing, else the payload dtype's size."""
        h = self.cfg.hidden
        if self.cfg.quantize_dispatch:
            return h + 4 * math.ceil(h / self.cfg.quant_block)
        return h * self.cfg.payload_dtype.itemsize

    def ll_dispatch_buffer_bytes(self) -> int:
        return self.ep_size * self.ll_disp_cap * self.payload_bytes_per_token()

    def ll_combine_buffer_bytes(self) -> int:
        return self.ep_size * self.ll_comb_cap * self.cfg.hidden * self.cfg.payload_dtype.itemsize


def ep_create_group(cfg: EpGroupConfig, comm=None, *, ep_size: int | None = None,
                    inner_size: int | None = None) -> EpGroup:
    """Create the long-lived group over ``comm`` (its rank count is the EP
    size, its innermost axis the pod unless ``inner_size`` says otherwise),
    or over an explicit ``ep_size`` for capacity arithmetic alone. The
    hierarchical path exchanges over the communicator's axes, so they must
    be ``cfg.ep_axis`` with the pod of ``inner_size`` ranks innermost."""
    if cfg.placement is not None or cfg.fault_domains is not None \
            or cfg.num_redundant_experts:
        raise NotImplementedError(
            "EPLB placement, redundant experts and fault domains are not "
            "ported yet (ROADMAP A10)")
    if comm is not None:
        if ep_size is not None and ep_size != comm.size:
            raise ValueError(f"ep_size={ep_size} but the communicator has "
                             f"{comm.size} ranks")
        ep_size = comm.size
    if ep_size is None:
        raise ValueError("ep_create_group needs a communicator or ep_size")
    if inner_size is None:
        inner_size = ep_size if comm is None else comm.inner_size
    if inner_size < 1 or ep_size % inner_size:
        raise ValueError(f"inner_size={inner_size} must divide ep_size={ep_size}")
    outer_size = ep_size // inner_size

    E, K, B = cfg.num_experts, cfg.top_k, cfg.max_tokens_per_rank
    N = ep_size
    if E % N != 0:
        raise ValueError(f"num_experts={E} must divide by ep_size={N}")
    L = E // N
    cf = cfg.capacity_factor
    al = cfg.slot_align

    def cap(expected: float, zero_drop: int) -> int:
        if cf is None:
            return _round_up(zero_drop, al)
        return min(_round_up(max(int(math.ceil(cf * expected)), al), al),
                   _round_up(zero_drop, al))

    # LL: one send per destination rank, zero-drop bound B
    ll_disp_cap = cap(B * min(K, N) / N, B)
    # combine: one entry per owned (t, k), zero-drop bound B*min(K, L)
    ll_comb_cap = cap(B * K / N, B * min(K, L))
    ecf = cfg.expert_capacity_factor
    if ecf is None:
        ll_expert_cap = N * B
    else:
        ll_expert_cap = min(_round_up(int(math.ceil(ecf * N * B * K / E)), 128), N * B)

    ht_pair_cap = cap(B * K / N, B * min(K, L))
    if ecf is None:
        ht_expert_cap = _round_up(min(N * B, int(N * ht_pair_cap // max(L, 1)) or 1), 128)
        ht_expert_cap = max(ht_expert_cap, 128)
    else:
        ht_expert_cap = _round_up(int(math.ceil(ecf * N * B * K / E)), 128)
    nc = cfg.ht_num_chunks
    if nc < 1:
        raise ValueError(f"ht_num_chunks={nc} must be >= 1")
    if B % nc != 0:
        raise ValueError(f"ht_num_chunks={nc} must divide max_tokens_per_rank={B}")
    Bc = B // nc
    ki = min(K, inner_size)
    ht_stage1_cap = cap(Bc * ki / inner_size, Bc)
    ko = min(K, outer_size) if outer_size > 1 else 1
    ht_stage2_cap = cap(inner_size * ht_stage1_cap * ko / max(outer_size, 1),
                        inner_size * ht_stage1_cap)

    group = EpGroup(
        cfg=cfg, ep_size=N, local_experts=L,
        ll_disp_cap=ll_disp_cap, ll_comb_cap=ll_comb_cap, ll_expert_cap=ll_expert_cap,
        ht_pair_cap=ht_pair_cap, ht_expert_cap=ht_expert_cap,
        ht_stage1_cap=ht_stage1_cap, ht_stage2_cap=ht_stage2_cap,
        inner_size=inner_size, outer_size=outer_size, comm=comm,
    )
    want = ((cfg.ep_axis[0], outer_size), (cfg.ep_axis[-1], inner_size))
    if group.hierarchical and comm is not None and comm.axes != want:
        raise ValueError(f"the hierarchical path over ep_axis={cfg.ep_axis} needs a "
                         f"communicator of {outer_size} pods of {inner_size} on "
                         f"those axes, got {comm.axes}")
    return group


@dataclasses.dataclass
class EpHandle:
    """One rank's per-forward-pass routing state (``ncclEpHandle_t``).

    ``plan`` holds every slot map of every phase, derived once at creation;
    ``routing_hash`` is the [2]-lane checksum of ``topk_global``, kept for
    the steady-state refresh path (``ep_handle_refresh``)."""

    rank: int                         # the EP rank this handle belongs to
    topk_idx: torch.Tensor            # [T, K] this rank's routing (padding -> E)
    topk_weights: torch.Tensor        # [T, K] combine weights
    topk_global: torch.Tensor         # [N, T, K] gathered routing
    tokens_per_expert: torch.Tensor   # [L] int32 received per local expert
    num_recv_tokens: torch.Tensor     # [] total received
    num_tokens: int                   # valid tokens on this rank (<= T)
    plan: object | None = None
    routing_hash: torch.Tensor | None = None


def ep_handle_get_num_recv_tokens(handle: EpHandle) -> torch.Tensor:
    """``ncclEpHandleGetNumRecvTokens``: the exact receive count, the
    handle's [] device tensor (never read back, so legal in a captured
    step)."""
    return handle.num_recv_tokens


def ep_handle_destroy(handle: EpHandle) -> None:
    """A no-op (the caching allocator owns the buffers); kept for API
    parity."""
    del handle
