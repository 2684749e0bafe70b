"""Decoder LM, family ``lm`` (port of the training/prefill forward and the
dense and paged decode paths of ``src/repro/models/transformer.py``): GQA or
MLA attention, dense or MoE FFNs, an optional dense prefix
(``MoESpec.first_k_dense``) and DeepSeek-V3's depth-1 multi-token
prediction (MTP) term in the forward.

Parameters keep the JAX layout: per-layer trees stacked along a leading
[n_layers] axis in ``dense_stack`` and ``moe_stack`` (the expert-stacked
MoE weights [n_moe, rows, ...], rows logical E or, under
``MoESpec.params_physical``, the placement's slots). The layer stack is a
Python loop over those slices (JAX scans it, with remat for training; the
port's forward has no backward yet, so it keeps nothing to recompute).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as ATT
from repro_torch.models import kv_pages as KVP
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig, ParamSpec
from repro_torch.models.layers import (cross_entropy_sum, embed_lookup, embed_spec,
                                       ffn_apply, ffn_spec, logits_out, mean_of_sum,
                                       rmsnorm, rmsnorm_spec)


def _stack_sizes(cfg: ArchConfig) -> tuple[int, int]:
    n_dense = cfg.moe.first_k_dense if cfg.moe else cfg.num_layers
    n_moe = cfg.num_layers - n_dense if cfg.moe else 0
    return n_dense, n_moe


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what this slice does not port."""
    if cfg.family != "lm":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP A12)")
    if cfg.attn is None:
        raise NotImplementedError("an lm without attention is not ported")
    if _is_mla(cfg) and cfg.mla is None:
        raise ValueError("attention kind 'mla' needs ArchConfig.mla")


def _is_mla(cfg: ArchConfig) -> bool:
    return cfg.attn is not None and cfg.attn.kind == "mla"


def layer_spec(cfg: ArchConfig, *, moe_layer: bool):
    sp = dict(ln1=rmsnorm_spec(cfg.d_model, cfg.dtype),
              ln2=rmsnorm_spec(cfg.d_model, cfg.dtype),
              attn=MLA.mla_spec(cfg) if _is_mla(cfg) else ATT.attn_spec(cfg))
    if moe_layer:
        sp["moe"] = MOE.moe_spec(cfg)
    else:
        sp["ffn"] = ffn_spec(cfg.d_model, cfg.d_ff, cfg.dtype, cfg.act)
    return sp


def _stack(specs, n: int):
    """Stack a layer's ParamSpec tree n times along a leading axis."""
    if isinstance(specs, dict):
        return {k: _stack(v, n) for k, v in specs.items()}
    axes = None if specs.axes is None else ("stack",) + tuple(specs.axes)
    return ParamSpec((n,) + specs.shape, specs.dtype, specs.init, specs.scale, axes)


def lm_spec(cfg: ArchConfig):
    n_dense, n_moe = _stack_sizes(cfg)
    sp = dict(embed=embed_spec(cfg.padded_vocab(), cfg.d_model, cfg.dtype),
              ln_f=rmsnorm_spec(cfg.d_model, cfg.dtype))
    if n_dense:
        sp["dense_stack"] = _stack(layer_spec(cfg, moe_layer=False), n_dense)
    if n_moe:
        sp["moe_stack"] = _stack(layer_spec(cfg, moe_layer=True), n_moe)
    if not cfg.tie_embeddings:
        sp["lm_head"] = embed_spec(cfg.padded_vocab(), cfg.d_model, cfg.dtype)
    if cfg.mtp:         # DeepSeek-V3 multi-token prediction: one depth-1 layer
        sp["mtp_layer"] = layer_spec(cfg, moe_layer=bool(cfg.moe))
        sp["mtp_proj"] = ParamSpec((2 * cfg.d_model, cfg.d_model), cfg.dtype)
        sp["mtp_ln"] = rmsnorm_spec(cfg.d_model, cfg.dtype)
    return sp


def lm_decode_state_spec(cfg: ArchConfig, batch: int, max_len: int):
    """{stack: {array: ParamSpec}} per layer stack: {"k", "v"} [n, B,
    S_max, n_kv, hd] for GQA, {"ckv", "krope"} [n, B, S_max, r_kv / rope]
    for MLA."""
    if _is_mla(cfg):
        one = MLA.mla_cache_spec(cfg, batch, max_len)
    else:
        shape = ATT.kv_cache_shape(cfg, batch, max_len)
        one = {kv: ParamSpec(shape, cfg.dtype, init="zeros") for kv in ("k", "v")}
    return {name: _stack(one, n)
            for name, n in zip(("dense", "moe"), _stack_sizes(cfg)) if n}


def tracks_heat(cfg: ArchConfig) -> bool:
    """Whether the decode states of ``cfg`` carry ``expert_heat``."""
    return bool(cfg.moe and cfg.moe.track_expert_heat and _stack_sizes(cfg)[1])


def _with_heat(cfg: ArchConfig, state: dict, device: torch.device) -> dict:
    """``state`` plus, under ``track_expert_heat``, ``expert_heat``: [E] f32
    per-logical-expert routed tokens summed over the MoE layers and the
    steps, in both weight layouts (the rebalancer reasons about logical
    experts, so an adoption never invalidates the state). The steps add to
    it in place, so a replayed graph advances it."""
    if tracks_heat(cfg):
        state["expert_heat"] = torch.zeros((cfg.moe.num_experts,), dtype=torch.float32,
                                           device=device)
    return state


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: torch.device):
    """Zeroed stacked caches, one per layer stack (a KVCache, or an
    MLACache for MLA), each with its filled length as a 0-dim int32 tensor
    on ``device``; and ``expert_heat`` when the config tracks it."""
    cache = MLA.MLACache if _is_mla(cfg) else ATT.KVCache
    return _with_heat(cfg, {
        name: cache(**{k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                       for k, s in arrays.items()},
                    length=torch.zeros((), dtype=torch.int32, device=device))
        for name, arrays in lm_decode_state_spec(cfg, batch, max_len).items()}, device)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_cache(stacked, i: int):
    """Layer i's view of a stacked KVCache or MLACache, sharing its length."""
    return type(stacked)(**{f.name: getattr(stacked, f.name)[i]
                            for f in dataclasses.fields(stacked) if f.name != "length"},
                         length=stacked.length)


def _ffn_half(p, x, cfg: ArchConfig, comm, heat=None):
    """The second half of a layer: x + FFN or MoE of its norm -> (x, aux).
    ``heat``, an [E] f32 counter, gets the MoE layer's routed tokens added
    in place."""
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        if heat is None:
            f, aux = MOE.moe_block(p["moe"], h, cfg, comm)
        else:
            f, aux, hh = MOE.moe_block(p["moe"], h, cfg, comm, with_heat=True)
            heat.add_(hh)
    else:
        f, aux = ffn_apply(p["ffn"], h, cfg.act), torch.zeros((), device=x.device)
    return x + f, aux


def layer_apply(p, x, cfg: ArchConfig, comm, *, cache=None, heat=None):
    """One decoder layer -> (x, new_cache, aux); without a cache it attends
    over x itself and new_cache is None. ``heat`` as in ``_ffn_half``."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if _is_mla(cfg):
        a, new_cache = MLA.mla_attention(p["attn"], h, cfg, cache=cache)
    else:
        a, new_cache = ATT.attention(p["attn"], h, cfg, cache=cache)
    x, aux = _ffn_half(p, x + a, cfg, comm, heat)
    return x, new_cache, aux


def paged_layer_apply(p, x, cfg: ArchConfig, comm, pool, page_tbl, kv_lens,
                      active, *, num_kv_splits: int, heat=None):
    """layer_apply's paged twin: attention against the paged KV pool, the
    FFN/MoE half the same -> (x, pool, aux)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    attend = MLA.paged_mla_attention if _is_mla(cfg) else ATT.paged_attention
    a, pool = attend(p["attn"], h, cfg, pool, page_tbl, kv_lens, active,
                     num_kv_splits=num_kv_splits)
    x, aux = _ffn_half(p, x + a, cfg, comm, heat)
    return x, pool, aux


def _stack_apply(x, stack, cfg: ArchConfig, comm):
    """Every layer of a stacked parameter tree in order, without caches
    (JAX: ``_scan_stack``) -> (x, the layers' summed aux)."""
    aux = torch.zeros((), device=x.device)
    for i in range(stack["ln1"].shape[0]):
        x, _, a = layer_apply(_index(stack, i), x, cfg, comm)
        aux = aux + a
    return x, aux


def lm_forward(params, batch, cfg: ArchConfig, comm):
    """Training/prefill forward. batch: {tokens [B, S], optional targets
    [B, S] (default: tokens shifted left, wrapping), optional loss_mask
    [B, S]}. Returns (loss, {"aux": aux}): the mean next-token cross-entropy
    plus the MoE layers' router aux and z losses, and with ``cfg.mtp`` 0.3
    times the MTP layer's cross-entropy against the token after next (that
    layer's aux added to the aux).

    Over a ``DistComm``, ``batch`` holds this process's rows
    (``comm.batch_rows``) and the returned values are the reference's
    global ones: each cross-entropy's (sum, count) is summed over the
    processes that hold other rows (masked rows count as the mask says),
    and each MoE layer's aux is already its mean over the token ranks."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens)
    aux = torch.zeros((), device=x.device)
    for name in ("dense", "moe"):
        if f"{name}_stack" in params:
            x, a = _stack_apply(x, params[f"{name}_stack"], cfg, comm)
            aux = aux + a
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = _head_table(params, cfg)
    targets = batch.get("targets")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = batch.get("loss_mask")

    def ce(logits, tg):
        sc = cross_entropy_sum(logits, tg, mask)
        return mean_of_sum(sc if comm is None else comm.sum_over_batch(sc))

    loss = ce(logits_out(x, head), targets)
    if cfg.mtp:
        # depth-1 MTP: predict t+2 from [h_t ; emb(t+1)]
        nxt = embed_lookup(params["embed"], targets)
        h2 = torch.cat([x, nxt], dim=-1) @ params["mtp_proj"]
        h2 = rmsnorm(h2, params["mtp_ln"], cfg.norm_eps)
        h2, _, a2 = layer_apply(params["mtp_layer"], h2, cfg, comm)
        aux = aux + a2
        t2 = torch.cat([targets[:, 1:], targets[:, :1]], dim=1)
        loss = loss + 0.3 * ce(logits_out(h2, head), t2)
    return loss + aux, dict(aux=aux)


def lm_decode_step(params, state, batch, cfg: ArchConfig, comm):
    """One decode step. batch: {tokens [B, 1]} -> (logits [B, 1, V], state).
    The caches in ``state`` are written in place and their lengths advanced
    in place after the last layer (every layer of a stack reads the same
    start), so the returned state is ``state``, its tensors the same
    objects: what a captured step needs (JAX donates the state instead).
    ``state["expert_heat"]``, where present, gets each MoE layer's routed
    tokens added in place."""
    x = embed_lookup(params["embed"], batch["tokens"])
    new_lens = {}
    heat = state.get("expert_heat")
    for name in ("dense", "moe"):
        if name not in state:
            continue
        st, stack = state[name], params[f"{name}_stack"]
        for i in range(stack["ln1"].shape[0]):
            x, c, _ = layer_apply(_index(stack, i), x, cfg, comm,
                                  cache=_layer_cache(st, i), heat=heat)
        new_lens[name] = c.length
    for name, n in new_lens.items():
        state[name].length.copy_(n)
    return _head(params, x, cfg), state


def _head_table(params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _head(params, x, cfg: ArchConfig):
    return logits_out(rmsnorm(x, params["ln_f"], cfg.norm_eps), _head_table(params, cfg))


def lm_paged_decode_state_spec(cfg: ArchConfig, num_pages: int, page_size: int):
    """Paged twin of lm_decode_state_spec: {stack: {pool: ParamSpec}}, {"k",
    "v"} [n, P+1, page, n_kv, hd] for GQA, {"kv"} [n, P+1, page, 1,
    r_kv+rope] for MLA. The page table, lengths and active mask are not
    device state: the scheduler builds them on the host each step."""
    mk = KVP.paged_mla_pool_spec if _is_mla(cfg) else KVP.paged_kv_pool_spec
    pool = mk(cfg, num_pages, page_size)
    return {name: _stack(pool, n)
            for name, n in zip(("dense", "moe"), _stack_sizes(cfg)) if n}


def init_paged_decode_state(cfg: ArchConfig, num_pages: int, page_size: int,
                            device: torch.device):
    """Zeroed stacked page pools on ``device``, one dict of pools per stack,
    and ``expert_heat`` when the config tracks it."""
    return _with_heat(cfg, {
        name: {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
               for k, s in pools.items()}
        for name, pools in lm_paged_decode_state_spec(cfg, num_pages, page_size).items()},
        device)


def _decode_splits(cfg: ArchConfig, max_pages: int) -> int:
    """Largest split count <= AttnSpec.decode_kv_splits dividing the page
    table's width."""
    s = max(min(cfg.attn.decode_kv_splits, max_pages), 1)
    while max_pages % s:
        s -= 1
    return s


def lm_paged_decode_step(params, state, batch, cfg: ArchConfig, comm):
    """One paged decode step. batch: {tokens [B, 1], page_tbl [B, max_pages],
    kv_lens [B], active [B]}, int32 on the device -> (logits [B, 1, V],
    state). The pools in ``state`` are written in place. Idle rows (active
    0, all-pad tables) write into the pad page and attend over nothing; the
    scheduler discards their logits, and no live row can see them."""
    x = embed_lookup(params["embed"], batch["tokens"])
    tbl, lens, act = batch["page_tbl"], batch["kv_lens"], batch["active"]
    splits = _decode_splits(cfg, tbl.shape[1])
    heat = state.get("expert_heat")
    for name in ("dense", "moe"):
        if name not in state:
            continue
        pools, stack = state[name], params[f"{name}_stack"]
        for i in range(stack["ln1"].shape[0]):
            x, _, _ = paged_layer_apply(_index(stack, i), x, cfg, comm,
                                        _index(pools, i), tbl, lens, act,
                                        num_kv_splits=splits, heat=heat)
    return _head(params, x, cfg), state
