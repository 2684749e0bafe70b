"""Decoder LMs (port of ``src/repro/models/transformer.py``), families
``lm``, ``vlm`` and ``gemma3``.

``lm``: the training/prefill forward and the dense and paged decode paths:
GQA or MLA attention, dense or MoE FFNs, an optional dense prefix
(``MoESpec.first_k_dense``) and DeepSeek-V3's depth-1 multi-token
prediction (MTP) term in the forward. ``vlm`` is ``lm`` whose forward takes
precomputed patch embeddings ``batch["img_embeds"]`` [B, P, D] in place of
the first P positions' token embeddings (the vision tower is a stub in the
reference too). ``gemma3``: super-blocks of ``local_global`` = (local,
global) layers and a tail of local layers; local layers attend within
``local_window`` keys, global ones causally; the embedding is scaled by
sqrt(d_model) rounded to the activation dtype; the head is tied. Its decode
state holds a ring KV cache of ``min(local_window, max_len)`` rows per
local layer (``_ring_local_decode``) and a linear one per global layer; it
has no paged path (nor has the reference).

Parameters keep the JAX layout: per-layer trees stacked along a leading
[n_layers] axis in ``dense_stack`` and ``moe_stack`` (the expert-stacked
MoE weights [n_moe, rows, ...], rows logical E or, under
``MoESpec.params_physical``, the placement's slots). The layer stack is a
Python loop over those slices (JAX scans it). The forward is
differentiable (training, ``runtime/steps.py make_train_step``): with
``cfg.remat`` and gradients on, each layer runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as JAX's
``_scan_stack`` wraps each layer in ``jax.checkpoint(nothing_saveable)``;
the head and the loss then run in recomputed blocks of rows
(``layers.head_cross_entropy_sum``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as ATT
from repro_torch.models import kv_pages as KVP
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig, ParamSpec
from repro_torch.models.layers import (apply_rope, cross_entropy_sum, embed_lookup,
                                       embed_spec, ffn_apply, ffn_spec,
                                       head_cross_entropy_sum, logits_out, mean_of_sum,
                                       rmsnorm, rmsnorm_spec)


def _stack_sizes(cfg: ArchConfig) -> tuple[int, int]:
    n_dense = cfg.moe.first_k_dense if cfg.moe else cfg.num_layers
    n_moe = cfg.num_layers - n_dense if cfg.moe else 0
    return n_dense, n_moe


# the families this port has; ssm and hybrid wait for ROADMAP A12b, encdec
# for A12c
FAMILIES = ("lm", "vlm", "gemma3")


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what this slice does not port."""
    if cfg.family not in FAMILIES:
        item = "A12c" if cfg.family == "encdec" else "A12b"
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP {item})")
    if cfg.attn is None:
        raise NotImplementedError("a decoder without attention is not ported")
    if cfg.family == "gemma3" and (cfg.local_global is None or _is_mla(cfg)):
        raise ValueError("gemma3 needs ArchConfig.local_global and GQA attention")
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


def _caches(cfg: ArchConfig, spec: dict, device: torch.device) -> dict:
    """One zeroed stacked cache per entry of a decode-state spec (a KVCache,
    or an MLACache for MLA), each with its filled length as a 0-dim int32
    tensor on ``device``."""
    cache = MLA.MLACache if _is_mla(cfg) else ATT.KVCache
    return {name: cache(**{k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                           for k, s in arrays.items()},
                        length=torch.zeros((), dtype=torch.int32, device=device))
            for name, arrays in spec.items()}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: torch.device):
    """Zeroed stacked caches of the family's decode-state spec (``gemma3``'s
    rings among them), one per layer stack, with their lengths on
    ``device`` (``_caches``); and ``expert_heat`` when the config tracks
    it."""
    from repro_torch.models.registry import get_model   # the registry imports this module
    spec = get_model(cfg).decode_state_spec(cfg, batch, max_len)
    return _with_heat(cfg, _caches(cfg, spec, device), device)


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


def layer_apply(p, x, cfg: ArchConfig, comm, *, cache=None, window="cfg", heat=None):
    """One decoder layer -> (x, new_cache, aux); without a cache it attends
    over x itself and new_cache is None. ``window``: GQA's attention window
    ("cfg": the config's; None: causal). ``heat`` as in ``_ffn_half``."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if _is_mla(cfg):
        a, new_cache = MLA.mla_attention(p["attn"], h, cfg, cache=cache)
    else:
        a, new_cache = ATT.attention(p["attn"], h, cfg, cache=cache, window=window)
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


def _tracks(x: torch.Tensor, tree) -> bool:
    """Whether autograd follows this forward: grad mode on and x or a
    parameter of ``tree`` requiring grad."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in _tensors(tree)))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _remat_layer(p, x, cfg: ArchConfig, comm, window):
    x, _, a = layer_apply(p, x, cfg, comm, window=window)
    return x, a


def _stack_apply(x, stack, cfg: ArchConfig, comm, windows=None):
    """Every layer of a stacked parameter tree in order, without caches
    (JAX: ``_scan_stack``) -> (x, the layers' summed aux); ``windows``, one
    per layer, as ``layer_apply`` takes it (default: the config's). With
    ``cfg.remat`` under autograd each layer keeps only its input and is
    recomputed in the backward."""
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and _tracks(x, stack)
    for i in range(stack["ln1"].shape[0]):
        p = _index(stack, i)
        w = "cfg" if windows is None else windows[i]
        if remat:
            x, a = checkpoint(_remat_layer, p, x, cfg, comm, w, use_reentrant=False)
        else:
            x, _, a = layer_apply(p, x, cfg, comm, window=w)
        aux = aux + a
    return x, aux


def _targets(batch: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``batch["targets"]``, by default the tokens shifted left, wrapping."""
    targets = batch.get("targets")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return targets


def _ce(h, head, targets, mask, comm) -> torch.Tensor:
    """The mean next-token cross-entropy of hidden states ``h`` through the
    f32 head ``head``: under autograd in recomputed blocks of rows
    (``head_cross_entropy_sum``), and over a ``DistComm`` summed with the
    other processes' rows."""
    if _tracks(h, head):
        sc = head_cross_entropy_sum(h, head, targets, mask)
    else:
        sc = cross_entropy_sum(logits_out(h, head), targets, mask)
    return mean_of_sum(sc if comm is None else comm.sum_over_batch(sc))


def lm_forward(params, batch, cfg: ArchConfig, comm):
    """Training/prefill forward. batch: {tokens [B, S], optional targets
    [B, S] (default: tokens shifted left, wrapping), optional loss_mask
    [B, S], for ``vlm`` optional img_embeds [B, P, D] (the first P
    positions' embeddings, cast to the activation dtype)}. Returns (loss, {"aux": aux}): the mean next-token cross-entropy
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
    if cfg.family == "vlm" and "img_embeds" in batch:
        P = batch["img_embeds"].shape[1]
        x = torch.cat([batch["img_embeds"].to(x.dtype), x[:, P:]], dim=1)
    aux = torch.zeros((), device=x.device)
    for name in ("dense", "moe"):
        if f"{name}_stack" in params:
            x, a = _stack_apply(x, params[f"{name}_stack"], cfg, comm)
            aux = aux + a
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = _head_table(params, cfg)
    targets = _targets(batch, tokens)
    mask = batch.get("loss_mask")
    loss = _ce(x, head, targets, mask, comm)
    if cfg.mtp:
        # depth-1 MTP: predict t+2 from [h_t ; emb(t+1)]
        nxt = embed_lookup(params["embed"], targets)
        h2 = torch.cat([x, nxt], dim=-1) @ params["mtp_proj"]
        h2 = rmsnorm(h2, params["mtp_ln"], cfg.norm_eps)
        h2, _, a2 = layer_apply(params["mtp_layer"], h2, cfg, comm)
        aux = aux + a2
        t2 = torch.cat([targets[:, 1:], targets[:, :1]], dim=1)
        loss = loss + 0.3 * _ce(h2, head, t2, mask, comm)
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


# ---------------------------------------------------------------------------
# family "gemma3": super-blocks of local_global = (local, global) layers
# ---------------------------------------------------------------------------

def _g3_counts(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(local, global layers a super-block, super-blocks, tail of local
    layers)."""
    loc, glob = cfg.local_global
    per = loc + glob
    n_super = cfg.num_layers // per
    return loc, glob, n_super, cfg.num_layers - n_super * per


def gemma3_spec(cfg: ArchConfig):
    """{embed, ln_f, super [n_super, per, ...], tail [tail, ...]}: JAX's
    names and layout."""
    loc, glob, n_super, tail = _g3_counts(cfg)
    sp = dict(embed=embed_spec(cfg.padded_vocab(), cfg.d_model, cfg.dtype),
              ln_f=rmsnorm_spec(cfg.d_model, cfg.dtype),
              super=_stack(_stack(layer_spec(cfg, moe_layer=False), loc + glob), n_super))
    if tail:
        sp["tail"] = _stack(layer_spec(cfg, moe_layer=False), tail)
    return sp


def _round_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (nearest, ties to even), as a Python
    float: a scalar the step multiplies by without making a tensor."""
    bits = int(np.float32(value).view(np.uint32))
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return float(np.uint32(bits).view(np.float32))
    if dtype == torch.float16:
        return float(np.float16(value))
    return float(np.float32(value))


def _g3_embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The embedding times sqrt(d_model), the scale rounded to the
    activation dtype first (73.5 in bf16 at d_model 5376), as the reference
    does."""
    x = embed_lookup(params["embed"], tokens)
    return x * _round_to(cfg.d_model ** 0.5, x.dtype)


def gemma3_forward(params, batch, cfg: ArchConfig, comm):
    """Training/prefill forward: every super-block's local layers windowed
    at ``cfg.local_window``, its global layers causal, the tail windowed;
    the tied head's mean cross-entropy (``_ce``, shared with
    ``lm_forward``). batch as ``lm_forward``'s. Returns (loss, {})."""
    check_supported(cfg)
    loc, glob, n_super, tail = _g3_counts(cfg)
    tokens = batch["tokens"]
    x = _g3_embed(params, tokens, cfg)
    windows = [cfg.local_window] * loc + [None] * glob
    for i in range(n_super):
        x, _ = _stack_apply(x, _index(params["super"], i), cfg, comm, windows)
    if tail:
        x, _ = _stack_apply(x, params["tail"], cfg, comm, [cfg.local_window] * tail)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _ce(x, params["embed"], _targets(batch, tokens), batch.get("loss_mask"), comm), {}


def gemma3_decode_state_spec(cfg: ArchConfig, batch: int, max_len: int):
    """{stack: {"k", "v"}}: ``local`` [n_super, local, B, wlen, n_kv, hd]
    rings (wlen = min(local_window, max_len)), ``globl`` [n_super, global,
    B, max_len, n_kv, hd] linear caches, ``tail`` [tail, B, wlen, ...]
    rings."""
    loc, glob, n_super, tail = _g3_counts(cfg)
    wlen = min(cfg.local_window, max_len)

    def kv(rows, *lead):
        shape = tuple(lead) + ATT.kv_cache_shape(cfg, batch, rows)
        return {k: ParamSpec(shape, cfg.dtype, init="zeros") for k in ("k", "v")}
    st = dict(local=kv(wlen, n_super, loc), globl=kv(max_len, n_super, glob))
    if tail:
        st["tail"] = kv(wlen, tail)
    return st


def _cache_at(stacked: ATT.KVCache, *idx) -> ATT.KVCache:
    """One layer's view of a stacked KVCache, sharing its length."""
    return ATT.KVCache(k=stacked.k[idx], v=stacked.v[idx], length=stacked.length)


def _ring_mask(pos: torch.Tensor, wlen: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A ring of ``wlen`` rows at the step of absolute position ``pos`` (a
    0-dim device tensor): (each row's position, the largest <= pos that is
    the row modulo wlen; which rows the window keeps)."""
    k_pos = pos - torch.remainder(pos - torch.arange(wlen, device=pos.device), wlen)
    return k_pos, (k_pos >= 0) & (k_pos <= pos) & (pos - k_pos < wlen)


def _ring_local_decode(p, x, cfg: ArchConfig, cache: ATT.KVCache, wlen: int):
    """A local layer's decode step over a ring KV cache of ``wlen`` rows:
    this step's K/V written (in place) at row ``length % wlen``, every
    row's absolute position rebuilt from the ring arithmetic and masked to
    the window. -> (x, cache with the advanced length). As the reference's:
    the step's S tokens share position ``length``, and q and k take no
    qk-norm (the reference's forward applies it, its ring decode does not;
    the port keeps the reference's arithmetic)."""
    a = cfg.attn
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    B, S, _ = x.shape
    pos = cache.length                                      # absolute position
    q = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wv"])
    pvec = pos.expand(B, S)
    q = apply_rope(q, pvec, a.rope_base, a.rope_fraction)
    k = apply_rope(k, pvec, a.rope_base, a.rope_fraction)
    # rows slot.. of the ring, clamped so that S rows fit (JAX's
    # dynamic_update_slice), written with device indices: no host read
    rows = (pos % wlen).clamp(0, wlen - S).long() + torch.arange(S, device=x.device)
    cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
    cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
    mask = _ring_mask(pos, wlen)[1]
    o = ATT._sdpa(q, cache.k, cache.v, mask[None, :].expand(S, wlen), a.logit_softcap,
                  a.head_dim ** -0.5)
    x = x + torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
    x = x + ffn_apply(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return x, ATT.KVCache(k=cache.k, v=cache.v, length=pos + S)


def gemma3_decode_step(params, state, batch, cfg: ArchConfig, comm):
    """One decode step. batch: {tokens [B, 1]} -> (logits [B, 1, V], state):
    local layers through their rings (``_ring_local_decode``), global
    layers through ``layer_apply`` over their linear caches, causal. The
    caches are written in place and every stack's length advanced in place
    after the last layer, as ``lm_decode_step`` does, so the step can be
    captured."""
    loc, glob, n_super, tail = _g3_counts(cfg)
    x = _g3_embed(params, batch["tokens"], cfg)
    wlen = state["local"].k.shape[3]
    new_len = None
    for i in range(n_super):
        sp = _index(params["super"], i)
        for j in range(loc + glob):
            pj = _index(sp, j)
            if j < loc:
                x, c = _ring_local_decode(pj, x, cfg, _cache_at(state["local"], i, j), wlen)
            else:
                x, c, _ = layer_apply(pj, x, cfg, comm, window=None,
                                      cache=_cache_at(state["globl"], i, j - loc))
            new_len = c.length
    for i in range(tail):
        x, c = _ring_local_decode(_index(params["tail"], i), x, cfg,
                                  _cache_at(state["tail"], i), wlen)
        new_len = c.length
    for c in state.values():
        c.length.copy_(new_len)
    return _head(params, x, cfg), state
