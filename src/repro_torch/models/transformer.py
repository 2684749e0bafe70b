"""Decoder LM, family ``lm`` (port of the decode path of
``src/repro/models/transformer.py``).

Parameters keep the JAX layout: per-layer trees stacked along a leading
[n_layers] axis in ``dense_stack`` and ``moe_stack``. The layer stack is a
Python loop over those slices (JAX scans it).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as ATT
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig, ParamSpec
from repro_torch.models.layers import (embed_lookup, embed_spec, ffn_apply,
                                       ffn_spec, logits_out, rmsnorm,
                                       rmsnorm_spec)


def _stack_sizes(cfg: ArchConfig) -> tuple[int, int]:
    n_dense = cfg.moe.first_k_dense if cfg.moe else cfg.num_layers
    n_moe = cfg.num_layers - n_dense if cfg.moe else 0
    return n_dense, n_moe


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what this slice does not port."""
    if cfg.family != "lm":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP A12)")
    if cfg.attn is None or cfg.attn.kind != "gqa" or cfg.mtp:
        raise NotImplementedError("only GQA attention without MTP is ported "
                                  "(MLA and MTP: ROADMAP A8)")
    if cfg.moe is not None:
        MOE.check_supported(cfg.moe)


def layer_spec(cfg: ArchConfig, *, moe_layer: bool):
    sp = dict(ln1=rmsnorm_spec(cfg.d_model, cfg.dtype),
              ln2=rmsnorm_spec(cfg.d_model, cfg.dtype),
              attn=ATT.attn_spec(cfg))
    if moe_layer:
        sp["moe"] = MOE.moe_spec(cfg)
    else:
        sp["ffn"] = ffn_spec(cfg.d_model, cfg.d_ff, cfg.dtype, cfg.act)
    return sp


def _stack(specs, n: int):
    """Stack a layer's ParamSpec tree n times along a leading axis."""
    if isinstance(specs, dict):
        return {k: _stack(v, n) for k, v in specs.items()}
    return ParamSpec((n,) + specs.shape, specs.dtype, specs.init, specs.scale)


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
    return sp


def lm_decode_state_spec(cfg: ArchConfig, batch: int, max_len: int):
    """{stack: (k/v shape [n, B, S_max, n_kv, hd], dtype)} per layer stack."""
    shape = ATT.kv_cache_shape(cfg, batch, max_len)
    return {name: ((n,) + shape, cfg.dtype)
            for name, n in zip(("dense", "moe"), _stack_sizes(cfg)) if n}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: torch.device):
    """Zeroed stacked KV caches, one KVCache per layer stack."""
    return {name: ATT.KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                              v=torch.zeros(shape, dtype=dt, device=device),
                              length=0)
            for name, (shape, dt) in lm_decode_state_spec(cfg, batch, max_len).items()}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def layer_apply(p, x, cfg: ArchConfig, comm, *, cache):
    """One decoder layer with a cache -> (x, new_cache, aux)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = ATT.attention(p["attn"], h, cfg, cache=cache)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = MOE.moe_block(p["moe"], h, cfg, comm)
    else:
        f, aux = ffn_apply(p["ffn"], h, cfg.act), torch.zeros((), device=x.device)
    return x + f, new_cache, aux


def lm_decode_step(params, state, batch, cfg: ArchConfig, comm):
    """One decode step. batch: {tokens [B, 1]} -> (logits [B, 1, V], state).
    The caches in ``state`` are written in place; the returned state carries
    the advanced lengths."""
    x = embed_lookup(params["embed"], batch["tokens"])
    new_state = dict(state)
    for name in ("dense", "moe"):
        if name not in state:
            continue
        st, stack = state[name], params[f"{name}_stack"]
        for i in range(st.k.shape[0]):
            c = ATT.KVCache(k=st.k[i], v=st.v[i], length=st.length)
            x, c, _ = layer_apply(_index(stack, i), x, cfg, comm, cache=c)
        new_state[name] = ATT.KVCache(k=st.k, v=st.v, length=c.length)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return logits_out(x, head), new_state
