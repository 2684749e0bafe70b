"""The walks and arithmetic of flash attention's bf16 backward pair, on the CPU.

The two kernels (``src/repro_torch/csrc/flash_attention_bwd.cu``) run only
on the card, so their walks are mirrored in ``kernels/flash_attention.py``:
the dQ kernel takes the forward's tiles (``tile_coords``, ``kv_tiles``), the
dK/dV kernel tiles of ``BKEY`` keys of one (batch, kv head)
(``dkv_tile_coords``) and, for each of the G query heads, the query tiles
of ``BQT`` rows that reach them (``q_tiles``). Both are held here against
the brute-force masks of ``tests/test_torch_flash.py``: every live (query,
key) pair is visited exactly once by each kernel, no walked tile lacks a
live pair, a tile walked without the per-element mask is live for all its
pairs, and each grid schedules every work tile once, heaviest first.

A float32 emulation of the kernels' arithmetic over those walks (bf16 Q,
K, V, O and dO; the log2 domain; P and dS rounded to bf16 before their
products, where the plain version keeps f32; each gradient rounded to bf16
once) is held against ``jax.vjp`` of the reference's ``_sdpa_chunked`` and
against the plain backward, within the card test's limit of 5e-3 relative
over each gradient (``tests/test_torch_cuda.py``); the errors it measures
(2.3e-3 to 2.6e-3 against JAX, 2.4e-3 to 2.7e-3 against the plain
version, at S 300 and d 64) say, before any card time, that the bf16
rounding fits that limit.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JATT
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa
from test_torch_flash import WALKS, live, walk_ids

# the card test's limit on each gradient's relative error (Frobenius)
BWD_REL = 5e-3


def rect(ok: np.ndarray, r0: int, rows: int, c0: int, cols: int) -> np.ndarray:
    """The [rows, cols] block of the live mask at (r0, c0), dead past its
    edges (the kernels' tiles reach past Sq and Sk)."""
    out = np.zeros((rows, cols), bool)
    part = ok[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


@pytest.mark.parametrize("params", WALKS, ids=walk_ids)
def test_both_walks_visit_every_live_pair_once(params):
    """dQ over (query tile, KV tile) and dK/dV over (key tile, query tile):
    the walked blocks cover each live pair once, each walked block holds a
    live pair, an unmasked block is live throughout, and a block left out
    has no live pair."""
    Sq, Sk, causal, window = params
    ok = live(Sq, Sk, causal, window)
    total = int(ok.sum())
    seen = 0
    for q0 in range(0, Sq, fa.BQ):
        tiles = dict(fa.kv_tiles(q0, Sq, Sk, causal, window))
        for j in range(-(-Sk // fa.BKV)):
            block = rect(ok, q0, fa.BQ, j * fa.BKV, fa.BKV)
            assert block.any() == (j in tiles), (q0, j)
            if j in tiles and not tiles[j]:
                # rows past Sq meet zero-filled Q and dO and add nothing
                assert block[:min(fa.BQ, Sq - q0)].all(), (q0, j)
            seen += int(block.sum()) if j in tiles else 0
    assert seen == total
    seen = 0
    for k0 in range(0, Sk, fa.BKEY):
        walk = fa.q_tiles(k0, Sq, Sk, causal, window)
        order = [i for i, _ in walk]
        assert order == sorted(set(order))             # first first, once each
        tiles = dict(walk)
        for i in range(-(-Sq // fa.BQT)):
            block = rect(ok, i * fa.BQT, fa.BQT, k0, fa.BKEY)
            assert block.any() == (i in tiles), (k0, i)
            if i in tiles and not tiles[i]:
                assert block.all(), (k0, i)
            seen += int(block.sum()) if i in tiles else 0
    assert seen == total


@pytest.mark.parametrize("params", WALKS, ids=walk_ids)
def test_both_grids_schedule_each_tile_once_heaviest_first(params):
    """Over the lanes of each persistent grid (an H100's 132 and a few),
    every work tile once; in the grid's order no tile carries fewer live
    blocks than a later one (dK/dV: the query tiles of all G heads)."""
    Sq, Sk, causal, window = params
    B, Hkv, G = 2, 2, 3
    Hq = Hkv * G
    n = fa.work_tiles(B, Hq, Sq)
    coords = [fa.tile_coords(B, Hq, Sq, t, causal) for t in range(n)]
    assert sorted(coords) == sorted((b, h, q0) for b in range(B) for h in range(Hq)
                                    for q0 in range(0, Sq, fa.BQ))
    weight = [len(fa.kv_tiles(q0, Sq, Sk, causal, window)) for _, _, q0 in coords]
    assert all(a >= b for a, b in zip(weight, weight[1:]))
    n = fa.dkv_work_tiles(B, Hkv, Sk)
    coords = [fa.dkv_tile_coords(B, Hkv, Sk, t, causal) for t in range(n)]
    assert sorted(coords) == sorted((b, h, k0) for b in range(B) for h in range(Hkv)
                                    for k0 in range(0, Sk, fa.BKEY))
    weight = [G * len(fa.q_tiles(k0, Sq, Sk, causal, window)) for _, _, k0 in coords]
    assert all(a >= b for a, b in zip(weight, weight[1:]))
    for lanes in (fa.SMS, 7, 1):
        work = fa.dkv_lane_tiles(B, Hkv, Sk, lanes)
        assert len(work) == min(n, lanes)
        assert sorted(t for lane in work for t in lane) == list(range(n))


def test_the_mirror_holds_the_kernels_tile_sizes():
    """The tile sizes the walks mirror are the ones the .cu compiles."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    consts = dict(re.findall(r"\b(BQ|BKV|BKEY|BQT) = (\d+)", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "BQ": fa.BQ, "BKV": fa.BKV, "BKEY": fa.BKEY, "BQT": fa.BQT}


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, H, S, d] zero-filled to n rows, as TMA fills a box past S."""
    out = x.new_zeros(x.shape[:2] + (n,) + x.shape[3:])
    out[:, :, :x.shape[2]] = x
    return out


def mask(r: torch.Tensor, c: torch.Tensor, Sq, Sk, causal, window) -> torch.Tensor:
    ok = (r < Sq) & (c < Sk)
    if causal:
        ok = ok & (c <= r)
    if window is not None:
        ok = ok & ((r - c) < window)
    return ok


def emulate_bwd(q, k, v, o, do, lse, scale, causal=True, window=None):
    """The bf16 kernels' arithmetic in float32 over their walks: q, o, do
    [B, Hq, Sq, d], k, v [B, Hkv, Sk, d] (values of bf16), lse [B, Hq, Sq]
    -> (dq, dk, dv) rounded to bf16. Rows past a length are zero-filled
    with lse and delta 0, as the kernels load them."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl2 = scale * math.log2(math.e)
    nq = -(-Sq // fa.BQ) * fa.BQ + fa.BQ
    nk = -(-Sk // fa.BKV) * fa.BKV + fa.BKV
    qp, dop = pad_rows(q, nq), pad_rows(do, nq)
    kp, vp = pad_rows(k, nk), pad_rows(v, nk)
    delta = pad_rows((do * o).sum(-1)[..., None], nq)[..., 0]
    lse2 = pad_rows(lse[..., None] * math.log2(math.e), nq)[..., 0]
    kr, vr = kp.repeat_interleave(G, 1), vp.repeat_interleave(G, 1)

    def p_ds(qt, dot, kt, vt, l2, dl, r, c, masked):
        p = torch.exp2(qt @ kt.transpose(-1, -2) * sl2 - l2[..., None])
        if masked:
            p = torch.where(mask(r, c, Sq, Sk, causal, window), p, 0.0)
        return p, p * (dot @ vt.transpose(-1, -2) - dl[..., None])

    dq = torch.zeros_like(qp)
    for q0 in range(0, Sq, fa.BQ):
        rows = slice(q0, q0 + fa.BQ)
        r = (q0 + torch.arange(fa.BQ))[:, None]
        for j, masked in fa.kv_tiles(q0, Sq, Sk, causal, window):
            keys = slice(j * fa.BKV, (j + 1) * fa.BKV)
            c = (j * fa.BKV + torch.arange(fa.BKV))[None, :]
            _, ds = p_ds(qp[:, :, rows], dop[:, :, rows], kr[:, :, keys], vr[:, :, keys],
                         lse2[:, :, rows], delta[:, :, rows], r, c, masked)
            dq[:, :, rows] += bf16(ds) @ kr[:, :, keys]
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for k0 in range(0, Sk, fa.BKEY):
        keys = slice(k0, k0 + fa.BKEY)
        c = (k0 + torch.arange(fa.BKEY))[None, :]
        for i, masked in fa.q_tiles(k0, Sq, Sk, causal, window):
            rows = slice(i * fa.BQT, (i + 1) * fa.BQT)
            r = (i * fa.BQT + torch.arange(fa.BQT))[:, None]
            p, ds = p_ds(qp[:, :, rows], dop[:, :, rows], kr[:, :, keys], vr[:, :, keys],
                         lse2[:, :, rows], delta[:, :, rows], r, c, masked)
            # the G query heads of a kv head summed in the block
            pv = (bf16(p).transpose(-1, -2) @ dop[:, :, rows]).reshape(B, Hkv, G, fa.BKEY, d)
            pk = (bf16(ds).transpose(-1, -2) @ qp[:, :, rows]).reshape(B, Hkv, G, fa.BKEY, d)
            dv[:, :, keys] += pv.sum(2)
            dk[:, :, keys] += pk.sum(2)
    return (bf16(dq[:, :, :Sq] * scale), bf16(dk[:, :, :Sk] * scale), bf16(dv[:, :, :Sk]))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("G,window", [(1, None), (6, None), (6, 100)])
def test_emulated_rounding_fits_the_card_limit(G, window):
    """S 300 (three query tiles of 128, five of 64), d 64: the emulation
    within BWD_REL of jax.vjp of ``_sdpa_chunked`` on the same bf16 values
    in f32, and of the plain backward (the card test's comparison)."""
    rng = np.random.default_rng(5)
    B, S, Hkv, d = 1, 300, 2, 64
    Hq = Hkv * G
    q, do = (bf16(torch.from_numpy(rng.standard_normal((B, S, Hq, d)).astype(np.float32)))
             for _ in range(2))
    k, v = (bf16(torch.from_numpy(rng.standard_normal((B, S, Hkv, d)).astype(np.float32)))
            for _ in range(2))
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: JATT._sdpa_chunked(a, b, c, None, scale, window,
                                                        chunk=128),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    t = [x.transpose(1, 2) for x in (q, k, v)]
    o, lse = ref.flash_attention_fwd(*(x.to(torch.bfloat16) for x in t), scale=scale,
                                     window=window)
    o = o.float()
    got = emulate_bwd(*t, o, do.transpose(1, 2), lse, scale, True, window)
    plain = ref.flash_attention_bwd(*t, o, do.transpose(1, 2), lse, scale=scale,
                                    window=window)
    errs = [rel(g_.transpose(1, 2).numpy(), w_) for g_, w_ in zip(got, want)]
    assert max(errs) < BWD_REL, errs
    errs_plain = [rel(g_.numpy(), bf16(p_).numpy()) for g_, p_ in zip(got, plain)]
    assert max(errs_plain) < BWD_REL, errs_plain
    # the rounding of P and dS is the kernels' own error: it is there, and
    # it is of bf16's size, not of a fault's
    assert min(errs_plain) > 1e-4, errs_plain
