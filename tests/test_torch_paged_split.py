"""The partition of the paged decode attention kernel, on the CPU.

``csrc/paged_decode_attention.cu`` cuts each request's live tokens into at
most ``num_kv_splits`` splits by its own ``kv_len`` alone
(``kernels/decode_attention.py kv_splits``), writes a request of one split
directly and merges the splits of the others in split order. The kernel runs
only on the card; here a pure-torch emulation of that partition (each split's
online softmax in f32, the direct write, the fixed-order merge) is held
against the JAX package's ``paged_decode_attention`` (its plain version, and
its Pallas kernel in interpret mode) within 1e-5 in f32, on numpy inputs:
idle, one-token, page-multiple, ragged and long rows, G = 1 and 6, the shared
absorbed-MLA pool. A request's emulated result must be bitwise the same
whatever its neighbours, and the partition's rules hold for every length.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro.kernels import ref as JREF
from repro_torch.kernels import decode_attention as tda

F32 = dict(rtol=1e-5, atol=1e-5)
CSRC = pathlib.Path(tda.__file__).resolve().parents[1] / "csrc" / "paged_decode_attention.cu"


def emulate(q, kp, vp, tbl, lens, *, scale, num_kv_splits, dv=None):
    """B6's partition in f32: per request, the splits of ``kv_splits``, each
    split's softmax-weighted values and log-sum-exp; one split written
    directly, more merged in split order; an idle request exactly 0."""
    B, Hq, dk = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    max_pages = tbl.shape[1]
    G = Hq // Hkv
    if vp is None:
        vp = kp[..., :dv]
    dv = vp.shape[-1]
    out = torch.zeros((B, Hq, dv), dtype=torch.float32)
    for b in range(B):
        L = min(int(lens[b]), max_pages * page)
        n, span = tda.kv_splits(L, num_kv_splits)
        if L == 0:
            continue
        pos = torch.arange(L)
        rows, slot = tbl[b, pos // page].long(), pos % page
        k, v = kp[rows, slot].float(), vp[rows, slot].float()      # [L, Hkv, d]
        qg = q[b].float().reshape(Hkv, G, dk)
        parts, lses = [], []
        for s in range(n):
            a, e = s * span, min((s + 1) * span, L)
            sc = torch.einsum("hgd,thd->hgt", qg, k[a:e]) * scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            l = p.sum(-1)
            parts.append(torch.einsum("hgt,thv->hgv", p, v[a:e]) / l[..., None])
            lses.append(m + torch.log(l))
        if n == 1:
            out[b] = parts[0].reshape(Hq, dv)
            continue
        lse = torch.stack(lses)                                     # [n, Hkv, G]
        w = torch.exp(lse - lse.amax(0))
        acc = sum(w[s][..., None] * parts[s] for s in range(n))
        out[b] = (acc / w.sum(0)[..., None]).reshape(Hq, dv)
    return out


def case(rng, *, B, Hkv, G, dk, dv, page, max_pages, lens, share_kv):
    """Pools with every live page at a shuffled place and garbage elsewhere
    (the pad page included), f32 numpy."""
    P = B * max_pages
    kp = rng.standard_normal((P + 1, page, Hkv, dk)).astype(np.float32)
    vp = None if share_kv else rng.standard_normal((P + 1, page, Hkv, dv)).astype(np.float32)
    perm = rng.permutation(P)
    tbl = np.full((B, max_pages), P, np.int32)
    for b in range(B):
        n = -(-int(lens[b]) // page)
        tbl[b, :n] = perm[b * max_pages:b * max_pages + n]
    q = rng.standard_normal((B, Hkv * G, dk)).astype(np.float32)
    return q, kp, vp, tbl, np.asarray(lens, np.int32)


# lengths: idle, one token, page multiples, ragged tails, rows of one, two
# and many splits (MIN_SPLIT 256 tokens), a full table
LENS = [0, 1, 16, 37, 256, 257, 600, 1024, 1500, 96 * 16]


@pytest.mark.parametrize("splits", [1, 4, 8])
@pytest.mark.parametrize("G,share_kv", [(1, False), (6, False), (4, True)],
                         ids=["G1", "G6", "share_kv"])
def test_partition_emulation_matches_jax(G, share_kv, splits):
    rng = np.random.default_rng(31 + G + splits)
    if share_kv:                       # dk = r_kv 32 + rope 8, values r_kv
        Hkv, dk, dv = 1, 40, 32
    else:
        Hkv, dk, dv = 2, 16, 16
    q, kp, vp, tbl, lens = case(rng, B=len(LENS), Hkv=Hkv, G=G, dk=dk, dv=dv, page=16,
                                max_pages=96, lens=LENS, share_kv=share_kv)
    kw = dict(scale=dk ** -0.5, num_kv_splits=splits, dv=dv if share_kv else None)
    t = [None if a is None else torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    got = emulate(*t, **kw)
    j = [None if a is None else jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
    np.testing.assert_allclose(got.numpy(), np.asarray(JREF.paged_decode_attention(*j, **kw)),
                               **F32)
    assert torch.all(got[0] == 0)
    if splits == 4:                    # the Pallas kernel is slow in interpret mode
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JDA.paged_decode_attention(*j, **kw, interpret=True)),
            **F32)


def test_partition_result_does_not_depend_on_neighbours():
    """Each request alone gives the same bits as among any neighbours: the
    split of a row depends only on its own length."""
    rng = np.random.default_rng(41)
    q, kp, vp, tbl, lens = case(rng, B=len(LENS), Hkv=2, G=6, dk=16, dv=16, page=16,
                                max_pages=96, lens=LENS, share_kv=False)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    kw = dict(scale=0.25, num_kv_splits=4)
    together = emulate(*t, **kw)
    order = torch.from_numpy(rng.permutation(len(LENS)))
    shuffled = emulate(t[0][order], t[1], t[2], t[3][order], t[4][order], **kw)
    for b in range(len(LENS)):
        alone = emulate(t[0][b:b + 1], t[1], t[2], t[3][b:b + 1], t[4][b:b + 1], **kw)
        assert torch.equal(alone[0], together[b])
    assert torch.equal(shuffled, together[order])


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
def test_kv_splits_rules(splits):
    """At most ``splits`` splits, none empty, every one but the last of
    ``span`` tokens (whole tiles, at least MIN_SPLIT), the splits covering
    [0, kv_len) exactly; one empty split for an idle request; a request of
    fewer than 2 * MIN_SPLIT tokens is never split."""
    for L in range(0, 5000, 7):
        n, span = tda.kv_splits(L, splits)
        assert 1 <= n <= splits and span % tda.TILE == 0 and span > 0
        if L == 0:
            assert n == 1
            continue
        assert (n - 1) * span < L <= n * span
        if n > 1:
            assert span >= tda.MIN_SPLIT
        if L < 2 * tda.MIN_SPLIT:
            assert n == 1
    assert not tda.splits_possible(splits, 4, 16)              # the serve's table
    assert tda.splits_possible(splits, 2048, 16) == (splits > 1)


def test_partition_constants_match_the_kernel():
    """The wrapper's mirror of the partition uses the kernel's constants."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (TT|MIN_SPLIT) = (\d+);", src))
    assert int(consts["TT"]) == tda.TILE and int(consts["MIN_SPLIT"]) == tda.MIN_SPLIT
