"""The walk of the bf16 ``flash_attention`` kernel, on the CPU.

The kernel (``src/repro_torch/csrc/flash_attention.cu``) runs only on the
card, so its walk is mirrored in ``kernels/flash_attention.py``
(``tile_coords``, ``lane_tiles``, ``kv_tiles``) and held here against
brute-force masks built from the reference's semantics (``kernels/ref.py
flash_attention``, ``src/repro/kernels/flash_attention.py`` ``_kernel``): a
(query row, key) pair is live when the key lies before Sk, at or before the
row under a causal mask, and less than ``window`` positions before it. Every
work tile is scheduled exactly once, heaviest first; a KV tile walked without
the per-element mask is live for all its pairs; a skipped tile has none; a
tile with a live pair is walked. A float32 emulation of the kernel's
arithmetic over that walk (the log2 domain, the unmasked tiles' max taken
before the scale, -1e30 for masked scores, zero-filled tails) is held
against the JAX package's Pallas kernel in interpret mode and against the
plain version. The fault that ``tools/flash_fault_check.py`` plants must
find its anchor in the kernel exactly once.
"""
import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEG_INF = -1e30

# (Sq, Sk): ragged in both tile sizes, Sq below Sk, one tile, the main path
LENGTHS = [(200, 328), (1000, 1000), (128, 128), (4096, 4096)]
MASKS = [(True, None), (True, 77), (True, 1024), (False, None), (False, 150)]


def live(Sq: int, Sk: int, causal: bool, window: int | None) -> np.ndarray:
    """[Sq, Sk] pairs the reference lets through (positions from 0 on both
    sides)."""
    r = np.arange(Sq)[:, None]
    c = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= c <= r
    if window is not None:
        ok &= (r - c) < window
    return ok


def walk_ids(params):
    Sq, Sk, causal, window = params
    return f"Sq{Sq}-Sk{Sk}-{'causal' if causal else 'full'}-w{window}"


WALKS = [(Sq, Sk, causal, window) for Sq, Sk in LENGTHS for causal, window in MASKS]


@pytest.mark.parametrize("params", WALKS, ids=walk_ids)
def test_kv_walk_matches_the_masks(params):
    Sq, Sk, causal, window = params
    ok = live(Sq, Sk, causal, window)
    nk = -(-Sk // fa.BKV)
    for q0 in range(0, Sq, fa.BQ):
        rows = ok[q0:q0 + fa.BQ]
        tiles = fa.kv_tiles(q0, Sq, Sk, causal, window)
        walked = [j for j, _ in tiles]
        assert walked == sorted(set(walked), reverse=True)   # last first, once each
        for j in range(nk):
            # keys past Sk count as dead pairs (the kernel's tile holds BKV keys)
            pairs = np.zeros((rows.shape[0], fa.BKV), bool)
            part = rows[:, j * fa.BKV:(j + 1) * fa.BKV]
            pairs[:, :part.shape[1]] = part
            if pairs.any():
                assert j in walked, (q0, j)
            if j not in walked:
                assert not pairs.any(), (q0, j)
        for j, masked in tiles:
            pairs = rows[:, j * fa.BKV:(j + 1) * fa.BKV]
            if not masked:
                assert pairs.shape[1] == fa.BKV and pairs.all(), (q0, j)


@pytest.mark.parametrize("G,d", [(1, 128), (6, 128), (6, 64)])
@pytest.mark.parametrize("params", WALKS, ids=walk_ids)
def test_tiles_scheduled_once_heaviest_first(params, G, d):
    """Over the lanes of the persistent grid (an H100's 132 and a few), each
    (batch, query head, query tile) once; in the grid's order, and so in
    each lane's, no tile reaches fewer KV tiles than a later one. The walk
    depends on neither d nor G beyond the head count."""
    Sq, Sk, causal, window = params
    B, Hq = 2, 2 * G
    n = fa.work_tiles(B, Hq, Sq)
    want = {(b, h, q0) for b in range(B) for h in range(Hq) for q0 in range(0, Sq, fa.BQ)}
    coords = [fa.tile_coords(B, Hq, Sq, t, causal) for t in range(n)]
    assert len(coords) == len(want) and set(coords) == want
    weight = [len(fa.kv_tiles(q0, Sq, Sk, causal, window)) for _, _, q0 in coords]
    assert all(a >= b for a, b in zip(weight, weight[1:]))
    for lanes in (fa.SMS, 7, 1):
        work = fa.lane_tiles(B, Hq, Sq, lanes)
        assert len(work) == min(n, lanes)
        flat = [t for lane in work for t in lane]
        assert sorted(flat) == list(range(n))
        assert all(lane == sorted(lane) for lane in work)


def emulate(q, k, v, scale, causal=True, window=None):
    """The bf16 kernel's arithmetic in float32 over its walk: q [B, Hq, Sq, d],
    k/v [B, Hkv, Sk, d] -> [B, Hq, Sq, d]. Tails are zero-filled as TMA
    fills them; P stays f32 here (the card rounds it to bf16)."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl2 = scale * math.log2(math.e)
    nk = -(-Sk // fa.BKV)
    kp = torch.zeros((B, Hkv, nk * fa.BKV, d))
    vp = torch.zeros_like(kp)
    kp[:, :, :Sk], vp[:, :, :Sk] = k, v
    out = torch.zeros_like(q)
    for q0 in range(0, Sq, fa.BQ):
        qt = torch.zeros((B, Hq, fa.BQ, d))
        qt[:, :, :min(fa.BQ, Sq - q0)] = q[:, :, q0:q0 + fa.BQ]
        r = (q0 + torch.arange(fa.BQ))[:, None]
        m = torch.full((B, Hq, fa.BQ), NEG_INF)
        l = torch.zeros((B, Hq, fa.BQ))
        o = torch.zeros((B, Hq, fa.BQ, d))
        for j, masked in fa.kv_tiles(q0, Sq, Sk, causal, window):
            keys = slice(j * fa.BKV, (j + 1) * fa.BKV)
            kt = kp[:, :, keys].repeat_interleave(G, dim=1)
            vt = vp[:, :, keys].repeat_interleave(G, dim=1)
            s = qt @ kt.transpose(-1, -2)
            if masked:
                c = (j * fa.BKV + torch.arange(fa.BKV))[None, :]
                ok = c < Sk
                if causal:
                    ok = ok & (c <= r)
                if window is not None:
                    ok = ok & ((r - c) < window)
                s = torch.where(ok, s * sl2, torch.tensor(NEG_INF))
                mx = s.amax(-1)
            else:
                mx = s.amax(-1) * sl2
            m_new = torch.maximum(m, mx)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None]) if masked else \
                torch.exp2(s * sl2 - m_new[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ vt
            m = m_new
        res = o / torch.clamp_min(l, 1e-30)[..., None]
        out[:, :, q0:q0 + fa.BQ] = res[:, :, :min(fa.BQ, Sq - q0)]
    return out


def qkv(seed, B, Hq, Hkv, Sq, Sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, d)).astype(np.float32))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None),
                                           (False, 100)])
def test_emulated_walk_matches_pallas_interpret(G, causal, window):
    """f32 within 1e-5 of the Pallas kernel in interpret mode (two query
    and two KV tiles of 128)."""
    q, k, v = qkv(3, 1, 2 * G, 2, 256, 256, 32)
    scale = 32 ** -0.5
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                     window=window, causal=causal, interpret=True)
    got = emulate(*(torch.from_numpy(a) for a in (q, k, v)), scale, causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 77), (False, None),
                                           (False, 150)])
def test_emulated_walk_matches_plain_ragged(G, causal, window):
    """At ragged lengths (Sq 200 over Sk 328, the card test's shape), which
    the Pallas kernel does not take: f32 within 1e-5 of the plain version."""
    q, k, v = (torch.from_numpy(a) for a in qkv(4, 1, 2 * G, 2, 200, 328, 64))
    scale = 64 ** -0.5
    want = ref.flash_attention(q, k, v, scale=scale, window=window, causal=causal)
    got = emulate(q, k, v, scale, causal, window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def tool_constants(path: pathlib.Path, names: tuple[str, ...]) -> dict:
    """The constants a script assigns to ``names`` at module level (in
    order, each from literals and the ones before it), read without
    importing the script and all it imports."""
    ns: dict = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in names:
            exec(compile(ast.Module([node], type_ignores=[]), str(path), "exec"), ns)
    return {n: ns[n] for n in names}


def test_fault_check_anchor_occurs_once():
    """tools/flash_fault_check.py plants its fault after ANCHOR in the bf16
    kernel; if the anchor drifted away it could not fault anything."""
    consts = tool_constants(ROOT / "tools" / "flash_fault_check.py",
                            ("SKIPPED_TILE", "ANCHOR", "FAULT"))
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert src.count(consts["ANCHOR"]) == 1
    assert f"== {consts['SKIPPED_TILE']}" in consts["FAULT"]
    # the tile it skips is one the main path's causal rows reach
    Sq = Sk = 4096
    reached = {j for q0 in range(0, Sq, fa.BQ) for j, _ in fa.kv_tiles(q0, Sq, Sk)}
    assert consts["SKIPPED_TILE"] in reached
