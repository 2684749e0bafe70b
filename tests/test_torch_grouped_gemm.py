"""The host side of the bf16 ``grouped_gemm`` kernel, on the CPU.

The kernel (``src/repro_torch/csrc/grouped_gemm.cu``) runs only on the card,
so everything around it that the CPU can reach lives in the wrapper and is
held here: the schedule chosen from the static shape (A, H, F), the work
of the persistent grid's lanes (every output tile and every 64-deep k block
covered exactly once, a split tile's pieces in k order), and the TMA maps'
dims, strides and boxes against the encoder's limits. A numpy emulation of
the plan (each piece's partial product, a split tile's pieces summed in
piece order, rows past the count zeroed) is held against the JAX package's
``grouped_gemm`` within 1e-5 in f32, at counts on every tile edge.
"""
import ctypes
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import grouped_gemm as gg

# DBRX-132B's four path shapes per hosted rank (2 local experts, d_model
# 6144, d_ff_expert 10752; A = 128 at decode, 10240 at HT prefill) and the
# card tests' shapes (H and F multiples of 8 but not of 64)
DBRX = {"decode gate": (2, 128, 6144, 10752), "decode down": (2, 128, 10752, 6144),
        "HT gate": (2, 10240, 6144, 10752), "HT down": (2, 10240, 10752, 6144)}
SMALL = {f"L{L}-A{A}": (L, A, 264, 200) for A in (128, 136, 1000) for L in (1, 3)}
SHAPES = {**DBRX, **SMALL}


def tma_limits_hold(m: tuple) -> bool:
    """What cuTensorMapEncodeTiled takes for a 3-D bf16 map with the
    128-byte swizzle: dims in [1, 2^32], strides multiples of 16 below
    2^40, a box edge in [1, 256] whose inner extent is at most 128 bytes.
    m is a plan's (dim0, dim1, dim2, stride1, stride2, box0, box1)."""
    d0, d1, d2, s1, s2, b0, b1 = m
    return (all(1 <= d <= 2 ** 32 for d in (d0, d1, d2))
            and all(s % 16 == 0 and 0 < s < 2 ** 40 for s in (s1, s2))
            and 1 <= b1 <= 256 and 1 <= b0 and b0 * 2 <= 128)


def edges(A):
    """Counts on every tile edge, at A and one past it."""
    return [0, 1, 63, 64, 65, 127, 128, A, A + 1]


def pieces_by_tile(p):
    """tile -> its pieces (piece, pieces, kb0, kb1), over every lane."""
    seen = {}
    for lane in range(p.grid):
        for t, kb0, kb1, j, n in gg.lane_work(p, lane):
            seen.setdefault(t, []).append((j, n, kb0, kb1))
    return seen


@pytest.mark.parametrize("name", SHAPES)
def test_work_covers_every_tile_and_k_block_once(name):
    L, A, H, F = SHAPES[name]
    p = gg.plan(L, A, H, F)
    assert (p.m_tiles - 1) * gg.BM < A <= p.m_tiles * gg.BM
    assert (p.n_tiles - 1) * p.bn < F <= p.n_tiles * p.bn
    assert (p.kb_total - 1) * gg.BK < H <= p.kb_total * gg.BK
    assert p.tiles == L * p.m_tiles * p.n_tiles and 1 <= p.grid <= gg.SMS
    coords = {gg.tile_coords(p, t) for t in range(p.tiles)}
    assert coords == {(l, mt, nt) for l in range(L) for mt in range(p.m_tiles)
                      for nt in range(p.n_tiles)}
    seen = pieces_by_tile(p)
    assert sorted(seen) == list(range(p.tiles))
    for t, pieces in seen.items():
        pieces.sort()
        n = len(pieces)
        assert [j for j, *_ in pieces] == list(range(n))
        assert all(m == n for _, m, _, _ in pieces)
        assert n == 1 or t < p.sk_tiles
        assert n <= max(p.max_pieces, 1)
        # the pieces are consecutive k ranges, in piece order, covering K
        assert [k for *_, kb0, kb1 in pieces for k in range(kb0, kb1)] == \
            list(range(p.kb_total))


@pytest.mark.parametrize("name", SHAPES)
def test_a_split_tile_waits_only_on_later_lanes(name):
    """A split tile's first piece is the last piece of its lane and waits
    for the others; they are each the first piece of a later lane, so no
    lane waits on an earlier one and no wait can close a cycle."""
    p = gg.plan(*SHAPES[name])
    where = {}
    for lane in range(p.grid):
        work = gg.lane_work(p, lane)
        for i, (t, _, _, j, n) in enumerate(work):
            if n > 1:
                where[(t, j)] = (lane, i, len([w for w in work if w[4] > 1]))
    for (t, j), (lane, i, n_split) in where.items():
        if j == 0:
            assert i == n_split - 1       # its lane's last split piece
            assert all(where[(t, k)][0] > lane for k in range(1, len(
                [key for key in where if key[0] == t])))
        else:
            assert i == 0                 # the first piece of its lane


@pytest.mark.parametrize("name", SHAPES)
def test_schedule_follows_the_static_shape(name):
    L, A, H, F = SHAPES[name]
    p = gg.plan(L, A, H, F)
    if A <= gg.STREAM_MAX_A:
        # one tile holds every row: each weight byte is read once per call
        assert (p.schedule, p.bn, p.m_tiles) == ("stream", 128, 1)
    else:
        assert (p.schedule, p.bn, p.sk_tiles, p.group_m) == ("compute", 256, 0, 8)
    assert p.scratch_floats() == p.sk_tiles * p.max_pieces * gg.BM * p.bn


@pytest.mark.parametrize("name", ["decode gate", "decode down"])
def test_decode_lanes_stream_equal_shares(name):
    """The down projection has 48 column tiles x 2 experts: 96 tiles on 132
    SMs. Stream-K gives every lane the same k blocks, one more at most."""
    p = gg.plan(*DBRX[name])
    loads = [sum(kb1 - kb0 for _, kb0, kb1, _, _ in gg.lane_work(p, lane))
             for lane in range(p.grid)]
    assert p.grid == gg.SMS and p.sk_tiles > 0
    assert max(loads) == -(-p.tiles * p.kb_total // gg.SMS)
    assert sum(loads) == p.tiles * p.kb_total
    # at most one whole tile and the pieces of two split tiles a lane
    assert max(len(gg.lane_work(p, lane)) for lane in range(p.grid)) <= 3


def test_compute_walks_bands_of_row_tiles():
    """The first wave of the HT gate, one tile per lane, lies in one band of
    eight row tiles of one expert, so concurrent tiles share their strips of
    x and w in L2."""
    p = gg.plan(*DBRX["HT gate"])
    first = {gg.tile_coords(p, t)[:2] for t in range(p.grid)}
    assert {l for l, _ in first} == {0} and {mt for _, mt in first} == set(range(8))


@pytest.mark.parametrize("name", SHAPES)
def test_tma_maps_hold_the_encoder_limits(name):
    L, A, H, F = SHAPES[name]
    p = gg.plan(L, A, H, F)
    assert p.x_map == (H, A, L, 2 * H, 2 * A * H, 64, 64)
    assert p.w_map == (F, H, L, 2 * F, 2 * H * F, 64, 64)
    assert tma_limits_hold(p.x_map) and tma_limits_hold(p.w_map)
    # models/moe.py hands the kernel w_gate[r*L:(r+1)*L]: a contiguous slice
    # whose start moves by whole experts, 16-byte aligned
    assert (L * H * F * 2) % 16 == 0


def test_tma_limits_refuse_what_the_encoder_refuses():
    assert not tma_limits_hold((4, 8, 1, 8, 64, 64, 64))        # stride of 8 bytes
    assert not tma_limits_hold((256, 8, 1, 512, 4096, 128, 64))  # 256-byte inner box
    assert not tma_limits_hold((256, 8, 1, 512, 4096, 64, 512))  # box edge > 256
    assert not tma_limits_hold((0, 8, 1, 16, 64, 64, 64))        # empty dim


def test_the_wrapper_plans_without_reading_counts(monkeypatch):
    """The plan is a function of (L, A, H, F) alone; the wrapper passes the
    same plan whatever the counts, and launches once per call."""
    assert list(inspect.signature(gg.plan).parameters) == ["L", "A", "H", "F"]
    calls = []

    def fake_launch(name, x, w, c, o, L, A, H, F, dt, plan, scratch, sems):
        n = len(gg.plan(L, A, H, F).args())
        calls.append((list((ctypes.c_int64 * n).from_address(plan)),
                      scratch is not None, sems is not None))

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "launch", fake_launch)
    L, A, H, F = SMALL["L3-A128"]
    x = torch.zeros((L, A, H), dtype=torch.bfloat16)
    w = torch.zeros((L, H, F), dtype=torch.bfloat16)
    before = gg.launches
    for c in ([0, 0, 0], [1, 64, 200], [500, 128, 65]):
        gg.grouped_gemm(x, w, torch.tensor(c, dtype=torch.int32))
    assert gg.launches == before + 3
    want = gg.plan(L, A, H, F)
    assert want.sk_tiles > 0
    assert calls == [(want.args(), True, True)] * 3


def emulate(p, x, w, counts):
    """The kernel's arithmetic piece by piece in f32: each piece's partial
    product over its k blocks, a split tile's pieces summed in piece order,
    rows at or past the count zero."""
    L, A, H = x.shape
    F = w.shape[2]
    out = np.full((L, A, F), np.nan, np.float32)
    partials = {}
    for lane in range(p.grid):
        for t, kb0, kb1, j, n in gg.lane_work(p, lane):
            l, mt, nt = gg.tile_coords(p, t)
            cnt, r0, n0 = min(int(counts[l]), A), mt * gg.BM, nt * p.bn
            rows, cols = slice(r0, min(r0 + gg.BM, A)), slice(n0, min(n0 + p.bn, F))
            if r0 >= cnt:
                if j == 0:
                    out[l, rows, cols] = 0.0
                continue
            k = slice(kb0 * gg.BK, min(kb1 * gg.BK, H))
            partials.setdefault((l, r0, n0), {})[j] = x[l, rows, k] @ w[l, k, cols]
    for (l, r0, n0), parts in partials.items():
        acc = parts[0]
        for j in range(1, len(parts)):
            acc = acc + parts[j]
        acc[max(0, min(int(counts[l]), A) - r0):] = 0.0
        out[l, r0:r0 + acc.shape[0], n0:n0 + acc.shape[1]] = acc
    return out


@pytest.mark.parametrize("name", SMALL)
def test_plan_emulation_matches_the_jax_package(name, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "off")
    L, A, H, F = SMALL[name]
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((L, A, H)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((L, H, F)) * 0.1).astype(np.float32)
    p = gg.plan(L, A, H, F)
    for i in range(len(edges(A))):
        counts = np.array([edges(A)[(i + l) % len(edges(A))] for l in range(L)], np.int32)
        got = emulate(p, x, w, counts)
        want = np.asarray(jops.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(counts)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for l in range(L):
            assert not got[l, min(int(counts[l]), A):].any()
